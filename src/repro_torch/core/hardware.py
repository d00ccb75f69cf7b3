"""Hardware descriptions for the co-design engine.

The paper derives its shape rules from GPU micro-architecture constants
(tensor-core alignment, tile sizes, #SMs).  We parameterize those constants so
the same analytic machinery can target TPU v5e (our production target) and the
paper's GPUs (for paper-fidelity benchmark regeneration).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A single accelerator chip, as seen by the GEMM cost model."""

    name: str
    # peak dense matmul throughput at the benchmark dtype, FLOP/s
    peak_flops: float
    # HBM bandwidth, bytes/s
    hbm_bw: float
    # interconnect bandwidth per chip (sum of usable links), bytes/s
    ici_bw: float
    # matmul unit native tile (rows, cols) in *elements* at bf16/fp16
    mxu: tuple[int, int]
    # native (sublane, lane) register/VMEM tile at 2-byte dtypes
    tile_2byte: tuple[int, int]
    # number of independent schedulable compute units.  GPUs: #SMs (wave
    # quantization domain).  TPU v5e: 1 TensorCore per chip (grid steps are
    # sequential); v5p Megacore: 2.
    num_cores: int
    # fast on-chip memory per core available to a kernel working set, bytes
    sram_bytes: int
    # whether the 'wave quantization' rule (paper §VI-B) applies: thread
    # blocks are scheduled concurrently in waves over num_cores.
    concurrent_tiles: bool
    # kernel launch / grid-step fixed overhead, seconds (tail-latency floor)
    launch_overhead: float = 2.0e-6

    def alignment_elements(self, dtype_bytes: int = 2) -> int:
        """Paper's tensor-core rule, generalized: dims should be multiples of
        this many elements for full matmul-unit utilization."""
        return self.mxu[1] * 2 // max(dtype_bytes, 1) if self.name.startswith("tpu") else (
            128 // dtype_bytes
        )


# --- TPU v5e: the production target -------------------------------------------------
# 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI (values from the task brief).
# 2D torus: model-parallel collectives typically see ~2 usable links per direction;
# we budget 3 links aggregate (conservative between 2 and 4).
TPU_V5E = Hardware(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=3 * 50e9,
    mxu=(128, 128),
    tile_2byte=(16, 128),
    num_cores=1,
    sram_bytes=64 * 1024 * 1024,  # usable VMEM working-set budget
    concurrent_tiles=False,
)

# --- Paper GPUs (paper-fidelity mode for benchmark regeneration) --------------------
A100_40GB = Hardware(
    name="a100",
    peak_flops=312e12,  # fp16 tensor core
    hbm_bw=1555e9,
    ici_bw=600e9,  # NVLink
    mxu=(128, 256),  # most efficient CUTLASS tile (paper §VI-B)
    tile_2byte=(64, 64),  # 128-byte alignment at fp16 => 64 elements
    num_cores=108,
    sram_bytes=192 * 1024,
    concurrent_tiles=True,
)

V100_16GB = Hardware(
    name="v100",
    peak_flops=125e12,
    hbm_bw=900e9,
    ici_bw=300e9,
    mxu=(128, 256),
    tile_2byte=(8, 8),  # 16-byte alignment at fp16 => 8 elements
    num_cores=80,
    sram_bytes=96 * 1024,
    concurrent_tiles=True,
)

H100_SXM = Hardware(
    name="h100",
    peak_flops=989e12,
    hbm_bw=3350e9,
    ici_bw=900e9,
    mxu=(128, 256),
    tile_2byte=(64, 64),
    num_cores=132,
    sram_bytes=228 * 1024,
    concurrent_tiles=True,
)

BY_NAME = {hw.name: hw for hw in (TPU_V5E, A100_40GB, V100_16GB, H100_SXM)}


def get_hardware(name: str = "h100") -> Hardware:
    """The port targets the H100: it is the default chip (the JAX package
    defaults to tpu_v5e)."""
    try:
        return BY_NAME[name]
    except KeyError as e:
        raise ValueError(f"unknown hardware {name!r}; have {sorted(BY_NAME)}") from e


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A mesh of chips for roofline purposes."""

    chip: Hardware
    num_chips: int

    @property
    def peak_flops(self) -> float:
        return self.chip.peak_flops * self.num_chips

    @property
    def hbm_bw(self) -> float:
        return self.chip.hbm_bw * self.num_chips
