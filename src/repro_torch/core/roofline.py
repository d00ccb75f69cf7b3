"""Three-term roofline analysis (a copy of the JAX package's `core/roofline.py`).

Where its inputs come from: in the JAX package, the compiled XLA program
(`core/hlo_analysis.py` on the post-SPMD HLO text).  The port has no
compiled program: `launch/dryrun.py` traces one rank's step on the meta
device over a virtual mesh, and `core/op_analysis.py` counts it in place of
the HLO walk (dot FLOPs of the aten matrix products, the eager program's
bytes, each hand-written kernel charged by its `cost` function, the
collectives' wire bytes from `parallel/comm.py`'s census).  `build_report`
takes those numbers; `collective_bytes` parses HLO text as the JAX
package's does.  A report's peak is its own hardware's (`hw.peak_flops`).
The JAX package's description follows:

  compute term    = HLO_FLOPs / (chips * peak_FLOP/s)
  memory term     = HLO_bytes / (chips * HBM_bw)
  collective term = collective_bytes / (chips * link_bw)

`compiled.cost_analysis()` reports the *per-partition* (per-chip) program, so
per-chip FLOPs/bytes divided by per-chip peaks give the same result as the
whole-cluster formula; we record per-chip numbers and say so.

collective_bytes is not in cost_analysis: we parse the (post-SPMD) HLO text
and sum output-shape bytes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute instruction (async start ops counted once).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

from .hardware import Hardware, get_hardware

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# one shape token: bf16[2,4096,512]{2,1,0}  (layout optional)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# an HLO instruction line: "%name = <shape-or-tuple> opcode(..."
_INSTR_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s+"
    r"([a-z0-9-]+)(?:-start)?\("
)


def _shape_bytes(shape_txt: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_txt):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum output-shape bytes per collective category from HLO text."""
    out: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for m in _INSTR_RE.finditer(hlo_text):
        shape_txt, opcode = m.group(1), m.group(2)
        if opcode.endswith("-done"):
            continue
        base = opcode[:-6] if opcode.endswith("-start") else opcode
        if base in out:
            out[base] += _shape_bytes(shape_txt)
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    num_chips: int
    # per-chip quantities (SPMD partition program)
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float  # 6*N*D per-chip-equivalent useful training FLOPs
    bytes_per_device: Optional[float] = None  # from memory_analysis
    # the report's hardware peak (not a field: the rows stay JAX's);
    # build_report sets it, a report made directly reads the default chip's
    _peak_flops = get_hardware().peak_flops

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput vs chip peak, given the bound step time
        (an analytic MFU)."""
        t = self.step_time_lower_bound
        return (self.model_flops / t) / self._peak_flops if t else 0.0


def build_report(arch: str, shape: str, mesh: str, num_chips: int,
                 flops: float, nbytes: float, coll: Dict[str, float],
                 model_flops_total: float,
                 hw: Optional[Hardware] = None,
                 bytes_per_device: Optional[float] = None) -> RooflineReport:
    """Assemble a RooflineReport from per-chip quantities.

    flops/nbytes/coll come from `core.op_analysis` on one rank's traced
    step (the JAX package's from `core.hlo_analysis.analyze_hlo` on the
    compiled, post-SPMD HLO text).
    `model_flops_total` is whole-cluster useful FLOPs per step (6·N_active·D
    train / 2·N_active·D serve), divided by chips here.
    """
    hw = hw or get_hardware()
    total = float(coll.get("total", sum(coll.values())))
    report = RooflineReport(
        arch=arch, shape=shape, mesh=mesh, num_chips=num_chips,
        hlo_flops=flops,
        hlo_bytes=nbytes,
        coll_bytes=total,
        coll_breakdown=coll,
        compute_s=flops / hw.peak_flops,
        memory_s=nbytes / hw.hbm_bw,
        collective_s=total / hw.ici_bw,
        model_flops=model_flops_total / max(num_chips, 1),
        bytes_per_device=bytes_per_device,
    )
    object.__setattr__(report, "_peak_flops", hw.peak_flops)
    return report


def to_row(r: RooflineReport) -> Dict[str, object]:
    return {
        "arch": r.arch,
        "shape": r.shape,
        "mesh": r.mesh,
        "compute_s": f"{r.compute_s:.4f}",
        "memory_s": f"{r.memory_s:.4f}",
        "collective_s": f"{r.collective_s:.4f}",
        "dominant": r.dominant,
        "useful_ratio": f"{r.useful_ratio:.3f}",
        "roofline_fraction": f"{r.roofline_fraction:.3f}",
        "bytes_per_device_GB": (f"{r.bytes_per_device/2**30:.2f}"
                                 if r.bytes_per_device else "n/a"),
    }
