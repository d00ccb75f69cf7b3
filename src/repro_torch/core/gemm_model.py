"""Analytic GEMM/BMM cost model (paper §III, §V) — hardware-parametric (a copy
of the JAX package's `core/gemm_model.py`; `MeasuredProfile.from_cache`
defaults to the H100, as `get_hardware` does here).

Predicted kernel time = max(compute_time, memory_time, launch_overhead) where

  compute_time = padded_flops / (peak_flops * wave_efficiency)
  memory_time  = bytes_moved / hbm_bw

`padded_flops` folds in tensor-core/tile quantization (see quantization.py);
`wave_efficiency` applies only on wave-scheduled hardware (GPUs).  The model
reproduces the paper's Figures 5-10 qualitatively: throughput rises with
arithmetic intensity, dips at misaligned dims and at wave boundaries.

`MeasuredProfile` grounds the analytic model in reality: built from the
autotuning cache (`repro_torch.tuning`), it substitutes measured wall times for
GEMMs whose exact shape was tuned and rescales the rest by the measured/
analytic calibration ratio, so relative comparisons stay on one scale.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Optional, Tuple

from .hardware import Hardware, get_hardware
from . import quantization as q


@dataclasses.dataclass(frozen=True)
class GEMM:
    """C[b](m,n) += A[b](m,k) @ B[b](k,n), `batch` independent problems.

    `name` ties the GEMM back to its transformer module (Table II).
    `weight_bytes` lets callers mark B as a resident weight (counted once per
    step for memory-traffic purposes regardless of batch).
    """

    name: str
    m: int
    k: int
    n: int
    batch: int = 1
    dtype_bytes: int = 2
    weight_is_b: bool = True  # B is a weight matrix (vs. activation BMM)
    count: int = 1  # how many times this GEMM occurs (e.g. per layer)

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n * self.batch * self.count

    @property
    def bytes_moved(self) -> float:
        """HBM traffic assuming A, B, C each move once (no fusion credit)."""
        a = self.m * self.k
        b = self.k * self.n
        c = self.m * self.n
        return (a + b + c) * self.batch * self.dtype_bytes * self.count

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_moved, 1.0)


@dataclasses.dataclass(frozen=True)
class GEMMEstimate:
    gemm: GEMM
    time_s: float
    compute_s: float
    memory_s: float
    tile_util: float
    wave_eff: float
    achieved_tflops: float
    bound: str  # "compute" | "memory" | "overhead" | "measured"

    @property
    def efficiency(self) -> float:
        """Achieved/peak — the quantity the paper plots."""
        return self.tile_util * self.wave_eff


@dataclasses.dataclass(frozen=True)
class MeasuredProfile:
    """Measured kernel timings for one hardware target, keyed by GEMM shape.

    Built from the autotuning cache (`MeasuredProfile.from_cache`).  Two uses:

      * exact hit — a GEMM whose (m, k, n, dtype) was autotuned gets the
        measured per-call wall time (scaled by batch*count) instead of the
        analytic roofline prediction;
      * calibration — GEMMs without an exact entry get the analytic time
        scaled by the median measured/analytic ratio over all entries, so
        measured and modeled GEMMs stay comparable inside one step_time sum.

    The calibration ratio is the model's systematic error on the card the
    entries were measured on: the analytic model prices a GEMM at the
    published peak, the cache holds what the kernels took.
    """

    hw_name: str
    # (m, k, n, dtype_bytes) -> measured seconds per single GEMM call
    points: Dict[Tuple[int, int, int, int], float]
    calibration: float = 1.0

    @classmethod
    def from_cache(cls, cache=None,
                   hw_name: str = "h100") -> "Optional[MeasuredProfile]":
        """Build from a TuningCache (default: the process default cache).
        Returns None when the cache has no matmul entries for `hw_name`."""
        # Deferred import: core must stay importable without tuning and
        # tuning.search imports the kernels, which import core.
        from ..tuning.cache import get_default_cache

        cache = cache if cache is not None else get_default_cache()
        hw = get_hardware(hw_name)
        points: Dict[Tuple[int, int, int, int], float] = {}
        ratios = []
        for entry in cache.by_op("matmul", hw_name):
            m, k, n = entry.shape
            dtype_bytes = _DTYPE_BYTES.get(entry.dtype, 2)
            measured_s = entry.time_us * 1e-6
            points[(m, k, n, dtype_bytes)] = measured_s
            analytic = estimate(GEMM("cal", m, k, n, dtype_bytes=dtype_bytes), hw)
            if analytic.time_s > 0:
                ratios.append(measured_s / analytic.time_s)
        if not points:
            return None
        return cls(hw_name=hw_name, points=dict(points),
                   calibration=statistics.median(ratios) if ratios else 1.0)

    def measured_time(self, gemm: GEMM) -> Optional[float]:
        """Measured seconds for `gemm` (batch*count folded in), or None."""
        t = self.points.get((gemm.m, gemm.k, gemm.n, gemm.dtype_bytes))
        if t is None:
            return None
        return t * gemm.batch * gemm.count

    def blend(self, gemm: GEMM, analytic_s: float) -> Tuple[float, bool]:
        """(time_s, was_measured): exact measurement if available, else the
        calibrated analytic prediction."""
        t = self.measured_time(gemm)
        if t is not None:
            return t, True
        return analytic_s * self.calibration, False


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1,
                "float8_e4m3fn": 1, "float8_e5m2": 1}


def estimate(gemm: GEMM, hw: Optional[Hardware] = None,
             profile: Optional[MeasuredProfile] = None) -> GEMMEstimate:
    hw = hw or get_hardware()
    util = q.tile_utilization(gemm.m, gemm.n, gemm.k, hw, gemm.dtype_bytes)
    weff = q.wave_efficiency(gemm.m, gemm.n, hw, gemm.batch)
    eff_flops = hw.peak_flops * util * weff
    compute_s = gemm.flops / eff_flops
    memory_s = gemm.bytes_moved / hw.hbm_bw
    over_s = hw.launch_overhead * gemm.count
    time_s = max(compute_s, memory_s, over_s)
    bound = (
        "compute"
        if time_s == compute_s
        else ("memory" if time_s == memory_s else "overhead")
    )
    if profile is not None:
        time_s, measured = profile.blend(gemm, time_s)
        if measured:
            bound = "measured"
    return GEMMEstimate(
        gemm=gemm,
        time_s=time_s,
        compute_s=compute_s,
        memory_s=memory_s,
        tile_util=util,
        wave_eff=weff,
        achieved_tflops=gemm.flops / time_s / 1e12,
        bound=bound,
    )


def estimate_many(gemms: list[GEMM], hw: Optional[Hardware] = None,
                  profile: Optional[MeasuredProfile] = None) -> list[GEMMEstimate]:
    hw = hw or get_hardware()
    return [estimate(g, hw, profile) for g in gemms]


def total_time(gemms: list[GEMM], hw: Optional[Hardware] = None,
               profile: Optional[MeasuredProfile] = None) -> float:
    return sum(e.time_s for e in estimate_many(gemms, hw, profile))


def throughput_tflops(gemms: list[GEMM], hw: Optional[Hardware] = None,
                      profile: Optional[MeasuredProfile] = None) -> float:
    """End-to-end achieved TFLOP/s over a GEMM set (the paper's y-axis)."""
    t = total_time(gemms, hw, profile)
    f = sum(g.flops for g in gemms)
    return f / t / 1e12 if t > 0 else 0.0


# --- precision pricing ----------------------------------------------------------------

def precision_candidates(gemm: GEMM, hw: Optional[Hardware] = None,
                         dtypes: Tuple[str, ...] = ("bfloat16", "int8"),
                         profile: Optional[MeasuredProfile] = None,
                         ) -> Dict[str, GEMMEstimate]:
    """Price the same GEMM at each storage precision.

    Only `dtype_bytes` changes per candidate: the model credits low
    precision with its bandwidth win (and the int8 sublane granule via
    tile_utilization), not a higher MXU issue rate — conservative, since
    the paper's bandwidth-bound serving GEMMs are where the bytes dominate.
    """
    hw = hw or get_hardware()
    return {
        dt: estimate(
            dataclasses.replace(gemm, dtype_bytes=_DTYPE_BYTES[dt]),
            hw, profile)
        for dt in dtypes
    }


def recommend_precision(gemm: GEMM, hw: Optional[Hardware] = None,
                        dtypes: Tuple[str, ...] = ("bfloat16", "int8"),
                        min_speedup: float = 1.05,
                        profile: Optional[MeasuredProfile] = None,
                        ) -> Tuple[str, float]:
    """(best_dtype, speedup_vs_dtypes[0]) under the analytic model.

    Sticks with the baseline precision unless a candidate clears
    `min_speedup` — a compute-bound GEMM sees ~1.0x from int8 here and the
    quantization-noise cost isn't worth paying for it.
    """
    ests = precision_candidates(gemm, hw, dtypes, profile)
    base_s = ests[dtypes[0]].time_s
    best = min(ests, key=lambda d: ests[d].time_s)
    speedup = base_s / ests[best].time_s if ests[best].time_s > 0 else 1.0
    if best == dtypes[0] or speedup < min_speedup:
        return dtypes[0], 1.0
    return best, speedup
