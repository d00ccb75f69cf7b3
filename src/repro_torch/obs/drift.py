"""Predicted-vs-measured drift monitor.

The analytic cost model (`core.gemm_model`, calibrated by
`MeasuredProfile` from the tuning cache) predicts a step time for every
program the engine lowers; the span tracer measures what each program
actually took.  This module holds both sides against each other, per
program site (one row per prefill bucket + one for the pool decode step),
and reports the prediction error — the exact quantity the ROADMAP's
measured shape-search loop will optimize against: a shape whose *relative*
drift is high is a shape where the model would mis-rank candidates.

Two error views per site:

  * ratio      — measured_p50 / predicted.  On the card this is the
    model's absolute error at the H100 (`core.hardware.H100_SXM`, the
    port's default chip); on the host (the kernels' plain versions against
    the H100's constants) it is huge but roughly uniform;
  * rel_drift  — ratio / median(ratio over all sites).  The uniform
    calibration constant divides out, so rel_drift ~ 1.0 everywhere means
    the model ranks the engine's programs correctly even when its absolute
    scale is off.

The JAX package's `obs/drift.py` over the port's `core.advisor.step_time`
and `MeasuredProfile`; in the port a "program" is a step shape (the
engine runs eagerly, one prefill shape per prompt bucket).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Dict, List, Optional

from ..configs.base import ModelConfig, ShapeConfig
from ..core.advisor import step_time
from ..core.gemm_model import MeasuredProfile
from ..core.hardware import Hardware, get_hardware


@dataclasses.dataclass
class _Site:
    predicted_s: float
    observed_s: List[float] = dataclasses.field(default_factory=list)


class DriftMonitor:
    """Accumulate observed durations per predicted site; report drift."""

    def __init__(self, hw_name: str = ""):
        self.hw_name = hw_name
        self._sites: Dict[str, _Site] = {}

    # -- construction --------------------------------------------------------

    @classmethod
    def for_engine(cls, cfg: ModelConfig, policy,
                   hw: Optional[Hardware] = None,
                   profile: Optional[MeasuredProfile] = None
                   ) -> "DriftMonitor":
        """One predicted site per engine program: every prefill bucket
        (batch 1, forward-only at the bucket length) plus the pool-wide
        decode step (batch = num_slots against a seq_max-deep cache —
        the upper bound the bucket policy sizes for)."""
        hw = hw or get_hardware()
        if profile is None:
            profile = MeasuredProfile.from_cache(None, hw.name)
        mon = cls(hw_name=hw.name)
        for b in policy.prompt_buckets:
            shape = ShapeConfig(f"obs_prefill_{b}", b, 1, "prefill")
            mon.add_site(f"prefill_{b}",
                         step_time(cfg, shape, hw, profile=profile))
        shape = ShapeConfig("obs_decode", policy.seq_max, policy.num_slots,
                            "decode")
        mon.add_site("decode_step",
                     step_time(cfg, shape, hw, microbatch=policy.num_slots,
                               profile=profile))
        return mon

    def add_site(self, site: str, predicted_s: float) -> None:
        self._sites[site] = _Site(predicted_s=predicted_s)

    # -- observation ---------------------------------------------------------

    def observe(self, site: str, dur_s: float) -> None:
        st = self._sites.get(site)
        if st is None:
            st = self._sites[site] = _Site(predicted_s=0.0)
        st.observed_s.append(dur_s)

    # -- reporting -----------------------------------------------------------

    def report(self) -> List[dict]:
        """One row per site with >= 1 observation, plus the per-site ratio
        normalized by the median ratio (rel_drift) — see module docstring."""
        rows = []
        for site, st in sorted(self._sites.items()):
            if not st.observed_s:
                continue
            xs = sorted(st.observed_s)
            p50 = xs[len(xs) // 2]
            ratio = (p50 / st.predicted_s) if st.predicted_s > 0 else None
            rows.append({
                "site": site,
                "count": len(xs),
                "predicted_ms": st.predicted_s * 1e3,
                "measured_p50_ms": p50 * 1e3,
                "measured_mean_ms": sum(xs) / len(xs) * 1e3,
                "ratio": ratio,
            })
        ratios = [r["ratio"] for r in rows if r["ratio"]]
        med = statistics.median(ratios) if ratios else 0.0
        for r in rows:
            r["rel_drift"] = (r["ratio"] / med) if (r["ratio"] and med) else None
        return rows

    def to_json(self) -> dict:
        return {"hw_name": self.hw_name, "rows": self.report()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
