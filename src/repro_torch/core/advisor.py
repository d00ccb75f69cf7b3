"""Shape advisor: score a model config against hardware shape rules and
propose nearby, faster shapes at ~constant parameter count (a copy of the
JAX package's `core/advisor.py`; on the H100 the lane is `tile_2byte[1]` =
64 elements, the paper's 128-byte rule).

This operationalizes the paper's §VI-B checklist and §VII case studies:
  * vocab divisible by the lane alignment (64 on A100 → 128 on TPU),
  * head_dim (h/a) divisible by a power of two, ideally the full lane width,
  * h/t, d_ff/t, a/t, kv/t, experts/t divisibility for t-way TP/EP,
  * (b·a)/t integral,
  * L divisible by pipeline stages,
  * SwiGLU d_ff re-search around 8h/3,
and the search procedure used for Fig. 1 (GPT-3 2.7B: a 32→20/40) and
§VII-B (LLaMA-2 d_ff=11008).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..configs.base import ModelConfig, ShapeConfig, TRAIN_4K
from .hardware import Hardware, get_hardware
from .gemm_model import MeasuredProfile, throughput_tflops, total_time
from .transformer_gemms import model_gemms
from .quantization import pow2_factor, round_up, shard_quantization


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str  # ok | warn | bad
    message: str


@dataclasses.dataclass(frozen=True)
class Proposal:
    config: ModelConfig
    change: str
    predicted_speedup: float  # >1 is faster than the input config
    param_delta: float  # relative parameter-count change
    tflops: float


def check_alignment(cfg: ModelConfig, hw: Optional[Hardware] = None,
                    tp: int = 1, pp: int = 1,
                    global_batch: int = 256) -> List[Finding]:
    """The paper's rule checklist, evaluated for `cfg` on `hw`."""
    hw = hw or get_hardware()
    lane = hw.tile_2byte[1]
    f: List[Finding] = []

    def rule(name, ok, warn, msg_ok, msg_bad):
        sev = "ok" if ok else ("warn" if warn else "bad")
        f.append(Finding(name, sev, msg_ok if ok else msg_bad))

    v = cfg.vocab_size
    rule("vocab_alignment", v % lane == 0, v % 64 == 0,
         f"vocab {v} is a multiple of {lane}",
         f"vocab {v} % {lane} = {v % lane}; pad to {round_up(v, lane)} "
         f"(+{round_up(v, lane) - v} tokens)")

    if cfg.num_heads:
        hd = cfg.head_dim
        p2 = pow2_factor(hd)
        rule("head_dim_alignment", hd % lane == 0, p2 >= 64,
             f"head_dim {hd} is a multiple of {lane}",
             f"head_dim {hd}: largest pow2 factor {p2} (< {lane}); "
             f"attention BMMs run at reduced MXU utilization")
        rule("heads_div_tp", cfg.num_heads % tp == 0, False,
             f"num_heads {cfg.num_heads} divisible by tp={tp}",
             f"num_heads {cfg.num_heads} not divisible by tp={tp}")
        if cfg.num_kv_heads:
            rule("kv_heads_div_tp", cfg.num_kv_heads % tp == 0,
                 tp % cfg.num_kv_heads == 0,
                 f"kv_heads {cfg.num_kv_heads} divisible by tp={tp}",
                 f"kv_heads {cfg.num_kv_heads} vs tp={tp}: KV heads must be "
                 f"replicated or resharded")

    rule("hidden_shard_alignment", (cfg.d_model % tp == 0)
         and ((cfg.d_model // tp) % lane == 0),
         cfg.d_model % tp == 0,
         f"h/t = {cfg.d_model // max(tp,1)} is a multiple of {lane}",
         f"h={cfg.d_model}, t={tp}: per-shard width misaligned")

    if cfg.d_ff:
        ff = cfg.d_ff
        rule("dff_shard_alignment", ff % tp == 0 and (ff // tp) % lane == 0,
             ff % tp == 0,
             f"d_ff/t = {ff // max(tp,1)} is a multiple of {lane}",
             f"d_ff={ff}, t={tp}: per-shard MLP width misaligned "
             f"(util {shard_quantization(ff, tp):.3f})")

    if cfg.num_experts:
        rule("experts_div_ep", cfg.num_experts % tp == 0, False,
             f"{cfg.num_experts} experts divide EP={tp}",
             f"{cfg.num_experts} experts do not divide EP={tp}")
        rule("expert_dff_alignment", cfg.moe_d_ff % lane == 0,
             cfg.moe_d_ff % 64 == 0,
             f"expert d_ff {cfg.moe_d_ff} is a multiple of {lane}",
             f"expert d_ff {cfg.moe_d_ff} misaligned")

    if cfg.ssm_state:
        rule("ssm_state_alignment", cfg.ssm_state % lane == 0,
             pow2_factor(cfg.ssm_state) >= 32,
             f"ssm_state {cfg.ssm_state} is a multiple of {lane}",
             f"ssm_state {cfg.ssm_state} misaligned (SSD chunk BMMs pad)")
        rule("ssm_chunk_alignment", cfg.ssm_chunk % lane == 0, False,
             f"ssm_chunk {cfg.ssm_chunk} is a multiple of {lane}",
             f"ssm_chunk {cfg.ssm_chunk} misaligned")

    rule("layers_div_pp", cfg.num_layers % pp == 0, False,
         f"L={cfg.num_layers} divisible by pp={pp}",
         f"L={cfg.num_layers} not divisible by pp={pp} (paper §VI-B)")

    rule("batch_div_dp", global_batch % 1 == 0, True, "batch rule checked by mesh", "")
    return f


def score(cfg: ModelConfig, shape: ShapeConfig = TRAIN_4K,
          hw: Optional[Hardware] = None, tp: int = 1,
          microbatch: int = 1,
          profile: Optional[MeasuredProfile] = None) -> float:
    """Predicted achieved TFLOP/s for one microbatch through the whole model
    (the paper's Fig. 1 y-axis; analytic, or measurement-calibrated when a
    `MeasuredProfile` is given)."""
    hw = hw or get_hardware()
    mode = "decode" if shape.is_decode else "train"
    gemms = model_gemms(cfg, microbatch, shape.seq_len, t=tp, mode=mode)
    return throughput_tflops(gemms, hw, profile)


def step_time(cfg: ModelConfig, shape: ShapeConfig = TRAIN_4K,
              hw: Optional[Hardware] = None, tp: int = 1,
              microbatch: int = 1,
              profile: Optional[MeasuredProfile] = None) -> float:
    hw = hw or get_hardware()
    mode = "decode" if shape.is_decode else "train"
    gemms = model_gemms(cfg, microbatch, shape.seq_len, t=tp, mode=mode)
    mult = 3.0 if shape.mode == "train" else 1.0  # fwd+bwd
    return mult * total_time(gemms, hw, profile)


def precision_plan(cfg: ModelConfig, shape: ShapeConfig = TRAIN_4K,
                   hw: Optional[Hardware] = None, tp: int = 1,
                   microbatch: int = 1,
                   dtypes: tuple = ("bfloat16", "int8"),
                   min_speedup: float = 1.05) -> List[dict]:
    """Per-layer GEMM precision recommendations under the analytic model.

    For every named GEMM in the model's step (Table II decomposition), price
    it at each candidate storage precision and report the winner — the
    dtype-aware companion to `check_alignment`: decode-mode skinny GEMMs are
    bandwidth-bound, so int8 weights (kernels.quantized / linear_impl=
    "quantized") buy their byte ratio, while compute-bound prefill GEMMs
    stay at the baseline.  Returns one dict per GEMM:
      {name, m, k, n, bound, recommended_dtype, speedup, candidates}
    with `candidates` mapping dtype -> predicted time_s.
    """
    from .gemm_model import estimate, precision_candidates, recommend_precision
    hw = hw or get_hardware()
    mode = "decode" if shape.is_decode else "train"
    gemms = model_gemms(cfg, microbatch, shape.seq_len, t=tp, mode=mode)
    plan: List[dict] = []
    for g in gemms:
        ests = precision_candidates(g, hw, dtypes)
        best, speedup = recommend_precision(g, hw, dtypes,
                                            min_speedup=min_speedup)
        plan.append({
            "name": g.name,
            "m": g.m, "k": g.k, "n": g.n,
            "bound": estimate(g, hw).bound,
            "recommended_dtype": best,
            "speedup": speedup,
            "candidates": {dt: e.time_s for dt, e in ests.items()},
        })
    return plan


def _candidate_heads(cfg: ModelConfig, lane: int,
                     max_head_dim: int = 256) -> List[int]:
    """Head counts near cfg.num_heads with aligned head_dim, h unchanged.

    head_dim is capped (default 256): the paper warns that aggressively
    shrinking `a` can cost accuracy (§VI-B), so we only propose shapes in the
    empirically safe 64..256 head_dim band.
    """
    h = cfg.d_model
    cands = []
    for a in range(1, min(h, 4 * cfg.num_heads) + 1):
        if h % a:
            continue
        hd = h // a
        if hd > max_head_dim or hd < 32:
            continue
        if hd % lane == 0 or pow2_factor(hd) >= 64:
            cands.append(a)
    # keep the ones closest to the original head count
    cands.sort(key=lambda a: abs(a - cfg.num_heads))
    return cands[:6]


def _candidate_dff(cfg: ModelConfig, lane: int, tp: int, tol: float) -> List[int]:
    """d_ff values near the original that are lane*tp aligned (§VII-B).

    Only values >= the original are proposed: shrinking d_ff is trivially
    'faster' but cuts capacity — the paper's search (and LLaMA-2's actual
    11008 = 86*128 choice for 8h/3 = 10922.6) rounds UP to alignment."""
    base = cfg.d_ff
    step = lane * max(tp, 1)
    hi = int(base * (1 + tol))
    out = [d for d in range(round_up(base, step), hi + 1, step)]
    return out[:32]


def advise(cfg: ModelConfig, shape: ShapeConfig = TRAIN_4K,
           hw: Optional[Hardware] = None, tp: int = 1,
           param_tolerance: float = 0.05,
           microbatch: int = 1,
           profile: Optional[MeasuredProfile] = None) -> List[Proposal]:
    """Search nearby configs; return proposals ranked by predicted speedup.

    Reproduces the paper's case studies: for GPT-3 2.7B (h=2560, a=32) the
    top proposals change `a` so head_dim is 64/128-aligned; for SwiGLU models
    it re-searches d_ff around 8h/3; for any model it pads the vocab.

    When `profile` is given, every step-time prediction is grounded in the
    measured kernel timings it carries (see gemm_model.MeasuredProfile);
    `propose()` builds that profile from the autotuning cache automatically.
    """
    hw = hw or get_hardware()
    lane = hw.tile_2byte[1]
    base_t = step_time(cfg, shape, hw, tp, microbatch, profile)
    base_params = cfg.param_count()
    props: List[Proposal] = []

    def consider(new_cfg: ModelConfig, change: str):
        p = new_cfg.param_count()
        delta = (p - base_params) / base_params
        if abs(delta) > param_tolerance:
            return
        t = step_time(new_cfg, shape, hw, tp, microbatch, profile)
        props.append(Proposal(new_cfg, change, base_t / t, delta,
                              score(new_cfg, shape, hw, tp, microbatch,
                                    profile)))

    # 1. vocab padding (Fig. 20 / Karpathy rule)
    v_pad = round_up(cfg.vocab_size, lane * max(tp, 1))
    if v_pad != cfg.vocab_size:
        consider(dataclasses.replace(cfg, vocab_size=v_pad),
                 f"pad vocab {cfg.vocab_size} -> {v_pad}")

    # 2. head count (Fig. 1 C1/C2 case study)
    if cfg.num_heads and cfg.attn_type == "gqa":
        for a in _candidate_heads(cfg, lane):
            if a == cfg.num_heads:
                continue
            kv = cfg.num_kv_heads
            if kv == cfg.num_heads:
                kv = a  # MHA: keep MHA
            elif a % max(kv, 1):
                continue  # GQA requires kv | a
            consider(dataclasses.replace(cfg, num_heads=a, num_kv_heads=kv,
                                         head_dim=cfg.d_model // a),
                     f"heads {cfg.num_heads} -> {a} (head_dim "
                     f"{cfg.head_dim} -> {cfg.d_model // a})")

    # 3. d_ff re-search (SwiGLU §VII-B, or any misaligned MLP)
    if cfg.d_ff:
        for ff in _candidate_dff(cfg, lane, tp, param_tolerance):
            if ff == cfg.d_ff:
                continue
            consider(dataclasses.replace(cfg, d_ff=ff),
                     f"d_ff {cfg.d_ff} -> {ff}")

    # 4. SSD chunk/state alignment (TPU adaptation of the BMM rules)
    if cfg.ssm_state and cfg.ssm_chunk % lane:
        consider(dataclasses.replace(cfg, ssm_chunk=round_up(cfg.ssm_chunk, lane)),
                 f"ssm_chunk {cfg.ssm_chunk} -> {round_up(cfg.ssm_chunk, lane)}")

    props.sort(key=lambda p: -p.predicted_speedup)
    return props


def propose(cfg: ModelConfig, shape: ShapeConfig = TRAIN_4K,
            hw: Optional[Hardware] = None, tp: int = 1,
            param_tolerance: float = 0.05, microbatch: int = 1,
            profile: Optional[MeasuredProfile] = None,
            cache=None) -> List[Proposal]:
    """`advise`, grounded in measurement when a tuning cache exists.

    If `profile` is None, one is built from `cache` (default: the process
    default tuning cache — see repro_torch.tuning.cache).  With no cache entries
    this degrades gracefully to the purely analytic `advise`.
    """
    hw = hw or get_hardware()
    if profile is None:
        profile = MeasuredProfile.from_cache(cache, hw.name)
    return advise(cfg, shape, hw, tp, param_tolerance, microbatch, profile)


def best_combined(cfg: ModelConfig, shape: ShapeConfig = TRAIN_4K,
                  hw: Optional[Hardware] = None, tp: int = 1,
                  param_tolerance: float = 0.05,
                  profile: Optional[MeasuredProfile] = None) -> Proposal:
    """Greedily stack the top proposal of each category."""
    hw = hw or get_hardware()
    cur = cfg
    changes = []
    for _ in range(4):
        props = advise(cur, shape, hw, tp, param_tolerance, profile=profile)
        props = [p for p in props if p.predicted_speedup > 1.005]
        if not props:
            break
        cur = props[0].config
        changes.append(props[0].change)
    base_t = step_time(cfg, shape, hw, tp, profile=profile)
    new_t = step_time(cur, shape, hw, tp, profile=profile)
    return Proposal(cur, "; ".join(changes) or "no change", base_t / new_t,
                    (cur.param_count() - cfg.param_count()) / cfg.param_count(),
                    score(cur, shape, hw, tp, profile=profile))
