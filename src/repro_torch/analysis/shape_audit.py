"""Shape-efficiency audit: the paper's §VI-B checklist as enforced lint.

Where `core.advisor.check_alignment` *advises* interactively, this pass
*gates*: every config in the port's registry (`configs.registry`) is checked
against the target hardware's tile geometry (the H100 unless asked for
another), each violation is priced through the analytic GEMM model
(`core.gemm_model.estimate`, not a measured profile), and the finding is
anchored to the config's source line — so a `# repro: noqa[SHP10x]` pragma
on the offending literal suppresses it with an auditable trail.  Rules,
messages and prices are the JAX package's (`repro.analysis.shape_audit`),
and its tests hold the two equal at every hardware target.

Severity policy
---------------
  * A misalignment on the *executed* path is an ``error``.
  * A misalignment mitigated at runtime (raw vocab that
    `ModelConfig.padded_vocab_size` pads to alignment before any GEMM runs)
    or merely sub-optimal (head_dim with a pow2 factor >= 64 but below the
    full lane) is a ``warn``.
  * Configs with ``production=False`` (smoke configs, the GPT-3 2.7B paper
    case-study variants) have errors downgraded to ``warn``: they stay
    flagged, but never gate CI — deliberately-bad pedagogical shapes remain
    usable in tests and examples.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Sequence

from ..configs.base import ModelConfig
from ..core import quantization as q
from ..core.gemm_model import GEMM, estimate
from ..core.hardware import Hardware, get_hardware
from .findings import Finding
from .source import load_source

# Tokens in flight for pricing: one 4k training sequence (TRAIN_4K's
# microbatch GEMM row count) — the m the paper's Fig. 20 vocab curve uses.
PRICE_TOKENS = 4096

# the port's config package, whose modules the registry imports by arch
_CONFIGS = __package__.rsplit(".", 1)[0] + ".configs"


@dataclasses.dataclass(frozen=True)
class RawFinding:
    """A shape finding before file/line attribution."""

    rule_id: str
    severity: str
    message: str
    fix_hint: str
    needles: Sequence[str]  # source substrings to anchor the finding to


def _gain_pct(t_bad: float, t_good: float) -> float:
    if t_good <= 0:
        return 0.0
    return (t_bad / t_good - 1.0) * 100.0


def _tput_gain_pct(bad: Sequence[GEMM], good: Sequence[GEMM],
                   hw: Hardware) -> float:
    """Predicted % gain in *useful FLOPs per second* from padding — the
    paper's efficiency framing.  (Raw time is the wrong yardstick here:
    `estimate` already folds tile quantization into the misaligned shape's
    time, so padding is roughly time-neutral while adding useful columns.)"""

    def tput(gemms: Sequence[GEMM]) -> float:
        t = sum(estimate(g, hw).time_s for g in gemms)
        f = sum(g.flops for g in gemms)
        return f / t if t > 0 else 0.0

    t_bad, t_good = tput(bad), tput(good)
    if t_bad <= 0:
        return 0.0
    return max((t_good / t_bad - 1.0) * 100.0, 0.0)


def _downgrade(sev: str, cfg: ModelConfig) -> str:
    if sev == "error" and not cfg.production:
        return "warn"
    return sev


def _price_lm_head(cfg: ModelConfig, hw: Hardware, v_bad: int,
                   v_good: int) -> float:
    """Predicted % throughput gain on the lm_head GEMM from padding."""
    return _tput_gain_pct(
        [GEMM("lm_head", PRICE_TOKENS, cfg.d_model, v_bad)],
        [GEMM("lm_head", PRICE_TOKENS, cfg.d_model, v_good)], hw)


def _price_mlp(cfg: ModelConfig, hw: Hardware, ff_bad: int,
               ff_good: int) -> float:
    """Predicted % throughput gain on the MLP GEMM pair from aligning
    d_ff."""
    h = cfg.d_model

    def pair(ff: int) -> List[GEMM]:
        return [GEMM("mlp_up", PRICE_TOKENS, h, ff),
                GEMM("mlp_down", PRICE_TOKENS, ff, h)]

    return _tput_gain_pct(pair(ff_bad), pair(ff_good), hw)


def _price_heads(cfg: ModelConfig, hw: Hardware) -> Optional[tuple]:
    """(the sibling config, est % step-time gain) for realigning head_dim
    at constant d_model — the paper's Fig. 1 C0 -> C3 move — or None if no
    aligned sibling exists.  The sibling keeps multi-head attention
    multi-head, and a GQA config's KV heads where they divide its heads."""
    from ..core.advisor import _candidate_heads, step_time

    lane = hw.tile_2byte[1]
    cands = [a for a in _candidate_heads(cfg, lane) if a != cfg.num_heads]
    if not cands:
        return None
    base = step_time(cfg, hw=hw)
    best = None
    for a in cands[:3]:
        kv = cfg.num_kv_heads
        if kv == cfg.num_heads:
            kv = a
        elif kv and a % kv:
            continue
        sib = dataclasses.replace(cfg, num_heads=a, num_kv_heads=kv,
                                  head_dim=cfg.d_model // a)
        t = step_time(sib, hw=hw)
        if best is None or t < best[1]:
            best = (sib, t)
    if best is None:
        return None
    return best[0], _gain_pct(base, best[1])


def audit_config(cfg: ModelConfig, hw: Optional[Hardware] = None,
                 tp: int = 1) -> List[RawFinding]:
    """All SHP findings for one config on one hardware target."""
    hw = hw or get_hardware()
    lane = hw.tile_2byte[1]
    out: List[RawFinding] = []

    # SHP101: vocab divisibility (§padded_vocab_size) --------------------
    v = cfg.vocab_size
    if v % lane != 0:
        v_pad = q.round_up(v, lane)
        gain = _price_lm_head(cfg, hw, v, v_pad)
        runtime_pad = cfg.padded_vocab_size % lane == 0
        sev = "warn" if runtime_pad else "error"
        note = (f"; runtime pads the embedding/lm_head to "
                f"{cfg.padded_vocab_size} (padded_vocab_size), so only the "
                f"declared shape is stale" if runtime_pad else
                "; every embedding/lm_head GEMM pads at execution")
        out.append(RawFinding(
            "SHP101", _downgrade(sev, cfg),
            f"[{cfg.name}] vocab {v} % {lane} = {v % lane}{note}",
            f"vocab {v} -> pad to {v_pad}, est. +{gain:.1f}% lm_head GEMM "
            f"throughput",
            (f"vocab_size={v}", f'name="{cfg.name}"')))

    # SHP102: per-head alignment (d_model / num_heads) -------------------
    if cfg.num_heads:
        hd = cfg.head_dim
        p2 = q.pow2_factor(hd)
        if hd % lane != 0:
            sev = "error" if p2 < 64 else "warn"
            priced = _price_heads(cfg, hw)
            if priced is not None:
                sib, gain = priced
                hint = (f"num_heads {cfg.num_heads} -> {sib.num_heads} (head_dim "
                        f"{hd} -> {sib.head_dim}), est. "
                        f"+{gain:.1f}% step time")
            else:
                hint = (f"choose num_heads so d_model/num_heads has a pow2 "
                        f"factor >= {lane}")
            out.append(RawFinding(
                "SHP102", _downgrade(sev, cfg),
                f"[{cfg.name}] head_dim {hd} (d_model {cfg.d_model} / "
                f"{cfg.num_heads} heads): largest pow2 factor {p2} < lane "
                f"{lane}; attention BMMs run at reduced MXU utilization",
                hint,
                (f"num_heads={cfg.num_heads}", f", {cfg.num_heads})",
                 f'name="{cfg.name}"')))

    # SHP103: d_ff tile quantization -------------------------------------
    if cfg.d_ff and cfg.d_ff % lane != 0:
        ff_pad = q.round_up(cfg.d_ff, lane)
        gain = _price_mlp(cfg, hw, cfg.d_ff, ff_pad)
        out.append(RawFinding(
            "SHP103", _downgrade("error", cfg),
            f"[{cfg.name}] d_ff {cfg.d_ff} % {lane} = {cfg.d_ff % lane}; "
            f"every MLP GEMM pads the hidden dimension "
            f"(util {q.tile_utilization(PRICE_TOKENS, cfg.d_ff, cfg.d_model, hw):.3f})",
            f"d_ff {cfg.d_ff} -> {ff_pad}, est. +{gain:.1f}% MLP GEMM "
            f"throughput (paper §VII-B: LLaMA-2 chose 11008 = 86*128 "
            f"for 8h/3)",
            (f"d_ff={cfg.d_ff}", f'name="{cfg.name}"')))

    # SHP104: MoE expert d_ff --------------------------------------------
    if cfg.num_experts and cfg.moe_d_ff % lane != 0:
        ff_pad = q.round_up(cfg.moe_d_ff, lane)
        gain = _price_mlp(cfg, hw, cfg.moe_d_ff, ff_pad)
        out.append(RawFinding(
            "SHP104", _downgrade("error", cfg),
            f"[{cfg.name}] expert d_ff {cfg.moe_d_ff} % {lane} = "
            f"{cfg.moe_d_ff % lane}; every expert GEMM pads",
            f"moe_d_ff {cfg.moe_d_ff} -> {ff_pad}, est. +{gain:.1f}% "
            f"expert GEMM throughput",
            (f"moe_d_ff={cfg.moe_d_ff}", f'name="{cfg.name}"')))

    # SHP105: SSM state / chunk alignment --------------------------------
    if cfg.ssm_state:
        for field, val in (("ssm_state", cfg.ssm_state),
                           ("ssm_chunk", cfg.ssm_chunk)):
            if val % lane != 0:
                sev = ("warn" if field == "ssm_state"
                       and q.pow2_factor(val) >= 32 else "error")
                out.append(RawFinding(
                    "SHP105", _downgrade(sev, cfg),
                    f"[{cfg.name}] {field} {val} % {lane} = {val % lane}; "
                    f"SSD chunk BMMs pad "
                    f"(util {q.tile_utilization(val, val, cfg.ssm_state, hw):.3f})",
                    f"{field} {val} -> {q.round_up(val, lane)}",
                    (f"{field}={val}", f'name="{cfg.name}"')))

    # SHP106: wave quantization (GPU targets only) -----------------------
    if hw.concurrent_tiles and cfg.d_ff:
        weff = q.wave_efficiency(PRICE_TOKENS, cfg.d_ff, hw)
        if weff < 0.90:
            tiles = q.num_output_tiles(PRICE_TOKENS, cfg.d_ff, hw)
            waves = q.ceil_div(tiles, hw.num_cores)
            out.append(RawFinding(
                "SHP106", "warn",
                f"[{cfg.name}] MLP output tiles ({tiles}) fill the last of "
                f"{waves} waves over {hw.num_cores} SMs to "
                f"{weff * 100:.0f}% on {hw.name} (paper §VI-B wave "
                f"quantization)",
                f"resize d_ff so ceil-tiles divide {hw.num_cores} SMs, or "
                f"absorb into batch",
                (f"d_ff={cfg.d_ff}", f'name="{cfg.name}"')))

    return out


# -- registry attribution -----------------------------------------------------


def _config_module_files():
    """arch module name -> source path, via the registry's arch list."""
    from ..configs import registry as reg

    out = {}
    for arch in reg._ARCHS:
        mod = importlib.import_module(f"{_CONFIGS}.{arch}")
        out[arch] = mod.__file__
    return out


def _configs_in_module(arch: str):
    """(config, is_smoke) pairs registered by `configs.<arch>`.

    Registered configs are matched to the module by name against the
    ModelConfig instances in its globals (the registry may hold a
    `production=False` copy of a smoke config, so identity is not enough).
    """
    from ..configs import registry as reg

    reg._load_all()
    mod = importlib.import_module(f"{_CONFIGS}.{arch}")
    declared = {v.name for v in vars(mod).values()
                if isinstance(v, ModelConfig)}
    pairs = [(c, False) for c in reg._REGISTRY.values()
             if c.name in declared]
    pairs += [(s, True) for s in reg._SMOKE.values() if s.name in declared]
    return pairs


def audit_registry(hw_name: str = "h100", tp: int = 1,
                   include_smoke: bool = True) -> List[Finding]:
    """Audit every registered config; findings anchored to config sources.

    Suppression: a `# repro: noqa[SHP10x]` pragma on the anchored line
    silences the finding (applied here, since the audit anchors its
    findings in files the engine may not have scanned).
    """
    hw = get_hardware(hw_name)
    out: List[Finding] = []
    for arch, path in _config_module_files().items():
        sf = load_source(path)
        seen = set()
        for cfg, is_smoke in _configs_in_module(arch):
            if is_smoke and not include_smoke:
                continue
            if cfg.name in seen:
                continue
            seen.add(cfg.name)
            for raw in audit_config(cfg, hw, tp):
                line = 1
                for needle in raw.needles:
                    hit = sf.find_line(needle, default=0)
                    if hit:
                        line = hit
                        break
                if sf.suppressions.is_suppressed(line, raw.rule_id):
                    continue
                out.append(Finding(path, line, raw.rule_id, raw.severity,
                                   raw.message, raw.fix_hint, arch=cfg.name))
    return out
