"""The port's analytic core (paper Table II, the GEMM cost model, the
advisor, the roofline report) against the JAX package's.

Both are the same Python float arithmetic in the same order, so every
comparison here is exact equality: GEMM lists for every registered config
(full and smoke) in train and decode at tp 1 and 8, estimates, rule
findings, scores, step times, precision plans, proposals and the combined
proposal on the H100, the A100 and the TPU v5e, the alignment report,
`collective_bytes` on an HLO snippet, and the measurement-calibrated
profile and proposals from one hand-written cache file.
"""
import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.configs.registry import list_archs
from repro.core import advisor as jax_advisor
from repro.core import gemm_model as jax_gm
from repro.core import roofline as jax_roofline
from repro.core import transformer_gemms as jax_tg
from repro.core.hardware import get_hardware as jax_get_hardware
from repro.kernels.matmul.ops import alignment_report as jax_alignment_report
from repro.tuning.cache import TuningCache as JaxTuningCache
from repro_torch.configs import base
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import advisor, gemm_model, roofline, transformer_gemms
from repro_torch.core.hardware import get_hardware
from repro_torch.kernels.matmul.ops import alignment_report
from repro_torch.tuning.cache import TuningCache

ARCHS = list_archs()
HWS = ("h100", "a100", "tpu_v5e")


def _cfgs(arch, smoke):
    if smoke:
        return jax_get_smoke_config(arch), get_smoke_config(arch)
    return jax_get_config(arch), get_config(arch)


def _rows(gemms):
    return [dataclasses.astuple(g) for g in gemms]


def _est(e):
    return (dataclasses.astuple(e.gemm), e.time_s, e.compute_s, e.memory_s, e.tile_util,
            e.wave_eff, e.achieved_tflops, e.bound, e.efficiency)


def _proposal(p):
    return (dataclasses.asdict(p.config), p.change, p.predicted_speedup, p.param_delta,
            p.tflops)


def test_registries_agree():
    from repro_torch.configs.registry import list_archs as port_list_archs
    assert port_list_archs() == ARCHS and len(ARCHS) == 11
    for arch in ARCHS:
        for smoke in (False, True):
            jcfg, cfg = _cfgs(arch, smoke)
            assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_and_layer_gemms_match_jax(arch, smoke):
    """Every GEMM's fields (name, m, k, n, batch, dtype bytes, weight flag,
    count), for the whole model and each layer, train and decode, tp 1 / 8."""
    jcfg, cfg = _cfgs(arch, smoke)
    b, s = (2, 64) if smoke else (1, 4096)
    for mode in ("train", "decode"):
        for tp in (1, 8):
            want = jax_tg.model_gemms(jcfg, b, s, t=tp, mode=mode)
            got = transformer_gemms.model_gemms(cfg, b, s, t=tp, mode=mode)
            assert _rows(got) == _rows(want), (mode, tp)
            for layer in range(min(cfg.num_layers, 8)):
                assert _rows(transformer_gemms.layer_gemms(cfg, b, s, tp, mode, layer)) == \
                    _rows(jax_tg.layer_gemms(jcfg, b, s, tp, mode, layer)), (mode, tp, layer)
    assert transformer_gemms.training_flops(cfg, b, s) == jax_tg.training_flops(jcfg, b, s)
    assert transformer_gemms.vanilla_forward_flops(cfg.d_model, b, s) == \
        jax_tg.vanilla_forward_flops(jcfg.d_model, b, s)


@pytest.mark.parametrize("hw_name", HWS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_and_advisor_match_jax(arch, hw_name):
    """estimate / total_time / throughput, check_alignment, score,
    step_time, precision_plan, advise and best_combined: equal to JAX's."""
    jcfg, cfg = _cfgs(arch, False)
    jhw, hw = jax_get_hardware(hw_name), get_hardware(hw_name)
    assert dataclasses.asdict(jhw) == dataclasses.asdict(hw)
    for mode, b, s in (("train", 1, 4096), ("decode", 8, 4096)):
        jg = jax_tg.model_gemms(jcfg, b, s, mode=mode)
        g = transformer_gemms.model_gemms(cfg, b, s, mode=mode)
        assert [_est(e) for e in gemm_model.estimate_many(g, hw)] == \
            [_est(e) for e in jax_gm.estimate_many(jg, jhw)]
        assert gemm_model.total_time(g, hw) == jax_gm.total_time(jg, jhw)
        assert gemm_model.throughput_tflops(g, hw) == jax_gm.throughput_tflops(jg, jhw)
    for tp in (1, 8):
        assert [dataclasses.astuple(f) for f in advisor.check_alignment(cfg, hw, tp=tp)] == \
            [dataclasses.astuple(f) for f in jax_advisor.check_alignment(jcfg, jhw, tp=tp)]
    for shape, jshape in ((base.TRAIN_4K, jax_base.TRAIN_4K),
                          (base.DECODE_32K, jax_base.DECODE_32K)):
        assert advisor.score(cfg, shape, hw) == jax_advisor.score(jcfg, jshape, jhw)
        assert advisor.step_time(cfg, shape, hw, microbatch=2) == \
            jax_advisor.step_time(jcfg, jshape, jhw, microbatch=2)
        assert advisor.precision_plan(cfg, shape, hw) == jax_advisor.precision_plan(
            jcfg, jshape, jhw)
    assert [_proposal(p) for p in advisor.advise(cfg, hw=hw)] == \
        [_proposal(p) for p in jax_advisor.advise(jcfg, hw=jhw)]
    assert _proposal(advisor.best_combined(cfg, hw=hw)) == \
        _proposal(jax_advisor.best_combined(jcfg, hw=jhw))


def test_gpt3_advisor_ranks_the_head_splits_on_the_h100():
    """The paper's Fig. 1 case study at the H100 (the JAX model's numbers,
    a formula, no card): a 32 -> 10 heads (head dim 256) first, 32 -> 20
    (128) second, the vocab pad third."""
    props = advisor.advise(get_config("gpt3-2.7b-c0"), hw=get_hardware("h100"))
    assert [p.change for p in props[:3]] == [
        "heads 32 -> 10 (head_dim 80 -> 256)", "heads 32 -> 20 (head_dim 80 -> 128)",
        "pad vocab 50257 -> 50304"]
    assert props[0].predicted_speedup > props[1].predicted_speedup > 1.1


@pytest.mark.parametrize("hw_name", [None, *HWS])
@pytest.mark.parametrize("m,k,n", [(64, 2048, 2048), (4096, 2560, 7680), (1, 80, 2048),
                                   (300, 1000, 50257), (8192, 2560, 10240)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_alignment_report_matches_jax(m, k, n, dtype, hw_name):
    want = jax_alignment_report(m, k, n, jnp.dtype(dtype), hw_name=hw_name or "h100")
    got = alignment_report(m, k, n, getattr(torch, dtype), hw_name=hw_name)
    assert got == want


HLO = """
HloModule step, entry_computation_layout={(bf16[8,1024]{1,0})->bf16[8,1024]{1,0}}

ENTRY %main (p0: bf16[8,1024]) -> bf16[8,1024] {
  %p0 = bf16[8,1024]{1,0} parameter(0)
  %ag = bf16[64,1024]{1,0} all-gather(bf16[8,1024]{1,0} %p0), dimensions={0}
  %ags = (bf16[8,1024]{1,0}, bf16[64,1024]{1,0}) all-gather-start(bf16[8,1024]{1,0} %p0), dimensions={0}
  %agd = bf16[64,1024]{1,0} all-gather-done((bf16[8,1024]{1,0}, bf16[64,1024]{1,0}) %ags)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), to_apply=%add
  %rs = f32[128]{0} reduce-scatter(f32[1024]{0} %x), dimensions={0}, to_apply=%add
  %a2a = (s8[4,256]{1,0}, s8[4,256]{1,0}) all-to-all(s8[4,256]{1,0} %a, s8[4,256]{1,0} %b)
  %cp = bf16[8,1024]{1,0} collective-permute(bf16[8,1024]{1,0} %p0), source_target_pairs={{0,1}}
  %cps = (bf16[8,1024]{1,0}, bf16[8,1024]{1,0}, u32[], u32[]) collective-permute-start(%p0)
  ROOT %out = bf16[8,1024]{1,0} add(%p0, %p0)
}
"""


def test_collective_bytes_and_report_match_jax():
    got = roofline.collective_bytes(HLO)
    assert got == jax_roofline.collective_bytes(HLO)
    assert got["all-gather"] > 0 and got["collective-permute"] > 0 and got["all-to-all"] == 2048
    for hw_name in HWS:
        kw = dict(arch="gpt3-2.7b-c0", shape="train_4k", mesh="1x8", num_chips=8, flops=3.1e15,
                  nbytes=2.2e12, coll=got, model_flops_total=2.0e16, bytes_per_device=4e10)
        r = roofline.build_report(**kw, hw=get_hardware(hw_name))
        jr = jax_roofline.build_report(**kw, hw=jax_get_hardware(hw_name))
        assert dataclasses.asdict(r) == dataclasses.asdict(jr)
        assert (r.dominant, r.step_time_lower_bound, r.useful_ratio, r.roofline_fraction) == \
            (jr.dominant, jr.step_time_lower_bound, jr.useful_ratio, jr.roofline_fraction)
        assert roofline.to_row(r) == jax_roofline.to_row(jr)


def _write_cache(path):
    """A hand-written cache file: H100 matmul entries (two of them gpt3's
    layer GEMMs at b 1, s 4096), one A100 entry and a non-matmul entry."""
    entries = {}
    for (m, k, n), dt, hw, us in [((4096, 2560, 7680), "bfloat16", "h100", 231.5),
                                  ((4096, 2560, 2560), "bfloat16", "h100", 80.25),
                                  ((4096, 2560, 10240), "bfloat16", "h100", 301.0),
                                  ((64, 2048, 2048), "float32", "h100", 40.0),
                                  ((4096, 2560, 7680), "bfloat16", "a100", 700.0)]:
        key = f"matmul/{m}x{k}x{n}/{dt}/{hw}"
        entries[key] = {"op": "matmul", "shape": [m, k, n], "dtype": dt, "hw_name": hw,
                        "blocks": {"block_m": 128, "block_n": 128, "split_k": 1},
                        "time_us": us, "baseline_us": us * 1.25, "candidates_tried": 8,
                        "time_us_std": 1.5}
    entries["int8_matmul/64x2048x2048/bfloat16xint8/h100"] = {
        "op": "int8_matmul", "shape": [64, 2048, 2048], "dtype": "bfloat16xint8",
        "hw_name": "h100", "blocks": {"block_m": 64, "block_n": 128, "split_k": 4},
        "time_us": 9.5, "baseline_us": 11.0, "candidates_tried": 8, "time_us_std": 0.1}
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    return str(path)


def test_measured_profile_and_propose_match_jax(tmp_path):
    path = _write_cache(tmp_path / "cache.json")
    cache, jcache = TuningCache.load(path), JaxTuningCache.load(path)
    prof = gemm_model.MeasuredProfile.from_cache(cache, "h100")
    jprof = jax_gm.MeasuredProfile.from_cache(jcache, "h100")
    assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
    assert len(prof.points) == 4 and prof.calibration != 1.0
    # the port's default chip is the H100 (JAX's the TPU v5e)
    assert gemm_model.MeasuredProfile.from_cache(cache) == prof
    assert gemm_model.MeasuredProfile.from_cache(cache, "tpu_v5e") is None
    jhw, hw = jax_get_hardware("h100"), get_hardware("h100")
    for arch in ("gpt3-2.7b-c0", "internlm2-1.8b", "mamba2-780m"):
        jcfg, cfg = _cfgs(arch, False)
        g, jg = (transformer_gemms.model_gemms(cfg, 1, 4096),
                 jax_tg.model_gemms(jcfg, 1, 4096))
        assert [_est(e) for e in gemm_model.estimate_many(g, hw, prof)] == \
            [_est(e) for e in jax_gm.estimate_many(jg, jhw, jprof)]
        assert [_proposal(p) for p in advisor.propose(cfg, hw=hw, cache=cache)] == \
            [_proposal(p) for p in jax_advisor.propose(jcfg, hw=jhw, cache=jcache)]
        assert advisor.score(cfg, hw=hw, profile=prof) == \
            jax_advisor.score(jcfg, hw=jhw, profile=jprof)
    assert any(e.bound == "measured" for e in gemm_model.estimate_many(
        transformer_gemms.model_gemms(get_config("gpt3-2.7b-c0"), 1, 4096), hw, prof))


def test_precision_recommendation_matches_jax():
    jhw, hw = jax_get_hardware("h100"), get_hardware("h100")
    for m, k, n in ((1, 2048, 2048), (64, 2048, 92544), (4096, 4096, 4096)):
        g, jg = gemm_model.GEMM("x", m, k, n), jax_gm.GEMM("x", m, k, n)
        assert gemm_model.recommend_precision(g, hw) == jax_gm.recommend_precision(jg, jhw)
        assert {d: _est(e) for d, e in gemm_model.precision_candidates(g, hw).items()} == \
            {d: _est(e) for d, e in jax_gm.precision_candidates(jg, jhw).items()}
