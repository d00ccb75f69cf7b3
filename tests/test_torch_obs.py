"""The port's observability layer (`repro_torch.obs`) against the JAX
package's `repro.obs`: the tracer / metrics / drift units (the JAX suite's
`tests/test_obs.py` cases), the build watchdog over a planted build, the
deduplicated dispatch records, and the engine's counters, which must equal
the JAX engine's on the same burst (slot and prefix engines, internlm2-smoke
f32 with the JAX params converted by `params_from_jax`).
"""
import dataclasses
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.hardware import H100_SXM as JAX_H100
from repro.models import init_lm as jax_init_lm
from repro.serving.engine import Engine as JaxEngine
from repro_torch import obs
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ops import matmul
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import view
from repro_torch.obs.trace import NULL_SPAN, Tracer
from repro_torch.serving.engine import Engine, synthetic_requests

ARCH = "internlm2-1.8b"
ENGINE = dict(max_batch=4, max_prompt=32, max_new=8)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with both packages' obs disabled and
    empty: the rest of the suite must never see leaked spans or metrics."""
    for o in (obs, jax_obs):
        o.disable()
        o.reset()
    yield
    for o in (obs, jax_obs):
        o.disable()
        o.reset()


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _burst(cfg, n=10, seed=3):
    return synthetic_requests(n, pattern="burst", min_prompt=4, max_prompt=28, min_new=2,
                              max_new=8, vocab=cfg.vocab_size, prefix_share=0.5,
                              shared_prefix_len=16, seed=seed)


# --- the units (the JAX suite's cases) ---------------------------------------------------

class TestTracer:
    def test_disabled_is_shared_noop(self):
        s = obs.span("anything", rid=1)
        assert s is NULL_SPAN and s.dur_s == 0.0
        with s:
            pass
        obs.instant("nothing")
        obs.record_dispatch("matmul", impl="plain", shape=(1, 2, 3))
        assert obs.get_tracer().events() == []
        assert obs.get_metrics().snapshot()["counters"] == {}

    def test_span_nesting_and_chrome_validity(self):
        obs.enable(annotate_device=False)
        with obs.span("outer", cat="engine", rid=7):
            with obs.span("inner", cat="sample"):
                pass
        by_name = {e["name"]: e for e in obs.get_tracer().events()}
        inner, outer = by_name["inner"], by_name["outer"]
        assert outer["args"]["depth"] == 0 and inner["args"]["depth"] == 1
        assert inner["ts"] >= outer["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert outer["args"]["rid"] == 7
        chrome = obs.get_tracer().to_chrome()
        assert chrome["displayTimeUnit"] == "ms"
        assert chrome["traceEvents"][0]["ph"] == "M"
        for e in chrome["traceEvents"][1:]:
            assert e["ph"] in ("X", "i")
            assert e["ts"] >= 0 and "pid" in e and "tid" in e
            if e["ph"] == "X":
                assert e["dur"] >= 0
        assert json.loads(json.dumps(chrome)) == chrome

    def test_instant_and_bounded_buffer(self):
        tr = Tracer(capacity=4, annotate_device=False)
        for i in range(6):
            tr.instant("tick", i=i)
        evs = tr.events()
        assert len(evs) == 4 and tr.dropped == 2
        assert all(e["ph"] == "i" and e["s"] == "t" for e in evs)
        assert evs[0]["args"]["i"] == 2

    def test_save_is_loadable(self, tmp_path):
        obs.enable(annotate_device=False)
        with obs.span("step"):
            pass
        path = tmp_path / "trace.json"
        obs.get_tracer().save(str(path))
        trace = json.loads(path.read_text())
        assert any(e["ph"] == "X" and e["name"] == "step" for e in trace["traceEvents"])

    def test_annotate_device_opens_a_profiler_range(self):
        """With annotate_device a span is a `record_function` range, which a
        torch.profiler capture shows under the span's name."""
        obs.enable(annotate_device=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("decode_step"):
                matmul(torch.ones(4, 8), torch.ones(8, 3))
        names = {e.name for e in prof.events()}
        assert "decode_step" in names


class TestMetrics:
    def test_instruments_and_prometheus_equal_jax(self):
        """The same operations give the same snapshot and exposition text
        in both packages (the registry is a copy)."""
        for o in (obs, jax_obs):
            o.counter("t.count").inc()
            o.counter("t.count").inc(2)
            o.gauge("t.depth").set(5)
            o.histogram("t.lat").observe_many([1.0, 2.0, 3.0, 4.0])
            o.counter("engine.tokens_generated").inc(42)
            o.histogram("engine.decode_step_s").observe(0.25)
        snap = obs.get_metrics().snapshot()
        assert snap == jax_obs.get_metrics().snapshot()
        assert snap["counters"]["t.count"] == 3 and snap["gauges"]["t.depth"] == 5.0
        s = snap["histograms"]["t.lat"]
        assert s["count"] == 4 and s["sum"] == 10.0 and s["p50"] == pytest.approx(2.5)
        text = obs.get_metrics().to_prometheus()
        assert text == jax_obs.get_metrics().to_prometheus()
        assert "engine_tokens_generated 42" in text
        assert 'engine_decode_step_s{quantile="0.5"} 0.25' in text


class TestDrift:
    def test_report_equals_jax(self, tmp_path):
        mons = [obs.DriftMonitor(hw_name="test_hw"), jax_obs.DriftMonitor(hw_name="test_hw")]
        for mon in mons:
            mon.add_site("a", 0.001)
            mon.add_site("b", 0.001)
            mon.add_site("never_observed", 0.5)
            for dur in (0.002, 0.0021, 0.0019):
                mon.observe("a", dur)
            mon.observe("b", 0.001)
            mon.observe("surprise", 0.1)      # auto-created, predicted 0
        got, want = mons[0].report(), mons[1].report()
        assert got == want
        rows = {r["site"]: r for r in got}
        assert rows["a"]["ratio"] == pytest.approx(2.0)
        assert rows["a"]["rel_drift"] == pytest.approx(2.0 / 1.5)
        assert rows["surprise"]["ratio"] is None and "never_observed" not in rows
        mons[0].save(str(tmp_path / "drift.json"))
        assert json.loads((tmp_path / "drift.json").read_text())["hw_name"] == "test_hw"

    def test_for_engine_predicts_as_jax_at_the_h100(self, smoke):
        jcfg, jparams, cfg, params = smoke
        jeng = JaxEngine(jparams, jcfg, hw=JAX_H100, **ENGINE)
        eng = Engine(params, cfg, device="cpu", **ENGINE)
        assert eng.hw.name == "h100"
        got = obs.DriftMonitor.for_engine(cfg, eng.policy, H100_SXM)
        want = jax_obs.DriftMonitor.for_engine(jcfg, jeng.policy, JAX_H100)
        for mon in (got, want):
            for site in list(mon._sites):
                mon.observe(site, 1e-3)
        assert got.report() == want.report()
        assert got.hw_name == want.hw_name == "h100"


class TestDispatch:
    def test_record_dispatch_dedupes(self):
        obs.enable(annotate_device=False)
        for _ in range(5):
            matmul(torch.ones(4, 8), torch.ones(8, 3))
        matmul(torch.ones(6, 8), torch.ones(8, 3))
        for _ in range(3):
            obs.record_dispatch("paged_decode", impl="cuda", shape=(4, 2, 16),
                                blocks={"tile": 64, "splits": 1}, tuned_hit=False)
        counters = obs.get_metrics().snapshot()["counters"]
        assert counters["dispatch.matmul.plain"] == 2       # two distinct shapes
        assert counters["dispatch.paged_decode.cuda"] == 1
        assert counters["dispatch.paged_decode.cache_miss"] == 1
        rows = [e for e in obs.get_tracer().events() if e.get("cat") == "dispatch"]
        assert [tuple(e["args"]["shape"]) for e in rows] == [(4, 8, 3), (6, 8, 3), (4, 2, 16)]
        obs.enable(annotate_device=False)     # a new enable() records each shape again
        matmul(torch.ones(4, 8), torch.ones(8, 3))
        assert obs.get_metrics().snapshot()["counters"]["dispatch.matmul.plain"] == 3

    def test_backward_kernels_record_dispatch_rows(self):
        """One backward pass through the fused MLP, flash attention, the SSD
        chunk and the MoE layer's expert Functions records a dispatch row
        for each backward kernel (plain on the CPU), beside the forwards'."""
        from repro_torch.kernels.flash_attention.ops import flash_attention
        from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
        from repro_torch.kernels.ssd.ops import ssd_chunk
        from repro_torch.models.linear import expert_fused_hidden, expert_linear
        obs.enable(annotate_device=False)
        gen = torch.Generator().manual_seed(0)

        def leaf(*shape):
            return (torch.randn(shape, generator=gen) * 0.3).requires_grad_()
        x, wg, wu = leaf(6, 16), leaf(16, 24), leaf(16, 24)
        q, k, v = leaf(1, 8, 4, 16), leaf(1, 8, 2, 16), leaf(1, 8, 2, 16)
        xd, B, C = leaf(1, 2, 2, 4, 8), leaf(1, 2, 2, 4, 8), leaf(1, 2, 2, 4, 8)
        seg = torch.cumsum(-torch.rand((1, 2, 2, 4), generator=gen), -1).requires_grad_()
        xe, we, wge, wue = leaf(2, 8, 16), leaf(2, 16, 24), leaf(2, 16, 24), leaf(2, 16, 24)
        y, s = ssd_chunk(xd, B, C, seg)
        loss = (fused_mlp_hidden(x, wg, wu, mlp_type="swiglu").sum()
                + flash_attention(q, k, v).sum() + y.sum() + s.sum()
                + expert_linear(xe, we, impl="fused").sum()
                + expert_fused_hidden(xe, wge, wue, mlp_type="gelu").sum())
        loss.backward()
        rows = {(e["name"], e["args"]["site"], tuple(e["args"]["shape"]))
                for e in obs.get_tracer().events()
                if e.get("cat") == "dispatch" and e["args"]["impl"] == "plain"}
        for row in [("fused_mlp_bwd", "swiglu", (6, 16, 24)),
                    ("flash_attention_bwd", "causal", (1, 8, 4, 16)),
                    ("ssd_chunk_bwd", "", (1, 2, 2, 4, 8, 8)),
                    ("fused_mlp_bwd_expert", "gelu", (2, 8, 16, 24)),
                    ("matmul_expert", "", (2, 8, 24, 16)),       # expert_linear's dgrad
                    ("matmul_expert", "", (2, 16, 8, 24))]:      # ... and its wgrad
            assert row in rows, row
        counters = obs.get_metrics().snapshot()["counters"]
        for op in ("fused_mlp_bwd", "flash_attention_bwd", "ssd_chunk_bwd",
                   "fused_mlp_bwd_expert"):
            assert counters[f"dispatch.{op}.plain"] == 1, op

    def test_tuning_samples_feed_a_histogram(self, monkeypatch):
        from repro_torch.tuning import search

        def fake_wall_us(fn, *args, iters, warmup, return_samples=False):
            samples = [10.0, 12.0, 14.0][:iters]
            return (sum(samples) / len(samples), samples) if return_samples else 12.0
        monkeypatch.setattr(search, "wall_us", fake_wall_us)
        # the search times on the card only; an operand that says it is there
        monkeypatch.setattr(search, "torch", types.SimpleNamespace(is_tensor=lambda a: True))
        card = types.SimpleNamespace(is_cuda=True)
        search._measure("matmul", None, card, iters=3, warmup=1)
        assert "tuning.matmul.us" not in obs.get_metrics().snapshot()["histograms"]
        obs.enable(annotate_device=False)
        mean, std = search._measure("matmul", None, card, iters=3, warmup=1)
        h = obs.get_metrics().snapshot()["histograms"]["tuning.matmul.us"]
        assert h["count"] == 3 and h["sum"] == 36.0 and mean == 12.0 and std > 0


class TestCompileWatch:
    def test_records_arming_and_mirror(self, monkeypatch):
        """A planted build (the library's loader replaced): the watch records
        it, and once armed raises from inside `build()`."""
        built = []

        def fake_load():
            built.append(1)
            return _build.Library(lib=None, path=Path(f"libreprokernels-{len(built)}.so"),
                                  build_s=1.5 if len(built) == 1 else 0.0, log="")
        monkeypatch.setattr(_build, "_load", fake_load)
        monkeypatch.setattr(_build, "_LIBRARY", None)
        obs.enable(annotate_device=False)
        with obs.CompileWatch() as watch:
            lib = _build.build()
            assert _build.build() is lib and len(built) == 1     # cached: no second build
            assert [(r.key, r.wall_s, r.armed) for r in watch.records] == \
                [("libreprokernels-1.so nvcc build", 1.5, False)]
            watch.check()
            monkeypatch.setattr(_build, "_LIBRARY", None)
            watch.arm()
            with pytest.raises(obs.UnexpectedCompile, match="libreprokernels-2.so loaded"):
                _build.build()
            assert _build._LIBRARY is None and watch.violations[-1].armed
            with pytest.raises(obs.UnexpectedCompile):
                watch.check()
            watch.disarm()
            d = watch.to_json()
            assert len(d["records"]) == 2 and len(d["violations"]) == 1
            assert d["backend_compiles"] == 2
        assert watch._on_build not in _build.BUILD_HOOKS
        counters = obs.get_metrics().snapshot()["counters"]
        assert counters["compile.count"] == 2 and counters["compile.violations"] == 1


# --- the engine ------------------------------------------------------------------------------

def _engine_counters(o):
    snap = o.get_metrics().snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith(("engine.", "kv."))}


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_counters_equal_jax(smoke, prefix_cache):
    """The same burst through both packages' engines with obs on: every
    engine.* and kv.* counter equal, and the spans line up with the
    engine's own stats."""
    jcfg, jparams, cfg, params = smoke
    kw = dict(ENGINE, prefix_cache=prefix_cache)
    if prefix_cache:
        kw.update(block_size=8, num_blocks=24)
    reqs = _burst(cfg)
    jeng = JaxEngine(jparams, jcfg, hw=JAX_H100, **kw)
    eng = Engine(params, cfg, device="cpu", **kw)
    for e in (jeng, eng):       # compile outside the counted run; it warms both prefix caches
        e.run(reqs[:2])
    jax_obs.enable(annotate_device=False)
    jdone, jstats = jeng.run(reqs)
    obs.enable(annotate_device=False)
    done, stats = eng.run(reqs)
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    got, want = _engine_counters(obs), _engine_counters(jax_obs)
    assert got == want
    assert got["engine.tokens_generated"] == stats.total_generated
    assert got["engine.decode_steps"] == stats.decode_steps > 0
    assert got["engine.prefills"] == stats.prefills
    if prefix_cache:
        assert got["kv.prefix_hit_blocks"] > 0 and got["kv.blocks_allocated"] > 0
        assert stats.preemptions == jstats.preemptions
    spans = [e for e in obs.get_tracer().events() if e["ph"] == "X"]
    assert sum(e["name"] == "decode_step" for e in spans) == stats.decode_steps
    assert sum(e["name"] == "prefill" for e in spans) == stats.prefills
    assert sum(e["name"] == "admit" for e in spans) == stats.prefills
    rows = {r["site"]: r for r in eng.drift.report()}
    assert rows["decode_step"]["count"] == stats.decode_steps
    assert any(s.startswith("prefill_") for s in rows)


def test_engine_dump_renders(smoke, tmp_path, capsys):
    _, _, cfg, params = smoke
    eng = Engine(params, dataclasses.replace(cfg, linear_impl="fused"), use_paged_kernel=True,
                 device="cpu", **ENGINE)
    obs.enable(annotate_device=False)
    with obs.CompileWatch() as watch:
        eng.run(_burst(cfg, 4))
    dump = str(tmp_path / "dump")
    paths = obs.export_all(dump, drift=eng.drift, watch=watch)
    assert sorted(paths) == ["compiles", "drift", "metrics", "prometheus", "trace"]
    text = "\n".join(view.render_summary(dump))
    assert "decode_step" in text and "## Kernel dispatch" in text
    for op in ("matmul", "fused_mlp_swiglu", "paged_decode"):
        assert f"| {op} | plain |" in text, op
    assert view.main([dump]) == 0
    assert "# obs summary" in capsys.readouterr().out


def test_disabled_call_sites_do_nothing_but_check(smoke, monkeypatch, tmp_path):
    """With obs off, a serve run (prefix engine, a preempting pool) and a
    train step reach no obs helper: the call sites stop at their one
    `obs.enabled()` check."""
    _, _, cfg, params = smoke

    def refuse(*a, **k):
        raise AssertionError("obs helper reached while disabled")
    for name in ("span", "instant", "counter", "gauge", "histogram", "record_dispatch"):
        monkeypatch.setattr(obs, name, refuse)
    fused = dataclasses.replace(cfg, linear_impl="fused", attn_impl="flash")
    eng = Engine(params, fused, max_batch=4, max_prompt=32, max_new=8, prefix_cache=True,
                 block_size=8, num_blocks=12, use_paged_kernel=True, device="cpu")
    done, stats = eng.run(_burst(cfg, 8), check_invariants=True)
    assert stats.preemptions > 0 and eng.drift is None
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                "--global-batch", "2", "--seq-len", "16", "--linear-impl", "fused",
                "--attn-impl", "flash", "--checkpoint-dir", str(tmp_path)])


def test_train_loop_spans_and_counters(tmp_path, capsys):
    from repro_torch.launch import train
    obs.enable(annotate_device=False)
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                "--global-batch", "2", "--seq-len", "16", "--checkpoint-dir", str(tmp_path)])
    counters = obs.get_metrics().snapshot()["counters"]
    assert counters["train.steps"] == 3 and counters["train.tokens"] == 3 * 2 * 16
    steps = [e for e in obs.get_tracer().events() if e["name"] == "train_step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2]
    assert "done" in capsys.readouterr().out
