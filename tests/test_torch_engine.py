"""The port's serving slice as a whole, against the JAX package.

The port's Engine (fused linear layers, paged decode kernel, CPU tensors so
every kernel wrapper runs its plain version) must generate greedy tokens
identical to the JAX Engine's on the same requests, policy and weights.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.hardware import H100_SXM as JAX_H100
from repro.models import init_lm as jax_init_lm
from repro.serving.engine import BucketPolicy as JaxBucketPolicy
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import make_policy as jax_make_policy
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.hardware import H100_SXM, get_hardware
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import (BucketPolicy, Engine, FaultEvent, FaultPlan, Request,
                                        RequestQueue, SamplingParams, make_policy,
                                        synthetic_requests)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
POLICY = dict(num_slots=4, prompt_buckets=(16, 32), seq_max=64)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _port_engine(cfg, params, **kw):
    return Engine(params, dataclasses.replace(cfg, linear_impl="fused"),
                  policy=BucketPolicy(**POLICY), use_paged_kernel=True, device="cpu", **kw)


@pytest.mark.parametrize("pattern,seed", [("burst", 3), ("longtail", 5)])
def test_greedy_tokens_identical_to_jax_engine(smoke, pattern, seed):
    """10 requests through a 4-slot pool: queueing and slot reuse."""
    jcfg, jparams, cfg, params = smoke
    reqs = synthetic_requests(10, pattern=pattern, min_prompt=4, max_prompt=30, min_new=3,
                              max_new=12, vocab=cfg.vocab_size, seed=seed)
    jdone, jstats = JaxEngine(jparams, jcfg, policy=JaxBucketPolicy(**POLICY),
                              hw=JAX_H100).run(reqs)
    eng = _port_engine(cfg, params)
    assert eng.cfg.attn_impl == "paged"
    done, stats = eng.run(reqs)
    assert stats.prefills == jstats.prefills == 10
    assert stats.total_generated == sum(r.max_new_tokens for r in reqs)
    for r, c, jc in zip(reqs, done, jdone):
        assert c.rid == jc.rid == r.rid and c.finish_reason == jc.finish_reason == "length"
        assert c.tokens == jc.tokens, f"rid {r.rid}"


def test_static_policy_same_tokens(smoke):
    _, _, cfg, params = smoke
    reqs = synthetic_requests(6, pattern="burst", min_prompt=4, max_prompt=20, min_new=2,
                              max_new=6, vocab=cfg.vocab_size, seed=1)
    eng = _port_engine(cfg, params)
    cont, _ = eng.run(reqs)
    static, st = eng.run(reqs, policy="static")
    assert [c.tokens for c in cont] == [c.tokens for c in static]
    assert st.prefills == 6


def test_temperature_sampling_reproducible(smoke):
    """Sampled tokens depend on (seed, step) only: the same across runs and
    scheduling policies (the port's own streams, not JAX's)."""
    _, _, cfg, params = smoke
    reqs = synthetic_requests(5, pattern="burst", min_prompt=4, max_prompt=20, min_new=4,
                              max_new=8, vocab=cfg.vocab_size, temperature=1.0, seed=2)
    eng = _port_engine(cfg, params)
    a, _ = eng.run(reqs)
    b, _ = eng.run(reqs, policy="static")
    assert [c.tokens for c in a] == [c.tokens for c in b]
    greedy = [dataclasses.replace(r, sampling=SamplingParams()) for r in reqs]
    g, _ = eng.run(greedy)
    assert [c.tokens for c in a] != [c.tokens for c in g]


def test_bad_requests_are_rejected_not_raised(smoke):
    _, _, cfg, params = smoke
    eng = _port_engine(cfg, params)
    reqs = [Request(rid=0, tokens=np.arange(5, dtype=np.int32), max_new_tokens=3),
            Request(rid=1, tokens=np.arange(40, dtype=np.int32), max_new_tokens=3),
            Request(rid=2, tokens=np.asarray([cfg.padded_vocab_size], np.int32),
                    max_new_tokens=3),
            Request(rid=3, tokens=np.arange(4, dtype=np.int32), max_new_tokens=0)]
    done, stats = eng.run(reqs)
    assert [c.finish_reason for c in done] == ["length", "rejected", "rejected", "rejected"]
    assert len(done[0].tokens) == 3 and stats.num_rejected == 3


@pytest.mark.parametrize("max_batch,max_prompt,max_seq,dtype", [
    (8, 64, 96, "bfloat16"), (3, 48, 96, "float32"), (70, 200, 0, "bfloat16"), (1, 16, 17, "float32")])
def test_make_policy_matches_jax(max_batch, max_prompt, max_seq, dtype):
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    for grow in (False, True):      # the advisor's bucket growth, and without it
        want = jax_make_policy(jcfg, JAX_H100, max_batch=max_batch, max_prompt=max_prompt,
                               max_seq=max_seq, grow_batch=grow)
        got = make_policy(cfg, H100_SXM, max_batch=max_batch, max_prompt=max_prompt,
                          max_seq=max_seq, grow_batch=grow)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert make_policy(cfg, max_batch=max_batch, max_prompt=max_prompt, max_seq=max_seq,
                           grow_batch=grow) == got   # the port's default chip is the H100
    assert get_hardware().name == "h100"


def test_engine_refuses_to_run_without_a_card(smoke, monkeypatch):
    _, _, cfg, params = smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_engine_unported_switches_raise(smoke):
    """No engine switch is left unported: fault injection runs (a seeded
    plan over an int8 block pool; tests/test_torch_faults.py holds it to
    JAX), grow_batch (the advisor's bucket growth) picks JAX's policy at the
    H100, int8 weights (linear_impl="quantized") serve; bad arguments
    still raise."""
    jcfg, jparams, cfg, params = smoke
    eng = Engine(params, cfg, prefix_cache=True, kv_dtype="int8", device="cpu")
    reqs = [Request(rid=i, tokens=np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
            for i in range(3)]
    plan = FaultPlan(request_faults={2: "garbage_prompt"},
                     events=[FaultEvent(step=1, kind="cow_storm")], hold_steps=2)
    done, _ = eng.run(plan.apply_to_requests(reqs, eng.policy.seq_max), faults=plan,
                      check_invariants=True)
    assert [c.finish_reason for c in done] == ["length", "length", "rejected"]
    want = JaxEngine(jparams, jcfg, grow_batch=True, hw=JAX_H100).policy
    got = Engine(params, cfg, grow_batch=True, device="cpu").policy
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    quantized = Engine(params, dataclasses.replace(cfg, linear_impl="quantized"), device="cpu")
    done, _ = quantized.run([Request(rid=0, tokens=np.arange(4, dtype=np.int32),
                                     max_new_tokens=1)])
    assert done[0].finish_reason == "length" and len(done[0].tokens) == 1
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        Engine(params, cfg, kv_dtype="fp4", device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        Engine(params, cfg, device="meta")


def test_request_queue_is_the_jax_one():
    reqs = [Request(rid=i, tokens=np.ones(4, np.int32), max_new_tokens=1, arrival_s=t)
            for i, t in enumerate([0.3, 0.0, 0.1])]
    q = RequestQueue(reqs)
    assert q.pop_ready(0.0).rid == 1
    assert q.pop_ready(0.05) is None
    assert q.pop_ready(0.2).rid == 2 and q.next_arrival_s() == 0.3


@pytest.mark.parametrize("argv", [
    ["--engine", "--paged", "--requests", "4", "--gen", "6"],
    ["--engine", "--paged", "--prefix-cache", "--kv-dtype", "int8", "--requests", "6",
     "--gen", "6"],
    ["--batch", "2", "--prompt-len", "8", "--gen", "4"]])
def test_launcher_runs_on_cpu_when_asked(argv, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "sample:" in out


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and chip_smoke.py import without pulling in
    jax or the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert len(names) >= 30, names
assert {"repro_torch.models.ssm", "repro_torch.kernels.ssd.ops",
        "repro_torch.kernels.ssd.ref", "repro_torch.obs", "repro_torch.obs.trace",
        "repro_torch.obs.metrics", "repro_torch.obs.drift", "repro_torch.obs.compile_watch",
        "repro_torch.obs.view", "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
        "repro_torch.serving.engine.faults", "repro_torch.parallel.sharding",
        "repro_torch.parallel.comm", "repro_torch.parallel.pipeline", "repro_torch.launch.mesh",
        "repro_torch.models.moe_shardmap", "repro_torch.analysis",
        "repro_torch.analysis.__main__"} <= set(names), names
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No card: non-zero exit and no result line.  A directory holding only
    chip_smoke.py: the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size) == (24, 2048, 16, 8, 128, 8192, 92544)
