"""The port's fault injection (`serving/engine/faults.py`) and `Engine.run(
faults=)` against the JAX package's, on internlm2-smoke (f32, the JAX
params converted with `params_from_jax`).

The plan generator is pure numpy, so the same seed must give the same plan,
event for event.  The soak runs burst arrivals (every request at t = 0), so
both packages' schedulers see the same queue at every step and a faulted
run must give the same completions — rid, finish reason and greedy tokens —
in both.  The forced-steal and 64-request soak cases are the JAX suite's
(`tests/test_engine_failures.py`), run on the port alone.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.hardware import H100_SXM as JAX_H100
from repro.models import init_lm as jax_init_lm
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import FaultPlan as JaxFaultPlan
from repro.serving.engine import chaos_soak as jax_chaos_soak
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.hardware import TPU_V5E
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import (FAULT_KINDS, Engine, FaultEvent, FaultPlan, Request,
                                        chaos_soak, synthetic_requests)

ARCH = "internlm2-1.8b"
# a 4-row block-table pool of 32 blocks of 8 tokens; 24 burst requests, 40%
# opening with a 16-token shared prefix; the plan's steals (28 blocks) force
# preemptions on top of every request-level fault
POOL = dict(max_batch=4, max_prompt=32, max_new=8, prefix_cache=True, block_size=8,
            num_blocks=32)
PLAN = dict(num_steps=24, oversized=1, garbage=1, deadline=1, steals=2, storms=2,
            steal_blocks=28, hold_steps=6)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _burst(cfg, n=24):
    return synthetic_requests(n, pattern="burst", min_prompt=4, max_prompt=28, min_new=3,
                              max_new=7, vocab=cfg.vocab_size, prefix_share=0.4,
                              shared_prefix_len=16, seed=11)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (7, dict(num_steps=16)), (23, PLAN),
    (101, dict(num_steps=5, oversized=3, garbage=0, deadline=4, steals=1, storms=6))])
def test_fault_plan_generate_matches_jax(seed, kw):
    rids = list(range(3, 43))
    got = FaultPlan.generate(seed, rids, **kw)
    want = JaxFaultPlan.generate(seed, rids, **kw)
    assert got.request_faults == want.request_faults
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert got.hold_steps == want.hold_steps and got.kinds_used == want.kinds_used
    assert got.affected_rids == want.affected_rids
    reqs = [Request(rid=r, tokens=np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
            for r in rids]
    for a, b in zip(got.apply_to_requests(reqs, 64), want.apply_to_requests(reqs, 64)):
        assert a.rid == b.rid and a.deadline_s == b.deadline_s
        np.testing.assert_array_equal(np.asarray(a.tokens), np.asarray(b.tokens))


def test_chaos_soak_matches_jax(smoke):
    """Every fault kind over a burst: both soaks pass, and the faulted runs'
    completions are identical across the packages (preemptions included)."""
    jcfg, jparams, cfg, params = smoke
    reqs = _burst(cfg)
    rids = [r.rid for r in reqs]
    jplan = JaxFaultPlan.generate(23, rids, **PLAN)
    plan = FaultPlan.generate(23, rids, **PLAN)
    assert plan.kinds_used == set(FAULT_KINDS)
    want = jax_chaos_soak(JaxEngine(jparams, jcfg, hw=JAX_H100, **POOL), reqs, jplan)
    got = chaos_soak(Engine(params, cfg, device="cpu", **POOL), reqs, plan)
    assert want.ok, want.violations
    assert got.ok, "\n".join(got.violations)
    assert got.chaos_stats.preemptions == want.chaos_stats.preemptions > 0
    assert got.chaos_stats.finish_reasons == want.chaos_stats.finish_reasons
    assert got.affected_rids == want.affected_rids
    for c, jc in zip(got.chaos_completions, want.chaos_completions):
        assert (c.rid, c.finish_reason, c.tokens) == (jc.rid, jc.finish_reason, jc.tokens)


def test_forced_steal_preempts_token_identically(smoke):
    """A block steal on an otherwise roomy pool: preemption is purely
    fault-induced, and every request still finishes with exactly the
    fault-free tokens (exact rollback and the seeded sampler's resume)."""
    _, _, cfg, params = smoke
    eng = Engine(params, cfg, max_batch=4, max_prompt=32, max_new=16, prefix_cache=True,
                 block_size=8, num_blocks=32, device="cpu")
    reqs = synthetic_requests(8, pattern="burst", min_prompt=12, max_prompt=28, min_new=10,
                              max_new=14, vocab=cfg.vocab_size, temperature=0.7, seed=7)
    want = {c.rid: c.tokens for c in eng.run(reqs)[0]}
    plan = FaultPlan(seed=0, events=[
        FaultEvent(step=2, kind="steal_blocks", blocks=28),
        FaultEvent(step=6, kind="cow_storm")], hold_steps=4)
    done, stats = eng.run(reqs, faults=plan, check_invariants=True)
    assert stats.preemptions > 0
    for c in done:
        if c.ok:
            assert c.tokens == want[c.rid], f"rid {c.rid}"
        else:
            assert c.tokens == want[c.rid][:len(c.tokens)]
    assert any(c.preemptions > 0 and c.ok for c in done)
    # the plan replays: the same object run again gives the same outcome
    again, stats2 = eng.run(reqs, faults=plan, check_invariants=True)
    assert [(c.rid, c.finish_reason, c.tokens) for c in again] == \
        [(c.rid, c.finish_reason, c.tokens) for c in done]
    assert stats2.preemptions == stats.preemptions
    eng.pool.blocks.check()
    assert eng.pool.num_free == eng.policy.num_slots


def test_soak_64_requests_4_fault_kinds(smoke):
    """The JAX suite's acceptance soak on the port: a seeded plan with all
    five fault kinds over 64 requests, BlockPool.check() after every step,
    unaffected outputs token-identical to the fault-free run.  The pool
    policy is JAX's default chip's (TPU v5e: 8 slots, buckets 8/16/32), the
    one the JAX case runs at."""
    _, _, cfg, params = smoke
    eng = Engine(params, cfg, max_batch=4, max_prompt=32, max_new=8, prefix_cache=True,
                 block_size=8, num_blocks=48, hw=TPU_V5E, device="cpu")
    reqs = synthetic_requests(64, pattern="bursty", min_prompt=4, max_prompt=28, min_new=3,
                              max_new=7, vocab=cfg.vocab_size, prefix_share=0.4,
                              shared_prefix_len=16, seed=11)
    kw = dict(num_steps=40, oversized=2, garbage=2, deadline=2, steals=2, storms=2,
              steal_blocks=24, hold_steps=6)
    plan = FaultPlan.generate(23, [r.rid for r in reqs], **kw)
    assert len(plan.kinds_used) >= 4, plan.kinds_used
    result = chaos_soak(eng, reqs, plan)
    assert result.ok, "\n".join(result.violations)
    assert result.chaos_stats.num_rejected == 4
    assert result.chaos_stats.num_timeout >= 2
    again = FaultPlan.generate(23, [r.rid for r in reqs], **kw)
    assert again.request_faults == plan.request_faults
    assert again.events == plan.events


def test_slot_pool_takes_a_plan(smoke):
    """On the slot pool the block-level events expire without firing (they
    need the block-table pool), as in JAX; request faults still apply."""
    _, _, cfg, params = smoke
    eng = Engine(params, cfg, max_batch=4, max_prompt=32, max_new=8, device="cpu")
    reqs = _burst(cfg, 8)
    plan = FaultPlan.generate(5, [r.rid for r in reqs], num_steps=8, oversized=1, garbage=1,
                              deadline=0, steals=1, storms=1, steal_blocks=4, hold_steps=2)
    result = chaos_soak(eng, reqs, plan)
    assert result.ok, result.violations
    assert result.chaos_stats.num_rejected == 2 and result.chaos_stats.preemptions == 0
