"""The port's prefix-cached serving and int8 KV, against the JAX package.

`BlockPool` (the host state machine) is driven through the same seeded op
sequences as the JAX package's and must end every op in the same state;
`PagedPool`'s gather / scatter must leave shared blocks untouched; the
block-table and int8 paged decode's plain versions must agree with the JAX
Pallas kernels run in interpret mode (tolerance 3e-5, abs and rel: both sum
in f32, in another order); `quantize_kv` must give the JAX package's int8
values and scales; and the port's Engine with prefix_cache=True and/or
kv_dtype="int8" (CPU tensors, so every kernel wrapper runs its plain
version; smoke config, f32, params converted from JAX) must generate greedy
tokens identical to the JAX Engine's on the same requests, policy and
weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.hardware import H100_SXM as JAX_H100
from repro.kernels.flash_attention.ops import paged_decode as jax_paged_decode
from repro.kernels.flash_attention.ops import \
    paged_decode_blocktable as jax_paged_decode_blocktable
from repro.kernels.flash_attention.ref import \
    paged_decode_blocktable_ref as jax_paged_decode_blocktable_ref
from repro.models import init_lm as jax_init_lm
from repro.quant import quantize_kv as jax_quantize_kv
from repro.serving.engine import BlockPool as JaxBlockPool
from repro.serving.engine import BucketPolicy as JaxBucketPolicy
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import PoolExhausted as JaxPoolExhausted
from repro.serving.serve_step import greedy_generate as jax_greedy_generate
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import tolerance
from repro_torch.kernels.flash_attention.ops import paged_decode, paged_decode_blocktable
from repro_torch.kernels.flash_attention.ref import gather_block_kv
from repro_torch.models.convert import params_from_jax
from repro_torch.quant import dequantize_kv, kv_bytes_per_token, quantize_kv
from repro_torch.serving.engine import (BlockPool, BucketPolicy, Engine, PagedPool,
                                        PoolExhausted, Request, synthetic_requests)
from repro_torch.serving.serve_step import greedy_generate

ARCH = "internlm2-1.8b"
TOL = dict(atol=3e-5, rtol=3e-5)
POLICY = dict(num_slots=4, prompt_buckets=(16, 32), seq_max=64)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- BlockPool: the host state machine -----------------------------------------------

def _state(bp):
    seqs = sorted((s.sid, tuple(s.table), s.length, s.num_cached) for s in bp.seqs.values())
    return (seqs, list(bp.ref), list(bp._free), list(bp._cached.items()),
            sorted(bp._hash.items()), bp.evictions)


def _both(jax_bp, bp, op):
    """Apply op(pool, exhausted_class) to both pools: both raise
    PoolExhausted, or both return equal results."""
    outs = []
    for pool, exc in ((jax_bp, JaxPoolExhausted), (bp, PoolExhausted)):
        try:
            outs.append(("ok", op(pool)))
        except exc:
            outs.append(("exhausted", None))
    assert outs[0] == outs[1]
    return outs[1]


def _cows(cows):
    return [(c.src, c.dst) for c in cows]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_block_pool_traces_equal_jax(seed):
    """alloc (with shared system prefixes), commit, prepare_append +
    advance, fork, release and reserve, in one seeded sequence on a
    12-block pool of 4-token blocks: equal tables, num_cached, COW copies,
    evictions, free / cached lists after every op; check() holds."""
    rng = np.random.default_rng(seed)
    jax_bp, bp = JaxBlockPool(12, 4), BlockPool(12, 4)
    prefixes = [rng.integers(0, 50, 9).tolist() for _ in range(3)]
    kinds = ("alloc", "alloc", "append", "append", "append", "fork", "release", "reserve")
    seen = set()
    for _ in range(160):
        live = sorted(bp.seqs)
        kind = kinds[rng.integers(len(kinds))]
        if kind != "alloc" and kind != "reserve" and not live:
            kind = "alloc"
        if kind == "alloc":
            toks = prefixes[rng.integers(3)][:rng.integers(0, 10)] \
                + rng.integers(0, 50, rng.integers(1, 7)).tolist()
            commit = rng.random() < 0.7
            res = _both(jax_bp, bp, lambda p: (lambda sc: (sc[0].sid, tuple(sc[0].table),
                                                          sc[0].num_cached, _cows(sc[1])))(
                p.alloc_sequence(toks)))
            if res[0] == "ok" and commit:
                for p in (jax_bp, bp):
                    p.commit(p.seqs[res[1][0]], toks)
        else:
            sid = live[rng.integers(len(live))] if live else None
            if kind == "append":
                def op(p):
                    seq = p.seqs[sid]
                    cow = p.prepare_append(seq)
                    p.advance(seq)
                    return None if cow is None else (cow.src, cow.dst)
                res = _both(jax_bp, bp, op)
            elif kind == "fork":
                res = _both(jax_bp, bp, lambda p: p.fork(p.seqs[sid]).sid)
            elif kind == "release":
                res = _both(jax_bp, bp, lambda p: p.release(p.seqs[sid]))
            else:
                n = int(rng.integers(1, 5))
                res = _both(jax_bp, bp, lambda p: tuple(p.reserve(n).table))
        seen.add((kind, res[0]))
        assert _state(jax_bp) == _state(bp)
        jax_bp.check()
        bp.check()
    # the sequence reached exhaustion, eviction and sharing
    assert ("alloc", "exhausted") in seen or ("append", "exhausted") in seen
    assert bp.evictions > 0


def test_paged_pool_gather_scatter_respects_shared_blocks(smoke):
    """The twin of the JAX suite's round-trip test: a second row sharing
    block 0 scatters from its first private block; the shared block and
    the other row's blocks stay as they were."""
    cfg = smoke[2]
    pool = PagedPool(cfg, num_rows=2, seq_max=16, dtype=torch.float32, device="cpu",
                     block_size=4)
    toks = list(range(8))
    seq = pool.alloc_sequence(0, toks)
    k0 = pool.caches[0]["k"]
    k0[:, seq.table[0]] = 7.0
    k0[:, seq.table[1]] = 3.0
    pool.commit(0, toks)
    seq2 = pool.alloc_sequence(1, toks[:4] + [9, 9, 9, 9])
    assert seq2.num_cached == 4 and seq2.table[0] == seq.table[0]
    contig = pool.gather(1)
    assert torch.all(contig[0]["k"][0, 0, :4] == 7.0)      # hit KV visible
    zeroed = [{n: torch.zeros_like(t) for n, t in seg.items()} for seg in contig]
    pool.scatter(1, zeroed, seq2.num_cached // pool.block_size)
    k = pool.caches[0]["k"]
    assert torch.all(k[:, seq.table[0]] == 7.0)            # shared: untouched
    assert torch.all(k[:, seq2.table[1]] == 0.0)           # private: rewritten
    assert torch.all(k[:, seq.table[1]] == 3.0)            # other row: untouched
    pool.blocks.check()
    row = 0
    pool.release(row)
    tab = pool.tables()
    assert tab.shape == (2, 4) and np.all(tab[0] == pool.garbage)   # dead row: garbage
    assert np.all(tab[1, 2:] == pool.garbage)                       # unallocated tail


def test_cow_copy_is_mirrored_on_the_device(smoke):
    """A full-hit prompt forks its last block: the fork holds the shared
    block's bytes in every leaf (int8 pool: values and scales)."""
    cfg = dataclasses.replace(smoke[2], kv_dtype="int8")
    pool = PagedPool(cfg, num_rows=2, seq_max=16, dtype=torch.float32, device="cpu",
                     block_size=4)
    toks = list(range(8))
    seq = pool.alloc_sequence(0, toks)
    for name, leaf in pool.caches[0].items():
        leaf[:, seq.table[1]] = 5 if name in ("k", "v") else 0.25
    pool.commit(0, toks)
    seq2 = pool.alloc_sequence(1, toks)
    assert seq2.num_cached == 7 and seq2.table[0] == seq.table[0]
    assert seq2.table[1] != seq.table[1]
    for name, leaf in pool.caches[0].items():
        assert torch.equal(leaf[:, seq2.table[1]], leaf[:, seq.table[1]]), name


# --- the block-table and int8 paged decode ---------------------------------------------

def _bt_inputs(rng, g=3, nkv=2, d=32, nb=12, bs=16):
    """test_prefix_cache.py's inputs: permuted, partly shared tables (rows 0
    and 2 share block 7), a dead row, lengths 50/64/17/0/33."""
    q = _np(rng, (5, nkv * g, d), 0.5)
    kp, vp = _np(rng, (nb, bs, nkv, d), 0.5), _np(rng, (nb, bs, nkv, d), 0.5)
    tables = np.asarray([[7, 3, 1, 0], [2, 8, 9, 4], [7, 5, 0, 0], [10, 0, 0, 0],
                         [11, 6, 3, 2]], np.int32)
    lengths = np.asarray([50, 64, 17, 0, 33], np.int32)
    return q, kp, vp, tables, lengths


def _quantized(kp, vp):
    (kq, ks), (vq, vs) = jax_quantize_kv(jnp.asarray(kp)), jax_quantize_kv(jnp.asarray(vp))
    return tuple(np.asarray(t) for t in (kq, ks, vq, vs))


@pytest.mark.parametrize("g,d", [(3, 32), (2, 64)])
def test_blocktable_decode_vs_jax(g, d):
    q, kp, vp, tables, lengths = _bt_inputs(np.random.default_rng(g), g=g, d=d)
    j = [jnp.asarray(t) for t in (q, kp, vp, tables, lengths)]
    want_kernel = np.asarray(jax_paged_decode_blocktable(*j, interpret=True))
    want_ref = np.asarray(jax_paged_decode_blocktable_ref(*j))
    got = paged_decode_blocktable(*(torch.from_numpy(t) for t in (q, kp, vp, tables,
                                                                   lengths))).numpy()
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    assert np.all(got[3] == 0.0)


@pytest.mark.parametrize("pool", ["slot", "blocktable"])
def test_int8_decode_vs_jax_kernel(pool):
    """The int8 plain versions dequantize in f32, as the JAX kernel does per
    kv tile: held to the JAX Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    q, kp, vp, tables, lengths = _bt_inputs(rng)
    kq, ks, vq, vs = _quantized(kp, vp)
    if pool == "slot":
        # the same values as a (5, 64) slot pool: slot_idx permuted
        kq, ks, vq, vs = (t[:10].reshape(5, 32, *t.shape[2:]) for t in (kq, ks, vq, vs))
        index = np.asarray([3, 0, 4, 2, 1], np.int32)
        lengths = np.asarray([17, 32, 1, 0, 30], np.int32)
        jfn, fn = jax_paged_decode, paged_decode
    else:
        index = tables
        jfn, fn = jax_paged_decode_blocktable, paged_decode_blocktable
    want = np.asarray(jfn(*(jnp.asarray(t) for t in (q, kq, vq, index, lengths)),
                          k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), interpret=True))
    t = torch.from_numpy
    got = fn(t(q), t(kq), t(vq), t(index), t(lengths), k_scale=t(ks), v_scale=t(vs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[3] == 0.0)


def test_int8_blocktable_plain_path_vs_jax_jnp_path():
    """JAX's non-kernel path dequantizes to q's dtype before attending; in
    f32 that is the port's plain version."""
    rng = np.random.default_rng(6)
    q, kp, vp, tables, lengths = _bt_inputs(rng)
    kq, ks, vq, vs = _quantized(kp, vp)
    want = np.asarray(jax_paged_decode_blocktable(
        *(jnp.asarray(t) for t in (q, kq, vq, tables, lengths)), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), use_pallas=False))
    t = torch.from_numpy
    got = paged_decode_blocktable(t(q), t(kq), t(vq), t(tables), t(lengths), k_scale=t(ks),
                                  v_scale=t(vs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_blocktable_decode_counts_nothing_on_the_cpu():
    before = (paged_decode_blocktable.launches, paged_decode_blocktable.int8_launches,
              paged_decode.launches, paged_decode.int8_launches)
    q, kp, vp, tables, lengths = (torch.from_numpy(t) for t in _bt_inputs(np.random.default_rng(0)))
    paged_decode_blocktable(q, kp, vp, tables, lengths)
    kq, ks = quantize_kv(kp)
    paged_decode_blocktable(q, kq, kq, tables, lengths, k_scale=ks, v_scale=ks)
    assert (paged_decode_blocktable.launches, paged_decode_blocktable.int8_launches,
            paged_decode.launches, paged_decode.int8_launches) == before
    with pytest.raises(ValueError, match="no kernel for device"):
        paged_decode_blocktable(q.to("meta"), kp.to("meta"), vp.to("meta"), tables.to("meta"),
                                lengths.to("meta"))


def _blocktable_exact(q, kf, vf, tables, lengths):
    """The exact (f64) decode over dequantized gathered K/V."""
    b, a, d = q.shape
    kk, vv = (gather_block_kv(p, tables).transpose(1, 2).double() for p in (kf, vf))
    nkv = kk.shape[1]
    sc = torch.einsum("bhgd,bhsd->bhgs", q.double().reshape(b, nkv, a // nkv, d), kk) / d ** 0.5
    live = (torch.arange(kk.shape[2])[None] < lengths[:, None])[:, None, None]
    w = torch.softmax(torch.where(live, sc, -torch.inf), -1).nan_to_num(0.0)
    return torch.einsum("bhgs,bhsd->bhgd", w, vv).reshape(q.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["blocktable", "slot int8", "blocktable int8"])
def test_tolerance_admits_exact_and_catches_a_dropped_token(dtype, variant):
    """The per-element bound of the new variants admits the exact result
    rounded to the output dtype and rejects a kernel that drops the last
    live token of a row; the float bound applies to the dequantized K/V."""
    rng = np.random.default_rng(9)
    q, kp, vp, tables, lengths = (torch.from_numpy(t) for t in _bt_inputs(rng, g=2, d=64))
    q = q.to(dtype)
    quant = "int8" in variant
    if quant:
        (kp, ks), (vp, vs) = quantize_kv(kp), quantize_kv(vp)
        kf, vf = dequantize_kv(kp, ks, torch.float64), dequantize_kv(vp, vs, torch.float64)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
        kf, vf, sc = kp, vp, {}
    if variant.startswith("slot"):
        # the same pool read as 5 slots of 64 tokens, through tables [4j..4j+3]
        slot_idx = torch.tensor([2, 0, 1, 2, 1], dtype=torch.int32)
        tables = (slot_idx[:, None] * 4 + torch.arange(4)).to(torch.int32)
        as_slots = lambda t: t[:12].reshape(3, 64, *t.shape[2:])  # noqa: E731
        kp, vp = as_slots(kp), as_slots(vp)
        sc = {n: as_slots(t) for n, t in sc.items()}
        want = paged_decode(q, kp, vp, slot_idx, lengths, **sc)
        faulty = paged_decode(q, kp, vp, slot_idx, (lengths - 1).clamp_min(0), **sc)
        tol = tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want, **sc)
    else:
        want = paged_decode_blocktable(q, kp, vp, tables, lengths, **sc)
        faulty = paged_decode_blocktable(q, kp, vp, tables, (lengths - 1).clamp_min(0), **sc)
        tol = tolerance.paged_decode_blocktable_tol(q, kp, vp, tables, lengths, want, **sc)
    exact = _blocktable_exact(q, kf.double(), vf.double(), tables, lengths).to(dtype)
    ok, err, ratio = tolerance.check(exact, want, tol)
    assert ok, (err, ratio)
    assert not tolerance.check(faulty, want, tol)[0]
    assert torch.all(tol[3] == 0)     # the dead row is held to exactly zero


def test_quantize_kv_matches_jax():
    """Equal int8 values and scales to `jax.jit(quantize_kv)`, the form the
    JAX engine runs (XLA computes absmax / 127 as absmax * f32(1/127)).  The
    eager JAX form divides: its scales lie within one ulp of these."""
    x = _np(np.random.default_rng(4), (6, 40, 4, 32), 3.0)
    x[0, 0] = 0.0                       # an all-zero slice: scale EPS / 127
    jq, js = (np.asarray(t) for t in jax.jit(jax_quantize_kv)(jnp.asarray(x)))
    q, s = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(q.numpy(), jq)
    eager = np.asarray(jax_quantize_kv(jnp.asarray(x))[1])
    assert np.all(np.abs(eager - js) <= np.spacing(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert kv_bytes_per_token(8, 128, "int8") == 2 * 8 * 128 + 2 * 8 * 4
    assert kv_bytes_per_token(8, 128) == 2 * 2 * 8 * 128


# --- engine token identity with the JAX engine ---------------------------------------

def _engines(smoke, policy=POLICY, jax_paged=False, **kw):
    """The JAX engine and the port's, on the same policy and weights; the
    port always runs the paged kernel's plain version (the JAX side runs its
    jnp path unless asked: the Pallas interpret path is slow)."""
    jcfg, jparams, cfg, params = smoke
    jeng = JaxEngine(jparams, jcfg, policy=JaxBucketPolicy(**policy), hw=JAX_H100,
                     use_paged_kernel=jax_paged, **kw)
    eng = Engine(params, dataclasses.replace(cfg, linear_impl="fused"),
                 policy=BucketPolicy(**policy), hw=H100_SXM, use_paged_kernel=True,
                 device="cpu", **kw)
    return jeng, eng


def _same(jdone, done):
    assert [c.rid for c in done] == [c.rid for c in jdone]
    for jc, c in zip(jdone, done):
        assert c.tokens == jc.tokens, f"rid {c.rid}"
        assert (c.finish_reason, c.cached_tokens, c.preemptions) == \
            (jc.finish_reason, jc.cached_tokens, jc.preemptions), f"rid {c.rid}"


def test_shared_prefix_workload_and_warm_rerun(smoke):
    reqs = synthetic_requests(10, pattern="burst", min_prompt=20, max_prompt=30, min_new=3,
                              max_new=8, vocab=smoke[2].vocab_size, prefix_share=0.8,
                              shared_prefix_len=16, seed=5)
    jeng, eng = _engines(smoke, prefix_cache=True, block_size=8)
    jdone, jstats = jeng.run(reqs)
    done, stats = eng.run(reqs)
    _same(jdone, done)
    assert stats.cache_hit_requests == jstats.cache_hit_requests >= 2
    assert 0.0 < stats.cache_hit_rate == jstats.cache_hit_rate < 1.0
    jdone2, jstats2 = jeng.run(reqs)
    done2, stats2 = eng.run(reqs)
    _same(jdone2, done2)
    assert [c.tokens for c in done2] == [c.tokens for c in done]
    assert stats2.cache_hit_rate == jstats2.cache_hit_rate > stats.cache_hit_rate
    assert stats2.cache_hit_requests == len(reqs)
    eng.pool.blocks.check()
    assert eng.pool.num_free == eng.policy.num_slots


def test_divergence_after_shared_prefix(smoke):
    """Cold (registers P), a suffix after P (cached 16), and P alone (a
    full hit: COW, cached 15); each equals JAX's greedy_generate."""
    jcfg, jparams, cfg, params = smoke
    P = np.random.RandomState(0).randint(0, cfg.vocab_size, size=16).astype(np.int32)
    reqs = [Request(rid=0, tokens=np.concatenate([P, np.asarray([3, 5, 7], np.int32)]),
                    max_new_tokens=6),
            Request(rid=1, tokens=np.concatenate([P, np.asarray([11, 13], np.int32)]),
                    max_new_tokens=6),
            Request(rid=2, tokens=P.copy(), max_new_tokens=6)]
    jeng, eng = _engines(smoke, prefix_cache=True, block_size=8)
    done, _ = eng.run(reqs)
    _same(jeng.run(reqs)[0], done)
    for r, c in zip(reqs, done):
        want = np.asarray(jax_greedy_generate(jparams, jcfg, jnp.asarray(r.tokens[None]),
                                              r.max_new_tokens))[0]
        assert c.tokens == want.tolist(), f"rid {r.rid}"
    assert [c.cached_tokens for c in done] == [0, 16, 15]
    eng.pool.blocks.check()


def test_eviction_pressure(smoke):
    """8 rows x 32 deep / block 8 = 32 physical blocks; 16 distinct prompts
    force released cached blocks to be evicted."""
    policy = dict(num_slots=8, prompt_buckets=(8, 16, 24), seq_max=32)
    reqs = synthetic_requests(16, pattern="burst", min_prompt=17, max_prompt=24, min_new=2,
                              max_new=5, vocab=smoke[2].vocab_size, seed=21)
    jeng, eng = _engines(smoke, policy=policy, prefix_cache=True, block_size=8)
    done, stats = eng.run(reqs)
    _same(jeng.run(reqs)[0], done)
    assert eng.pool.blocks.num_blocks == 32
    assert eng.pool.blocks.evictions == jeng.pool.blocks.evictions > 0
    assert stats.num_requests == 16


def test_prefix_cache_with_the_paged_kernel_on_both_sides(smoke):
    reqs = synthetic_requests(5, pattern="burst", min_prompt=18, max_prompt=28, min_new=3,
                              max_new=6, vocab=smoke[2].vocab_size, prefix_share=0.8,
                              shared_prefix_len=16, seed=17)
    jeng, eng = _engines(smoke, jax_paged=True, prefix_cache=True, block_size=8)
    assert eng.cfg.attn_impl == jeng.cfg.attn_impl == "paged"
    done, stats = eng.run(reqs)
    _same(jeng.run(reqs)[0], done)
    assert stats.cache_hit_requests >= 1


def test_tight_pool_preempts_and_resumes(smoke):
    """num_blocks=24 against 8 requests that want up to 64 blocks: the
    youngest row is preempted with exact rollback and resumed, token for
    token as the JAX engine; each finished request equals the roomy run,
    each partial is a prefix of it; check() holds after every step."""
    reqs = synthetic_requests(8, pattern="burst", min_prompt=12, max_prompt=28, min_new=24,
                              max_new=30, vocab=smoke[2].vocab_size, seed=5)
    _, roomy = _engines(smoke, prefix_cache=True, block_size=8)
    want = {c.rid: c.tokens for c in roomy.run(reqs)[0]}
    jeng, eng = _engines(smoke, prefix_cache=True, block_size=8, num_blocks=24)
    done, stats = eng.run(reqs, check_invariants=True)
    jdone, jstats = jeng.run(reqs, check_invariants=True)
    _same(jdone, done)
    assert (stats.preemptions, stats.resumes) == (jstats.preemptions, jstats.resumes)
    assert stats.preemptions > 0 and stats.resumes > 0
    for c in done:
        if c.ok:
            assert c.tokens == want[c.rid], f"rid {c.rid}"
        else:
            assert c.finish_reason == "preempted-retry-exhausted"
            assert c.tokens == want[c.rid][:len(c.tokens)], f"rid {c.rid}"
    assert any(c.ok and c.preemptions > 0 for c in done)
    eng.pool.blocks.check()
    assert eng.pool.num_free == eng.policy.num_slots


@pytest.mark.parametrize("paged", [False, True])
def test_int8_slot_pool(smoke, paged):
    """kv_dtype="int8" on the slot pool, with the JAX engine's paged kernel
    (interpret mode) or its jnp path; and the port's engine against its own
    greedy_generate under the same int8 config."""
    reqs = synthetic_requests(5 if paged else 6, pattern="burst", min_prompt=4,
                              max_prompt=24, min_new=3, max_new=8 if not paged else 6,
                              vocab=smoke[2].vocab_size, seed=23 if paged else 21)
    jeng, eng = _engines(smoke, jax_paged=paged, kv_dtype="int8")
    assert eng.cfg.kv_dtype == "int8" and eng.pool.caches[0]["k"].dtype == torch.int8
    done, stats = eng.run(reqs)
    _same(jeng.run(reqs)[0], done)
    assert stats.prefills == len(reqs)
    params = smoke[3]
    for r, c in zip(reqs, done):
        want = greedy_generate(params, eng.cfg, torch.from_numpy(r.tokens[None]),
                               r.max_new_tokens)[0]
        assert c.tokens == want.tolist(), f"rid {r.rid}"


def test_prefix_cache_with_int8(smoke):
    reqs = synthetic_requests(8, pattern="burst", min_prompt=18, max_prompt=30, min_new=3,
                              max_new=8, vocab=smoke[2].vocab_size, prefix_share=0.75,
                              shared_prefix_len=16, seed=29)
    jeng, eng = _engines(smoke, prefix_cache=True, block_size=8, kv_dtype="int8")
    done, stats = eng.run(reqs)
    _same(jeng.run(reqs)[0], done)
    assert stats.cache_hit_requests >= 2
    assert set(eng.pool.caches[0]) == {"k", "v", "k_scale", "v_scale"}
    _, slot8 = _engines(smoke, kv_dtype="int8")
    assert [c.tokens for c in slot8.run(reqs)[0]] == [c.tokens for c in done]


def test_unported_run_faults_raises(smoke):
    _, eng = _engines(smoke, prefix_cache=True, block_size=8)
    with pytest.raises(NotImplementedError, match="observability-and-faults"):
        eng.run([], faults=object())


def test_block_size_falls_back_to_the_lattice(smoke):
    """No tuning cache in the port: the smallest lattice divisor of seq_max
    >= 16, which is 64 on the H100 at chip_smoke's policy (64 rows x 192)."""
    cfg, params = smoke[2], smoke[3]
    eng = Engine(params, dataclasses.replace(cfg, dtype="bfloat16"), max_batch=8,
                 max_prompt=128, max_new=32, hw=H100_SXM, prefix_cache=True, device="cpu")
    assert (eng.policy.num_slots, eng.policy.seq_max) == (64, 192)
    assert eng.pool.block_size == 64 and eng.pool.blocks.num_blocks == 64 * 3
    assert eng.pool.caches[0]["k"].shape[1:3] == (64 * 3 + 1, 64)


def test_suffix_prefill_past_the_pool_depth(smoke):
    """A cache-backed suffix prefill whose padded bucket passes seq_max: a
    resumed request at start = 56 with a 16-wide bucket on a 64-deep view
    (the engine's resume path reaches it once prompt + generated tokens pass
    seq_max - 16).  The port's model refuses a write past the cache's depth;
    the engine pads the suffix only to min(bucket, seq_max - start) = 8, and
    those logits equal a cold prefill's.  The JAX package's
    `dynamic_update_slice` clamps the 16-wide write to start 48, overwriting
    live prefix KV, and its logits do not (a reference fault, ROADMAP.md
    queue 3)."""
    from repro.models import apply_lm as jax_apply_lm
    from repro.models import init_caches as jax_init_caches
    from repro_torch.models import apply_lm, init_caches
    jcfg, jparams, cfg, params = smoke
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 60).astype(np.int32)
    padded = np.zeros(16, np.int32)
    padded[:4] = toks[56:]

    def jax_run(ids, caches, ci):
        return jax_apply_lm(jparams, jnp.asarray(ids[None]), jcfg, caches=caches,
                            cache_index=ci)[:2]

    want = np.asarray(jax_run(toks, jax_init_caches(jcfg, 1, 64, jnp.float32), 0)[0])[0, 59]
    _, jc = jax_run(toks[:56], jax_init_caches(jcfg, 1, 64, jnp.float32), 0)
    jax_got = np.asarray(jax_run(padded, jc, 56)[0])[0, 3]
    caches = init_caches(cfg, 1, 64, torch.float32)
    with torch.no_grad():
        apply_lm(params, torch.from_numpy(toks[None, :56]), cfg, caches=caches, cache_index=0)
        with pytest.raises(RuntimeError):
            apply_lm(params, torch.from_numpy(padded[None]), cfg, caches=caches, cache_index=56)
        got = apply_lm(params, torch.from_numpy(padded[None, :64 - 56]), cfg, caches=caches,
                       cache_index=56)[0][0, 3].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(jax_got - want).max() > 100 * np.abs(got - want).max()


def test_resume_at_the_pool_depth_pads_only_what_fits(smoke):
    """A tight pool (30 blocks of 8) preempts a row as it crosses position
    56 of a 64-deep pool; on resume its one-token suffix goes in at start 56
    with a 16-wide bucket.  The port's engine pads it only to 8, the room
    left, and every request equals the roomy run.  The JAX engine's clamped
    write lands over the cached prefix and the resumed request's tokens
    diverge (the reference fault above, reached through the engine)."""
    reqs = synthetic_requests(8, pattern="burst", min_prompt=24, max_prompt=32, min_new=28,
                              max_new=32, vocab=smoke[2].vocab_size, seed=1)
    _, roomy = _engines(smoke, prefix_cache=True, block_size=8)
    want = {c.rid: c.tokens for c in roomy.run(reqs)[0]}
    jeng, eng = _engines(smoke, prefix_cache=True, block_size=8, num_blocks=30)
    widths = []
    prefill = eng._prefill

    def recording(params, tokens, true_len, start, caches):
        widths.append((start, tokens.shape[1]))
        return prefill(params, tokens, true_len, start, caches)

    eng._prefill = recording
    done, stats = eng.run(reqs, check_invariants=True)
    assert stats.resumes > 0 and (56, 8) in widths
    assert all(c.ok and c.tokens == want[c.rid] for c in done)
    jdone, _ = jeng.run(reqs, check_invariants=True)
    resumed = {c.rid for c in done if c.preemptions}
    assert resumed and all((c.tokens == want[c.rid]) == (c.rid not in resumed) for c in jdone)
