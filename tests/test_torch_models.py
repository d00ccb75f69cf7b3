"""Port model modules vs the JAX package on the same inputs.

Params are made by the JAX package and converted with `params_from_jax`;
activations and tokens come from a seed with numpy.  The smoke config runs
in f32; tolerance 2e-5 (abs and rel) unless stated: both sides compute in
f32, with sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import apply_lm as jax_apply_lm
from repro.models import init_caches as jax_init_caches
from repro.models import init_lm as jax_init_lm
from repro.models.attention import apply_gqa as jax_apply_gqa
from repro.models.layers import apply_rotary as jax_apply_rotary
from repro.models.layers import norm_apply as jax_norm_apply
from repro.serving.serve_step import greedy_generate as jax_greedy_generate
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import apply_lm, init_caches, init_lm
from repro_torch.models.attention import apply_gqa
from repro_torch.models.blocks import tree_index
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import apply_rotary, norm_apply
from repro_torch.models.linear import linear
from repro_torch.serving.serve_step import greedy_generate

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def smoke():
    """(jax cfg, jax params, port cfg, port params) on internlm2-smoke."""
    jcfg = jax_get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_configs_are_copies():
    for name in (ARCH, "qwen1.5-4b", "deepseek-v3-671b"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jax_get_config(name))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_get_smoke_config(ARCH))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    rng = np.random.default_rng(0)
    x = _np(rng, (3, 5, 64))
    p = {"scale": _np(rng, (64,)) + 1.0, "bias": _np(rng, (64,))}
    want = np.asarray(jax_norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), kind))
    got = norm_apply({k: _t(v) for k, v in p.items()}, _t(x), kind).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rotary(per_row):
    rng = np.random.default_rng(1)
    x = _np(rng, (2, 7, 4, 32))
    pos = (np.asarray([[3], [11]], np.int32) + np.arange(7, dtype=np.int32)[None]) \
        if per_row else np.arange(5, 12, dtype=np.int32)
    want = np.asarray(jax_apply_rotary(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = apply_rotary(_t(x), _t(pos), 10000.0).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)  # sin/cos of angles up to ~17 rad


def _layer(jparams, params, layer=1):
    jp = jax.tree.map(lambda t: t[layer], jparams["seg0"]["attn"])
    return jp, tree_index(params["seg0"]["attn"], layer)


@pytest.mark.parametrize("linear_impl", ["jnp", "fused"])
def test_apply_gqa_prefill(smoke, linear_impl):
    jcfg, jparams, cfg, params = smoke
    cfg = dataclasses.replace(cfg, linear_impl=linear_impl)
    jp, p = _layer(jparams, params)
    rng = np.random.default_rng(2)
    b, s, s_max = 2, 9, 24
    x = _np(rng, (b, s, cfg.d_model))
    shape = (b, s_max, cfg.num_kv_heads, cfg.head_dim)
    cache0 = {"k": _np(rng, shape), "v": _np(rng, shape)}
    want, wcache = jax_apply_gqa(jp, jnp.asarray(x), jcfg, positions=jnp.arange(s),
                                 cache={k: jnp.asarray(v) for k, v in cache0.items()},
                                 cache_index=0)
    cache = {k: _t(v.copy()) for k, v in cache0.items()}
    got, gcache = apply_gqa(p, _t(x), cfg, positions=torch.arange(s), cache=cache,
                            cache_index=0)
    assert gcache["k"] is cache["k"]          # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wcache[k]), **TOL)


@pytest.mark.parametrize("attn_impl", ["naive", "paged"])
def test_apply_gqa_vector_index_decode(smoke, attn_impl):
    """Engine decode: per-row write positions, one token per row; dead rows
    (index 0) included."""
    jcfg, jparams, cfg, params = smoke
    jp, p = _layer(jparams, params)
    rng = np.random.default_rng(3)
    b, s_max = 4, 20
    x = _np(rng, (b, 1, cfg.d_model))
    ci = np.asarray([5, 0, 19, 11], np.int32)
    shape = (b, s_max, cfg.num_kv_heads, cfg.head_dim)
    cache0 = {"k": _np(rng, shape), "v": _np(rng, shape)}
    want, wcache = jax_apply_gqa(
        jp, jnp.asarray(x), dataclasses.replace(jcfg, attn_impl=attn_impl),
        positions=jnp.asarray(ci)[:, None],
        cache={k: jnp.asarray(v) for k, v in cache0.items()}, cache_index=jnp.asarray(ci))
    cache = {k: _t(v.copy()) for k, v in cache0.items()}
    got, _ = apply_gqa(p, _t(x), dataclasses.replace(cfg, attn_impl=attn_impl),
                       positions=_t(ci)[:, None], cache=cache, cache_index=_t(ci))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(wcache[k]), **TOL)


def _int8_cache(rng, shape):
    """An int8 cache as the JAX package quantizes it, and its numpy copy."""
    from repro.quant import quantize_kv as jax_quantize_kv
    out = {}
    for name in ("k", "v"):
        q, sc = jax_quantize_kv(jnp.asarray(_np(rng, shape)))
        out[name], out[f"{name}_scale"] = np.asarray(q), np.asarray(sc)
    return out


def _assert_cache_close(got, want):
    """int8 leaves may differ by one step where the two divisions round a
    .5 boundary apart; everything else to TOL."""
    for name, w in want.items():
        g, w = got[name].numpy(), np.asarray(w)
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["naive", "paged"])
@pytest.mark.parametrize("cache_index", ["prefill", "vector"])
def test_apply_gqa_int8_cache(smoke, attn_impl, cache_index):
    """kv_dtype="int8": quantize per (token, kv head) on write, dequantize
    on read (the paged kernel per kv tile, the plain path up front)."""
    jcfg, jparams, cfg, params = smoke
    jp, p = _layer(jparams, params)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl, kv_dtype="int8")
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl, kv_dtype="int8")
    rng = np.random.default_rng(7)
    b, s_max = 3, 20
    if cache_index == "prefill":
        s, ci = 7, 4
        pos = np.arange(ci, ci + s)
        jci, tci = ci, ci
    else:
        s = 1
        ci = np.asarray([5, 0, 19], np.int32)
        pos = ci[:, None]
        jci, tci = jnp.asarray(ci), _t(ci)
    x = _np(rng, (b, s, cfg.d_model))
    cache0 = _int8_cache(rng, (b, s_max, cfg.num_kv_heads, cfg.head_dim))
    want, wcache = jax_apply_gqa(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                 cache={k: jnp.asarray(v) for k, v in cache0.items()},
                                 cache_index=jci)
    cache = {k: _t(v.copy()) for k, v in cache0.items()}
    got, _ = apply_gqa(p, _t(x), cfg, positions=_t(pos), cache=cache, cache_index=tci)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    _assert_cache_close(cache, wcache)


@pytest.mark.parametrize("attn_impl", ["naive", "paged"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_apply_gqa_block_table_decode(smoke, attn_impl, kv_dtype):
    """One decode step over a physical block pool: the new token goes to
    (table[b, ci // bs], ci % bs); attention reads through the table (the
    block-table kernel, or a gather and the plain path).  Rows 0 and 2
    share block 5, row 1 is dead (its table points at garbage block 7)."""
    jcfg, jparams, cfg, params = smoke
    jp, p = _layer(jparams, params)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl, kv_dtype=kv_dtype)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl, kv_dtype=kv_dtype)
    rng = np.random.default_rng(8)
    nb, bs = 8, 4
    shape = (nb, bs, cfg.num_kv_heads, cfg.head_dim)
    cache0 = _int8_cache(rng, shape) if kv_dtype == "int8" else \
        {"k": _np(rng, shape), "v": _np(rng, shape)}
    tables = np.asarray([[5, 2, 0], [7, 7, 7], [5, 1, 3]], np.int32)
    ci = np.asarray([6, 0, 9], np.int32)
    x = _np(rng, (3, 1, cfg.d_model))
    want, wcache = jax_apply_gqa(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(ci)[:, None],
                                 cache={k: jnp.asarray(v) for k, v in cache0.items()},
                                 cache_index=jnp.asarray(ci), block_tables=jnp.asarray(tables))
    cache = {k: _t(v.copy()) for k, v in cache0.items()}
    got, _ = apply_gqa(p, _t(x), cfg, positions=_t(ci)[:, None], cache=cache,
                       cache_index=_t(ci), block_tables=_t(tables))
    np.testing.assert_allclose(got[[0, 2]].numpy(), np.asarray(want)[[0, 2]],
                               atol=1e-4, rtol=1e-4)
    live = [0, 1, 2, 3, 5, 6]   # block 7 is the garbage block; 4 is unused
    _assert_cache_close({k: v[live] for k, v in cache.items()},
                        {k: np.asarray(v)[live] for k, v in wcache.items()})


def test_greedy_generate_int8_kv_tokens_identical(smoke):
    """greedy_generate under an int8 config: int8 cache leaves, a prefill
    at cache_index 0 and scalar-index decode steps."""
    jcfg, jparams, cfg, params = smoke
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(jparams, dataclasses.replace(jcfg, kv_dtype="int8"),
                                          jnp.asarray(prompt), 8))
    got = greedy_generate(params, dataclasses.replace(cfg, linear_impl="fused",
                                                      kv_dtype="int8"), _t(prompt), 8).numpy()
    np.testing.assert_array_equal(got, want)
    caches = init_caches(dataclasses.replace(cfg, kv_dtype="int8"), 2, 19, torch.float32)
    assert {n: t.dtype for n, t in caches[0].items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32, "v_scale": torch.float32}
    assert caches[0]["k_scale"].shape == (cfg.num_layers, 2, 19, cfg.num_kv_heads)


@pytest.mark.parametrize("linear_impl", ["jnp", "pallas", "fused"])
def test_apply_lm_logits(smoke, linear_impl):
    jcfg, jparams, cfg, params = smoke
    cfg = dataclasses.replace(cfg, linear_impl=linear_impl)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _, _ = jax_apply_lm(jparams, jnp.asarray(toks), jcfg)
    got, _, _ = apply_lm(params, _t(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("linear_impl", ["jnp", "pallas", "fused"])
def test_apply_lm_logits_tied_head(linear_impl):
    """Tied embeddings: the head is embed^T (no lm_head leaf)."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), tie_embeddings=True)
    jparams = jax_init_lm(jax.random.PRNGKey(1), jcfg)
    assert "lm_head" not in jparams
    cfg = dataclasses.replace(get_smoke_config(ARCH), tie_embeddings=True,
                              linear_impl=linear_impl)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _, _ = jax_apply_lm(jparams, jnp.asarray(toks), jcfg)
    got, _, _ = apply_lm(params, _t(toks), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=5e-5)


def test_apply_lm_prefill_then_vector_decode(smoke):
    """Prefill into a cache, then one engine-style decode step (vector
    cache_index, paged kernel path) — logits and caches against JAX."""
    jcfg, jparams, cfg, params = smoke
    cfg = dataclasses.replace(cfg, linear_impl="fused", attn_impl="paged")
    jcfg = dataclasses.replace(jcfg, attn_impl="paged")
    rng = np.random.default_rng(5)
    b, s, s_max = 3, 8, 16
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    _, jc, _ = jax_apply_lm(jparams, jnp.asarray(toks), jcfg,
                            caches=jax_init_caches(jcfg, b, s_max, jnp.float32), cache_index=0)
    caches = init_caches(cfg, b, s_max, torch.float32)
    apply_lm(params, _t(toks), cfg, caches=caches, cache_index=0)
    pos = np.asarray([8, 3, 8], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    want, jc, _ = jax_apply_lm(jparams, jnp.asarray(nxt), jcfg, caches=jc,
                               cache_index=jnp.asarray(pos), decode=True)
    got, caches, _ = apply_lm(params, _t(nxt), cfg, caches=caches, cache_index=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(caches[0]["k"].numpy(), np.asarray(jc[0]["k"]), **TOL)


def test_greedy_generate_tokens_identical(smoke):
    jcfg, jparams, cfg, params = smoke
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(jparams, jcfg, jnp.asarray(prompt), 8))
    got = greedy_generate(params, dataclasses.replace(cfg, linear_impl="fused"),
                          _t(prompt), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_from_jax_consumes_every_leaf(smoke):
    jcfg, jparams, cfg, params = smoke
    tree = jax.tree.map(np.asarray, jparams)
    assert len(jax.tree.leaves(tree)) == sum(1 for _ in _leaves(params))
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        params_from_jax(extra, cfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        params_from_jax(missing, cfg, "cpu")
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_jax(bad, cfg, "cpu")


def test_params_from_jax_casts_once_to_compute_dtype(smoke):
    """bf16 config: GEMM weights and the embedding become bf16 (round to
    nearest even, as JAX's per-call astype), norm gains stay f32."""
    jcfg, jparams, cfg, _ = smoke
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jparams)
    out = params_from_jax(tree, bcfg, "cpu")
    wq = out["seg0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and out["seg0"]["norm1"]["scale"].dtype == torch.float32
    want = np.asarray(jnp.asarray(tree["seg0"]["attn"]["wq"]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(wq.float().numpy(), want)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_full_width_bridge_shapes_without_allocating():
    """internlm2-1.8b at full width: the port's init_lm (meta device) has the
    shapes of jax.eval_shape(init_lm), and params_from_jax consumes every
    leaf of a tree of that shape (zero-stride arrays: nothing allocated)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jshapes = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    want = {path: tuple(leaf.shape) for path, leaf in _leaves(jshapes)}
    port = init_lm(None, cfg, device="meta")
    got = {path: tuple(t.shape) for path, t in _leaves(port)}
    assert got == want
    zero = np.zeros(1, np.float32)
    tree = {}
    for path, shape in want.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.lib.stride_tricks.as_strided(zero, shape=shape, strides=(0,) * len(shape))
    out = params_from_jax(tree, cfg, "meta")
    assert {p: tuple(t.shape) for p, t in _leaves(out)} == want
    assert all(t.device.type == "meta" for _, t in _leaves(out))
    assert out["lm_head"].dtype == torch.bfloat16


def test_init_lm_scales_match_jax(smoke):
    """The port's own init draws every leaf with the JAX init's scale (the
    values differ: torch.Generator is not jax.random)."""
    _, jparams, cfg, _ = smoke
    port = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = {p: float(np.std(np.asarray(t))) for p, t in _leaves(jax.tree.map(np.asarray, jparams))}
    got = {p: float(t.float().std(unbiased=False)) for p, t in _leaves(port)}
    assert got.keys() == want.keys()
    for path, s in want.items():
        if s == 0.0:                      # norm gains: ones
            assert got[path] == 0.0, path
        else:
            assert abs(got[path] / s - 1.0) < 0.1, (path, got[path], s)


def test_unported_paths_raise(smoke):
    _, _, cfg, params = smoke
    x = torch.zeros(1, 2, cfg.d_model)
    # the int8 path is ported: a zero weight quantizes to zeros (scale EPS / 127)
    assert torch.equal(linear(x, torch.zeros(cfg.d_model, 4), impl="quantized"),
                       torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="unknown linear_impl"):
        linear(x, torch.zeros(cfg.d_model, 4), impl="xla")
    p = tree_index(params["seg0"]["attn"], 0)
    with pytest.raises(NotImplementedError, match="tuning"):
        apply_gqa(p, x, dataclasses.replace(cfg, attn_impl="blocked"), positions=torch.arange(2))
    with pytest.raises(ValueError, match="block_tables requires single-token decode"):
        apply_gqa(p, x, cfg, positions=torch.arange(2), block_tables=torch.zeros(1, 1))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        init_lm(None, get_config("whisper-small"), device="meta")
