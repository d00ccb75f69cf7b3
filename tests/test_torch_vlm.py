"""The port's VLM path (internvl2: patch embeddings prepended to the token
stream) and blocked attention vs the JAX package's.

internvl2-smoke: 3 layers, d 64, 4 / 2 heads, 8 patches, f32.  Params are
made by the JAX package and converted with `params_from_jax`; batches come
from the numpy data pipeline (its patch stub), identical in both; other
inputs from a numpy seed.  Tolerances: 2e-5 (abs and rel) for the logits
and blocked attention at f32, sums in another order; the training suite's
atol 2e-4 / rtol 2e-3 for the loss and every gradient leaf; 1e-4 relative
for 3-step trajectories.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.models import apply_lm as jax_apply_lm
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.models.attention import apply_gqa as jax_apply_gqa
from repro.models.blocked_attention import blocked_sdpa as jax_blocked_sdpa
from repro.optim import adamw as jax_adamw
from repro.serving.serve_step import make_decode_step as jax_make_decode_step
from repro.serving.serve_step import make_prefill_step as jax_make_prefill_step
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import apply_lm, init_lm, lm_loss
from repro_torch.models.attention import apply_gqa
from repro_torch.models.blocked_attention import blocked_sdpa
from repro_torch.models.blocks import tree_index
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving.engine import Engine
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

ARCH = "internvl2-76b"
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
ATTN = ["naive", "flash", "blocked"]
SEQ, BATCH = 24, 2          # 8 patches + 16 tokens


def _walk(tree, prefix="", sort=True):
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _walk(tree[k], f"{prefix}{k}/", sort)
    else:
        yield prefix[:-1], tree


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    jcfg = jax_get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    np_batch = make_batch(cfg, ShapeConfig("t", SEQ, BATCH, "train"), 0, 0)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, np_batch=np_batch,
                jbatch={k: jnp.asarray(v) for k, v in np_batch.items()})


def _params(ref, dtype=None):
    return params_from_jax(_np_tree(ref["jparams"]), ref["cfg"], "cpu", dtype=dtype)


def _batch(ref):
    return {k: torch.from_numpy(v) for k, v in ref["np_batch"].items()}


def _cfgs(ref, linear_impl="jnp", attn_impl="naive"):
    kw = dict(linear_impl=linear_impl, attn_impl=attn_impl)
    return dataclasses.replace(ref["jcfg"], **kw), dataclasses.replace(ref["cfg"], **kw)


@pytest.mark.parametrize("full", [False, True])
def test_make_batch_identical(full):
    """The patch stub is byte-identical to JAX's and the tokens shrink to
    seq_len - num_patches, host-sharded too; at internvl2-76b's full width
    as well (1024 patches of 8192)."""
    jcfg, cfg = ((jax_get_config(ARCH), get_config(ARCH)) if full
                 else (jax_get_smoke_config(ARCH), get_smoke_config(ARCH)))
    rows, seq = (2, cfg.num_patches + 40) if full else (6, 40)
    for step, seed, pi, pc in ((0, 0, 0, 1), (3, 1234, 1, 2)):
        got = make_batch(cfg, ShapeConfig("t", seq, rows, "train"), step, seed, pi, pc)
        want = jax_make_batch(jcfg, JaxShapeConfig("t", seq, rows, "train"), step, seed, pi, pc)
        assert got.keys() == want.keys() == {"tokens", "labels", "patch_embeds"}
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), k
    assert got["tokens"].shape == (rows // 2, seq - cfg.num_patches)
    assert got["patch_embeds"].shape == (rows // 2, cfg.num_patches, cfg.d_model)


@pytest.mark.parametrize("attn_impl", ATTN)
def test_apply_lm_logits_with_patches_match_jax(ref, attn_impl):
    """Patches prepended, one causal mask over patches and tokens: logits
    at every position (the patches' too)."""
    jcfg, cfg = _cfgs(ref, "fused", attn_impl)
    toks, patches = ref["np_batch"]["tokens"], ref["np_batch"]["patch_embeds"]
    want, _, _ = jax_apply_lm(ref["jparams"], jnp.asarray(toks), jcfg,
                              patch_embeds=jnp.asarray(patches))
    got, _, _ = apply_lm(_params(ref), torch.from_numpy(toks), cfg,
                         patch_embeds=torch.from_numpy(patches))
    assert got.shape[1] == toks.shape[1] + patches.shape[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _port_grads(params, batch, cfg):
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {p: g.numpy() for (p, _), g in zip(_walk(params, sort=False), grads)}


@pytest.mark.parametrize("linear_impl,attn_impl", [("jnp", "naive"), ("fused", "flash"),
                                                   ("jnp", "blocked")])
def test_lm_loss_and_grads_match_jax(ref, linear_impl, attn_impl):
    """The loss over the text positions only (the patches sliced off), and
    every leaf's gradient."""
    jcfg, cfg = _cfgs(ref, linear_impl, attn_impl)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, ref["jbatch"], jcfg), has_aux=True))(ref["jparams"])
    want = dict(_walk(_np_tree(jgrads)))
    loss, grads = _port_grads(_params(ref, torch.float32), _batch(ref), cfg)
    np.testing.assert_allclose(loss, float(jloss), **GRAD_TOL)
    assert grads.keys() == want.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g, want[path], err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_trajectory_matches_jax(ref, n_micro):
    """Three steps of make_train_step on the kernel path (fused, flash),
    patches split across microbatches with the tokens."""
    jtc = JaxTrainConfig(total_steps=3, warmup_steps=1, remat="none")
    tc = TrainConfig(total_steps=3, warmup_steps=1, remat="none")
    jcfg, cfg = _cfgs(ref, "fused", "flash")
    jstep = jax.jit(jax_make_train_step(jcfg, jtc, n_micro=n_micro))
    step = make_train_step(cfg, tc, n_micro=n_micro)
    jparams, params = ref["jparams"], _params(ref, torch.float32)
    jopt, opt = jax_adamw.init_opt(jparams, jtc), adamw.init_opt(params, tc)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    for s in range(3):
        b = make_batch(cfg, shape, s, 0)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {s} {key}")


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
@torch.no_grad()
def test_decode_after_prefill_matches_full_forward_and_jax(ref, attn_impl):
    """A prefill of the patches and s - 1 tokens (blocked: into the cache,
    kv_len short of its depth), then one decode step at position
    n_patches + s - 1: its logits equal the full forward's last position
    and JAX's decode step's."""
    jcfg, cfg = _cfgs(ref, "fused", attn_impl)
    params = _params(ref)
    toks, patches = ref["np_batch"]["tokens"], ref["np_batch"]["patch_embeds"]
    s, npatch = toks.shape[1], patches.shape[1]
    s_max = npatch + s + 5
    full, _, _ = apply_lm(params, torch.from_numpy(toks), cfg,
                          patch_embeds=torch.from_numpy(patches))
    _, caches = make_prefill_step(cfg, s_max)(
        params, {"tokens": torch.from_numpy(toks[:, :-1]),
                 "patch_embeds": torch.from_numpy(patches)})
    got, _ = make_decode_step(cfg)(params, torch.from_numpy(toks[:, -1:]), caches,
                                   npatch + s - 1)
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)
    _, jc = jax_make_prefill_step(jcfg, s_max)(
        ref["jparams"], {"tokens": jnp.asarray(toks[:, :-1]),
                         "patch_embeds": jnp.asarray(patches)})
    want, _ = jax_make_decode_step(jcfg)(ref["jparams"], jnp.asarray(toks[:, -1:]), jc,
                                         jnp.asarray(npatch + s - 1, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@torch.no_grad()
def test_greedy_tokens_identical_to_jax(ref):
    """serve_step's prefill over patches + prompt, then greedy decode steps,
    token for token against JAX's."""
    jcfg, cfg = _cfgs(ref, "fused", "naive")
    params = _params(ref)
    prompt = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    patches = ref["np_batch"]["patch_embeds"]
    n, s_max = 8, patches.shape[1] + 9 + 8
    prefill, decode = make_prefill_step(cfg, s_max), make_decode_step(cfg)
    jprefill = jax.jit(jax_make_prefill_step(jcfg, s_max))
    jdecode = jax.jit(jax_make_decode_step(jcfg))
    logits, caches = prefill(params, {"tokens": torch.from_numpy(prompt),
                                      "patch_embeds": torch.from_numpy(patches)})
    jlogits, jc = jprefill(ref["jparams"], {"tokens": jnp.asarray(prompt),
                                            "patch_embeds": jnp.asarray(patches)})
    got, want = [], []
    idx = patches.shape[1] + prompt.shape[1]
    for i in range(n):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        got.append(tok.numpy())
        want.append(np.asarray(jtok))
        if i < n - 1:
            logits, caches = decode(params, tok, caches, idx + i)
            jlogits, jc = jdecode(ref["jparams"], jtok, jc, jnp.asarray(idx + i, jnp.int32))
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))


def test_full_width_bridge_shapes_without_allocating():
    """internvl2-76b at full width: the port's init_lm on the meta device has
    jax.eval_shape(init_lm)'s shapes, and params_from_jax consumes a tree of
    them (no patch-embedding weights: the frontend is a stub)."""
    jshapes = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(ARCH)),
                             jax.random.PRNGKey(0))
    want = {p: tuple(t.shape) for p, t in _walk(jshapes)}
    cfg = get_config(ARCH)
    got = {p: tuple(t.shape) for p, t in _walk(init_lm(None, cfg, device="meta"))}
    assert got == want and "pos_embed" not in got
    assert want["seg0/mlp/w_down"] == (80, 28672, 8192)
    zero = np.zeros(1, np.float32)
    tree = {}
    for path, shape in want.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = np.lib.stride_tricks.as_strided(zero, shape=shape, strides=(0,) * len(shape))
    out = params_from_jax(tree, cfg, "meta")
    assert {p: tuple(t.shape) for p, t in _walk(out)} == want


def test_engine_refuses_internvl(ref):
    with pytest.raises(NotImplementedError, match="attention-based decoders"):
        Engine(_params(ref), ref["cfg"], device="cpu")


def test_launchers_run_internvl_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen", "4"])
    assert "decode:  3 steps" in capsys.readouterr().out
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq-len", "24", "--log-every", "1",
                "--linear-impl", "fused", "--attn-impl", "blocked", "--microbatch", "1",
                "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     1" in out and out.rstrip().endswith("done")


# --- blocked attention ---------------------------------------------------------------

def _qkv(rng, b, sq, skv, a, nkv, d):
    return (rng.standard_normal((b, sq, a, d)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, nkv, d)).astype(np.float32))


# (b, sq, skv, a, nkv, d, causal, block_kv, q_pos offset or None, kv_len or None)
BLOCKED_CASES = [
    (2, 16, 16, 4, 4, 16, True, 8, None, None),      # causal, whole blocks
    (2, 16, 40, 4, 4, 16, False, 16, None, None),    # non-causal, ragged tail (40 = 2 x 16 + 8)
    (1, 7, 30, 6, 2, 32, False, 1024, None, None),   # one block (blk = skv), GQA g 3
    (2, 5, 24, 4, 2, 16, True, 8, 11, 16),           # a cache: q at 11..15, kv_len 16 < 24
    (1, 9, 21, 8, 1, 8, True, 4, 3, 12),             # MQA, ragged, kv_len inside a block
    (1, 3, 17, 2, 2, 16, False, 5, None, 9),         # non-causal with kv_len
]


@pytest.mark.parametrize("b,sq,skv,a,nkv,d,causal,blk,q0,kv_len", BLOCKED_CASES)
def test_blocked_sdpa_matches_jax(b, sq, skv, a, nkv, d, causal, blk, q0, kv_len):
    """Values and the gradients of q, k and v against JAX's lax.scan
    version (differentiated by jax.grad) under a random cotangent."""
    rng = np.random.default_rng(20)
    q, k, v = _qkv(rng, b, sq, skv, a, nkv, d)
    do = rng.standard_normal((b, sq, a, d)).astype(np.float32)
    q_pos = None if q0 is None else np.arange(q0, q0 + sq, dtype=np.int32)
    kw = dict(causal=causal, kv_len=kv_len, block_kv=blk)

    def jfn(q, k, v):
        return jax_blocked_sdpa(q, k, v, q_pos=None if q_pos is None else jnp.asarray(q_pos),
                                **kw)
    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wgrads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = blocked_sdpa(*leaves, q_pos=None if q_pos is None else torch.from_numpy(q_pos), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", leaves, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, atol=5e-5,
                                   rtol=5e-5)


def test_blocked_sdpa_keeps_jax_dtypes():
    """bf16 inputs: the accumulator is in q's dtype and the output bf16, as
    JAX's; the values agree with JAX's bf16 run to a few bf16 ulps (two
    CPU backends round bf16 products in their own order)."""
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, 2, 12, 37, 4, 2, 64)
    want = jax_blocked_sdpa(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
                            causal=False, block_kv=16)
    got = blocked_sdpa(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
                       causal=False, block_kv=16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_gqa_blocked_prefill_into_a_cache_matches_jax(ref, per_row):
    """A blocked prefill into a cache at offset 5 (kv_len 5 + s of a deeper
    cache), with 1-D positions or 2-D per-row ones (row 0's are used, as
    JAX's), GQA: output and the written cache against JAX's."""
    jcfg, cfg = _cfgs(ref, "jnp", "blocked")
    jcfg = dataclasses.replace(jcfg, attn_block_kv=8)
    cfg = dataclasses.replace(cfg, attn_block_kv=8)
    jp = jax.tree.map(lambda t: t[1], ref["jparams"]["seg0"]["attn"])
    p = tree_index(_params(ref)["seg0"]["attn"], 1)
    rng = np.random.default_rng(22)
    b, s, s_max, ci = 2, 7, 21, 5
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    shape = (b, s_max, cfg.num_kv_heads, cfg.head_dim)
    cache0 = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    pos = np.arange(ci, ci + s, dtype=np.int32)
    if per_row:
        pos = np.broadcast_to(pos, (b, s)).copy()
    want, wc = jax_apply_gqa(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                             cache={n: jnp.asarray(t) for n, t in cache0.items()},
                             cache_index=ci)
    cache = {n: torch.from_numpy(t.copy()) for n, t in cache0.items()}
    got, _ = apply_gqa(p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                       cache=cache, cache_index=ci)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(wc[n]), **TOL)


@pytest.mark.parametrize("sq,skv", [(1, 40), (9, 40), (40, 9)])
def test_flash_non_causal_cross_shapes_match_jax(sq, skv):
    """The flash wrapper's plain version at the cross-attention's shapes
    (sq = 1 as at decode, sq < skv, sq > skv), non-causal, against the
    Pallas kernel in interpret mode: forward and the VJP."""
    rng = np.random.default_rng(23)
    q, k, v = _qkv(rng, 2, sq, skv, 4, 4, 16)
    do = rng.standard_normal(q.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, causal=False,
                                                            interpret=True),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    wgrads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = flash_attention(*leaves, causal=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(torch.from_numpy(do))
    for name, t, w in zip("qkv", leaves, wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, atol=5e-5,
                                   rtol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,q0,kv_len", [(False, None, None), (True, 20, 30)])
def test_blocked_sdpa_tol_admits_blocked_and_rejects_faults(dtype, causal, q0, kv_len):
    """The bound on blocked attention against the naive path holds the
    blocked result (a ragged tail, GQA; causal into a cache with kv_len)
    and rejects a causal mask dropped and a block's values dropped."""
    from repro_torch.kernels.tolerance import blocked_sdpa_tol, check
    from repro_torch.models.attention import _sdpa
    rng = np.random.default_rng(24)
    q, k, v = (torch.from_numpy(t).to(dtype) for t in _qkv(rng, 2, 10, 37, 4, 2, 32))
    q_pos = None if q0 is None else torch.arange(q0, q0 + 10)
    kw = dict(q_pos=q_pos, kv_len=kv_len)
    want = _sdpa(q, k, v, causal, **kw)
    tol = blocked_sdpa_tol(q, k, v, want, causal, block_kv=16, **kw)
    assert check(blocked_sdpa(q, k, v, causal=causal, block_kv=16, **kw), want, tol)[0]
    v_drop = v.clone()
    v_drop[:, 16:32] = 0
    faults = [blocked_sdpa(q, k, v_drop, causal=causal, block_kv=16, **kw)]
    if causal:
        faults.append(blocked_sdpa(q, k, v, causal=False, block_kv=16, **kw))
    for bad in faults:
        assert not check(bad, want, tol)[0]
