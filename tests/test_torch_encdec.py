"""The port's encoder-decoder path (whisper) vs the JAX package's, on
whisper-smoke (2 + 2 layers, d 64, 4 heads, 32 encoder frames, f32).

Params are made by the JAX package and converted with `params_from_jax`;
batches come from the numpy data pipeline (its encoder-frame stub),
identical in both; other inputs from a numpy seed.  Flash runs the JAX
package's Pallas kernels in interpret mode against the port's plain
versions.  Tolerances: 2e-5 (abs and rel) for the encoder and the logits
at f32, sums in another order; the training suite's atol 2e-4 / rtol 2e-3
for the loss and every gradient leaf; 1e-4 relative for 3-step
trajectories.
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
from repro.models import apply_encoder as jax_apply_encoder
from repro.models import apply_lm as jax_apply_lm
from repro.models import init_caches as jax_init_caches
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.serving.serve_step import make_decode_step as jax_make_decode_step
from repro.serving.serve_step import make_prefill_step as jax_make_prefill_step
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import apply_encoder, apply_lm, init_caches, init_lm, lm_loss
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving.engine import Engine
from repro_torch.serving.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

ARCH = "whisper-small"
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
ATTN = ["naive", "flash", "blocked"]
SEQ, BATCH = 24, 2


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
    """JAX params and config, the port's config, one training batch (numpy)."""
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


@pytest.mark.parametrize("arch,rows,seq", [(ARCH, 6, 40), ("whisper-full", 2, 16)])
def test_make_batch_identical(arch, rows, seq):
    """The encoder-frame stub is byte-identical to JAX's, host-sharded too;
    at whisper-small's full width as well (1500 frames of 768)."""
    jcfg, cfg = ((jax_get_config(ARCH), get_config(ARCH)) if arch == "whisper-full"
                 else (jax_get_smoke_config(arch), get_smoke_config(arch)))
    for step, seed, pi, pc in ((0, 0, 0, 1), (3, 1234, 1, 2)):
        got = make_batch(cfg, ShapeConfig("t", seq, rows, "train"), step, seed, pi, pc)
        want = jax_make_batch(jcfg, JaxShapeConfig("t", seq, rows, "train"), step, seed, pi, pc)
        assert got.keys() == want.keys() == {"tokens", "labels", "encoder_frames"}
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), k
    assert got["encoder_frames"].shape == (rows // 2, cfg.encoder_seq, cfg.d_model)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("attn_impl", ATTN)
def test_apply_encoder_matches_jax(ref, attn_impl, remat):
    jcfg, cfg = _cfgs(ref, "fused", attn_impl)
    frames = ref["np_batch"]["encoder_frames"]
    want = jax_apply_encoder(ref["jparams"], jnp.asarray(frames), jcfg, remat)
    got = apply_encoder(_params(ref), torch.from_numpy(frames), cfg, remat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn_impl", ATTN)
def test_apply_lm_logits_match_jax(ref, attn_impl):
    """Decoder self-attention (causal), the cross-attention post-pass (non-
    causal over the encoder's output) and learned positions."""
    jcfg, cfg = _cfgs(ref, "fused", attn_impl)
    toks, frames = ref["np_batch"]["tokens"], ref["np_batch"]["encoder_frames"]
    want, _, _ = jax_apply_lm(ref["jparams"], jnp.asarray(toks), jcfg,
                              encoder_frames=jnp.asarray(frames))
    got, _, _ = apply_lm(_params(ref), torch.from_numpy(toks), cfg,
                         encoder_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_enc_out_stands_in_for_the_frames(ref):
    """apply_lm with enc_out (the decode steps' form) equals apply_lm on the
    frames; without either an encoder-decoder raises."""
    cfg, params = ref["cfg"], _params(ref)
    toks, frames = (torch.from_numpy(ref["np_batch"][k]) for k in ("tokens", "encoder_frames"))
    a, _, _ = apply_lm(params, toks, cfg, encoder_frames=frames)
    b, _, _ = apply_lm(params, toks, cfg, enc_out=apply_encoder(params, frames, cfg))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="encoder_frames or enc_out"):
        apply_lm(params, toks, cfg)


def _port_grads(params, batch, cfg, remat="none"):
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {p: g.numpy() for (p, _), g in zip(_walk(params, sort=False), grads)}


@pytest.mark.parametrize("linear_impl,attn_impl", [("jnp", "naive"), ("fused", "flash"),
                                                   ("jnp", "blocked")])
def test_lm_loss_and_grads_match_jax(ref, linear_impl, attn_impl):
    """Loss and every leaf's gradient, the encoder's, the cross-attention's
    and pos_embed's among them; flash's backward is JAX's Pallas backward
    in interpret mode against the port's plain one."""
    jcfg, cfg = _cfgs(ref, linear_impl, attn_impl)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, ref["jbatch"], jcfg), has_aux=True))(ref["jparams"])
    want = dict(_walk(_np_tree(jgrads)))
    loss, grads = _port_grads(_params(ref, torch.float32), _batch(ref), cfg)
    np.testing.assert_allclose(loss, float(jloss), **GRAD_TOL)
    assert grads.keys() == want.keys()
    assert any(p.startswith("encoder/") for p in grads) and "pos_embed" in grads
    assert any(p.startswith("xattn/") for p in grads)
    for path, g in grads.items():
        assert np.abs(g).max() > 0, path
        np.testing.assert_allclose(g, want[path], err_msg=path, **GRAD_TOL)


def test_kernel_path_grads_equal_plain_path_and_remat(ref):
    """On the CPU the wrappers run their plain versions: the (fused, flash)
    path's gradients equal the (jnp, naive) path's to f32 rounding, and
    remat="full" (the encoder's layers recomputed too) changes no number."""
    _, kern = _cfgs(ref, "fused", "flash")
    _, plain = _cfgs(ref)
    lk, gk = _port_grads(_params(ref, torch.float32), _batch(ref), kern)
    _, gp = _port_grads(_params(ref, torch.float32), _batch(ref), plain)
    for path in gp:
        np.testing.assert_allclose(gk[path], gp[path], atol=2e-5, rtol=2e-4, err_msg=path)
    lf, gf = _port_grads(_params(ref, torch.float32), _batch(ref), kern, remat="full")
    assert lk == lf
    for path in gk:
        np.testing.assert_array_equal(gk[path], gf[path], err_msg=path)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_trajectory_matches_jax(ref, n_micro):
    """Three steps of make_train_step on the kernel path (fused, flash),
    frames split across microbatches with the tokens: loss, lm_loss,
    grad-norm and lr per step within 1e-4 relative."""
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


@pytest.mark.parametrize("attn_impl", ["naive", "flash", "blocked"])
def test_decode_after_prefill_matches_full_forward_and_jax(ref, attn_impl):
    """A prefill of s - 1 tokens into the caches, then one decode step with
    enc_out (learned position s - 1, cross-attention at sq = 1): its logits
    equal the full forward's last position and JAX's decode step's."""
    jcfg, cfg = _cfgs(ref, "fused", attn_impl)
    params = _params(ref)
    toks, frames = ref["np_batch"]["tokens"], ref["np_batch"]["encoder_frames"]
    b, s = toks.shape
    full, _, _ = apply_lm(params, torch.from_numpy(toks), cfg,
                          encoder_frames=torch.from_numpy(frames))
    prefill = make_prefill_step(cfg, s + 4)
    _, caches = prefill(params, {"tokens": torch.from_numpy(toks[:, :-1]),
                                 "encoder_frames": torch.from_numpy(frames)})
    enc_out = apply_encoder(params, torch.from_numpy(frames), cfg)
    got, _ = make_decode_step(cfg)(params, torch.from_numpy(toks[:, -1:]), caches, s - 1, enc_out)
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), **TOL)
    _, jc = jax_make_prefill_step(jcfg, s + 4)(
        ref["jparams"], {"tokens": jnp.asarray(toks[:, :-1]),
                         "encoder_frames": jnp.asarray(frames)})
    jenc = jax_apply_encoder(ref["jparams"], jnp.asarray(frames), jcfg)
    want, _ = jax_make_decode_step(jcfg)(ref["jparams"], jnp.asarray(toks[:, -1:]), jc,
                                         jnp.asarray(s - 1, jnp.int32), jenc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_greedy(jcfg, jparams, prompt, frames, n, s_max):
    prefill = jax.jit(jax_make_prefill_step(jcfg, s_max))
    decode = jax.jit(jax_make_decode_step(jcfg))
    logits, caches = prefill(jparams, {"tokens": prompt, "encoder_frames": frames})
    enc = jax_apply_encoder(jparams, frames, jcfg)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(n - 1):
        logits, caches = decode(jparams, tok, caches, jnp.asarray(prompt.shape[1] + i, jnp.int32),
                                enc)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@torch.no_grad()
def test_greedy_tokens_identical_to_jax(ref):
    """serve_step's prefill and decode steps with enc_out, greedy, against
    JAX's decode step given enc_out (its launcher omits it: see
    test_jax_static_loop_cannot_decode_whisper)."""
    jcfg, cfg = _cfgs(ref, "fused", "flash")
    params = _params(ref)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    frames = ref["np_batch"]["encoder_frames"]
    n, s_max = 8, 16
    want = _jax_greedy(ref["jcfg"], ref["jparams"], jnp.asarray(prompt), jnp.asarray(frames),
                       n, s_max)
    prefill, decode = make_prefill_step(cfg, s_max), make_decode_step(cfg)
    logits, caches = prefill(params, {"tokens": torch.from_numpy(prompt),
                                      "encoder_frames": torch.from_numpy(frames)})
    enc = apply_encoder(params, torch.from_numpy(frames), cfg)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    out = [tok]
    for i in range(n - 1):
        logits, caches = decode(params, tok, caches, prompt.shape[1] + i, enc)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want)


def test_params_from_jax_dtypes_and_every_leaf(ref):
    """bf16 serving params: pos_embed as the embedding, the encoder's and
    the cross-attention's GEMM weights as the blocks', every norm f32;
    every leaf of JAX's tree consumed."""
    tree = _np_tree(ref["jparams"])
    cfg = dataclasses.replace(ref["cfg"], dtype="bfloat16")
    out = params_from_jax(tree, cfg, "cpu")
    leaves = dict(_walk(out))
    assert len(leaves) == len(jax.tree.leaves(tree))
    for path, t in leaves.items():
        name = path.rsplit("/", 1)[-1]
        assert t.dtype == (torch.float32 if name in ("scale", "bias") else torch.bfloat16), path
    assert {"pos_embed", "encoder/final_norm/bias", "xattn/attn/wk", "xattn/norm/scale",
            "encoder/seg0/attn/wq"} <= leaves.keys()
    np.testing.assert_array_equal(out["pos_embed"].float().numpy(), np.asarray(
        jnp.asarray(tree["pos_embed"]).astype(jnp.bfloat16).astype(jnp.float32)))


def test_full_width_bridge_shapes_without_allocating():
    """whisper-small at full width: the port's init_lm on the meta device has
    jax.eval_shape(init_lm)'s shapes (pos_embed 8192 rows, 12 encoder and 12
    cross-attention layers), about 284 M parameters."""
    jshapes = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(ARCH)),
                             jax.random.PRNGKey(0))
    want = {p: tuple(t.shape) for p, t in _walk(jshapes)}
    got = {p: tuple(t.shape) for p, t in _walk(init_lm(None, get_config(ARCH), device="meta"))}
    assert got == want
    assert want["pos_embed"] == (8192, 768) and want["xattn/attn/wq"] == (12, 768, 768)
    assert 2.80e8 < sum(int(np.prod(s)) for s in got.values()) < 2.90e8


def test_engine_refuses_whisper(ref):
    from repro_torch.launch import serve
    params = _params(ref)
    with pytest.raises(NotImplementedError, match="attention-based decoders"):
        Engine(params, ref["cfg"], device="cpu")
    with pytest.raises(NotImplementedError, match="attention-based decoders"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine"])


def test_jax_static_loop_cannot_decode_whisper(capsys):
    """The reference fault (ROADMAP section 3): JAX's static serve loop gives
    prefill the frames but calls decode without enc_out, and apply_lm
    asserts; the port's launcher computes enc_out once and decodes."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "3"]
    with pytest.raises(AssertionError, match="whisper needs encoder frames"):
        jax_serve.main(argv)
    capsys.readouterr()
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode:  2 steps" in out and "sample:" in out


def test_train_launcher_runs_whisper_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train
    train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq-len", "16", "--log-every", "1",
                "--linear-impl", "fused", "--attn-impl", "blocked",
                "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     1" in out and out.rstrip().endswith("done")


def test_caches_hold_only_the_decoder(ref):
    """The cross-attention writes no cache: a whisper cache is the decoder's
    self-attention K/V only, as JAX's."""
    cfg = ref["cfg"]
    caches = init_caches(cfg, 2, 9, torch.float32)
    jc = jax_init_caches(ref["jcfg"], 2, 9, jnp.float32)
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in caches] == \
        [{k: tuple(v.shape) for k, v in c.items()} for c in jc]
