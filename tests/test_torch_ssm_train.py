"""The port's SSM training path (mamba2, zamba2) against the JAX package.

Params are made by the JAX package and converted with
`params_from_jax(..., dtype=torch.float32)` (float32 masters, as training
holds them); batches come from the numpy data pipeline, identical in both.
The sequence (40 steps, chunk 32) pads the last chunk.  Each model runs at
its random init and at a trained model's slow decay (softplus(dt_bias) in
[1e-3, 1e-1]), under which every key of a chunk weighs in.  On CPU tensors
`ssd_chunk` under autograd runs `_SSDChunk` with its plain versions (the
forward oracle and `ssd_chunk_bwd_ref`); the JAX model trains through its
einsums by autodiff.  Tolerances, and why:
  * loss and every gradient leaf: the JAX suite's `atol=2e-4, rtol=2e-3`
    (as tests/test_torch_train.py): f32 sums in another order, the
    inter-chunk recurrence a loop here and an associative scan in JAX;
  * the kernel path against the plain path (autograd through
    `ssd_chunk_ref`): f32 rounding, 2e-5 / 2e-4;
  * a 3-step trajectory: 1e-4 relative (AdamW bounds each update by lr);
  * `ssd_chunk_bwd_ref` against autograd of `ssd_chunk_ref`: the same
    derivatives summed in another order, 1e-5 / 1e-4 at f32, and
    `ssd_chunk_bwd_tol` (the bound the card's kernel is held to) at bf16;
  * remat="full" against "none": bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import init_lm as jax_init_lm
from repro.models import lm_loss as jax_lm_loss
from repro.optim import adamw as jax_adamw
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import tolerance
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunk_bwd_ref, ssd_chunk_ref
from repro_torch.models import lm_loss
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.train_step import make_train_step

ARCHS = ("mamba2-780m", "zamba2-2.7b")
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
IMPLS = [("jnp", "naive"), ("fused", "flash")]
DECAYS = ("random init", "slow decay")
SEQ, BATCH = 40, 2          # chunk 32: the second chunk is padded (8 live steps)


def _walk(tree, prefix="", sort=True):
    """(path, leaf) pairs: in sorted key order (JAX's flattening), or in
    insertion order (the port's) with sort=False."""
    if isinstance(tree, dict):
        for k in (sorted(tree) if sort else tree):
            yield from _walk(tree[k], f"{prefix}{k}/", sort)
    else:
        yield prefix[:-1], tree


def _slow_decay(jparams, seed=0):
    """dt_bias with softplus(dt_bias) log-uniform in [1e-3, 1e-1], as a
    trained Mamba2's dt, on every SSM layer."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        if getattr(path[-1], "key", None) != "dt_bias":
            return leaf
        u = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=leaf.shape))
        return jnp.asarray(np.log(np.expm1(u)), jnp.float32)
    return jax.tree_util.tree_map_with_path(f, jparams)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """Per arch: JAX params at both decays, the port's config, one batch,
    and per (decay, impl pair) the JAX loss and gradients (numpy, by path)."""
    jcfg = jax_get_smoke_config(request.param)
    j0 = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    jparams = {"random init": j0, "slow decay": _slow_decay(j0)}
    cfg = get_smoke_config(request.param)
    np_batch = make_batch(cfg, ShapeConfig("t", SEQ, BATCH, "train"), 0, 0)
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    grads = {}
    for decay in DECAYS:
        for li, ai in IMPLS:
            c = dataclasses.replace(jcfg, linear_impl=li, attn_impl=ai)
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, c=c: jax_lm_loss(p, jbatch, c), has_aux=True))(jparams[decay])
            grads[(decay, li, ai)] = (float(loss), dict(_walk(jax.tree.map(np.asarray, g))))
    return dict(arch=request.param, jcfg=jcfg, jparams=jparams, cfg=cfg, np_batch=np_batch,
                grads=grads)


def _port_params(ref, decay="random init"):
    return params_from_jax(jax.tree.map(np.asarray, ref["jparams"][decay]), ref["cfg"], "cpu",
                           dtype=torch.float32)


def _port_batch(ref):
    return {k: torch.from_numpy(v) for k, v in ref["np_batch"].items()}


def _port_grads(params, batch, cfg, remat="none"):
    leaves = list(tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm_loss(params, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    paths = [path for path, _ in _walk(params, sort=False)]
    return loss.item(), {p: g.numpy() for p, g in zip(paths, grads)}


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("linear_impl,attn_impl", IMPLS)
def test_lm_loss_and_grads_match_jax(ref, decay, linear_impl, attn_impl):
    """Loss and every leaf's gradient on (jnp, naive) and (fused, flash):
    the second runs the SSD Function (and the GEMM, fused-MLP and flash
    Functions) with their plain versions on CPU tensors, against JAX's
    Pallas kernels in interpret mode and its einsum SSM."""
    cfg = dataclasses.replace(ref["cfg"], linear_impl=linear_impl, attn_impl=attn_impl)
    loss, grads = _port_grads(_port_params(ref, decay), _port_batch(ref), cfg)
    want_loss, want = ref["grads"][(decay, linear_impl, attn_impl)]
    np.testing.assert_allclose(loss, want_loss, **GRAD_TOL)
    assert grads.keys() == want.keys()
    for path, g in grads.items():
        np.testing.assert_allclose(g, want[path], err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("decay", DECAYS)
def test_kernel_path_grads_equal_plain_path(ref, decay, monkeypatch):
    """The kernel path ((fused, flash): `_SSDChunk` with the backward's
    plain version) against the plain path ((jnp, naive), autograd through
    `ssd_chunk_ref`): the same derivatives, to f32 rounding."""
    base = ref["cfg"]
    _, gk = _port_grads(_port_params(ref, decay), _port_batch(ref),
                        dataclasses.replace(base, linear_impl="fused", attn_impl="flash"))
    monkeypatch.setattr(ssm_mod, "ssd_chunk", ssd_chunk_ref)
    _, gp = _port_grads(_port_params(ref, decay), _port_batch(ref), base)
    for path in gp:
        np.testing.assert_allclose(gk[path], gp[path], atol=2e-5, rtol=2e-4, err_msg=path)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_trajectory_matches_jax(ref, n_micro):
    """Three steps of make_train_step on the kernel path (fused, flash):
    loss, lm_loss, grad-norm and lr per step within 1e-4 relative."""
    jtc = JaxTrainConfig(total_steps=3, warmup_steps=1, remat="none")
    tc = TrainConfig(total_steps=3, warmup_steps=1, remat="none")
    jcfg = dataclasses.replace(ref["jcfg"], linear_impl="fused", attn_impl="flash")
    cfg = dataclasses.replace(ref["cfg"], linear_impl="fused", attn_impl="flash")
    jstep = jax.jit(jax_make_train_step(jcfg, jtc, n_micro=n_micro))
    step = make_train_step(cfg, tc, n_micro=n_micro)
    jparams, params = ref["jparams"]["random init"], _port_params(ref)
    jopt, opt = jax_adamw.init_opt(jparams, jtc), adamw.init_opt(params, tc)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    for s in range(3):
        b = make_batch(cfg, shape, s, 0)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "lm_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {s} {key}")


def test_remat_full_equals_none(ref):
    """Recomputing each Mamba2 layer (mamba2) or superblock with zamba2's
    shared block captured in the closure changes no number."""
    cfg = dataclasses.replace(ref["cfg"], linear_impl="fused", attn_impl="flash")
    params = _port_params(ref, "slow decay")
    l0, g0 = _port_grads(params, _port_batch(ref), cfg, remat="none")
    l1, g1 = _port_grads(params, _port_batch(ref), cfg, remat="full")
    assert l0 == l1
    for path in g0:
        np.testing.assert_array_equal(g0[path], g1[path], err_msg=path)


def test_ssd_function_only_when_a_gradient_is_recorded(ref, monkeypatch):
    """The serve path (no_grad, or no leaf requiring grad) calls the SSD
    kernel's wrapper directly and never pays `_SSDChunk`."""
    def refuse(*a):
        raise AssertionError("_SSDChunk taken")
    monkeypatch.setattr(ssd_ops._SSDChunk, "apply", refuse)
    cfg = dataclasses.replace(ref["cfg"], linear_impl="fused", attn_impl="flash")
    params = _port_params(ref)
    with torch.no_grad():
        lm_loss(params, _port_batch(ref), cfg)
    lm_loss(params, _port_batch(ref), cfg)      # no leaf requires grad
    next(iter(tree_leaves(params))).requires_grad_(True)   # the embedding
    with pytest.raises(AssertionError, match="_SSDChunk taken"):
        lm_loss(params, _port_batch(ref), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_ssm_on_cpu(arch, capsys, tmp_path):
    from repro_torch.launch import train
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                "--global-batch", "2", "--seq-len", str(SEQ), "--log-every", "1",
                "--linear-impl", "fused", "--attn-impl", "flash",
                "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     1" in out and out.rstrip().endswith("done")


# --- the SSD backward's plain version and its bound ------------------------------------

def _ssd_case(rng, lead, nc, Q, P, N, step, expanded, dtype=torch.float32):
    """x_dt, B, C, seg, dY, dS; B and C expanded over the last leading dim
    (the heads of a group) when `expanded`."""
    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)
    x = t((*lead, nc, Q, P), 0.5)
    bl = (*lead[:-1], 1) if expanded else lead
    B, C = (t((*bl, nc, Q, N), 0.5).expand(*lead, nc, Q, N) for _ in range(2))
    seg = torch.from_numpy(-np.cumsum(rng.uniform(0.0, step, size=(*lead, nc, Q)), axis=-1)
                           .astype(np.float32))
    return x, B, C, seg, t((*lead, nc, Q, P)), t((*lead, nc, N, P))


SHAPES = [((2, 3), 2, 32, 16, 16), ((1, 4), 1, 100, 24, 40),   # a ragged chunk
          ((2, 3), 2, 40, 16, 16),                            # the misaligned smoke shape
          ((1, 2, 3), 2, 64, 8, 16)]                           # leading dims (b, g, heads)


@pytest.mark.parametrize("step", [1.0, 0.02])
@pytest.mark.parametrize("lead,nc,Q,P,N", SHAPES)
def test_ssd_chunk_bwd_ref_matches_autograd(lead, nc, Q, P, N, step):
    """The written-out gradient against torch.autograd.grad of the forward
    oracle, B and C expanded over the heads (their gradients summed over
    the heads by the expand's backward), in f32."""
    x, B, C, seg, dY, dS = _ssd_case(np.random.default_rng(Q + P), lead, nc, Q, P, N, step,
                                     expanded=True)
    bases = [x.clone(), B[..., :1, :, :, :].clone(), C[..., :1, :, :, :].clone(), seg.clone()]
    bases = [b.requires_grad_(True) for b in bases]
    y, s = ssd_chunk_ref(bases[0], bases[1].expand(B.shape), bases[2].expand(C.shape), bases[3])
    want = torch.autograd.grad((y * dY).sum() + (s * dS).sum(), bases)
    dx, db, dc, dseg = ssd_chunk_bwd_ref(x, B, C, seg, dY, dS)
    assert db.shape == B.shape and dc.shape == C.shape and dseg.dtype == torch.float32
    got = (dx, db.sum(-4, keepdim=True), dc.sum(-4, keepdim=True), dseg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("lead,nc,Q,P,N", SHAPES)
def test_ssd_chunk_bwd_ref_matches_autograd_bf16(lead, nc, Q, P, N):
    """bf16 operands, the flat layout (dB, dC per head as autograd's):
    autograd through the oracle on the same values in f32 (autograd on bf16
    leaves would round each use's gradient of x_dt to bf16 before adding
    them), rounded to bf16, lies within the bound of the plain version's
    bf16 outputs."""
    ops = _ssd_case(np.random.default_rng(Q), lead, nc, Q, P, N, 0.02, expanded=False,
                    dtype=torch.bfloat16)
    leaves = [t.float().requires_grad_(True) for t in ops[:4]]
    y, s = ssd_chunk_ref(*leaves)
    want = torch.autograd.grad((y * ops[4].float()).sum() + (s * ops[5].float()).sum(), leaves)
    got = ssd_chunk_bwd_ref(*ops)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for g, w, tol in zip(got, want, tolerance.ssd_chunk_bwd_tol(*ops, got)):
        ok, err, ratio = tolerance.check(w.to(g.dtype), g, tol)
        assert ok, (err, ratio)


def _faulty_bwd(x, B, C, seg, dY, dS, fault):
    """ssd_chunk_bwd_ref's formulas in f32 with one planted fault."""
    Q = x.shape[-2]
    xf, Bf, Cf, dy, ds = (t.float() for t in (x, B, C, dY, dS))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    if fault == "a dropped key tile":      # keys [0, 64) never visited
        mask = mask & (torch.arange(Q) >= 64)[None, :]
    L = torch.exp(torch.where(mask, seg[..., :, None] - seg[..., None, :], -1e30))
    CB = torch.einsum("...qn,...kn->...qk", Cf, Bf)
    pos = seg[..., -1:] if fault != "the decay from the wrong position" else seg[..., -2:-1]
    decay = torch.exp(pos - seg)
    dAL = torch.where(mask, torch.einsum("...qp,...kp->...qk", dy, xf), 0.0) * L
    BdS = torch.einsum("...kn,...np->...kp", Bf, ds)
    state = 0.0 if fault == "a dropped dS term" else 1.0
    dX = torch.einsum("...qk,...qp->...kp", CB * L, dy) + state * decay[..., None] * BdS
    dC = torch.einsum("...qk,...kn->...qn", dAL, Bf)
    dB = torch.einsum("...qk,...qn->...kn", dAL, Cf) \
        + state * torch.einsum("...kp,...np->...kn", xf * decay[..., None], ds)
    G = dAL * CB
    e = state * decay * (xf * BdS).sum(-1)
    sign = -1.0 if fault == "a dseg sign flip" else 1.0
    last = torch.zeros_like(e)
    last[..., -1] = e.sum(-1)
    dseg = G.sum(-1) - sign * G.sum(-2) - e + last
    return dX.to(x.dtype), dB.to(x.dtype), dC.to(x.dtype), dseg


FAULTS = ("a dropped dS term", "a dropped key tile", "a dseg sign flip",
          "the decay from the wrong position")


def _kernel_numerics_bwd(x, B, C, seg, dY, dS):
    """ssd_chunk_bwd_ref's formulas with the bf16 kernels' own roundings
    (csrc/ssd_chunk_bwd.cu): L = 2^(seg_i log2(e) rounded - seg_j log2(e)),
    A and dA o L rounded to bf16 before the dX, dC and dB products, G and
    the chunk-state terms in f32."""
    Q = x.shape[-2]
    xf, Bf, Cf, dy, ds = (t.float() for t in (x, B, C, dY, dS))
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    log2e = 1.4426950408889634
    rq = (seg * log2e).float().double()
    ex = (rq[..., :, None] - seg.double()[..., None, :] * log2e).float()   # one FFMA's rounding
    L = torch.exp2(torch.where(mask, ex, -1e30))
    CB = torch.einsum("...qn,...kn->...qk", Cf, Bf)
    dAL = torch.where(mask, torch.einsum("...qp,...kp->...qk", dy, xf), 0.0) * L
    r16 = lambda t: t.bfloat16().float()  # noqa: E731
    decay = torch.exp(seg[..., -1:] - seg)
    BdS = torch.einsum("...kn,...np->...kp", Bf, ds)
    dX = torch.einsum("...qk,...qp->...kp", r16(CB * L), dy) + decay[..., None] * BdS
    dC = torch.einsum("...qk,...kn->...qn", r16(dAL), Bf)
    dB = torch.einsum("...qk,...qn->...kn", r16(dAL), Cf) \
        + decay[..., None] * torch.einsum("...kp,...np->...kn", xf, ds)
    G = dAL * CB
    e = decay * (xf * BdS).sum(-1)
    last = torch.zeros_like(e)
    last[..., -1] = e.sum(-1)
    dseg = G.sum(-1) - G.sum(-2) - e + last
    return dX.to(x.dtype), dB.to(x.dtype), dC.to(x.dtype), dseg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_bwd_tol_admits_exact_and_rejects_faults(dtype, monkeypatch):
    """The exact result (f64, rounded to the operands' dtype) lies within
    `ssd_chunk_bwd_tol` of the plain version's, and in bf16 so does a
    result with the kernels' own roundings (A and dA o L in bf16, L by a
    prescaled exp2), which the bound charges and which breaks the bound
    without the charge for A's and dA o L's rounding; each planted fault
    breaks it (at the JAX tests' decay and at the slow decay, Q = 100: two
    key tiles)."""
    for step in (1.0, 0.02):
        ops = _ssd_case(np.random.default_rng(9), (2, 3), 2, 100, 16, 24, step, expanded=True,
                        dtype=dtype)
        want = ssd_chunk_bwd_ref(*ops)
        tols = tolerance.ssd_chunk_bwd_tol(*ops, want)
        exact = ssd_chunk_bwd_ref(*(t.double() for t in ops))
        for e, w, tol in zip(exact, want, tols):
            ok, err, ratio = tolerance.check(e.to(w.dtype), w, tol)
            assert ok, (step, err, ratio)
        if dtype == torch.bfloat16:
            kernel_like = _kernel_numerics_bwd(*ops)
            for g, w, tol in zip(kernel_like, want, tols):
                ok, err, ratio = tolerance.check(g, w, tol)
                assert ok, ("the kernels' roundings", step, err, ratio)
            with monkeypatch.context() as m:   # the bound less the rounding charge
                m.setattr(tolerance, "_rounds", lambda dt: 0.0)
                bare = tolerance.ssd_chunk_bwd_tol(*ops, want)
            assert not all(tolerance.check(g, w, tol)[0]
                           for g, w, tol in zip(kernel_like[:3], want, bare)), step
        for fault in FAULTS:
            got = _faulty_bwd(*ops, fault)
            assert not all(tolerance.check(g, w, tol)[0] for g, w, tol in zip(got, want, tols)), \
                (fault, step)
