"""The port's SSM serving path (mamba2, zamba2) against the JAX package.

Inputs come from numpy seeds and reach both packages as the same arrays;
params are made by the JAX package and converted (`params_from_jax`).  On
CPU tensors the port's `ssd_chunk` runs its plain version; the JAX side's
kernel runs in Pallas interpret mode (`repro.kernels.ssd_chunk`), as its own
tests run it.  Tolerances, and why:
  * the SSD op, port vs the Pallas kernel: `tolerance.ssd_chunk_tol`, the
    bound the CUDA kernel is held to — both sides compute in f32 in
    another order (and exp on another library) and round the outputs once;
  * apply_ssm / decode_ssm / the LM logits at f32: 2e-5 to 5e-5 — every
    sum runs in f32 in another order; the inter-chunk recurrence is a
    sequential loop here and an associative scan in JAX (the same products
    grouped otherwise);
  * at bf16 the port keeps f32 inside the SSD op where the JAX model
    rounds C B^T, C B^T o L and the decay to bf16 (ROADMAP queue 3): the
    two differ by bf16 roundings, bounded in
    `test_apply_ssm_bf16_rounding_difference`;
  * greedy tokens: identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.kernels.ssd.ops import ssd_chunk as jax_ssd_chunk
from repro.models import apply_lm as jax_apply_lm
from repro.models import init_caches as jax_init_caches
from repro.models import init_lm as jax_init_lm
from repro.models.ssm import apply_ssm as jax_apply_ssm
from repro.models.ssm import decode_ssm as jax_decode_ssm
from repro.serving.serve_step import greedy_generate as jax_greedy_generate
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import _build, tolerance
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ops import ssd_chunk
from repro_torch.kernels.ssd.ref import ssd_chunk_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import apply_lm, init_caches, init_lm
from repro_torch.models.blocks import tree_index
from repro_torch.models.convert import params_from_jax
from repro_torch.models.ssm import apply_ssm, decode_ssm
from repro_torch.serving.engine import Engine
from repro_torch.serving.serve_step import greedy_generate, make_decode_step, make_prefill_step

ARCHS = ("mamba2-780m", "zamba2-2.7b")
TOL = dict(atol=2e-5, rtol=2e-5)
LOGITS_TOL = dict(atol=5e-5, rtol=5e-5)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(jax cfg, jax params, port cfg, port params) on the arch's smoke config."""
    jcfg = jax_get_smoke_config(request.param)
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(request.param)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_get_smoke_config("mamba2-780m")
    jparams = jax_init_lm(jax.random.PRNGKey(1), jcfg)
    cfg = get_smoke_config("mamba2-780m")
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


# --- the SSD op -------------------------------------------------------------------------

# Decrements of seg per step: the JAX kernel's tests draw them in [0, 1), a
# decay of about e^-0.5 per step, under which a key 65 steps back weighs
# at most e^-32 -- no fault in a key tile below the diagonal's neighbour
# can show.  A trained Mamba2 has dt in about [1e-3, 1e-1]; SLOW_DECAY
# draws them in [0, 0.02), so the whole chunk counts (e^-5 over 256 steps).
SLOW_DECAY = 0.02


def _ssd_inputs(rng, bh, nc, Q, P, N, step=1.0):
    x, B, C = (_np(rng, (bh, nc, Q, d), 0.5) for d in (P, N, N))
    seg = -np.cumsum(rng.uniform(0.0, step, size=(bh, nc, Q)), axis=-1).astype(np.float32)
    return x, B, C, seg


@pytest.mark.parametrize("bh,nc,Q,P,N", [
    (4, 3, 32, 16, 16), (2, 2, 64, 32, 64), (1, 4, 128, 64, 128), (2, 1, 256, 64, 128),
    (3, 2, 100, 24, 40),     # a ragged chunk (a prompt shorter than ssm_chunk)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_matches_jax_kernel(bh, nc, Q, P, N, dtype):
    """At the JAX tests' decay and at SLOW_DECAY, where every key tile of
    the chunk weighs in Y and every row in S."""
    rng = np.random.default_rng(Q + P)
    for step in (1.0, SLOW_DECAY):
        x, B, C, seg = _ssd_inputs(rng, bh, nc, Q, P, N, step)
        jd = jnp.dtype(dtype)
        want = jax_ssd_chunk(*(jnp.asarray(a, jd) for a in (x, B, C)), jnp.asarray(seg),
                             interpret=True)
        td = getattr(torch, dtype)
        xt, Bt, Ct = (_t(a).to(td) for a in (x, B, C))
        got = ssd_chunk(xt, Bt, Ct, _t(seg))
        tols = tolerance.ssd_chunk_tol(xt, Bt, Ct, _t(seg), got)
        for g, w, tol in zip(got, want, tols):
            assert g.dtype == td
            ok, err, ratio = tolerance.check(_t(np.asarray(w.astype(jnp.float32))), g, tol)
            assert ok, (err, ratio, step)


def test_ssd_chunk_takes_the_models_strided_views():
    """Leading dims (b, groups, heads per group), B and C expanded over the
    heads of a group, x a permuted view: the same numbers as the (bh, ...)
    layout with the repeat materialised."""
    rng = np.random.default_rng(3)
    b, nc, Q, g, hg, P, N = 2, 3, 16, 2, 3, 8, 16
    x = _t(_np(rng, (b, nc, Q, g, hg, P)))
    Bg, Cg = _t(_np(rng, (b, nc, Q, g, N))), _t(_np(rng, (b, nc, Q, g, N)))
    seg = _t(-np.cumsum(rng.uniform(size=(b, nc, Q, g, hg)), axis=2).astype(np.float32))
    heads = lambda t: t.permute(0, 3, 4, 1, 2, *range(5, t.dim()))  # noqa: E731
    expand = lambda t: heads(t[:, :, :, :, None].expand(b, nc, Q, g, hg, N))  # noqa: E731
    y, s = ssd_chunk(heads(x), expand(Bg), expand(Cg), heads(seg))
    flat = lambda t: t.reshape(b * g * hg, *t.shape[3:])  # noqa: E731
    y1, s1 = ssd_chunk_ref(flat(heads(x).contiguous()), flat(expand(Bg).contiguous()),
                           flat(expand(Cg).contiguous()), flat(heads(seg).contiguous()))
    torch.testing.assert_close(flat(y), y1, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(flat(s), s1, atol=1e-6, rtol=1e-6)


def test_ssd_chunk_grad_on_the_card_path_takes_the_function(monkeypatch):
    """Under autograd a tensor bound for the kernel goes through `_SSDChunk`:
    its forward launches the SSD kernel and its backward the backward kernel
    (both stubbed here by their plain versions, counted), with the same
    gradients as the CPU's path through the same Function."""
    ins = [_t(a) for a in _ssd_inputs(np.random.default_rng(4), 2, 2, 16, 8, 8)]

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, s = ssd_chunk(*leaves)
        (y.sum() + 2.0 * s.sum()).backward()
        return [t.grad for t in leaves]
    want = grads()
    assert all(g is not None and torch.isfinite(g).all() for g in want)
    calls = []

    def stub(name, fn):
        def f(*args):
            calls.append(name)
            return fn(*args)
        monkeypatch.setattr(ssd_ops, name, f)
    stub("_ssd_chunk_cuda", ssd_chunk_ref)
    stub("_ssd_chunk_bwd_cuda", ssd_ops.ssd_chunk_bwd_ref)
    monkeypatch.setattr(_build, "dispatch_device", lambda what, t: "cuda")
    got = grads()
    assert calls == ["_ssd_chunk_cuda", "_ssd_chunk_bwd_cuda"]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    with torch.no_grad():                         # no gradient recorded: the kernel alone
        ssd_chunk(*(t.clone().requires_grad_(True) for t in ins))
    assert calls[2:] == ["_ssd_chunk_cuda"]


# --- the kernel's launch -----------------------------------------------------------------

def _strides(lead, nc, Q, d, expanded):
    """Element strides (three leading dims, the chunk, the row) of a
    contiguous (*lead, nc, Q, d) tensor, or of one expanded over the heads
    (l2) from (l0, l1, 1, nc, Q, d)."""
    l0, l1, l2 = lead
    if expanded:
        return (l1 * nc * Q * d, nc * Q * d, 0, Q * d, d)
    return (l1 * l2 * nc * Q * d, l2 * nc * Q * d, nc * Q * d, Q * d, d)


@pytest.mark.parametrize("lead,nc,Q,N,P,expanded", [
    ((4, 1, 48), 4, 256, 128, 64, True),     # mamba2-780m's prefill
    ((4, 1, 80), 4, 256, 64, 64, True),      # zamba2-2.7b's
    ((2, 1, 13), 1, 256, 128, 64, True),     # a head count no slab size divides
    ((1, 2, 3), 2, 256, 128, 64, True),      # two groups
    ((2, 1, 3), 2, 40, 16, 16, True),        # the smoke shape
    ((1, 1, 6), 3, 77, 130, 20, True),       # N past 128, P off the grid
    ((1, 1, 4), 2, 300, 256, 128, True),     # Q > 256: more score tiles than a block keeps
    ((1, 1, 192), 4, 256, 128, 64, False),   # the flat (bh, ...) layout
    ((4, 1, 1), 4, 256, 128, 64, True),      # one head a group
])
def test_ssd_launch_shape(lead, nc, Q, N, P, expanded):
    """The bf16 kernel's launch (`launch_shape`): C B^T shared by a slab of
    min(heads, HEADS) heads wherever B and C have stride 0 over the heads
    and Q <= 256, else one head a warpgroup, two a block where they fit (the
    per-head route); the grid of S units (128 state rows) and query tiles x
    chunks x l0 l1 x slabs; shared memory within the card's 227 KB a block,
    and two blocks an SM at the two models' prefill shapes."""
    l0, l1, l2 = lead
    st = _strides(lead, nc, Q, N, expanded)
    shape = ssd_ops.launch_shape(lead, nc, st, st, Q, N, P)
    shared = expanded and l2 > 1 and Q <= 256
    assert shape.shared == shared
    two = ssd_ops._smem(N, shape.width, -(-Q // 64), False, 2) <= ssd_ops.MAX_SMEM
    assert shape.heads == (min(l2, ssd_ops.HEADS) if shared else min(l2, 2 if two else 1))
    assert shape.width == next(w for w in (16, 32, 64, 128) if P <= w)
    slabs = -(-l2 // shape.heads)
    assert shape.grid == (-(-N // 128) + -(-Q // 64)) * nc * l0 * l1 * slabs
    assert shape.smem <= 232448
    if shared and (N, P, Q) in ((128, 64, 256), (64, 64, 256)):
        assert 2 * (shape.smem + 1024) <= 228 * 1024
    # B shared but not C (or the reverse): the scores differ by head
    if shared:
        own = _strides(lead, nc, Q, N, False)
        for b_st, c_st in ((st, own), (own, st)):
            per_head = ssd_ops.launch_shape(lead, nc, b_st, c_st, Q, N, P)
            assert not per_head.shared and per_head.heads == min(l2, 2 if two else 1)
    # a forced slab, as tuning/ssd_tiles.py sweeps it
    assert ssd_ops.launch_shape(lead, nc, st, st, Q, N, P, heads=3).heads == (
        min(l2, 3) if shared else shape.heads)


@pytest.mark.parametrize("lead,nc,Q,N,P,expanded", [
    ((4, 1, 48), 4, 256, 128, 64, True),     # mamba2-780m's training shape
    ((4, 1, 80), 4, 256, 64, 64, True),      # zamba2-2.7b's
    ((1, 1, 13), 1, 256, 128, 64, True),     # a head count the slab does not divide
    ((1, 2, 3), 2, 256, 128, 64, True),      # two groups
    ((2, 1, 3), 2, 40, 16, 16, True),        # the smoke shape
    ((1, 1, 4), 2, 300, 128, 64, True),      # Q > 256: more score tiles than a block keeps
    ((1, 1, 192), 4, 256, 128, 64, False),   # the flat (bh, ...) layout
    ((1, 1, 3), 1, 256, 256, 128, True),     # the widest: shared scores do not fit
    ((1, 1, 4), 2, 130, 160, 96, True),      # two column slices of each output
])
def test_ssd_bwd_launch_shape(lead, nc, Q, N, P, expanded):
    """The bf16 backward's launch (`bwd_launch_shape`): scores shared by a
    slab of min(heads, BWD_HEADS) heads wherever B and C have stride 0 over
    the heads, Q <= 256 and the shared tiles fit; else one head a
    warpgroup, two a block where they fit; the grid of tiles x column slices
    x chunks x l0 l1 x slabs (per kernel); the larger kernel's shared
    memory, within the card's 227 KB; the flat layout of the same shape
    takes the per-head route."""
    l0, l1, l2 = lead
    st = _strides(lead, nc, Q, N, expanded)
    shape = ssd_ops.bwd_launch_shape(lead, nc, st, st, Q, N, P)
    nqt = -(-Q // 64)
    fits = max(ssd_ops.bwd_smem(Q, P, N, True, 2)) <= ssd_ops.MAX_SMEM
    shared = expanded and l2 > 1 and nqt <= 4 and fits
    assert shape.shared == shared
    two = max(ssd_ops.bwd_smem(Q, P, N, False, 2)) <= ssd_ops.MAX_SMEM
    assert shape.heads == (min(l2, ssd_ops.BWD_HEADS) if shared else min(l2, 2 if two else 1))
    px, nb = -(-P // 64) * 64, -(-N // (64 if N <= 64 else 128)) * (64 if N <= 64 else 128)
    slices = max(px // 64, nb // (64 if N <= 64 else 128))
    assert shape.width == px
    assert shape.grid == nqt * slices * nc * l0 * l1 * -(-l2 // shape.heads)
    assert shape.smem == max(ssd_ops.bwd_smem(Q, P, N, shared, min(shape.heads, 2)))
    assert shape.smem <= 232448
    flat = ssd_ops.bwd_launch_shape((1, 1, l0 * l1 * l2), nc, _strides((1, 1, l0 * l1 * l2), nc, Q,
                                    N, False), _strides((1, 1, l0 * l1 * l2), nc, Q, N, False),
                                    Q, N, P)
    assert not flat.shared and flat.heads == min(l0 * l1 * l2, 2 if two else 1)
    # a forced slab, as tuning/ssd_bwd_tiles.py sweeps it
    assert ssd_ops.bwd_launch_shape(lead, nc, st, st, Q, N, P, heads=3).heads == (
        min(l2, 3) if shared else shape.heads)


def test_ssd_bwd_launch_fits_every_ssm_config():
    """Every registered SSM or hybrid config's backward shape (its chunk,
    head dim and state) launches within the card's shared memory, with the
    scores shared at the model's expanded B and C, in bf16 and in f32."""
    from repro_torch.configs.registry import get_config, list_archs
    cfgs = [get_config(a) for a in list_archs()]
    cfgs = [c for c in cfgs if c.family in ("ssm", "hybrid")]
    assert {c.name for c in cfgs} >= {"mamba2-780m", "zamba2-2.7b"}
    for c in cfgs:
        Q, P, N, nh = c.ssm_chunk, c.ssm_head_dim, c.ssm_state, c.ssm_nheads
        st = _strides((4, 1, nh), 1, Q, N, True)
        shape = ssd_ops.bwd_launch_shape((4, 1, nh), 1, st, st, Q, N, P)
        assert shape.smem <= 232448, (c.name, shape)
        assert shape.shared == (nh > 1 and Q <= 256), (c.name, shape)
        assert ssd_ops.bwd_smem_f32(N, P) <= 232448, c.name


@pytest.mark.parametrize("shape,index,d,want", [
    ((4, 64), (slice(None), slice(None)), 64, 16),          # whole 16-byte rows
    ((4, 68), (slice(None), slice(0, 64)), 64, 2),          # 136-byte row stride
    ((4, 72), (slice(None), slice(0, 20)), 20, 2),          # 40-byte rows
    ((4, 65), (slice(None), slice(0, 64)), 64, 2),          # odd row stride
    ((4, 72), (slice(None), slice(1, 65)), 64, 2),          # base one element in
])
def test_ssd_copy_width(shape, index, d, want):
    """The kernel's copies for a bf16 operand: 16 bytes where every row's
    start (base and row stride) and its d elements lie in whole 16-byte
    copies, else element by element."""
    t = torch.zeros(shape, dtype=torch.bfloat16)[index]
    assert ssd_ops.copy_width(t, t.stride()[:-1], d) == want


# --- the tolerance ----------------------------------------------------------------------

def _ssd_faults(x, B, C, seg):
    """(exact f64 result, and the faulty results: one 64-key tile dropped
    for every query, one chunk's state dropped, the causal mask shifted by
    one; where Q > 192, key tile [0, 64) dropped for query rows [192, 256)
    only, and S summed without its first 64 rows)."""
    xd, Bd, Cd, sd = (t.double() for t in (x, B, C, seg))
    Q = x.shape[-2]
    live = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    L = torch.exp(torch.where(live, sd[..., :, None] - sd[..., None, :], -torch.inf))
    cb = torch.einsum("...qn,...kn->...qk", Cd, Bd)
    decay = torch.exp(sd[..., -1:] - sd)
    exact = (torch.einsum("...qk,...kp->...qp", cb * L, xd),
             torch.einsum("...qn,...qp->...np", Bd, xd * decay[..., None]))
    x_drop = x.clone()
    x_drop[:, :, :64] = 0                  # keys [0, 64) of every chunk
    y_drop, s_first = ssd_chunk_ref(x_drop, B, C, seg)
    y_ok, s_ok = ssd_chunk_ref(x, B, C, seg)
    s_drop = s_ok.clone()
    s_drop[:, 1] = 0
    cb = torch.einsum("...qn,...kn->...qk", C.float(), B.float())

    def y_masked(live):
        L = torch.exp(torch.where(live, seg[..., :, None] - seg[..., None, :], -1e30))
        return torch.einsum("...qk,...kp->...qp", cb * L, x.float()).to(x.dtype)
    faults = {"dropped key tile": (y_drop, s_ok), "dropped chunk state": (y_ok, s_drop),
              "shifted mask": (y_masked(torch.tril(live, diagonal=-1)), s_ok)}
    if Q > 192:
        far = live.clone()
        far[192:, :64] = False
        faults["far key tile of rows 192-255"] = (y_masked(far), s_ok)
        faults["S without its first key tile"] = (y_ok, s_first)
    return exact, faults


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_tol_admits_the_exact_result_and_catches_faults(dtype):
    """At the JAX tests' fast decay (Q = 100) and at SLOW_DECAY (Q = 256),
    where a fault in a key tile far below the diagonal, or in S's first
    rows, must show too."""
    for rng, shape, step in ((np.random.default_rng(5), (3, 2, 100, 24, 40), 1.0),
                             (np.random.default_rng(6), (3, 2, 256, 24, 40), SLOW_DECAY)):
        x, B, C, seg = (_t(a) for a in _ssd_inputs(rng, *shape, step))
        x, B, C = (t.to(dtype) for t in (x, B, C))
        want = ssd_chunk_ref(x, B, C, seg)
        tols = tolerance.ssd_chunk_tol(x, B, C, seg, want)
        exact, faults = _ssd_faults(x, B, C, seg)
        for e, w, tol in zip(exact, want, tols):
            assert tolerance.check(e.to(dtype), w, tol)[0]
        for name, fault in faults.items():
            assert not all(tolerance.check(f, w, tol)[0]
                           for f, w, tol in zip(fault, want, tols)), (name, step)


# --- the model ---------------------------------------------------------------------------

def _layer(jparams, params, layer=0):
    return (jax.tree.map(lambda t: t[layer], jparams["seg0"]["ssm"]),
            tree_index(params["seg0"]["ssm"], layer))


def slow_decay_dt_bias(shape, seed):
    """dt_bias with softplus(dt_bias) log-uniform in [1e-3, 1e-1], as a
    trained Mamba2's dt (at random init dt_bias = 0 gives dt ~ 0.7, which
    decays the state within a few steps and hides the chunk handoff)."""
    u = np.exp(np.random.default_rng(seed).uniform(np.log(1e-3), np.log(1e-1), size=shape))
    return np.log(np.expm1(u)).astype(np.float32)


@pytest.mark.parametrize("decay", ["random_init", "slow"])
@pytest.mark.parametrize("s", [20, 32, 70])         # shorter than, equal to, past a chunk
@pytest.mark.parametrize("linear_impl", ["jnp", "fused"])
def test_apply_ssm_matches_jax(mamba, s, linear_impl, decay):
    jcfg, jparams, cfg, params = mamba
    cfg = dataclasses.replace(cfg, linear_impl=linear_impl)
    jp, p = _layer(jparams, params)
    if decay == "slow":   # both packages' layer, one numpy draw
        bias = slow_decay_dt_bias(tuple(p["dt_bias"].shape), seed=s)
        jp, p = {**jp, "dt_bias": jnp.asarray(bias)}, {**p, "dt_bias": _t(bias)}
    rng = np.random.default_rng(s)
    x = _np(rng, (2, s, cfg.d_model))
    state = _np(rng, (2, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_head_dim), 0.1)
    want, (jst, jtails) = jax_apply_ssm(jp, jnp.asarray(x), jcfg, state=jnp.asarray(state))
    got, (st, tails) = apply_ssm(p, _t(x), cfg, state=_t(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    for k, v in jtails.items():
        np.testing.assert_allclose(tails[k].numpy(), np.asarray(v), **TOL)


def test_decode_ssm_after_prefill_matches_jax(mamba):
    """Prefill's final state and conv tails hand off to one recurrent step."""
    jcfg, jparams, cfg, params = mamba
    jp, p = _layer(jparams, params, 1)
    rng = np.random.default_rng(9)
    x, x1 = _np(rng, (3, 45, cfg.d_model)), _np(rng, (3, 1, cfg.d_model))
    _, (jst, jtails) = jax_apply_ssm(jp, jnp.asarray(x), jcfg)
    want, jnew = jax_decode_ssm(jp, jnp.asarray(x1), jcfg, {"state": jst, **jtails})
    _, (st, tails) = apply_ssm(p, _t(x), cfg)
    got, new = decode_ssm(p, _t(x1), cfg, {"state": st, **tails})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k, v in jnew.items():
        np.testing.assert_allclose(new[k].numpy(), np.asarray(v), **TOL)


def test_apply_ssm_bf16_rounding_difference(mamba):
    """The one numerical difference from the JAX model: at bf16 it rounds
    C B^T, C B^T o L and the decay to bf16 before its products, the port
    (its SSD op and kernel) keeps them in f32.  Both bf16 outputs lie
    within bf16 roundings of the f32 result, the port no farther than JAX
    (it reads 6.9e-3 against JAX's 7.7e-3 here), and 1e-2 relative (norm)
    of each other (6.0e-3 here)."""
    jcfg, jparams, cfg, params = mamba
    jp, p = _layer(jparams, params)
    x = _np(np.random.default_rng(11), (2, 70, cfg.d_model))
    ref = np.asarray(jax_apply_ssm(jp, jnp.asarray(x), jcfg)[0])
    bf = dataclasses.replace(jcfg, dtype="bfloat16")
    want = np.asarray(jax_apply_ssm(jax.tree.map(lambda t: t.astype(jnp.bfloat16)
                                                 if t.ndim == 2 else t, jp),
                                    jnp.asarray(x, jnp.bfloat16), bf)[0].astype(jnp.float32))
    pb = {k: (v.to(torch.bfloat16) if k.startswith(("in_", "out_")) else v) for k, v in p.items()}
    got = apply_ssm(pb, _t(x).to(torch.bfloat16), cfg)[0].float().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    assert rel(got, want) < 1e-2, rel(got, want)
    assert rel(got, ref) <= 1.1 * rel(want, ref), (rel(got, ref), rel(want, ref))


def test_lm_logits_prefill_then_decode_match_jax(smoke):
    """Prefill logits (s = 45, past a chunk of 32) and one decode step from
    the caches, against JAX; the caches too."""
    jcfg, jparams, cfg, params = smoke
    cfg = dataclasses.replace(cfg, linear_impl="fused")
    rng = np.random.default_rng(12)
    b, s, s_max = 2, 45, 48
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    want, jc, _ = jax_apply_lm(jparams, jnp.asarray(toks), jcfg,
                               caches=jax_init_caches(jcfg, b, s_max, jnp.float32),
                               cache_index=0)
    caches = init_caches(cfg, b, s_max, torch.float32)
    got, caches = apply_lm(params, _t(toks), cfg, caches=caches, cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS_TOL)
    want, jc, _ = jax_apply_lm(jparams, jnp.asarray(nxt), jcfg, caches=jc, cache_index=s,
                               decode=True)
    got, caches = make_decode_step(cfg)(params, _t(nxt), caches, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1], **LOGITS_TOL)
    jleaves = dict(_leaves(jax.tree.map(np.asarray, {str(i): c for i, c in enumerate(jc)})))
    leaves = dict(_leaves({str(i): c for i, c in enumerate(caches)}))
    assert jleaves.keys() == leaves.keys()
    for k, v in jleaves.items():
        np.testing.assert_allclose(leaves[k].numpy(), v, err_msg=k, **TOL)


def test_prefill_decode_handoff(mamba):
    """One decode step after a prefill of s tokens gives the logits of a
    prefill of s + 1 (the handoff chip_smoke checks at full width)."""
    _, _, cfg, params = mamba
    toks = _t(np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32))
    full, _ = make_prefill_step(cfg, 41)(params, {"tokens": toks})
    _, caches = make_prefill_step(cfg, 41)(params, {"tokens": toks[:, :40]})
    step, _ = make_decode_step(cfg)(params, toks[:, 40:], caches, 40)
    np.testing.assert_allclose(step.numpy(), full.numpy(), **LOGITS_TOL)


def test_greedy_tokens_identical_to_jax(smoke):
    jcfg, jparams, cfg, params = smoke
    prompt = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    want = np.asarray(jax_greedy_generate(jparams, jcfg, jnp.asarray(prompt), 8))
    got = greedy_generate(params, dataclasses.replace(cfg, linear_impl="fused"),
                          _t(prompt), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_from_jax_consumes_every_leaf_and_keeps_f32_leaves(smoke):
    jcfg, jparams, cfg, params = smoke
    tree = jax.tree.map(np.asarray, jparams)
    assert len(jax.tree.leaves(tree)) == sum(1 for _ in _leaves(params))
    bf = params_from_jax(tree, cfg, "cpu", dtype=torch.bfloat16)
    for path, t in _leaves(bf):
        name = path.rsplit("/", 1)[-1]
        f32 = name in ("A_log", "D", "dt_bias", "scale") or name.startswith("conv_")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), path


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_bridge_shapes_without_allocating(arch):
    """At full width the port's init_lm (meta device) has the shapes of
    jax.eval_shape(init_lm), and params_from_jax consumes a tree of them."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda k: jax_init_lm(k, jcfg), jax.random.PRNGKey(0))
    want = {path: tuple(leaf.shape) for path, leaf in _leaves(jshapes)}
    got = {path: tuple(t.shape) for path, t in _leaves(init_lm(None, cfg, device="meta"))}
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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_ssm_families(arch):
    cfg = get_smoke_config(arch)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-based decoders"):
        Engine(params, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-based decoders"):
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--engine"])


def test_serve_launcher_runs_the_static_loop(capsys):
    serve_cli.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill: 4x32" in out and "decode:  3 steps" in out
