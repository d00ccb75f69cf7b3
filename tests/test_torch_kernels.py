"""Port kernel modules vs the JAX package's Pallas kernels (interpret mode).

The same inputs, made from a seed with numpy, go through the JAX wrapper in
interpret mode and the port's wrapper on CPU tensors (its plain PyTorch
version); f32 throughout.  Tolerance 3e-5 (abs and rel): both sides sum in
f32, in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ops import paged_decode as jax_paged_decode
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.fused_mlp.ops import fused_mlp_hidden as jax_fused_mlp_hidden
from repro.kernels.matmul.ops import matmul as jax_matmul
from repro_torch.kernels import _build, tolerance
from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_bwd,
                                                     flash_attention_fwd, paged_decode)
from repro_torch.kernels.flash_attention.ref import (attention_ref, flash_attention_bwd_ref,
                                                     flash_attention_ref, paged_decode_ref)
from repro_torch.kernels.fused_mlp.backward import fused_mlp_bwd_ref
from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd, fused_mlp_hidden
from repro_torch.kernels.fused_mlp.ref import ACTS, DACTS, fused_mlp_hidden_ref
from repro_torch.kernels.matmul.ops import (BLOCK_K, TILES, launch_shape, matmul, pick_tile,
                                           split_k, transposed)
from repro_torch.kernels.matmul.ref import matmul_ref

TOL = dict(atol=3e-5, rtol=3e-5)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(37, 70, 45), (64, 128, 200), (1, 33, 7), (130, 256, 64)])
def test_matmul_vs_jax(m, k, n):
    rng = np.random.default_rng(0)
    a, b = _np(rng, (m, k)), _np(rng, (k, n), k ** -0.5)
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_matmul_flattens_leading_dims():
    rng = np.random.default_rng(1)
    a, b = _np(rng, (2, 5, 24)), _np(rng, (24, 40))
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2, 5, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,k,n", [(37, 70, 45), (64, 128, 200), (130, 33, 64)])
@pytest.mark.parametrize("grad", ["dgrad", "wgrad"])
def test_matmul_transposed_vs_jax(grad, m, k, n):
    """The linear backward's GEMMs on transposed views: dgrad g @ w^T and
    wgrad x^T @ g (JAX's models/linear.py:90-93)."""
    rng = np.random.default_rng(4)
    x, w, g = _np(rng, (m, k)), _np(rng, (k, n), k ** -0.5), _np(rng, (m, n))
    if grad == "dgrad":
        want = np.asarray(jax_matmul(jnp.asarray(g), jnp.asarray(w).T, interpret=True))
        got = matmul(torch.from_numpy(g), torch.from_numpy(w).T)
    else:
        want = np.asarray(jax_matmul(jnp.asarray(x).T, jnp.asarray(g), interpret=True))
        got = matmul(torch.from_numpy(x).T, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_matmul_second_pair_sums_into_one_product():
    rng = np.random.default_rng(5)
    a, a1, b, b1 = (torch.from_numpy(_np(rng, s)) for s in ((9, 40), (9, 40), (40, 70), (40, 70)))
    got = matmul(a, b.T.contiguous().T, a1, b1)
    np.testing.assert_allclose(got.numpy(), (a @ b + a1 @ b1).numpy(), **TOL)


def test_operand_layouts():
    """Row-major and transposed views are taken in place; other strides raise."""
    w = torch.zeros(8, 16)
    assert transposed("t", w) is False
    assert transposed("t", w.T) is True
    assert transposed("t", torch.zeros(1, 5).T) is False   # both layouts at once
    with pytest.raises(ValueError, match="transposed views"):
        transposed("t", torch.zeros(16, 16)[:, ::2])


@pytest.mark.parametrize("m,n,k", [(64, 2048, 2048), (64, 1024, 2048), (64, 2048, 8192),
                                   (64, 92544, 2048), (3, 5, 7), (64, 64, 100),
                                   (4096, 2048, 2048), (4096, 1024, 2048), (2048, 1024, 4096),
                                   (8192, 2048, 4096), (4096, 92544, 2048), (130, 96, 4096),
                                   (65, 45, 4100), (129, 200, 70)])
def test_split_k_covers_k(m, n, k):
    """The split of k for the tile the wrapper picks: 64 x 128 at most 64
    rows, 128 rows above."""
    bm, bn = pick_tile(m)
    assert (bm, bn) in TILES and (bm == 64) == (m <= 64)
    ks = split_k(m, n, k, num_sms=132)
    assert ks == split_k(m, n, k, num_sms=132, tile=(bm, bn))
    splits = -(-k // ks)
    assert ks % BLOCK_K == 0 and ks > 0
    assert (splits - 1) * ks < k <= splits * ks       # every split non-empty
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= 132:
        assert splits == 1                            # the output alone fills the card
    if bm == 128:
        assert tiles * splits <= max(tiles, 132)      # no second, partial wave from splitting


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(19, 72, 200), (64, 128, 256)])
def test_fused_mlp_vs_jax(mlp_type, m, h, f):
    rng = np.random.default_rng(2)
    x, wg, wu = _np(rng, (m, h)), _np(rng, (h, f), h ** -0.5), _np(rng, (h, f), h ** -0.5)
    want = np.asarray(jax_fused_mlp_hidden(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), mlp_type=mlp_type, interpret=True))
    got = fused_mlp_hidden(torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
                           mlp_type=mlp_type).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("s_max,g", [(72, 2), (200, 3), (128, 1)])
def test_paged_decode_vs_jax(s_max, g):
    """Permuted slot_idx, dead slots (length 0) and pool depths that 128
    does not divide."""
    rng = np.random.default_rng(3)
    slots, nkv, d, b = 9, 2, 32, 6
    q = _np(rng, (b, nkv * g, d), 0.5)
    kp, vp = _np(rng, (slots, s_max, nkv, d), 0.5), _np(rng, (slots, s_max, nkv, d), 0.5)
    slot_idx = np.asarray([4, 0, 8, 2, 7, 1], np.int32)
    lengths = np.asarray([17, 0, s_max, 1, 65, 0], np.int32)
    want = np.asarray(jax_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.asarray(slot_idx), jnp.asarray(lengths),
                                       interpret=True))
    got = paged_decode(*(torch.from_numpy(t) for t in (q, kp, vp, slot_idx, lengths))).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[[1, 5]] == 0.0)


# flash attention: (b, sq, skv, a, nkv, d, causal).  Causal cases keep
# sq == skv (training); non-causal ones cover sq != skv.  Lengths are not
# multiples of 128 (the JAX kernels pad to it; the port masks).  Head dims
# 20, 40, 80 and 192 are the misaligned ones of gpt3-2.7b's C0-C1, zamba2
# and nemotron-4 (the CUDA kernels pad them in shared memory).
FLASH_CASES = [(2, 72, 72, 4, 4, 32, True), (1, 200, 200, 4, 2, 16, True),
               (2, 40, 90, 8, 2, 32, False), (1, 130, 61, 4, 1, 16, False),
               (1, 70, 70, 4, 1, 20, True), (1, 50, 90, 4, 2, 40, False),
               (1, 65, 65, 8, 2, 80, True), (1, 40, 40, 2, 1, 192, False)]


def _flash_inputs(rng, b, sq, skv, a, nkv, d):
    return (_np(rng, (b, sq, a, d)), _np(rng, (b, skv, nkv, d)), _np(rng, (b, skv, nkv, d)),
            _np(rng, (b, sq, a, d)))


def _fold(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.parametrize("b,sq,skv,a,nkv,d,causal", FLASH_CASES)
def test_flash_forward_vs_jax(b, sq, skv, a, nkv, d, causal):
    """Output against JAX's wrapper, lse against the Pallas kernel's residual
    (folded, padded to its 128 blocks, kv_len masking the pad), GQA g = a /
    nkv in {1, 2, 4}."""
    rng = np.random.default_rng(6)
    q, k, v, _ = _flash_inputs(rng, b, sq, skv, a, nkv, d)
    want = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, interpret=True))
    pad = lambda x, s: np.pad(_fold(x), ((0, 0), (0, -(-s // 128) * 128 - s), (0, 0)))  # noqa: E731
    _, lse_want = flash_attention_pallas(
        jnp.asarray(pad(q, sq)), jnp.asarray(pad(k, skv)), jnp.asarray(pad(v, skv)),
        causal=causal, kv_len=skv, return_residuals=True, interpret=True)
    out, lse = flash_attention_fwd(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want)[:, :sq].reshape(b, a, sq),
                               **TOL)
    assert torch.equal(flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                       causal=causal), out)


@pytest.mark.parametrize("b,sq,skv,a,nkv,d,causal", FLASH_CASES)
def test_flash_backward_vs_jax(b, sq, skv, a, nkv, d, causal):
    """dq, dk, dv against jax.vjp of JAX's flash attention (its Pallas
    backward kernels in interpret mode): through the port's autograd.Function
    and through `flash_attention_bwd` directly."""
    rng = np.random.default_rng(7)
    q, k, v, do = _flash_inputs(rng, b, sq, skv, a, nkv, d)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_attention(q_, k_, v_, causal=causal,
                                                           interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    flash_attention(tq, tk, tv, causal=causal).backward(torch.from_numpy(do))
    out, lse = flash_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    direct = flash_attention_bwd(*(torch.from_numpy(t) for t in (q, k, v)), out, lse,
                                 torch.from_numpy(do), causal=causal)
    for name, g, dg, w in zip("qkv", (tq.grad, tk.grad, tv.grad), direct, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}", atol=1e-4, rtol=1e-4)
        assert torch.equal(g, dg), f"d{name}"


@pytest.mark.parametrize("causal,sq,skv", [(True, 50, 50), (True, 30, 70), (False, 30, 70)])
def test_attention_ref_vs_jax(causal, sq, skv):
    """The port's copy of the JAX oracle, bottom-right causal mask and all."""
    rng = np.random.default_rng(8)
    q, k, v = _np(rng, (4, sq, 16)), _np(rng, (2, skv, 16)), _np(rng, (2, skv, 16))
    want = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal))
    got = attention_ref(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if sq == skv:   # the kernels' top-left mask agrees where sq == skv
        fo, _ = flash_attention_ref(*(torch.from_numpy(t[None].transpose(0, 2, 1, 3))
                                      for t in (q, k, v)), causal=causal)
        np.testing.assert_allclose(fo[0].transpose(0, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(19, 72, 200), (64, 128, 256)])
def test_fused_mlp_backward_vs_jax(mlp_type, m, h, f):
    """(dx, dwg, dwu) against jax.vjp of JAX's fused MLP hidden (its Pallas
    backward kernels in interpret mode), through `fused_mlp_bwd` and the
    port's autograd.Function."""
    rng = np.random.default_rng(9)
    x, wg, wu = _np(rng, (m, h)), _np(rng, (h, f), h ** -0.5), _np(rng, (h, f), h ** -0.5)
    dh = _np(rng, (m, f))
    gated = mlp_type == "swiglu"
    if gated:
        _, vjp = jax.vjp(lambda a, b, c: jax_fused_mlp_hidden(a, b, c, mlp_type=mlp_type,
                                                             interpret=True),
                         jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    else:
        _, vjp = jax.vjp(lambda a, c: jax_fused_mlp_hidden(a, None, c, mlp_type=mlp_type,
                                                          interpret=True),
                         jnp.asarray(x), jnp.asarray(wu))
    want = [np.asarray(t) for t in vjp(jnp.asarray(dh))]
    tx, twg, twu = (torch.from_numpy(t).requires_grad_(True) for t in (x, wg, wu))
    fused_mlp_hidden(tx, twg, twu, mlp_type=mlp_type).backward(torch.from_numpy(dh))
    dx, dwg, dwu = fused_mlp_bwd(*(torch.from_numpy(t) for t in (x, wg, wu, dh)),
                                 mlp_type=mlp_type)
    got = [dx, dwg, dwu] if gated else [dx, dwu]
    grads = [tx.grad, twg.grad, twu.grad] if gated else [tx.grad, twu.grad]
    assert (twg.grad is None) == (not gated)
    for g, a, w in zip(got, grads, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        assert torch.equal(g, a)


def _tol_cases(dtype, rng):
    """Per kernel: (plain output, exact f64 result in dtype, a faulty result,
    the bound).  The fault is a kernel error the bound must catch: one k term
    dropped at a 32-wide tile edge, or the last live token of a row dropped."""
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    m, k, n = 64, 512, 96
    a, b = t(_np(rng, (m, k))), t(_np(rng, (k, n), k ** -0.5))
    b_drop = b.clone()
    b_drop[31] = 0
    want = matmul_ref(a, b)
    yield ("matmul", want, (a.double() @ b.double()).to(dtype), matmul_ref(a, b_drop),
           tolerance.matmul_tol(a, b, want))
    wg, wu = t(_np(rng, (k, n), k ** -0.5)), t(_np(rng, (k, n), k ** -0.5))
    wg_drop, wu_drop = wg.clone(), wu.clone()
    wg_drop[31], wu_drop[31] = 0, 0
    for mlp_type in ("swiglu", "gelu", "relu2"):
        act = ACTS[mlp_type]
        up = a.double() @ wu.double()
        exact = act(a.double() @ wg.double()) * up if mlp_type == "swiglu" else act(up)
        want = fused_mlp_hidden_ref(a, wg, wu, mlp_type)
        yield (f"fused_mlp {mlp_type}", want, exact.to(dtype),
               fused_mlp_hidden_ref(a, wg_drop, wu_drop, mlp_type),
               tolerance.fused_mlp_hidden_tol(a, wg, wu, mlp_type, want))
    slots, s_max, nkv, g, d = 9, 72, 2, 2, 64
    q = t(_np(rng, (6, nkv * g, d)))
    kp, vp = t(_np(rng, (slots, s_max, nkv, d))), t(_np(rng, (slots, s_max, nkv, d)))
    slot_idx = torch.tensor([4, 0, 8, 2, 7, 1], dtype=torch.int32)
    lengths = torch.tensor([17, 0, s_max, 2, 65, 40], dtype=torch.int32)
    kk, vv = (p[slot_idx.long()].transpose(1, 2).double() for p in (kp, vp))
    sc = torch.einsum("bhgd,bhsd->bhgs", q.double().reshape(6, nkv, g, d), kk) / d ** 0.5
    live = (torch.arange(s_max)[None] < lengths[:, None])[:, None, None]
    w = torch.softmax(torch.where(live, sc, -torch.inf), -1).nan_to_num(0.0)
    exact = torch.einsum("bhgs,bhsd->bhgd", w, vv).reshape(q.shape)
    want = paged_decode_ref(q, kp, vp, slot_idx, lengths)
    yield ("paged_decode", want, exact.to(dtype),
           paged_decode_ref(q, kp, vp, slot_idx, (lengths - 1).clamp_min(0)),
           tolerance.paged_decode_tol(q, kp, vp, slot_idx, lengths, want))
    yield from _tol_cases_grad(dtype, rng, t)


def _tol_cases_grad(dtype, rng, t):
    """The training slice's kernels: transposed matmul, the fused-MLP
    backward (a dropped k term) and flash attention forward and backward
    (the last key dropped; for dk and dv, the last query row's cotangent)."""
    m, k, n = 64, 512, 96
    g, w = t(_np(rng, (m, n))), t(_np(rng, (k, n), k ** -0.5))
    want = matmul_ref(g, w.T)
    w_drop = w.clone()
    w_drop[:, 31] = 0
    yield ("matmul dgrad", want, (g.double() @ w.double().T).to(dtype), matmul_ref(g, w_drop.T),
           tolerance.matmul_tol(g, w.T, want))
    x, wg, wu = t(_np(rng, (m, k))), t(_np(rng, (k, n), k ** -0.5)), t(_np(rng, (k, n), k ** -0.5))
    dh = t(_np(rng, (m, n)))
    x_drop = x.clone()
    x_drop[:, 31] = 0
    for mlp_type in ("swiglu", "gelu", "relu2"):
        act, dact = ACTS[mlp_type], DACTS[mlp_type]
        xd, wgd, wud, dhd = (a.double() for a in (x, wg, wu, dh))
        if mlp_type == "swiglu":
            gg, uu = xd @ wgd, xd @ wud
            dg, du = dhd * uu * dact(gg), dhd * act(gg)
            exact = (dg @ wgd.T + du @ wud.T, xd.T @ dg, xd.T @ du)
        else:
            du = dhd * dact(xd @ wud)
            exact = (du @ wud.T, None, xd.T @ du)
        want = fused_mlp_bwd_ref(x, wg, wu, dh, mlp_type)
        tols = tolerance.fused_mlp_bwd_tol(x, wg, wu, dh, mlp_type, want)
        faulty = fused_mlp_bwd_ref(x_drop, wg, wu, dh, mlp_type)
        for name, w_, e, f_, tl in zip(("dx", "dwg", "dwu"), want, exact, faulty, tols):
            if w_ is not None:
                yield (f"fused_mlp_bwd {mlp_type} {name}", w_, e.to(dtype), f_, tl)
    b, s, a, nkv, d = 2, 72, 4, 2, 32
    q, kk, vv, do = (t(x_) for x_ in _flash_inputs(rng, b, s, s, a, nkv, d))
    for causal in (True, False):
        want = flash_attention_ref(q, kk, vv, causal=causal)
        exact = flash_attention_ref(q.double(), kk.double(), vv.double(), causal=causal)
        faulty = flash_attention_ref(q, kk[:, :-1], vv[:, :-1], causal=causal)
        tols = tolerance.flash_attention_tol(q, kk, vv, want, causal=causal)
        for name, i in (("out", 0), ("lse", 1)):
            yield (f"flash {causal=} {name}", want[i], exact[i].to(want[i].dtype), faulty[i],
                   tols[i])
        o, lse = want
        gw = flash_attention_bwd_ref(q, kk, vv, o, lse, do, causal=causal)
        ge = flash_attention_bwd_ref(*(x_.double() for x_ in (q, kk, vv, o, lse, do)),
                                     causal=causal)
        do_drop = do.clone()
        do_drop[:, -1] = 0
        gf = (flash_attention_bwd_ref(q, kk[:, :-1], vv[:, :-1], o, lse, do, causal=causal)[0],
              *flash_attention_bwd_ref(q, kk, vv, o, lse, do_drop, causal=causal)[1:])
        tols = tolerance.flash_attention_bwd_tol(q, kk, vv, o, lse, do, gw, causal=causal)
        for name, w_, e, f_, tl in zip(("dq", "dk", "dv"), gw, ge, gf, tols):
            yield (f"flash_bwd {causal=} {name}", w_, e.to(dtype), f_, tl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_admits_any_order_and_catches_dropped_terms(dtype):
    """The kernel-vs-plain bound admits the exact result rounded to the
    output dtype (so any summation order passes), and rejects a kernel that
    drops one term of a sum or one live token."""
    for name, want, exact, faulty, tol in _tol_cases(dtype, np.random.default_rng(7)):
        ok, err, ratio = tolerance.check(exact, want, tol)
        assert ok, (name, err, ratio)
        ok, err, ratio = tolerance.check(faulty, want, tol)
        assert not ok, (name, err, ratio)


def test_tolerance_holds_dead_rows_to_zero():
    q, kp = torch.ones(2, 2, 8), torch.ones(2, 4, 1, 8)
    slot_idx, lengths = torch.tensor([0, 1]), torch.tensor([4, 0])
    want = paged_decode_ref(q, kp, kp, slot_idx, lengths)
    tol = tolerance.paged_decode_tol(q, kp, kp, slot_idx, lengths, want)
    assert torch.all(tol[1] == 0)
    bad = want.clone()
    bad[1, 0, 0] = 1e-30
    assert not tolerance.check(bad, want, tol)[0]


def test_cpu_runs_plain_versions_without_launching():
    counters = (matmul, fused_mlp_hidden, fused_mlp_bwd, paged_decode, flash_attention_fwd,
                flash_attention_bwd)
    before = [c.launches for c in counters]
    x = torch.ones(4, 8)
    matmul(x, torch.ones(8, 8))
    matmul(x.T, torch.ones(4, 8))
    fused_mlp_hidden(x, torch.ones(8, 16), torch.ones(8, 16))
    fused_mlp_bwd(x, torch.ones(8, 16), torch.ones(8, 16), torch.ones(4, 16))
    paged_decode(torch.ones(2, 2, 8), torch.ones(2, 4, 1, 8), torch.ones(2, 4, 1, 8),
                 torch.tensor([0, 1]), torch.tensor([4, 2]))
    q = torch.ones(1, 3, 2, 16, requires_grad=True)
    flash_attention(q, torch.ones(1, 3, 1, 16), torch.ones(1, 3, 1, 16)).sum().backward()
    assert [c.launches for c in counters] == before


def test_other_devices_raise():
    """No silent fallback: a device that is neither CPU nor CUDA raises."""
    a = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul(a, torch.empty(8, 8, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_mlp_hidden(a, None, torch.empty(8, 8, device="meta"), mlp_type="gelu")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_mlp_bwd(a, None, torch.empty(8, 8, device="meta"), torch.empty(4, 8, device="meta"),
                      mlp_type="gelu")
    qm = torch.empty(1, 3, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(qm, qm[:, :, :1], qm[:, :, :1])
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention_bwd(qm, qm, qm, qm, torch.empty(1, 2, 3, device="meta"), qm)


def test_build_is_lazy_and_keyed_by_sources():
    """Importing the kernels builds nothing; the library name hashes the
    sources and flags, so an edited source cannot load a stale build."""
    assert _build._LIBRARY is None or _build._LIBRARY.path.exists()
    names = {p.name for p in _build._sources()}
    assert {"matmul.cu", "fused_mlp.cu", "fused_mlp_bwd.cu", "flash_attention.cu",
            "paged_decode.cu", "gemm_tile.cuh", "gemm_sm90.cuh", "sm90.cuh"} <= names
    assert len(_build._digest()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS



def _gqa_archs():
    from repro_torch.configs.registry import get_config, list_archs
    return [n for n in list_archs() if get_config(n).attn_type == "gqa"]


@pytest.mark.parametrize("arch", _gqa_archs())
def test_registered_gqa_model_passes_the_kernels_shape_checks(arch):
    """Every registered GQA model's head dim and group size (80 for gpt3-2.7b
    and zamba2, 192 and g = 12 for nemotron-4, g = 12 for command-r-plus) are
    taken by the flash and paged-decode wrappers, over f32, bf16 and int8
    pools: the wrappers' own shape predicates, no launch.  MLA is not ported."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.ops import flash_shape_ok, paged_shape_ok
    cfg = get_config(arch)
    d, a, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    assert flash_shape_ok(d, a, nkv)
    for itemsize in (4, 2, 1):
        assert paged_shape_ok(d, a, nkv, itemsize), itemsize


def _dense_archs():
    from repro_torch.configs.registry import get_config, list_archs
    return [n for n in list_archs() if get_config(n).family == "dense"]


SMEM_BYTES = 232448      # dynamic shared memory a block may use on the H100
GRID_YZ = 65535          # CUDA's limit on gridDim.y and gridDim.z


def _gemm_smem(tile, nb=1):
    """csrc/gemm_sm90.cuh GemmSmem: four ring slots of a (rows x 64) A tile
    and nb (64 x columns) B tiles in bf16, and 1024 bytes of alignment."""
    bm, bn = tile
    return 4 * (bm + nb * bn) * 64 * 2 + 1024


@pytest.mark.parametrize("arch", _dense_archs())
def test_registered_dense_model_gets_a_valid_gemm_launch(arch):
    """Every projection of every registered dense model, at 64 and 4096
    token rows, in each layout it runs (forward, dgrad, wgrad, the fused
    MLP backward's dx pair): the tile picker returns an instantiated tile,
    the split covers k in whole k steps, the grid fits CUDA's limits and
    the ring fits shared memory; the fused MLP kernels' tiles likewise.
    The wrappers' own launch arithmetic, no launch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.fused_mlp.ops import pick_tile as fused_tile
    cfg = get_config(arch)
    d, hd = cfg.d_model, cfg.head_dim
    projections = {"q": (d, cfg.num_heads * hd), "kv": (d, cfg.num_kv_heads * hd),
                   "o": (cfg.num_heads * hd, d), "up": (d, cfg.d_ff), "down": (cfg.d_ff, d),
                   "lm_head": (d, cfg.padded_vocab_size)}
    for rows in (64, 4096):
        for name, (k_in, n_out) in projections.items():
            shapes = {"forward": (rows, k_in, n_out), "dgrad": (rows, n_out, k_in),
                      "wgrad": (k_in, rows, n_out)}
            if name == "up":
                shapes["dx pair"] = (rows, 2 * n_out, k_in)   # two pairs of k = d_ff
            for layout, (m, k, n) in shapes.items():
                bm, bn, ks = launch_shape(m, n, k, torch.bfloat16, 132)
                what = (arch, rows, name, layout, (m, k, n), (bm, bn, ks))
                assert (bm, bn) in TILES and (bm == 64) == (m <= 64), what
                splits = -(-k // ks)
                assert ks % BLOCK_K == 0 and (splits - 1) * ks < k, what
                assert splits <= GRID_YZ and -(-n // bn) <= GRID_YZ, what
                assert _gemm_smem((bm, bn)) <= SMEM_BYTES, what
        for mlp_type in ("swiglu", "gelu", "relu2"):
            tile = fused_tile(rows, torch.bfloat16)
            assert tile == ((64, 64) if rows <= 64 else (128, 128))
            assert -(-cfg.d_ff // tile[1]) <= GRID_YZ
            assert _gemm_smem(tile, nb=2 if mlp_type == "swiglu" else 1) <= SMEM_BYTES


@pytest.mark.parametrize("b,nkv,g,d,capacity,itemsize", [
    (64, 8, 2, 128, 128, 2), (64, 8, 2, 128, 192, 1), (16, 8, 12, 128, 256, 2),
    (16, 8, 2, 128, 4096, 2), (6, 2, 2, 128, 2048, 2), (5, 2, 12, 128, 80, 1),
    (1, 1, 2, 64, 16, 2), (4, 8, 96, 128, 8192, 2), (2, 1, 64, 256, 100_000, 1),
    (3, 2, 48, 256, 300, 2), (40, 8, 16, 80, 512, 2)])
def test_paged_launch_geometry(b, nkv, g, d, capacity, itemsize):
    """The bf16 paged-decode launch from shapes alone: a power-of-two number
    of splits, at most 8 (one cluster), that keeps the grid within two
    blocks an SM unless one split already exceeds it; whole tiles that
    cover the pool's capacity, so rounding may leave fewer splits, never
    more; a deep pool stretches the split; shared memory under the card's
    limit.  The f32 body keeps the parent's tile: the largest of 64 .. 8
    whose shared memory fits 48 KB, one block walking the whole row."""
    from repro_torch.kernels.flash_attention.ops import (MAX_SPLITS, PAGED_TILES, SMEM_BUDGET,
                                                         SMEM_LIMIT, TARGET_BLOCKS, _f32_smem,
                                                         paged_launch)
    geo = paged_launch(b, nkv, g, d, capacity, itemsize)
    walks = b * nkv * -(-g // 64)
    asked = min(MAX_SPLITS, 1 << (max(1, TARGET_BLOCKS // walks).bit_length() - 1))
    assert asked & (asked - 1) == 0 and (walks * asked <= TARGET_BLOCKS or asked == 1)
    assert asked * 2 > MAX_SPLITS or walks * asked * 2 > TARGET_BLOCKS   # the largest such
    assert geo.tile == (64 if walks < TARGET_BLOCKS else 32) and geo.tile in PAGED_TILES
    assert geo.split % geo.tile == 0 and 1 <= geo.splits <= asked
    assert geo.splits * geo.split >= capacity > (geo.splits - 1) * geo.split
    assert geo.split == -(-capacity // (asked * geo.tile)) * geo.tile
    assert geo.smem <= SMEM_LIMIT
    assert paged_launch(b, nkv, g, d, capacity, itemsize) is geo   # cached per shape
    kv = 4 if itemsize == 2 else 1                                  # an f32 pool, or int8
    f32 = paged_launch(b, nkv, g, d, capacity, kv, 4)
    assert (f32.splits, f32.split) == (1, capacity) and f32.tile in (64, 32, 16, 8)
    assert f32.smem == _f32_smem(g, d, f32.tile, kv)
    assert f32.tile == 8 or f32.smem <= SMEM_BUDGET
    assert f32.tile == 64 or _f32_smem(g, d, 2 * f32.tile, kv) > SMEM_BUDGET


def test_kernel_shape_predicates_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels.flash_attention.ops import flash_shape_ok, paged_shape_ok
    assert all(flash_shape_ok(d, 8, 2) for d in range(1, 257))
    assert not flash_shape_ok(272, 8, 2) and not flash_shape_ok(0, 8, 2)
    assert not flash_shape_ok(64, 6, 4)        # a % nkv != 0
    assert paged_shape_ok(128, 96, 8, 1) and paged_shape_ok(256, 64, 2, 2)
    assert not paged_shape_ok(272, 8, 2, 2)    # d > 256
    assert not paged_shape_ok(40, 8, 2, 1)     # an int8 row of 40 bytes: not whole 16-byte loads
