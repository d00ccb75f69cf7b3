"""Port kernel modules vs the JAX package's Pallas kernels (interpret mode).

The same inputs, made from a seed with numpy, go through the JAX wrapper in
interpret mode and the port's wrapper on CPU tensors (its plain PyTorch
version); f32 throughout.  Tolerance 3e-5 (abs and rel): both sides sum in
f32, in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import paged_decode as jax_paged_decode
from repro.kernels.fused_mlp.ops import fused_mlp_hidden as jax_fused_mlp_hidden
from repro.kernels.matmul.ops import matmul as jax_matmul
from repro_torch.kernels import _build, tolerance
from repro_torch.kernels.flash_attention.ops import paged_decode
from repro_torch.kernels.flash_attention.ref import paged_decode_ref
from repro_torch.kernels.fused_mlp.ops import fused_mlp_hidden
from repro_torch.kernels.fused_mlp.ref import ACTS, fused_mlp_hidden_ref
from repro_torch.kernels.matmul.ops import BLOCK_K, matmul, split_k
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


@pytest.mark.parametrize("m,n,k", [(64, 2048, 2048), (64, 1024, 2048), (64, 2048, 8192),
                                   (64, 92544, 2048), (3, 5, 7), (64, 64, 100)])
def test_split_k_covers_k(m, n, k):
    ks = split_k(m, n, k, num_sms=132)
    splits = -(-k // ks)
    assert ks % BLOCK_K == 0 and ks > 0
    assert (splits - 1) * ks < k <= splits * ks       # every split non-empty
    tiles = -(-m // 64) * -(-n // 64)
    if tiles >= 132:
        assert splits == 1                            # the output alone fills the card


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
    before = (matmul.launches, fused_mlp_hidden.launches, paged_decode.launches)
    x = torch.ones(4, 8)
    matmul(x, torch.ones(8, 8))
    fused_mlp_hidden(x, torch.ones(8, 16), torch.ones(8, 16))
    paged_decode(torch.ones(2, 2, 8), torch.ones(2, 4, 1, 8), torch.ones(2, 4, 1, 8),
                 torch.tensor([0, 1]), torch.tensor([4, 2]))
    assert (matmul.launches, fused_mlp_hidden.launches, paged_decode.launches) == before


def test_other_devices_raise():
    """No silent fallback: a device that is neither CPU nor CUDA raises."""
    a = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        matmul(a, torch.empty(8, 8, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_mlp_hidden(a, None, torch.empty(8, 8, device="meta"), mlp_type="gelu")


def test_build_is_lazy_and_keyed_by_sources():
    """Importing the kernels builds nothing; the library name hashes the
    sources and flags, so an edited source cannot load a stale build."""
    assert _build._LIBRARY is None or _build._LIBRARY.path.exists()
    names = {p.name for p in _build._sources()}
    assert {"matmul.cu", "fused_mlp.cu", "paged_decode.cu", "gemm_tile.cuh"} <= names
    assert len(_build._digest()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

