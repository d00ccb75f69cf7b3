"""The port's int8-weight path (linear_impl="quantized"), against the JAX package.

Quantization (`quantize_int8`, `quantize_kv`, `quantize_weight`) must be
bit-identical to `jax.jit` of the JAX functions, the form the JAX package
runs (XLA computes absmax / 127 as absmax * f32(1/127)); `fp8_round_trip`
must give JAX's values, NaN past e4m3's range included.  The int8 GEMM's
plain version must be bit-identical to the JAX Pallas kernel in interpret
mode (both sum exactly, then take the same f32 de-scale); the int8 fused
MLP within `int8_fused_mlp_tol` (the activations round apart).  The model
modules and the engines run on CPU tensors (every kernel wrapper runs its
plain version), smoke configs in f32, params converted from JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.hardware import H100_SXM as JAX_H100
from repro.kernels.quantized.ops import fp8_matmul as jax_fp8_matmul
from repro.kernels.quantized.ops import int8_fused_mlp_hidden as jax_int8_fused_mlp_hidden
from repro.kernels.quantized.ops import int8_matmul as jax_int8_matmul
from repro.models import apply_lm as jax_apply_lm
from repro.models import init_lm as jax_init_lm
from repro.models.linear import linear as jax_linear
from repro.models.linear import quantize_linear_params as jax_quantize_linear_params
from repro.models.linear import quantized_mlp as jax_quantized_mlp
from repro.quant import QuantizedTensor as JaxQuantizedTensor
from repro.quant import fp8_round_trip as jax_fp8_round_trip
from repro.quant import quantize_int8 as jax_quantize_int8
from repro.quant import quantize_kv as jax_quantize_kv
from repro.quant import quantize_weight as jax_quantize_weight
from repro.serving.engine import BucketPolicy as JaxBucketPolicy
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import tolerance
from repro_torch.kernels.matmul.ops import split_k
from repro_torch.kernels.quantized.ops import (BLOCK_K, FUSED_TILE, FUSED_WIDE_TILE, MAX_SPLITS,
                                               SPLIT_MIN_STEPS, SPLIT_WAVES, WIDE_TILE,
                                               fp8_matmul, fused_tile, int8_fused_mlp_hidden,
                                               int8_fused_mlp_q, int8_matmul, int8_matmul_q,
                                               launch_shape)
from repro_torch.kernels.quantized.ref import fp8_matmul_ref, int8_matmul_ref
from repro_torch.models import apply_lm
from repro_torch.models.blocks import tree_index, tree_unbind
from repro_torch.models.convert import params_from_jax
from repro_torch.models.linear import (QUANT_WEIGHT_KEYS, QuantizedLinear, linear,
                                       quantize_linear_params, quantized_mlp)
from repro_torch.quant import (FP8_DTYPES, QuantizedTensor, fp8_round_trip, k_major,
                               quantize_int8, quantize_kv, quantize_weight)
from repro_torch.serving.engine import BucketPolicy, Engine, synthetic_requests

ARCH = "internlm2-1.8b"
POLICY = dict(num_slots=4, prompt_buckets=(16, 32), seq_max=64)
# f32 sums of the same products in another order (the straight-through
# gradients' tile GEMMs, the attention and norms around the int8 GEMMs)
TOL = dict(atol=2e-5, rtol=2e-5)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _smoke(arch):
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), linear_impl="quantized")
    jparams = jax_init_lm(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(get_smoke_config(arch), linear_impl="quantized")
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def smoke():
    return _smoke(ARCH)


# --- quantization -----------------------------------------------------------------------

_QUANTIZERS = {
    "int8": (lambda x: jax_quantize_int8(x, axis=-1), lambda x: quantize_int8(x, axis=-1)),
    "kv": (jax_quantize_kv, quantize_kv),
    "weight": (lambda x: tuple(jax_quantize_weight(x))[:2],
               lambda x: tuple(quantize_weight(x))[:2]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", sorted(_QUANTIZERS))
def test_quantize_bit_identical_to_jitted_jax(which, dtype):
    x = _np(np.random.default_rng(0), (16, 24, 4, 64), 3.0)
    x[0, 0] = 0.0                               # all-zero slices: scale EPS / 127
    x[:, :, :, 5] = 0.0
    jx = jnp.asarray(x).astype(dtype)
    jf, tf = _QUANTIZERS[which]
    jq, js = (np.asarray(t) for t in jax.jit(jf)(jx))
    q, s = tf(_t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(q.numpy(), jq)


@pytest.mark.parametrize("fp8", FP8_DTYPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_round_trip_matches_jax(fp8, dtype):
    """At e4m3's edges (448 its largest value, 464 the last that rounds to
    it; JAX gives NaN past it and for inf, where torch alone saturates) and
    on random values of both signs."""
    edges = np.asarray([448.0, 464.0, 465.0, 500.0, 1e4, 6e4, np.inf, -465.0, -448.0, 0.0],
                       np.float32)
    x = np.concatenate([edges, _np(np.random.default_rng(1), (500,), 30.0)])
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_fp8_round_trip(jx, fp8).astype(jnp.float32))
    got = fp8_round_trip(_t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype)), fp8)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)
    if fp8 == "float8_e4m3fn":
        assert np.isnan(want[3:7]).all() and not np.isnan(want[:2]).any()


def test_quantize_weight_fp8_and_unknown_dtypes():
    w = _np(np.random.default_rng(2), (40, 24), 100.0)
    for fp8 in FP8_DTYPES:
        jw = jax_quantize_weight(jnp.asarray(w), fp8)
        tw = quantize_weight(_t(w), fp8)
        assert tw.axis == jw.axis == -2 and tw.q.dtype == getattr(torch, fp8)
        np.testing.assert_array_equal(tw.q.float().numpy(), np.asarray(jw.q.astype(jnp.float32)))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    with pytest.raises(ValueError, match="unknown quant dtype"):
        quantize_weight(_t(w), "int4")
    with pytest.raises(ValueError, match="unknown fp8 dtype"):
        fp8_round_trip(_t(w), "float8_e3m4")


# --- kernels ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(37, 70, 45), (5, 300, 200), (64, 8192, 33),
                                   (130, 257, 96), (1, 2048, 1024)])
def test_int8_matmul_bit_identical_to_jax_kernel(m, k, n):
    """f32 activations, float and prequantized weights, against JAX's
    wrapper under jit with the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    a, w = _np(rng, (m, k)), _np(rng, (k, n), k ** -0.5)
    want = np.asarray(jax.jit(lambda a, w: jax_int8_matmul(a, w, interpret=True))(
        jnp.asarray(a), jnp.asarray(w)))
    np.testing.assert_array_equal(int8_matmul(_t(a), _t(w)).numpy(), want)
    jw = jax.jit(jax_quantize_weight)(jnp.asarray(w))
    qw = QuantizedTensor(_t(jw.q), _t(jw.scale), -2)
    np.testing.assert_array_equal(int8_matmul(_t(a), qw).numpy(), want)
    assert int8_matmul.launches == 0            # the CPU runs the plain version


def test_int8_matmul_plain_version_is_exact():
    """The integer sum is exact past 2^24 (k 8192, operands at +-127, where
    an f32 sum would round), then de-scaled in the JAX kernel's order."""
    rng = np.random.default_rng(4)
    m, k, n = 8, 8192, 16
    a_q = rng.choice([-127, 127], (m, k)).astype(np.int8)
    b_q = rng.integers(-127, 128, (k, n), dtype=np.int8)
    b_q[:, 0] = a_q[0]                          # one sum of 8192 * 127^2 > 2^27
    a_s, b_s = _np(rng, (m, 1)).__abs__(), _np(rng, (1, n)).__abs__()
    exact = (a_q.astype(np.int64) @ b_q.astype(np.int64)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = int8_matmul_ref(_t(a_q), _t(a_s), _t(b_q), _t(b_s), dtype)
        want = ((_t(exact) * _t(a_s)) * _t(b_s)).to(dtype)
        assert torch.equal(got, want)
        assert torch.equal(int8_matmul_q(_t(a_q), _t(a_s), _t(b_q), _t(b_s), dtype), got)
    assert exact[0, 0] == k * 127 ** 2


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("m,h,f", [(19, 72, 200), (64, 256, 512), (3, 1000, 40)])
def test_int8_fused_mlp_matches_jax_kernel(mlp_type, m, h, f):
    """Gate and up are the same exact sums de-scaled the same way; the
    activations (sigmoid, tanh) round apart: each element within
    `int8_fused_mlp_tol`."""
    rng = np.random.default_rng(5)
    x, wg, wu = _np(rng, (m, h)), _np(rng, (h, f), h ** -0.5), _np(rng, (h, f), h ** -0.5)
    want = np.asarray(jax.jit(lambda x, wg, wu: jax_int8_fused_mlp_hidden(
        x, wg, wu, mlp_type=mlp_type, interpret=True))(*map(jnp.asarray, (x, wg, wu))))
    got = int8_fused_mlp_hidden(_t(x), _t(wg), _t(wu), mlp_type=mlp_type)
    x_q, x_s = quantize_int8(_t(x))
    (gq, gs), (uq, us) = (quantize_int8(_t(w), axis=-2) for w in (wg, wu))
    tol = tolerance.int8_fused_mlp_tol(x_q, x_s, gq, gs, uq, us, mlp_type, got)
    ok, err, ratio = tolerance.check(_t(want), got, tol)
    assert ok, (err, ratio)
    assert torch.equal(int8_fused_mlp_q(x_q, x_s, gq, gs, uq, us, mlp_type=mlp_type), got)


@pytest.mark.parametrize("fp8", FP8_DTYPES)
def test_fp8_matmul_matches_jax(fp8):
    rng = np.random.default_rng(6)
    a, b = _np(rng, (2, 9, 70), 4.0), _np(rng, (70, 45), 0.3)
    want = np.asarray(jax_fp8_matmul(jnp.asarray(a), jnp.asarray(b), fp8_dtype=fp8,
                                     interpret=True))
    got = fp8_matmul(_t(a), _t(b), fp8_dtype=fp8)
    assert got.shape == (2, 9, 45)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(fp8_matmul_ref(_t(a).reshape(-1, 70), _t(b), fp8),
                               got.reshape(-1, 45), **TOL)


def test_int8_tolerances_admit_exact_and_reject_faults():
    """int8_matmul's bound is zero: the exact result passes, a dropped
    64-deep k tile or one weight channel's scale doubled fails.  The fused
    MLP's bound admits the exact epilogue and rejects the same faults."""
    rng = np.random.default_rng(7)
    m, k, n = 16, 256, 96
    a_q = _t(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b_q = _t(rng.integers(-127, 128, (k, n), dtype=np.int8))
    a_s, b_s = _t(np.abs(_np(rng, (m, 1))) * 1e-2), _t(np.abs(_np(rng, (1, n))) * 1e-2)
    exact = (a_q.long() @ b_q.long()).float()
    dropped = (a_q[:, 64:].long() @ b_q[64:].long()).float()
    b_s2 = b_s.clone()
    b_s2[0, 7] *= 2.0
    want = int8_matmul_ref(a_q, a_s, b_q, b_s, torch.bfloat16)
    tol = tolerance.int8_matmul_tol(want)
    assert tolerance.check((exact * a_s * b_s).to(torch.bfloat16), want, tol)[0]
    assert not tolerance.check((dropped * a_s * b_s).to(torch.bfloat16), want, tol)[0]
    assert not tolerance.check((exact * a_s * b_s2).to(torch.bfloat16), want, tol)[0]
    for mlp_type in ("swiglu", "gelu", "relu2"):
        g_q = _t(rng.integers(-127, 128, (k, n), dtype=np.int8))
        want = int8_fused_mlp_q(a_q, a_s, g_q, b_s, b_q, b_s, mlp_type=mlp_type)
        tol = tolerance.int8_fused_mlp_tol(a_q, a_s, g_q, b_s, b_q, b_s, mlp_type, want)
        act = {"swiglu": lambda g, u: g.double() * torch.sigmoid(g.double()) * u,
               "gelu": lambda g, u: torch.nn.functional.gelu(u.double(), approximate="tanh"),
               "relu2": lambda g, u: u.double().clamp_min(0) ** 2}[mlp_type]
        up = exact * a_s * b_s
        gate = (a_q.long() @ g_q.long()).float() * a_s * b_s
        assert tolerance.check(act(gate, up).float(), want, tol)[0], mlp_type
        faults = [act((a_q[:, 64:].long() @ g_q[64:].long()).float() * a_s * b_s,
                      dropped * a_s * b_s), act(gate, exact * a_s * b_s2)]
        for fault in faults:
            assert not tolerance.check(fault.float(), want, tol)[0], mlp_type


def test_split_k_and_raw_int8_weights():
    """Decode GEMMs (64 rows) split k to fill the card, in steps of the int8
    kernel's 128 columns; large grids do not; a raw int8 weight is refused
    as ambiguous, as in the JAX package."""
    policy = dict(waves=SPLIT_WAVES, min_steps=SPLIT_MIN_STEPS, most=MAX_SPLITS)
    assert split_k(64, 2048, 2048, 132, BLOCK_K, **policy) == 256  # 16 tiles -> 8 splits
    assert split_k(64, 92544, 2048, 132, BLOCK_K, **policy) == 2048  # 723 tiles: none
    assert split_k(64, 200, 100, 132, BLOCK_K, **policy) % BLOCK_K == 0
    with pytest.raises(ValueError, match="ambiguous"):
        int8_matmul(torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int8))


# internlm2-1.8b's projections (k, n) at the int8 serve path
PROJECTIONS = [(2048, 2048), (2048, 1024), (8192, 2048), (2048, 92544)]


# the int8 GEMM's splits of k at 64 rows on 132 SMs: q/o, k/v and w_down 8
# (the most one cluster holds), the lm_head (723 column tiles) none
DECODE_SPLITS = {(2048, 2048): 8, (2048, 1024): 8, (8192, 2048): 8, (2048, 92544): 1}


@pytest.mark.parametrize("m", [1, 16, 64, 65, 128, 4096])
@pytest.mark.parametrize("k,n", list(DECODE_SPLITS) + [(70, 45), (4100, 45)])
def test_int8_launch_shape(m, k, n):
    """The int8 GEMM's tile by row count: one 64-row warpgroup tile (64 x
    128) up to 64 rows, 128 x 256 of two above.  k split in multiples of
    128, each split at least SPLIT_MIN_STEPS
    steps deep and at most MAX_SPLITS of them (one cluster), wherever the
    grid leaves SMs idle and k has room for two splits (128-row tiles: in
    whole copies of the grid that one wave holds); a grid that fills the
    card alone is not split.  The fused MLP's tile: 64 x 32 up to 64 rows,
    128 x 32 above."""
    sms = 132
    tm, tn, ks = launch_shape(m, n, k, sms)
    assert (tm, tn) == ((64, 128) if m <= 64 else WIDE_TILE) and WIDE_TILE == (128, 256)
    assert ks % BLOCK_K == 0 and ks > 0
    tiles, splits = -(-m // tm) * -(-n // tn), -(-k // ks)
    assert splits <= MAX_SPLITS
    if tiles >= sms:
        assert splits == 1
    else:
        assert splits == 1 or ks >= SPLIT_MIN_STEPS * BLOCK_K
        room = k >= 2 * SPLIT_MIN_STEPS * BLOCK_K
        if tm == 64:
            assert (splits > 1) == room
        else:                                    # whole copies of the grid, in one wave
            assert tiles * splits <= sms and (splits > 1) == (room and 2 * tiles <= sms)
    if m == 64 and (k, n) in DECODE_SPLITS:
        assert splits == DECODE_SPLITS[k, n]
    assert fused_tile(m) == (FUSED_TILE if m <= 64 else FUSED_WIDE_TILE)
    assert (FUSED_TILE, FUSED_WIDE_TILE) == ((64, 32), (128, 32))


def _k_major_ok(q):
    return q.dtype == torch.int8 and q.mT.is_contiguous() and (
        q.shape[-1] == 1 or q.shape[-2] == 1 or not q.is_contiguous())


@pytest.mark.parametrize("shape", [(64, 32), (70, 45), (3, 64, 32)])
def test_quantize_weight_holds_payloads_k_major(shape):
    """quantize_weight's int8 payload is the .mT view of a contiguous
    (..., n, k) tensor, its values and scales bit-identical to jax.jit of
    JAX's quantizer (which holds (k, n) row-major); each layer's slice and
    unbind of a stacked payload stay K-major; the plain GEMM of the K-major
    payload is bit-identical to the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(15)
    w = _np(rng, shape, 0.3)
    got = quantize_weight(_t(w))
    jw = jax.jit(jax_quantize_weight)(jnp.asarray(w))
    assert _k_major_ok(got.q) and got.q.shape == shape and got.scale.is_contiguous()
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(jw.scale))
    assert k_major(got.q).data_ptr() == got.q.data_ptr()          # no second copy
    if len(shape) == 3:
        for i, (a, b) in enumerate(zip(tree_unbind({"w": got}, shape[0]),
                                       (tree_index({"w": got}, i) for i in range(shape[0])))):
            for leaf in (a["w"], b["w"]):
                assert _k_major_ok(leaf.q) and leaf.scale.is_contiguous()
                np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jw.q[i]))
        return
    x = _np(rng, (5, shape[0]))
    want = np.asarray(jax.jit(lambda a, w: jax_int8_matmul(a, w, interpret=True))(
        jnp.asarray(x), jw))
    np.testing.assert_array_equal(int8_matmul(_t(x), got).numpy(), want)


def test_quantized_params_are_k_major(smoke):
    """Every int8 payload of quantize_linear_params (stacked and 2-D) and of
    params_from_jax (JAX's quantized lm_head) is held K-major, and so is
    each layer's slice and unbind, with values bit-identical to JAX's."""
    jcfg, jparams, cfg, params = smoke
    qp = quantize_linear_params(params)
    L = cfg.num_layers
    leaves = [qp["lm_head"]] + [leaf for block in ("attn", "mlp")
                                for leaf in qp["seg0"][block].values()
                                if isinstance(leaf, QuantizedLinear)]
    assert len(leaves) == 8
    for leaf in leaves:
        assert _k_major_ok(leaf.q)
        if leaf.q.dim() == 3:
            for per in (tree_unbind({"w": leaf}, L), [tree_index({"w": leaf}, i)
                                                      for i in range(L)]):
                assert all(_k_major_ok(p["w"].q) for p in per)
    jq = jax_quantize_linear_params(jparams)
    head = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")["lm_head"]
    assert _k_major_ok(head.q)
    np.testing.assert_array_equal(head.q.numpy(), np.asarray(jq["lm_head"].q))
    np.testing.assert_array_equal(head.q.numpy(), qp["lm_head"].q.numpy())


# --- model ------------------------------------------------------------------------------

@pytest.mark.parametrize("frozen", [False, True])
def test_linear_quantized_forward_and_straight_through_grads(frozen):
    """linear(impl="quantized") under jit in JAX (the form a model runs)
    against the port: forward bit-identical; dx (and dw for a float weight)
    from the straight-through tile GEMMs."""
    rng = np.random.default_rng(8)
    x, w = _np(rng, (2, 8, 64), 0.5), _np(rng, (64, 32), 0.5)
    jw = jax.jit(jax_quantize_weight)(jnp.asarray(w)) if frozen else jnp.asarray(w)

    def jloss(x, w):
        return jnp.sum(jax_linear(x, w, impl="quantized") ** 2)

    jy = np.asarray(jax.jit(lambda x, w: jax_linear(x, w, impl="quantized"))(jnp.asarray(x), jw))
    tx = _t(x).requires_grad_()
    if frozen:
        tw = QuantizedLinear(_t(jw.q), _t(jw.scale), -2)
        jdx = jax.jit(jax.grad(lambda x: jloss(x, jw)))(jnp.asarray(x))
    else:
        tw = _t(w).requires_grad_()
        jdx, jdw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jw)
    y = linear(tx, tw, impl="quantized")
    np.testing.assert_array_equal(y.detach().numpy(), jy)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    if not frozen:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)
        assert tw.grad.dtype == torch.float32
    with torch.no_grad():                        # serving: the wrapper directly
        assert torch.equal(linear(_t(x), tw, impl="quantized"), y.detach())


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("frozen", [False, True])
def test_quantized_mlp_matches_jax(mlp_type, frozen):
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), mlp_type=mlp_type)
    cfg = dataclasses.replace(get_smoke_config(ARCH), mlp_type=mlp_type)
    h, f = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(9)
    p = {"w_up": _np(rng, (h, f), 0.3), "w_down": _np(rng, (f, h), 0.3)}
    if mlp_type == "swiglu":
        p["w_gate"] = _np(rng, (h, f), 0.3)
    x = _np(rng, (2, 4, h), 0.5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if frozen:
        jp = {k: jax.jit(jax_quantize_weight)(v) for k, v in jp.items()}
        tp = {k: QuantizedTensor(_t(v.q), _t(v.scale), -2) for k, v in jp.items()}
    else:
        tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    want = np.asarray(jax.jit(lambda x, p: jax_quantized_mlp(x, p, jcfg))(jnp.asarray(x), jp))
    tx = _t(x).requires_grad_()
    got = quantized_mlp(tx, tp, cfg)
    ok, err, ratio = tolerance.check(got.detach(), _t(want), torch.full_like(got, 2e-5))
    assert ok, (err, ratio)
    if frozen:
        return
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jax_quantized_mlp(x, p, jcfg) ** 2)))(
        jp, jnp.asarray(x))
    (got ** 2).sum().backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), atol=1e-4, rtol=1e-4)


def test_quantize_linear_params_per_layer_slice(smoke):
    """Every GEMM leaf of the stacked smoke params (L, k, n) is quantized per
    layer slice, equal to JAX's per-call quantization of that layer's weight
    (under jit); tree_index / tree_unbind take payload and scales together;
    norm gains and the embedding pass through."""
    jcfg, jparams, cfg, params = smoke
    qp = quantize_linear_params(params)
    seg, jseg = qp["seg0"], jparams["seg0"]
    L = cfg.num_layers
    n_quantized = 0
    for block in ("attn", "mlp"):
        for name, leaf in seg[block].items():
            if name not in QUANT_WEIGHT_KEYS:
                continue
            n_quantized += 1
            assert isinstance(leaf, QuantizedLinear) and leaf.scale.shape == (L, 1,
                                                                               leaf.q.shape[-1])
            slices = tree_unbind({"w": leaf}, L)
            for layer in range(L):
                jw = jax.jit(jax_quantize_weight)(jseg[block][name][layer])
                for got in (tree_index({"w": leaf}, layer)["w"], slices[layer]["w"]):
                    np.testing.assert_array_equal(got.q.numpy(), np.asarray(jw.q))
                    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(jw.scale))
    assert n_quantized == 7                     # wq wk wv wo w_gate w_up w_down
    assert isinstance(qp["lm_head"], QuantizedLinear)
    assert qp["embed"] is params["embed"] and qp["seg0"]["norm1"] is not None
    assert torch.equal(qp["seg0"]["norm1"]["scale"], params["seg0"]["norm1"]["scale"])


def test_quantize_linear_params_leaves_expert_stacks_float():
    """A GEMM key converts only where it is a 2-D weight once a segment's
    layer axis is set aside: (k, n) anywhere, (L, k, n) under `seg{i}`.
    Expert stacks — (E, h, f) unstacked, (L, E, h, f) stacked, named as
    JAX's MoE names them — stay float tensors for their non-GEMM consumers."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    params = {"lm_head": r(8, 16),
              "seg0": {"mlp": {"w_up": r(2, 8, 16), "w_down": r(2, 16, 8)},
                       "moe": {"w_gate": r(2, 4, 8, 16), "w_up": r(2, 4, 8, 16),
                               "w_down": r(2, 4, 16, 8)}},
              "experts": {"w_up": r(4, 8, 16), "wo": r(8, 8)}}
    qp = quantize_linear_params(params)
    for leaf in (qp["lm_head"], qp["seg0"]["mlp"]["w_up"], qp["seg0"]["mlp"]["w_down"],
                 qp["experts"]["wo"]):
        assert isinstance(leaf, QuantizedLinear)
    assert qp["seg0"]["mlp"]["w_up"].scale.shape == (2, 1, 16)
    for name in ("w_gate", "w_up", "w_down"):
        assert qp["seg0"]["moe"][name] is params["seg0"]["moe"][name]
    assert qp["experts"]["w_up"] is params["experts"]["w_up"]


def test_convert_takes_jax_quantized_leaves(smoke):
    """JAX's quantize_linear_params converts the 2-D lm_head only (its
    stacked leaves stay float); the converted container keeps payload and
    scales bit for bit, and the logits follow."""
    jcfg, jparams, cfg, _ = smoke
    jq = jax_quantize_linear_params(jparams)
    assert isinstance(jq["lm_head"], JaxQuantizedTensor)
    assert not isinstance(jq["seg0"]["attn"]["wq"], JaxQuantizedTensor)
    params = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    head = params["lm_head"]
    assert isinstance(head, QuantizedTensor) and head.axis == -2
    np.testing.assert_array_equal(head.q.numpy(), np.asarray(jq["lm_head"].q))
    np.testing.assert_array_equal(head.scale.numpy(), np.asarray(jq["lm_head"].scale))
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jax_apply_lm(p, t, jcfg)[0])(jq, jnp.asarray(toks)))
    got, _ = apply_lm(params, _t(toks).long(), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    bad = jax.tree.map(np.asarray, jq)
    bad["final_norm"]["scale"] = JaxQuantizedTensor(bad["lm_head"].q, bad["lm_head"].scale, -2)
    with pytest.raises(ValueError, match="no GEMM weight"):
        params_from_jax(bad, cfg, "cpu")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen1.5-4b"])
def test_apply_lm_forward_and_grads_match_jax(arch):
    """As the JAX package's TestQuantizedModelEndToEnd, held to JAX: a full
    forward (logits) and a full backward (every leaf's gradient) with
    linear_impl="quantized"; qwen1.5 carries a qkv bias.  The int8 GEMMs are
    exact on both sides, but the f32 norms and attention around them sum in
    another order, which can move an activation across an int8 rounding
    step: the logits are held to 1e-4 and the gradients to 1e-3 of their
    largest element."""
    jcfg, jparams, cfg, params = _smoke(arch)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jax_apply_lm(p, t, jcfg)[0])(jparams,
                                                                        jnp.asarray(toks)))
    leaves = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                leaves[prefix + k] = v.requires_grad_()
    walk(params)
    got, _ = apply_lm(params, _t(toks).long(), cfg)
    assert got.shape == (1, 8, cfg.padded_vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=1e-4)
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(
        jax_apply_lm(p, jnp.asarray(toks), jcfg)[0].astype(jnp.float32) ** 2)))(jparams)
    (got.float() ** 2).mean().backward()
    jflat = {"/".join(str(k.key) for k in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(jflat) == set(leaves)
    for path, leaf in leaves.items():
        g, jg = leaf.grad.numpy(), jflat[path]
        assert np.isfinite(g).all(), path
        scale = max(np.abs(jg).max(), 1e-30)
        assert np.abs(g - jg).max() <= 1e-3 * scale, (path, np.abs(g - jg).max(), scale)


# --- engines ----------------------------------------------------------------------------

_WORKLOADS = {
    "slot": dict(),
    "prefix": dict(prefix_cache=True, block_size=8),
    "int8 kv prefix": dict(prefix_cache=True, block_size=8, kv_dtype="int8"),
}


@pytest.mark.parametrize("workload", sorted(_WORKLOADS))
@pytest.mark.parametrize("prequantized", [False, True])
def test_engine_tokens_identical_to_jax_engine(smoke, workload, prequantized):
    """The JAX engine with linear_impl="quantized" (float params, weights
    quantized per call under jit) against the port's, on float params or on
    `quantize_linear_params` output: identical greedy tokens."""
    jcfg, jparams, cfg, params = smoke
    kw = _WORKLOADS[workload]
    reqs = synthetic_requests(10, pattern="burst", min_prompt=4 if not kw else 20,
                              max_prompt=30, min_new=3, max_new=10, vocab=cfg.vocab_size,
                              prefix_share=0.8 if kw else 0.0, shared_prefix_len=16, seed=13)
    jdone, jstats = JaxEngine(jparams, jcfg, policy=JaxBucketPolicy(**POLICY), hw=JAX_H100,
                              **kw).run(reqs)
    eng = Engine(quantize_linear_params(params) if prequantized else params, cfg,
                 policy=BucketPolicy(**POLICY), hw=H100_SXM, use_paged_kernel=True,
                 device="cpu", **kw)
    done, stats = eng.run(reqs)
    assert [c.rid for c in done] == [c.rid for c in jdone]
    for jc, c in zip(jdone, done):
        assert c.tokens == jc.tokens, f"rid {c.rid}"
        assert c.finish_reason == jc.finish_reason == "length"
    assert stats.cache_hit_requests == jstats.cache_hit_requests
    if kw:
        assert stats.cache_hit_requests >= 2
