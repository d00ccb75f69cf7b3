"""Unified linear-execution layer: every model GEMM routes through here.

`linear` flattens (b, s, h) activations to 2-D and selects the execution
path from `ModelConfig.linear_impl`:

  "jnp"    — `torch.matmul` (the JAX package leaves this GEMM to XLA)
  "pallas" — the hand-written CUDA tile GEMM (kernels/matmul)
  "tuned"  — the same kernel: block shapes are fixed until the tuning slice
  "fused"  — the tile GEMM everywhere, plus the fused SwiGLU/MLP kernel
             (kernels/fused_mlp) for the MLP gate/up pair
  "quantized" — the int8 weight path (kernels/quantized): per-channel
             weight scales, dynamic per-row activation quantization, i32
             accumulate, f32 de-scale.  Weights may be float leaves
             (quantized per call, as JAX does) or `QuantizedLinear`
             containers from `quantize_linear_params` (quantized once)

The kernel paths are differentiable: `_Linear` mirrors JAX's
`_pallas_linear` custom VJP, its dgrad (g @ w^T) and wgrad (x^T @ g) both
launching the tile GEMM on transposed views; the quantized path's
Functions mirror JAX's straight-through VJPs (the int8 rounding is taken as
the identity; the gradient GEMMs run the tile GEMM in high precision).
They are taken only when a gradient is recorded: serving (under
`no_grad`) calls the kernel wrappers directly and pays no
`autograd.Function` on its ~170 calls per decode step.

Weights are cast to the activation dtype per call, as JAX does: a no-op on
the serving path (params arrive in the compute dtype), and on the training
path (float32 masters) the cast's own backward returns the float32
gradient.
"""
from __future__ import annotations

import re

import torch

from ..kernels.fused_mlp.ops import fused_mlp_hidden
from ..kernels.fused_mlp.ref import fused_mlp_hidden_ref
from ..kernels.matmul.ops import matmul
from ..kernels.quantized.ops import int8_fused_mlp_hidden, int8_matmul
from ..quant import QuantizedTensor, quantize_weight

LINEAR_IMPLS = ("jnp", "pallas", "tuned", "fused", "quantized")

# The weight container of the quantized path is `quant.QuantizedTensor`,
# under the dispatch layer's name.
QuantizedLinear = QuantizedTensor


def _check_impl(impl: str) -> None:
    if impl not in LINEAR_IMPLS:
        raise ValueError(
            f"unknown linear_impl {impl!r}; valid: {list(LINEAR_IMPLS)}")


class _Linear(torch.autograd.Function):
    """JAX's `_pallas_linear` (models/linear.py:75-97): x2 (m, k) @ w (k, n)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return matmul(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.contiguous()
        dx = matmul(g, w.T) if ctx.needs_input_grad[0] else None
        dw = matmul(x2.T, g) if ctx.needs_input_grad[1] else None
        return dx, dw


class _QuantizedLinear(_Linear):
    """JAX's `_quantized_linear` (models/linear.py:100-123): the int8 GEMM
    forward on a float weight; `_Linear`'s dgrad and wgrad on the tile GEMM
    (straight-through)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return int8_matmul(x2, w)


class _QuantizedLinearFrozen(torch.autograd.Function):
    """JAX's `_quantized_linear_frozen` (models/linear.py:126-149): a
    prequantized weight; dx from the de-quantized weight, none for the
    payload or its scales."""

    @staticmethod
    def forward(ctx, x2, wq, wscale):
        ctx.dtype = x2.dtype
        ctx.save_for_backward(wq, wscale)
        return int8_matmul(x2, QuantizedTensor(wq, wscale, -2))

    @staticmethod
    def backward(ctx, g):
        wq, wscale = ctx.saved_tensors
        w = (wq.float() * wscale).to(ctx.dtype)
        return matmul(g.contiguous(), w.T), None, None


def _grad_recorded(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _quantized_linear(x, w):
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if isinstance(w, QuantizedTensor):
        if _grad_recorded(x):
            out = _QuantizedLinearFrozen.apply(x2, w.q, w.scale.reshape(1, -1))
        else:
            out = int8_matmul(x2, w)
        return out.reshape(*lead, w.q.shape[-1])
    w = w.to(x.dtype)
    out = _QuantizedLinear.apply(x2, w) if _grad_recorded(x, w) else int8_matmul(x2, w)
    return out.reshape(*lead, w.shape[-1])


def linear(x, w, *, impl: str = "jnp"):
    """y = x @ w with dispatched execution.  x: (..., k); w: (k, n), or a
    `QuantizedLinear` under impl="quantized"."""
    _check_impl(impl)
    if impl == "quantized":
        return _quantized_linear(x, w)
    w = w.to(x.dtype)
    if impl == "jnp":
        return x @ w
    if _grad_recorded(x, w):
        lead, k = x.shape[:-1], x.shape[-1]
        return _Linear.apply(x.reshape(-1, k), w).reshape(*lead, w.shape[-1])
    return matmul(x, w)


def fused_mlp(x, p, cfg):
    """Full MLP block through the fused hidden kernel + the tile-GEMM down
    projection.  p: {w_gate (swiglu), w_up, w_down}; x: (..., h)."""
    dt = x.dtype
    w_gate = p["w_gate"].to(dt) if cfg.mlp_type == "swiglu" else None
    hidden = fused_mlp_hidden(x, w_gate, p["w_up"].to(dt), mlp_type=cfg.mlp_type)
    return linear(hidden, p["w_down"], impl="tuned")


_SEGMENT_KEY = re.compile(r"seg\d+")   # a stacked segment: its leaves lead with the layer axis

# Param-leaf names that are (k, n) GEMM weights consumed through `linear()`
# (JAX's set, one to one).  Embeddings, conv kernels, norm gains and 3-D
# expert stacks are not here.
QUANT_WEIGHT_KEYS = frozenset({
    "wq", "wk", "wv", "wo",                       # attention projections
    "wq_down", "wq_up", "wkv_down", "wk_up", "wv_up",  # MLA projections
    "w_gate", "w_up", "w_down",                   # MLP
    "in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj",  # SSM projections
    "lm_head",                                    # untied output head
})


def quantize_linear_params(params):
    """Quantize once at load: every floating leaf named in
    `QUANT_WEIGHT_KEYS` that is a 2-D GEMM weight once a stacked segment's
    layer axis is set aside becomes an int8 `QuantizedLinear`, per output
    channel of each slice (axis -2).  So a (k, n) leaf, or a (L, k, n) leaf
    under a `seg{i}` subtree, converts — the stacked one with (L, 1, n)
    scales, so layer l's slice is the container JAX quantizes per call from
    that layer's weight — while an expert stack ((E, h, f), or (L, E, h, f)
    stacked) stays float for its non-GEMM consumers.  (JAX's own
    `quantize_linear_params` converts 2-D leaves only, which leaves the
    stacked layers to per-call quantization: the same numbers, paid every
    call.)  The weights are quantized as they are held: the compute dtype,
    for serving params.  Other leaves pass through."""
    def walk(tree, gemm_dims):
        if not isinstance(tree, dict):
            return tree
        return {k: (quantize_weight(v)
                    if k in QUANT_WEIGHT_KEYS and torch.is_tensor(v) and v.dim() == gemm_dims
                    and v.is_floating_point()
                    else walk(v, 3 if _SEGMENT_KEY.fullmatch(k) else gemm_dims))
                for k, v in tree.items()}
    return walk(params, 2)


class _QuantizedHidden(torch.autograd.Function):
    """JAX's `_quantized_hidden` (models/linear.py:264-293): the int8 fused
    forward on float weights; the backward recomputes the hidden in high
    precision and differentiates the plain `fused_mlp_hidden_ref`."""

    @staticmethod
    def forward(ctx, x2, w_gate, w_up, mlp_type):
        ctx.mlp_type = mlp_type
        ctx.save_for_backward(x2, w_gate, w_up)
        return int8_fused_mlp_hidden(x2, w_gate, w_up, mlp_type=mlp_type)

    @staticmethod
    def backward(ctx, g):
        x2, wg, wu = (None if t is None else t.detach().requires_grad_()
                      for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = fused_mlp_hidden_ref(x2, wg, wu, ctx.mlp_type)
        grads = iter(torch.autograd.grad(out, [t for t in (x2, wg, wu) if t is not None], g))
        return next(grads), None if wg is None else next(grads), next(grads), None


def quantized_mlp(x, p, cfg):
    """Full MLP block on the int8 path: the gate/up pair runs the int8 fused
    kernel, the down projection the quantized linear.  Float weight leaves
    quantize per call and keep the high-precision gradient; `QuantizedLinear`
    containers (from `quantize_linear_params`) skip re-quantization — the
    inference path."""
    lead, h = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, h)
    w_gate = p.get("w_gate") if cfg.mlp_type == "swiglu" else None
    w_up = p["w_up"]
    if isinstance(w_up, QuantizedTensor):
        hidden = int8_fused_mlp_hidden(x2, w_gate, w_up, mlp_type=cfg.mlp_type)
    else:
        w_gate = None if w_gate is None else w_gate.to(x.dtype)
        w_up = w_up.to(x.dtype)
        if _grad_recorded(x2, w_gate, w_up):
            hidden = _QuantizedHidden.apply(x2, w_gate, w_up, cfg.mlp_type)
        else:
            hidden = int8_fused_mlp_hidden(x2, w_gate, w_up, mlp_type=cfg.mlp_type)
    return linear(hidden.reshape(*lead, hidden.shape[-1]), p["w_down"], impl="quantized")
