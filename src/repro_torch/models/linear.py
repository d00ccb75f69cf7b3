"""Unified linear-execution layer: every model GEMM routes through here.

`linear` flattens (b, s, h) activations to 2-D and selects the execution
path from `ModelConfig.linear_impl`:

  "jnp"    — `torch.matmul` (the JAX package leaves this GEMM to XLA)
  "pallas" — the hand-written CUDA tile GEMM (kernels/matmul), at the
             wrapper's rule geometry (`tuned=False`)
  "tuned"  — the same kernel at the tuning cache's measured-best tile and
             split for each (m, k, n) where the cache has one (`tuned=True`;
             a miss keeps the rule)
  "fused"  — the tuned tile GEMM everywhere, plus the fused SwiGLU/MLP
             kernel (kernels/fused_mlp, tuned) for the MLP gate/up pair
  "quantized" — the int8 weight path (kernels/quantized, tuned): per-channel
             weight scales, dynamic per-row activation quantization, i32
             accumulate, f32 de-scale.  Weights may be float leaves
             (quantized per call, as JAX does) or `QuantizedLinear`
             containers from `quantize_linear_params` (quantized once)

As in JAX's `_LinearConfig`, "tuned", "fused" and "quantized" look the
tuning cache up and "pallas" does not; the gradient GEMMs of a tuned
forward look up their own (m, k, n) keys.

The kernel paths are differentiable: `_Linear` mirrors JAX's
`_pallas_linear` custom VJP, its dgrad (g @ w^T) and wgrad (x^T @ g) both
launching the tile GEMM on transposed views; the quantized path's
Functions mirror JAX's straight-through VJPs (the int8 rounding is taken as
the identity; the gradient GEMMs run the tile GEMM in high precision).
They are taken only when a gradient is recorded: serving (under
`no_grad`) calls the kernel wrappers directly and pays no
`autograd.Function` on its ~170 calls per decode step.  Inside
`products_as_ops()` (remat="dots", `models/blocks.py`) the tile GEMM and
the fused hidden run instead as the dispatcher ops
`repro_torch::linear_fwd` and `repro_torch::fused_mlp_hidden`
(`torch.library.custom_op`s with the Functions' backwards), so the remat
policy can name them and keep their outputs, as it keeps `aten.mm`'s on
the "jnp" path.  Elsewhere the Functions call the kernels directly: a
dispatcher op costs the host more per call.

The MoE layer's expert stacks go through `expert_linear` and
`expert_fused_hidden`: one batched launch per expert stack on the card.
Under autograd they take `_ExpertLinear` (its dgrad and wgrad the batched
tile GEMM on `.mT` views), `_QuantizedExpertLinear` (the batched int8
forward, `_ExpertLinear`'s backward: straight-through) and
`_FusedHiddenExpert` (the batched recompute backward), on either device:
the plain versions on CPU tensors, the kernels on CUDA ones.  remat="dots"
cannot name these Functions, so it recomputes the expert products.

Weights are cast to the activation dtype per call, as JAX does: a no-op on
the serving path (params arrive in the compute dtype), and on the training
path (float32 masters) the cast's own backward returns the float32
gradient.
"""
from __future__ import annotations

import contextlib
import re

import torch

from ..kernels.fused_mlp.ops import (fused_mlp_bwd_expert, fused_mlp_hidden,
                                     fused_mlp_hidden_expert)
from ..kernels.fused_mlp.ref import fused_mlp_hidden_ref
from ..kernels.matmul.ops import matmul, matmul_expert
from ..kernels.quantized.ops import (int8_fused_mlp_hidden, int8_matmul, int8_matmul_expert,
                                     int8_matmul_q)
from ..parallel import sharding as sh
from ..quant import QuantizedTensor, k_major, quantize_int8, quantize_weight

LINEAR_IMPLS = ("jnp", "pallas", "tuned", "fused", "quantized")

# The weight container of the quantized path is `quant.QuantizedTensor`,
# under the dispatch layer's name.
QuantizedLinear = QuantizedTensor


def _check_impl(impl: str) -> None:
    if impl not in LINEAR_IMPLS:
        raise ValueError(
            f"unknown linear_impl {impl!r}; valid: {list(LINEAR_IMPLS)}")


def _linear_setup(ctx, inputs, output):
    x2, w, ctx.tuned = inputs
    ctx.save_for_backward(x2, w)


def _linear_backward(ctx, g):
    x2, w = ctx.saved_tensors
    g = g.contiguous()
    dx = matmul(g, w.T, tuned=ctx.tuned) if ctx.needs_input_grad[0] else None
    dw = matmul(x2.T, g, tuned=ctx.tuned) if ctx.needs_input_grad[1] else None
    return dx, dw, None


class _Linear(torch.autograd.Function):
    """JAX's `_pallas_linear` (models/linear.py:75-97): x2 (m, k) @ w (k, n)."""

    @staticmethod
    def forward(x2, w, tuned):
        return matmul(x2, w, tuned=tuned)

    setup_context = staticmethod(_linear_setup)
    backward = staticmethod(_linear_backward)


@torch.library.custom_op("repro_torch::linear_fwd", mutates_args=())
def linear_fwd(x2: torch.Tensor, w: torch.Tensor, tuned: bool) -> torch.Tensor:
    """`_Linear` as one dispatcher op with the same backward: the tile GEMM
    on a CUDA tensor, its plain version on a CPU one."""
    return matmul(x2, w, tuned=tuned)


linear_fwd.register_autograd(_linear_backward, setup_context=_linear_setup)

_PRODUCTS_AS_OPS = False


@contextlib.contextmanager
def products_as_ops():
    """Within it, a recorded kernel-path product runs as a dispatcher op
    (`linear_fwd`, `repro_torch::fused_mlp_hidden`) that a dispatch mode
    can see."""
    global _PRODUCTS_AS_OPS
    before, _PRODUCTS_AS_OPS = _PRODUCTS_AS_OPS, True
    try:
        yield
    finally:
        _PRODUCTS_AS_OPS = before


class _QuantizedLinear(torch.autograd.Function):
    """JAX's `_quantized_linear` (models/linear.py:100-123): the int8 GEMM
    forward on a float weight (a row-parallel product's under tensor
    parallelism with its scales over `model`: `_int8`); `_Linear`'s dgrad
    and wgrad on the tile GEMM (straight-through), on the rank's shard."""

    @staticmethod
    def forward(x2, w, row):
        return _int8(x2, w, row)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x2, w, _ = inputs
        ctx.tuned = True
        ctx.save_for_backward(x2, w)

    backward = staticmethod(_linear_backward)


class _QuantizedLinearFrozen(torch.autograd.Function):
    """JAX's `_quantized_linear_frozen` (models/linear.py:126-149): a
    prequantized weight; dx from the de-quantized weight (under tensor
    parallelism, a row-parallel shard's: `row`), none for the payload or
    its scales."""

    @staticmethod
    def forward(ctx, x2, wq, wscale, row):
        ctx.dtype = x2.dtype
        ctx.save_for_backward(wq, wscale)
        return _int8(x2, QuantizedTensor(wq, wscale, -2), row)

    @staticmethod
    def backward(ctx, g):
        wq, wscale = ctx.saved_tensors
        w = (wq.float() * wscale).to(ctx.dtype)
        return matmul(g.contiguous(), w.T, tuned=True), None, None, None


# --- int8 under tensor parallelism ---------------------------------------------------
#
# A column-parallel product (wq / wk / wv, w_gate / w_up, the head) keeps its
# whole fan-in: its activation's row scales and its weight's column scales
# are the unsharded run's as they stand.  A row-parallel one (wo, w_down,
# out_proj) holds a slice of the fan-in, so each scale is taken as a MAX
# over `model` of the rank's absmax; a maximum is exact, so the int8 codes
# equal the unsharded run's and only the f32 sum over `model` (`tp_exit`)
# differs in order.  A prequantized weight was quantized whole before the
# shard: its payload's rows are sharded, its scales replicated.

def row_activation_absmax(x2):
    """Each activation row's absmax over the whole (sharded) fan-in."""
    return sh.max_over_tp(x2.float().abs().amax(dim=-1, keepdim=True))


def row_weight_absmax(w):
    """Each weight column's absmax over the whole (sharded) fan-in."""
    return sh.max_over_tp(w.float().abs().amax(dim=-2, keepdim=True))


def _row_int8(x2, w):
    """x2 (m, k_shard) @ w (k_shard, n) on the int8 GEMM, quantized with
    the whole fan-in's scales: the rank's partial sum, in x2's dtype."""
    a_q, a_scale = quantize_int8(x2, -1, row_activation_absmax(x2))
    if not isinstance(w, QuantizedTensor):
        q, scale = quantize_int8(w, -2, row_weight_absmax(w))
        w = QuantizedTensor(k_major(q), scale, -2)
    return int8_matmul_q(a_q, a_scale, w.q, w.scale.reshape(1, -1), x2.dtype, tuned=True,
                         act_dtype=x2.dtype)


def _int8(x2, w, row: bool):
    """The int8 product of x2 and w; a row-parallel one (`row`) under tensor
    parallelism with its scales over `model`."""
    return _row_int8(x2, w) if row and sh.tp_size() > 1 else int8_matmul(x2, w, tuned=True)


def _grad_recorded(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _quantized_linear(x, w, row: bool):
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if isinstance(w, QuantizedTensor):
        out = (_QuantizedLinearFrozen.apply(x2, w.q, w.scale.reshape(1, -1), row)
               if _grad_recorded(x) else _int8(x2, w, row))
        return out.reshape(*lead, w.q.shape[-1])
    w = w.to(x.dtype)
    out = _QuantizedLinear.apply(x2, w, row) if _grad_recorded(x, w) else _int8(x2, w, row)
    return out.reshape(*lead, w.shape[-1])


def linear(x, w, *, impl: str = "jnp", row: bool = False):
    """y = x @ w with dispatched execution.  x: (..., k); w: (k, n), or a
    `QuantizedLinear` under impl="quantized".  `row`: a row-parallel
    product (wo, w_down, out_proj), whose fan-in is sharded over `model`
    under tensor parallelism; on the int8 path its scales are then taken
    over `model` (`_row_int8`)."""
    _check_impl(impl)
    if impl == "quantized":
        return _quantized_linear(x, w, row)
    w = w.to(x.dtype)
    if impl == "jnp":
        return x @ w
    tuned = impl != "pallas"
    if _grad_recorded(x, w):
        lead, k = x.shape[:-1], x.shape[-1]
        fn = linear_fwd if _PRODUCTS_AS_OPS else _Linear.apply
        return fn(x.reshape(-1, k), w, tuned).reshape(*lead, w.shape[-1])
    return matmul(x, w, tuned=tuned)


def _expert_setup(ctx, inputs, output):
    x, w, ctx.tuned = inputs
    ctx.save_for_backward(x, w)


def _expert_backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.contiguous()
    dx = matmul_expert(g, w.mT, tuned=ctx.tuned) if ctx.needs_input_grad[0] else None
    dw = matmul_expert(x.mT, g, tuned=ctx.tuned) if ctx.needs_input_grad[1] else None
    return dx, dw, None


class _ExpertLinear(torch.autograd.Function):
    """JAX's `_pallas_linear` mapped over the experts (models/linear.py:
    232-235): x (e, m, k) @ w (e, k, n), the dgrad g @ w^T and the wgrad
    x^T @ g each one batched launch on `.mT` views."""

    @staticmethod
    def forward(x, w, tuned):
        return matmul_expert(x, w, tuned=tuned)

    setup_context = staticmethod(_expert_setup)
    backward = staticmethod(_expert_backward)


class _QuantizedExpertLinear(_ExpertLinear):
    """JAX's `_quantized_linear` mapped over the experts (models/linear.py:
    225-231): the batched int8 forward on a float expert stack, quantized
    per call; `_ExpertLinear`'s float dgrad and wgrad (straight-through)."""

    @staticmethod
    def forward(x, w, tuned):
        return int8_matmul_expert(x, w, tuned=tuned)


class _FusedHiddenExpert(torch.autograd.Function):
    """JAX's `fused_mlp_hidden` custom VJP mapped over the experts
    (models/linear.py:323-341): the batched fused forward; it saves only
    its inputs, and the backward recomputes the gate/up pre-activations
    (`fused_mlp_bwd_expert`)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, mlp_type):
        ctx.mlp_type = mlp_type
        ctx.save_for_backward(x, w_gate, w_up)
        return fused_mlp_hidden_expert(x, w_gate, w_up, mlp_type=mlp_type, tuned=True)

    @staticmethod
    def backward(ctx, dh):
        x, w_gate, w_up = ctx.saved_tensors
        dx, dwg, dwu = fused_mlp_bwd_expert(x, w_gate, w_up, dh.contiguous(),
                                            mlp_type=ctx.mlp_type, tuned=True)
        return dx, dwg, dwu, None


def expert_linear(x, w, *, impl: str = "jnp"):
    """Batched per-expert GEMM: x (e, m, k) @ w (e, k, n) -> (e, m, n).

    "jnp" keeps the einsum; "pallas", "tuned" and "fused" run ONE launch of
    the tile GEMM for all experts (`matmul_expert`, the expert on the grid's
    z axis) where JAX maps one Pallas kernel per expert (`lax.map`); "tuned"
    and "fused" look up the per-expert (m, k, n) key, as JAX's do.
    "quantized" runs ONE launch of the int8 GEMM (`int8_matmul_expert`),
    the float stack quantized per call and per expert, as JAX's.  When a
    gradient is recorded they run as `_ExpertLinear` /
    `_QuantizedExpertLinear`."""
    _check_impl(impl)
    w = w.to(x.dtype)
    if impl == "jnp":
        return torch.einsum("emk,ekn->emn", x, w)
    x = x.contiguous()
    if impl == "quantized":
        if _grad_recorded(x, w):
            return _QuantizedExpertLinear.apply(x, w, True)
        return int8_matmul_expert(x, w, tuned=True)
    tuned = impl != "pallas"
    if _grad_recorded(x, w):
        return _ExpertLinear.apply(x, w, tuned)
    return matmul_expert(x, w, tuned=tuned)


def expert_fused_hidden(x, w_gate, w_up, *, mlp_type: str):
    """Per-expert fused hidden: x (e, m, h) with (e, h, f) expert weights ->
    (e, m, f), one launch of the fused MLP kernel for all experts
    (`fused_mlp_hidden_expert`, tuned), the MoE counterpart of `fused_mlp`'s
    hidden half; `_FusedHiddenExpert` when a gradient is recorded."""
    dt = x.dtype
    w_gate = None if mlp_type != "swiglu" else w_gate.to(dt)
    w_up = w_up.to(dt)
    x = x.contiguous()
    if _grad_recorded(x, w_gate, w_up):
        return _FusedHiddenExpert.apply(x, w_gate, w_up, mlp_type)
    return fused_mlp_hidden_expert(x, w_gate, w_up, mlp_type=mlp_type, tuned=True)


def fused_mlp(x, p, cfg):
    """Full MLP block through the fused hidden kernel + the tile-GEMM down
    projection.  p: {w_gate (swiglu), w_up, w_down}; x: (..., h)."""
    dt = x.dtype
    w_gate = p["w_gate"].to(dt) if cfg.mlp_type == "swiglu" else None
    hidden = fused_mlp_hidden(x, w_gate, p["w_up"].to(dt), mlp_type=cfg.mlp_type, tuned=True,
                              as_op=_PRODUCTS_AS_OPS)
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
        return int8_fused_mlp_hidden(x2, w_gate, w_up, mlp_type=mlp_type, tuned=True)

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
    inference path.  Under tensor parallelism w_down is row-parallel: its
    scales are taken over `model` (`_row_int8`)."""
    lead, h = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, h)
    w_gate = p.get("w_gate") if cfg.mlp_type == "swiglu" else None
    w_up = p["w_up"]
    if isinstance(w_up, QuantizedTensor):
        hidden = int8_fused_mlp_hidden(x2, w_gate, w_up, mlp_type=cfg.mlp_type, tuned=True)
    else:
        w_gate = None if w_gate is None else w_gate.to(x.dtype)
        w_up = w_up.to(x.dtype)
        if _grad_recorded(x2, w_gate, w_up):
            hidden = _QuantizedHidden.apply(x2, w_gate, w_up, cfg.mlp_type)
        else:
            hidden = int8_fused_mlp_hidden(x2, w_gate, w_up, mlp_type=cfg.mlp_type, tuned=True)
    return linear(hidden.reshape(*lead, hidden.shape[-1]), p["w_down"], impl="quantized",
                  row=True)
