"""AdamW with a cosine schedule, global-norm clipping, and the int8
row-quantized moment variant (`adamw8bit`): plain functions on tensors, one
to one with the JAX package's `optim/adamw.py` (b1 0.9, b2 0.95, eps 1e-8,
decoupled weight decay on every leaf).

Unlike the JAX functions, `apply_updates` updates in place: each parameter
and moment tensor is overwritten with its new value (and the same dicts are
returned), so a step needs one leaf's temporaries, not a second copy of
the parameters and moments.  The float32 moments' update runs a slice of
UPDATE_CHUNK elements at a time: its arithmetic is elementwise, so the
slices give the same bits, and the temporaries stay ~2 GB where a whole
embedding's (3.7-4.1 GB a tensor at deepseek-v3's and llama4-maverick's
vocabularies, ~8 live at once) would not fit beside a full-width MoE's
masters, gradients and moments.  The arithmetic is JAX's, in float32, leaf
by leaf.  `init_opt` and the state's `step` live on the parameters'
device.

Under a sharding plan (`parallel/sharding.py`) params, gradients and
moments are this rank's blocks: the clip norm sums each leaf's squares
over the axes that shard it (`Plan.global_sq_sum`), and adamw8bit's row
absmax is the whole row's (`Plan.row_absmax`: a column-parallel leaf
shards the last dim over `model`, a row-parallel one over `data`).  The
int8 moments are sharded as their parameter is, their scales as the
parameter but whole along the last dim.  (JAX's spec tree names the
moment leaves "codes" and "scale", which no rule matches, so its int8
moments are replicated: the same numbers.)
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..configs.base import TrainConfig


# --- pytrees of nested dicts ---------------------------------------------------------

def tree_leaves(tree, is_leaf=None):
    """Leaves in insertion order (a dict is a node unless `is_leaf` says so)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        for v in tree.values():
            yield from tree_leaves(v, is_leaf)
    else:
        yield tree


def tree_map(fn, tree, *rest, is_leaf=None):
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


# --- row-wise int8 quantization ------------------------------------------------------

def quantize_i8(x: torch.Tensor, row_max=None):
    """x (param shape, f32) -> {codes: int8 same shape, scale: f32
    absmax/127 over the last dim (keepdims)}.  row_max: takes the local
    absmax to the whole row's (a sharded row)."""
    if x.dim() == 0:
        x = x[None]
    amax = x.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        amax = row_max(amax)
    scale = amax / 127.0
    scale = scale.clamp_min(1e-12)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale.float()}


def dequantize_i8(q, shape=None) -> torch.Tensor:
    out = q["codes"].float() * q["scale"]
    if shape is not None:
        out = out.reshape(shape)
    return out


def _is_quant(x) -> bool:
    return isinstance(x, dict) and "codes" in x


# --- schedules -----------------------------------------------------------------------

def lr_schedule(tc: TrainConfig):
    """step (int or tensor) -> learning rate (float32 tensor): linear warmup,
    then cosine decay to 10%."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return tc.learning_rate * warm * (0.1 + 0.9 * cos)
    return lr


# --- AdamW ---------------------------------------------------------------------------

class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Any
    v: Any


def init_opt(params, tc: TrainConfig) -> OptState:
    dev = next(tree_leaves(params)).device
    if tc.optimizer == "adamw8bit":
        zero = lambda p: quantize_i8(torch.zeros(p.shape, dtype=torch.float32, device=p.device))  # noqa: E731
    else:
        zero = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zero, params), tree_map(zero, params))


def global_norm(tree, plan=None, specs=None) -> torch.Tensor:
    """The L2 norm over every leaf; under a sharding plan, over the global
    tree whose blocks `tree` holds."""
    if plan is not None:
        return torch.sqrt(plan.global_sq_sum(tree, specs))
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, in float32; the norm)."""
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: x.float() * scale, grads), g


UPDATE_CHUNK = 1 << 26     # elements of a float32 leaf updated at once


def _adamw(p, g, m, v, clip, lr, bc1, bc2, b1, b2, eps, wd):
    """AdamW's arithmetic on a leaf (or a slice of one) and its float32
    moments: (new p, new m, new v) in float32."""
    g = g.float() * clip
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    pn = p.float()
    return pn - lr * (m / bc1 / (torch.sqrt(v / bc2) + eps) + wd * pn), m, v


@torch.no_grad()
def apply_updates(params, grads, state: OptState, tc: TrainConfig,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, *, plan=None,
                  specs=None):
    """One AdamW step, in place.  Returns (params, new_state, metrics).
    plan, specs: a sharding plan and the params' spec tree, when the trees
    hold this rank's blocks."""
    gnorm = global_norm(grads, plan, specs)
    clip = _clip_scale(gnorm, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(tc)(step)
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    eightbit = tc.optimizer == "adamw8bit"

    flat_p = list(tree_leaves(params))
    flat_g = list(tree_leaves(grads))
    flat_m = list(tree_leaves(state.m, _is_quant))
    flat_v = list(tree_leaves(state.v, _is_quant))
    flat_s = [()] * len(flat_p) if plan is None else list(tree_leaves(specs))
    hyper = (clip, lr, bc1, bc2, b1, b2, eps, tc.weight_decay)
    for p, g, m, v, spec in zip(flat_p, flat_g, flat_m, flat_v, flat_s):
        if eightbit:
            pn, m_f, v_f = _adamw(p, g, dequantize_i8(m, p.shape), dequantize_i8(v, p.shape),
                                  *hyper)
            p.copy_(pn)
            row_max = None if plan is None else (lambda a, spec=spec: plan.row_absmax(a, spec))
            for old, new in ((m, quantize_i8(m_f, row_max)), (v, quantize_i8(v_f, row_max))):
                old["codes"].copy_(new["codes"])
                old["scale"].copy_(new["scale"])
            continue
        pf, gf, mf, vf = p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)
        for i in range(0, pf.numel(), UPDATE_CHUNK):
            sl = slice(i, i + UPDATE_CHUNK)
            for old, new in zip((pf[sl], mf[sl], vf[sl]),
                                _adamw(pf[sl], gf[sl], mf[sl], vf[sl], *hyper)):
                old.copy_(new)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
