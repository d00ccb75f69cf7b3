"""GPipe-style pipeline parallelism over a mesh axis (the JAX package's
`parallel/pipeline.py`), over `torch.distributed` point-to-point ops.

Each stage holds L / num_stages layers (the paper's §VI-B rule "L divisible
by the number of pipeline stages" is asserted).  Microbatches stream
through the stages on JAX's schedule: M + S - 1 ticks, stage s live for t
in [s, s + M), working on microbatch t - s; an activation hops one stage on
by send / recv, and the last stage's outputs are broadcast to every rank.
JAX computes every tick on every device and masks the ticks outside a
stage's window (SPMD has no per-device control flow); here a stage runs
only its live ticks, with the same results.

It is differentiable, as JAX's is: a hop's backward sends the activation's
gradient back one stage (`comm.send_grad` / `recv_grad`).  Every rank of
the axis must take the backward of a loss of the output, as every device of
an SPMD program does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from . import comm


def _stage_slice(tree):
    if isinstance(tree, dict):
        return {k: _stage_slice(v) for k, v in tree.items()}
    return tree[0]


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run a layer stack split across `axis` as a GPipe pipeline.

    stage_fn(params_for_stage, microbatch) -> microbatch  (one stage's layers)
    stage_params: this rank's block of a tree whose leaves have a leading
                  dim of num_stages sharded over `axis` (leading dim 1 here).
    x: (num_micro, micro_batch, ...) microbatched input, the same on every
       rank of the axis.

    Returns the (num_micro, micro_batch, ...) outputs on every rank.
    """
    num_stages = mesh.axis_size(axis)
    num_micro = x.shape[0]
    group = mesh.group(axis)
    if group is None:
        params = _stage_slice(stage_params)
        return torch.stack([stage_fn(params, x[m]) for m in range(num_micro)])
    stage = mesh.index(axis)
    ranks = torch.distributed.get_process_group_ranks(group)   # stage -> global rank
    params = _stage_slice(stage_params)
    grad = torch.is_grad_enabled()
    anchor = torch.zeros((), requires_grad=True) if grad and stage > 0 else None
    like = torch.empty_like(x[0])
    pending, tokens, outputs = [], [], []
    for t in range(num_micro + num_stages - 1):
        m = t - stage
        if not 0 <= m < num_micro:
            continue
        h = x[m] if stage == 0 else comm.recv_grad(like, ranks[stage - 1], m, group, anchor)
        out = stage_fn(params, h)
        if stage == num_stages - 1:
            outputs.append(out)
        else:
            tokens.append(comm.send_grad(out, ranks[stage + 1], m, group, pending))
    last = num_stages - 1
    held = torch.stack(outputs) if stage == last else torch.empty_like(x)
    y = _Broadcast.apply(held, ranks[last], group) if grad else comm.broadcast(held, ranks[last],
                                                                              group)
    for work, _buf in pending:
        work.wait()
    if tokens:   # keep this stage's sends in the graph: their backward receives
        y = y + 0 * torch.stack(tokens).sum().to(y.dtype)
    return y


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every rank, a value the ranks share: its
    gradient is the last stage's own (the other ranks' inputs are
    placeholders)."""

    @staticmethod
    def forward(ctx, held, src, group):
        ctx.src = src
        return comm.broadcast(held, src, group)

    @staticmethod
    def backward(ctx, g):
        mine = torch.distributed.get_rank() == ctx.src
        return (g if mine else None), None, None


def split_layers_into_stages(stacked_params: Any, num_stages: int) -> Any:
    """(L, ...) stacked layer params -> (num_stages, L/num_stages, ...).

    Asserts the paper's §VI-B rule: L % num_stages == 0.
    """
    def reshape(t):
        L = t.shape[0]
        assert L % num_stages == 0, (
            f"L={L} not divisible by pipeline stages={num_stages} "
            "(paper §VI-B)")
        return t.reshape((num_stages, L // num_stages) + tuple(t.shape[1:]))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return reshape(tree)
    return walk(stacked_params)
