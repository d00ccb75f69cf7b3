"""Training step: loss and gradients, microbatched gradient accumulation in
float32, and the AdamW update (the JAX package's `train/train_step.py`).

Params are float32 masters (nested dicts of leaves); the step marks them as
requiring grad, takes the gradient of `lm_loss` with `torch.autograd.grad`,
and updates params and optimizer state in place (`optim.adamw`).  A Python
loop over microbatches takes the place of `lax.scan`; remat is applied
inside the layer loop (`models/blocks.py`).  It trains every family
`lm_loss` takes: the dense decoder, mamba2 and zamba2 (the SSD kernel and
its backward kernel under `kernels/ssd/ops.py` `_SSDChunk`); the MoE and
MLA families on the host (their metrics, aux_loss and mtp_loss, pass
through), since the card's batched expert launch is forward-only.

Under a sharding plan (`parallel/sharding.py`; `launch/train.py --data /
--model`) params and moments are this rank's blocks.  Each rank takes its
rows of every global microbatch (`Plan.batch_rows`) and the gradient of
its share of the global loss; the model gathers each data-sharded leaf
where it uses it, a layer at a time (`sharding.fsdp_use`: the gradient
comes back reduce-scattered to the block).  The step all-reduces the
other leaves' gradients over the data axes (`Plan.reduce_grads`) and
updates its blocks (the clip norm and adamw8bit's row absmax over the
global tree).  The sum over ranks is the global batch's gradient, so the
step is the single-device one.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import MeshConfig, ModelConfig, ShapeConfig, TrainConfig
from ..core import op_analysis
from ..models import lm_loss
from ..optim.adamw import OptState, apply_updates, tree_leaves, tree_map
from ..parallel import sharding as sh


def num_microbatches(shape: ShapeConfig, mesh_cfg: MeshConfig, tc: TrainConfig) -> int:
    per_step = mesh_cfg.dp * tc.microbatch_per_device
    if shape.global_batch % per_step:
        raise ValueError(
            f"global_batch {shape.global_batch} % (dp {mesh_cfg.dp} * "
            f"microbatch {tc.microbatch_per_device}) != 0")
    return shape.global_batch // per_step


def _grads(params, leaves, batch, cfg, tc):
    loss, metrics = lm_loss(params, batch, cfg, remat=tc.remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    # metrics["loss"] is the global loss (`loss` a rank's share under a plan)
    return metrics["loss"].detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig, n_micro: int = 1,
                    plan: Optional[sh.Plan] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    batch: dict of (global_batch, ...) tensors on the params' device.  With
    n_micro > 1 the batch splits into n_micro equal microbatches whose
    gradients are summed in float32 and averaged, as are loss and metrics.
    plan: a sharding plan; params and opt_state are then this rank's
    blocks (`Plan.shard`) and batch is still the global batch.
    """

    @sh.under(plan)
    def train_step(params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        specs = None
        if plan is not None:
            specs = plan.specs(params)
            batch = plan.batch_rows(batch, n_micro)
        if n_micro == 1:
            loss, metrics, grads = _grads(params, leaves, batch, cfg, tc)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), device=leaves[0].device)
            zero, sums = torch.zeros_like(loss), {}
            # JAX's scan over microbatches: under the op counter's trace_one
            # rule one pass runs, counted n_micro times (core/op_analysis.py);
            # every pass does the same work, the metrics' sums included
            for i in op_analysis.repeat("microbatch", n_micro):
                l, m, g = _grads(params, leaves, {k: v[i] for k, v in micro.items()}, cfg, tc)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss = loss + l
                sums = {k: sums.get(k, zero) + v for k, v in m.items()}
            grads = [g / n_micro for g in grads]
            loss = loss / n_micro
            metrics = {k: v / n_micro for k, v in sums.items()}
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if plan is not None:
            grads = plan.reduce_grads(grads, specs)
        params, opt_state, om = apply_updates(params, grads, opt_state, tc, plan=plan,
                                              specs=specs)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
