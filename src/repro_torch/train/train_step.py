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
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import MeshConfig, ModelConfig, ShapeConfig, TrainConfig
from ..models import lm_loss
from ..optim.adamw import OptState, apply_updates, tree_leaves, tree_map


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
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig, n_micro: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    batch: dict of (global_batch, ...) tensors on the params' device.  With
    n_micro > 1 the batch splits into n_micro equal microbatches whose
    gradients are summed in float32 and averaged, as are loss and metrics.
    """

    def train_step(params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        if n_micro == 1:
            loss, metrics, grads = _grads(params, leaves, batch, cfg, tc)
        else:
            micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
                     for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), device=leaves[0].device)
            ms = []
            for i in range(n_micro):
                l, m, g = _grads(params, leaves, {k: v[i] for k, v in micro.items()}, cfg, tc)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss = loss + l
                ms.append(m)
            grads = [g / n_micro for g in grads]
            loss = loss / n_micro
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = apply_updates(params, grads, opt_state, tc)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
