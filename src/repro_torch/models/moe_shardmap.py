"""Expert-parallel MoE with explicit collective scheduling (the JAX
package's `models/moe_shardmap.py`, `moe_dispatch="shard_map"`).

Tokens are sharded over `data` and replicated over `model` (the EP axis),
so selection, capacity packing and the expert FFN are local to each
(data, model) rank: each packs only the tokens routed to its E / model
resident experts, with a capacity computed from its own tokens (`t_loc`,
JAX's `_local_block`), and the combine is one sum over `model` per layer.
Unlike the "auto" dispatch (`moe.apply_moe_auto`), nothing is global over
`data`: a data rank drops what its own capacity window does not hold, as
JAX's shard_map block does.  The load-balance loss is each data rank's own
(JAX's shard_map returns it replicated); the loss counts their mean.

Without a sharding plan it is the "auto" dispatch, as JAX's falls back
without a mesh.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..parallel import sharding as sh
from . import moe


def apply_moe_shardmap(p, x, cfg: ModelConfig):
    """x: (b, s, h), this data rank's tokens -> (y, aux)."""
    if sh.active() is None:
        return moe.apply_moe_auto(p, x, cfg)
    x = sh.tokens_whole(x)
    b, s, h = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t_loc = b * s
    xt = x.reshape(t_loc, h)
    probs, gate, idx = moe.route(p, xt, cfg)
    # load-balance aux (identical on every model rank: the same tokens)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, idx.reshape(-1), torch.ones(t_loc * k, dtype=torch.float32, device=x.device))
    aux = e * (counts / (t_loc * k) * probs.mean(0)).sum()
    y = moe.dispatch_combine(p, xt, gate, idx, cfg, moe._capacity(t_loc, cfg),
                             torch.zeros_like(counts))
    return sh.tp_exit(y.reshape(b, s, h)), aux
