"""Mixture-of-Experts layer: top-k routing, capacity-bounded sort-based
dispatch, batched-expert GEMMs, shared experts (the JAX package's
`models/moe.py`, one to one).

The expert FFN is `num_experts` GEMMs of size (capacity, h) x (h, moe_d_ff)
-- the `moe_expert_*` entries of `core/transformer_gemms.py` -- run as ONE
batched launch per expert stack (`linear.expert_linear`,
`linear.expert_fused_hidden`).  Dispatch is sort-based: entries (token,
choice) are sorted by expert (stable), positioned within their expert's
capacity window, and scattered into an (E, capacity, h) buffer; entries
past the window drop.  One device has nothing to shard, so JAX's layout
anchors (`parallel.sharding.constrain`) have no counterpart here.

Two places differ from a literal translation, for the card's sake:
  * dispatch: JAX adds every entry into the buffer, the dropped ones as
    zeros aimed at row e*cap-1, a real slot of the last expert.  A copying
    scatter would overwrite that slot, so here the dropped entries go to a
    trash row past the buffer, and the kept destinations are unique.
  * combine: JAX scatter-adds each entry's gated output into its token's
    row, which XLA on the CPU sums in entry order: a token's k outputs in
    ascending expert order.  `index_add_` on the card uses atomics, whose
    order (and so the bf16 sum) changes run to run.  Here each token's k
    outputs are gathered in ascending expert order and summed in that
    fixed order in x's dtype: deterministic on the card, and JAX's order on
    the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .layers import dense_init
from .linear import expert_fused_hidden, expert_linear, linear
from .mlp import apply_mlp, init_mlp

MOE_DISPATCHES = ("auto", "shard_map")


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig, *, lead=(), device=None,
             dtype=torch.float32):
    """Router (h, E), expert stacks (E, h, f) / (E, f, h), and the shared
    expert: an MLP of width moe_d_ff * num_shared_experts."""
    h, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5
    kw = dict(device=device, dtype=dtype)
    p = {"router": dense_init(gen, h, e, scale=0.5, lead=lead, **kw),
         "w_up": dense_init(gen, h, f, lead=(*lead, e), **kw),
         "w_down": dense_init(gen, f, h, scale=out_scale, lead=(*lead, e), **kw)}
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = dense_init(gen, h, f, lead=(*lead, e), **kw)
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.moe_d_ff * cfg.num_shared_experts,
                               lead=lead, **kw)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.moe_capacity_factor / cfg.num_experts)
    return max(cap - cap % -8, 8)  # round up to 8 (sublane alignment)


def route(p, xt, cfg: ModelConfig):
    """Router probabilities (t, E) in f32, and the top-k gates (renormalised)
    and experts (t, k), descending by probability."""
    probs = torch.softmax(linear(xt, p["router"], impl=cfg.linear_impl).float(), dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)  # renormalize
    return probs, gate, idx


def apply_moe(p, x, cfg: ModelConfig):
    """x: (b, s, h) -> (y, aux_loss); aux_loss a 0-d f32 tensor."""
    if cfg.moe_dispatch not in MOE_DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}; valid: "
                         f"{list(MOE_DISPATCHES)}")
    if cfg.moe_dispatch == "shard_map":
        raise NotImplementedError(
            "moe_dispatch='shard_map' (expert-parallel dispatch across devices) is not "
            "ported yet: it comes with the parallelism slice")
    b, s, h = x.shape
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(b * s, h)
    t = b * s
    cap = _capacity(t, cfg)
    impl = cfg.linear_impl
    dev = x.device

    probs, gate, idx = route(p, xt, cfg)
    # load-balance auxiliary loss (Switch/GShard form); the counts are exact
    # f32 integers in any order (and need no host sync, as bincount would)
    counts = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, idx.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=dev))
    aux = e * (counts / (t * k) * probs.mean(0)).sum()

    # ---- sort-based dispatch -------------------------------------------------
    flat_expert = idx.reshape(-1)                       # (t*k,)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = torch.div(order, k, rounding_mode="floor")     # the entry's token
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev), side="left")
    pos = torch.arange(t * k, device=dev) - seg_start[se]
    keep = pos < cap
    # dropped entries go to a trash row past the (e * cap) buffer
    dst = torch.where(keep, se * cap + pos, e * cap)
    buf = torch.zeros((e * cap + 1, h), dtype=x.dtype, device=dev)
    buf.index_put_((dst,), xt[st])
    buf = buf[:e * cap].view(e, cap, h)

    # ---- batched expert GEMMs (E x (cap,h)x(h,f)), one launch per stack ----
    if impl == "fused":
        hdn = expert_fused_hidden(buf, p.get("w_gate"), p["w_up"],
                                  mlp_type="swiglu" if cfg.mlp_type == "swiglu" else "gelu")
    elif cfg.mlp_type == "swiglu":
        g = torch.nn.functional.silu(expert_linear(buf, p["w_gate"], impl=impl))
        u = expert_linear(buf, p["w_up"], impl=impl)
        hdn = g * u
    else:
        hdn = torch.nn.functional.gelu(expert_linear(buf, p["w_up"], impl=impl),
                                       approximate="tanh")
    out_buf = expert_linear(hdn, p["w_down"], impl=impl).reshape(e * cap, h)

    # ---- gather back + combine, in ascending expert order per token ----------
    picked = torch.where(keep[:, None], out_buf[dst.clamp_max(e * cap - 1)],
                         torch.zeros((), dtype=x.dtype, device=dev))
    contrib = picked * gate.reshape(-1)[order].to(x.dtype)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    # token i's entries in sorted (= ascending expert) order
    by_token = inv.view(t, k).sort(dim=-1).values
    c = contrib[by_token]                               # (t, k, h)
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]

    if cfg.num_shared_experts:
        y = y + apply_mlp(p["shared"], xt, cfg)
    return y.reshape(b, s, h), aux
