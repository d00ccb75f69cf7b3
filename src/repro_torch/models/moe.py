"""Mixture-of-Experts layer: top-k routing, capacity-bounded sort-based
dispatch, batched-expert GEMMs, shared experts (the JAX package's
`models/moe.py`, one to one).

The expert FFN is `num_experts` GEMMs of size (capacity, h) x (h, moe_d_ff)
-- the `moe_expert_*` entries of `core/transformer_gemms.py` -- run as ONE
batched launch per expert stack (`linear.expert_linear`,
`linear.expert_fused_hidden`).  Dispatch is sort-based: entries (token,
choice) are sorted by expert (stable), positioned within their expert's
capacity window, and scattered into an (E, capacity, h) buffer; entries
past the window drop.  JAX's layout anchors (`parallel.sharding.constrain`)
have no counterpart: under a sharding plan the dispatch is explicit.  The
experts are sharded on `model` (the (E, h, f) specs), each rank packs and
runs only its own experts' entries, and the combine is one all-reduce over
`model`; under data parallelism the capacity and each entry's slot are the
global batch's, as JAX's "auto" dispatch computes them
(`global_slots`).  Under sequence parallelism the layer's input, a
sequence shard, is all-gathered first (`tokens_whole`) and the combine is
a reduce-scatter on the sequence instead (`tp_exit`).

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
from ..parallel import comm
from ..parallel import sharding as sh
from .layers import dense_init
from .linear import expert_fused_hidden, expert_linear, linear
from .mlp import init_mlp, mlp_partial

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
    """x: (b, s, h) -> (y, aux_loss); aux_loss a 0-d f32 tensor.
    moe_dispatch "shard_map" under a sharding plan takes JAX's explicit
    expert-parallel schedule (`moe_shardmap.py`); without a plan it is the
    "auto" dispatch, as JAX's falls back without a mesh."""
    if cfg.moe_dispatch not in MOE_DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}; valid: "
                         f"{list(MOE_DISPATCHES)}")
    if cfg.moe_dispatch == "shard_map" and sh.active() is not None:
        from .moe_shardmap import apply_moe_shardmap
        return apply_moe_shardmap(p, x, cfg)
    return apply_moe_auto(p, x, cfg)


def global_slots(counts, t: int):
    """Under data parallelism: (each local expert's entries on the data
    ranks before this one, the global token count).  JAX's "auto" dispatch
    packs the global batch, so an entry's slot in its expert's capacity
    window counts every earlier rank's entries (an exclusive scan of the E
    counts over the data ranks), and the capacity is the global batch's."""
    dp = sh.dp_size()
    if dp == 1:
        return torch.zeros_like(counts), t
    every = sh.gather_dp(counts[None], 0)                 # (dp, E)
    return every[:sh.active().dp_rank].sum(0), t * dp


def apply_moe_auto(p, x, cfg: ModelConfig):
    """JAX's "auto" dispatch: capacity and slots over the global batch, the
    experts this rank holds (all of them without a plan)."""
    x = sh.tokens_whole(x)
    b, s, h = x.shape
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(b * s, h)
    t = b * s
    dev = x.device

    probs, gate, idx = route(p, xt, cfg)
    # load-balance auxiliary loss (Switch/GShard form); the counts are exact
    # f32 integers in any order (and need no host sync, as bincount would)
    counts = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, idx.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=dev))
    before, t_all = global_slots(counts, t)
    if t_all == t:
        frac_probs = probs.mean(0)
    else:   # the global batch's statistics, the same on every data rank
        counts = comm.all_reduce(counts, sh.active().dp_group)
        frac_probs = sh.sum_over_dp(probs.sum(0)) / t_all
    aux = e * (counts / (t_all * k) * frac_probs).sum()
    y = dispatch_combine(p, xt, gate, idx, cfg, _capacity(t_all, cfg), before)
    return sh.tp_exit(y.reshape(b, s, h)), aux


def dispatch_combine(p, xt, gate, idx, cfg: ModelConfig, cap: int, before):
    """Pack the entries of this rank's experts into their capacity windows,
    run the expert FFN, and sum each token's kept outputs; plus the shared
    expert.  `before[e]`: entries of expert e that come earlier in the
    global order (on other data ranks); an entry is kept where its global
    slot is under `cap`.  Under tensor parallelism the experts are this
    rank's E / model (p's stacks), and the result is this rank's share of
    the sum over `model`, which the caller takes (`tp_exit`)."""
    t, h = xt.shape
    k = cfg.top_k
    impl = cfg.linear_impl
    dev = xt.device
    e_loc = p["w_up"].shape[0]
    lo = sh.tp_rank() * e_loc
    # replicated inputs to this rank's share of the experts: their
    # gradients are summed over `model` (the router's is not: every rank
    # computes it whole)
    xin, gate = sh.copy_to_tp(xt), sh.copy_to_tp(gate)

    # ---- sort-based dispatch -------------------------------------------------
    flat_expert = idx.reshape(-1) - lo                  # (t*k,), local ids
    local = (flat_expert >= 0) & (flat_expert < e_loc)
    flat_expert = torch.where(local, flat_expert, e_loc)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = torch.div(order, k, rounding_mode="floor")     # the entry's token
    seg_start = torch.searchsorted(se, torch.arange(e_loc, device=dev), side="left")
    sec = se.clamp_max(e_loc - 1)
    pos = torch.arange(t * k, device=dev) - seg_start[sec]
    keep = (se < e_loc) & (pos + before[lo + sec] < cap)
    # dropped entries go to a trash row past the (e * cap) buffer
    dst = torch.where(keep, se * cap + pos, e_loc * cap)
    buf = torch.zeros((e_loc * cap + 1, h), dtype=xt.dtype, device=dev)
    buf.index_put_((dst,), xin[st])
    buf = buf[:e_loc * cap].view(e_loc, cap, h)

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
    out_buf = expert_linear(hdn, p["w_down"], impl=impl).reshape(e_loc * cap, h)

    # ---- gather back + combine, in ascending expert order per token ----------
    picked = torch.where(keep[:, None], out_buf[dst.clamp_max(e_loc * cap - 1)],
                         torch.zeros((), dtype=xt.dtype, device=dev))
    contrib = picked * gate.reshape(-1)[order].to(xt.dtype)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    # token i's entries in sorted (= ascending expert) order
    by_token = inv.view(t, k).sort(dim=-1).values
    c = contrib[by_token]                               # (t, k, h)
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]

    if cfg.num_shared_experts:
        y = y + mlp_partial(p["shared"], xin, cfg)
    return y
