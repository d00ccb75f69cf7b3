"""Sharding: the JAX package's spec trees, and the explicit plan that does
what its SPMD partitioner does.

Mesh axes (as in JAX):
  pod    outer data parallelism
  data   data parallelism + FSDP (parameters and moments sharded)
  model  tensor parallelism (Megatron column / row pairs), expert
         parallelism, vocab sharding

`param_specs`, `batch_specs`, `cache_specs`, `strip_axis` and
`validate_divisibility` are JAX's, name for name.  A spec is a plain tuple
with one entry per dim: None, an axis name, or a tuple of axis names, with
leading Nones for stacked dims — JAX's `PartitionSpec` entries, as
`_base_spec` gives them.

JAX places each leaf by its spec and lets XLA insert the collectives, so a
sharded step computes what the single-device step computes.  PyTorch has no
partitioner that knows the port's kernels, so the `Plan` says where each
collective goes and the model calls it:
  * column-parallel projections (wq, wk, wv, w_gate, w_up and their biases)
    take their input through `copy_to_tp` (all-reduce of the input's
    gradient); row-parallel ones (wo, w_down) end in `reduce_from_tp`, one
    all-reduce over `model`;
  * the embedding is vocab-sharded (each rank looks up its rows, one
    all-reduce), the head column-parallel, its loss a vocab-parallel cross
    entropy (`models/lm.py`);
  * experts are sharded on `model`: each rank runs its own experts'
    assignments and the combine is one all-reduce (`models/moe.py`);
  * query heads that do not split over `model` (or KV heads that neither
    split into whole groups nor replicate): halo heads (`head_span`).  The
    params stay JAX's mid-head column slices; each rank all-gathers the
    q / k / v columns of the heads its slice touches (`gather_heads`,
    whose backward reduce-scatters), runs attention on those heads whole
    and keeps its own output columns for the row-parallel wo;
  * int8 weights (linear_impl="quantized"): a row-parallel product takes
    each activation row's absmax and a per-call weight's column absmax as
    a MAX over `model` (`max_over_tp`), so its int8 codes are the
    unsharded run's; a prequantized weight (`QuantizedTensor`) shards its
    payload by the leaf's spec and keeps the reduced axis of its scales
    whole (`Plan.shard`);
  * MLA: the column-sharded down projections' latents are all-gathered
    (`gather_latent`) before the up projections, which are column-parallel
    over heads (`models/attention.py` `apply_mla`);
  * the SSM block: d_inner and its heads over `model`, B / C / dt computed
    whole and sliced to the rank's heads (`scatter_to_tp`), the gated
    norm's mean square summed over `model` (`sum_over_tp`; `models/ssm.py`);
  * sequence parallelism (`cfg.seq_parallel`): below;
  * FSDP: the model gathers each data-sharded leaf where it uses it
    (`fsdp_use`: a layer's leaves in the layer loop, the embedding and
    head where they are applied), through `fsdp_gather`, whose backward
    reduce-scatters the gradient to the rank's block; the train step
    all-reduces the other leaves' gradients over the data axes
    (`reduce_grads`); the loss is each rank's share of the global mean, so
    the sum over ranks is the global batch's gradient.  A gathered layer
    lives as long as autograd keeps what was computed from it: under
    remat="full" or "dots" the gather runs inside the recomputed body, so
    the whole leaves are freed after the layer's forward and gathered
    again in its backward; under remat="none" each layer's
    compute-dtype weight copies stay saved for the backward, as they are
    on one device;
  * the clip norm sums each leaf's squares over the axes that shard it
    (`global_sq_sum`), and adamw8bit's row absmax is taken over the whole
    row (`row_absmax`).
JAX's activation context (`set_activation_context` / `constrain`) has no
counterpart: its job, telling the partitioner where activations live, is
what the plan above does by construction.  Model code reads the plan in
force (`use(plan)`, `active()`); with none, every helper is the identity
and the model is the single-device one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..configs.base import MeshConfig, ModelConfig
from ..quant import QuantizedTensor, k_major
from . import comm

# --- spec trees (the JAX package's, one to one) ----------------------------------------

def _axes(mesh):
    return set(mesh.axis_names)


def _base_spec(name: str, path: str, ndim_base: int, fsdp: Optional[str]):
    col = (fsdp, "model")       # (in, out) column-parallel
    row = ("model", fsdp)       # (in, out) row-parallel
    if name == "embed":
        return ("model", fsdp), 2          # (vocab, h)
    if name == "lm_head":
        return (fsdp, "model"), 2          # (h, vocab)
    if name == "pos_embed":
        return (None, fsdp), 2
    if name in ("wq", "wk", "wv", "wq_down", "wq_up", "wkv_down", "wk_up", "wv_up"):
        return col, 2
    if name in ("wo", "out_proj"):
        return row, 2
    if name in ("w_up", "w_gate"):
        if ndim_base == 3:                   # MoE expert stack (E, h, f)
            return ("model", fsdp, None), 3
        return col, 2
    if name == "w_down":
        if ndim_base == 3:                   # (E, f, h)
            return ("model", None, fsdp), 3
        return row, 2
    if name == "router":
        return (fsdp, None), 2
    if name == "proj":                        # MTP projection (2h, h)
        return (fsdp, None), 2
    if name in ("in_z", "in_x"):
        return col, 2
    if name in ("in_B", "in_C", "in_dt"):     # small n-dim: shard only fan-in
        return (fsdp, None), 2
    if name == "conv_x":
        return (None, "model"), 2
    if name in ("conv_B", "conv_C"):
        return (None, None), 2
    if name == "conv_bx":
        return ("model",), 1
    if name in ("conv_bB", "conv_bC"):
        return (None,), 1
    if name in ("A_log", "D", "dt_bias"):
        return ("model",), 1                 # nh sharded with d_inner
    if name in ("bq", "bk", "bv"):
        return ("model",), 1
    if name in ("scale", "bias"):
        # the SSD gated-norm scale lives on the TP-sharded d_inner dim
        if ".ssm." in path or "/ssm/" in path:
            return ("model",), 1
        return (None,), 1
    return None, None


def _ndim(leaf) -> int:
    if isinstance(leaf, QuantizedTensor):
        leaf = leaf.q
    return leaf.dim() if torch.is_tensor(leaf) else len(leaf.shape)


def _map(fn, tree, path=()):
    """fn(path, leaf) over a tree of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params: Any, cfg: ModelConfig, mesh, fsdp: bool = True) -> Any:
    """The spec tree matching `params` (leaves: tensors, or anything with a
    `.shape`).  A leaf with no rule is replicated: ()."""
    fsdp_ax = "data" if (fsdp and "data" in _axes(mesh)) else None

    def spec(path, leaf):
        pstr = "." + ".".join(str(k) for k in path) + "."
        name = str(path[-1])
        # MoE routed-expert stacks carry a leading expert dim (E, h, f)
        is_expert = (name in ("w_up", "w_gate", "w_down")
                     and ".moe." in pstr and ".shared." not in pstr)
        base, nd = _base_spec(name, pstr, 3 if is_expert else 2, fsdp_ax)
        if base is None:
            return ()
        lead = _ndim(leaf) - nd
        if lead < 0:
            return ()
        return (*([None] * lead), *base)

    return _map(spec, params)


def _P(*entries) -> tuple:
    """A spec as JAX's `PartitionSpec` holds it: a one-axis tuple entry is
    that axis's name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def batch_specs(cfg: ModelConfig, mesh) -> Any:
    """Input batch: global batch dim sharded over (pod, data)."""
    dp = ("pod", "data") if "pod" in _axes(mesh) else ("data",)
    return {"tokens": _P(dp, None), "labels": _P(dp, None), "loss_mask": _P(dp, None),
            "patch_embeds": _P(dp, None, None), "encoder_frames": _P(dp, None, None)}


def cache_specs(cfg: ModelConfig, mesh) -> Any:
    """Decode caches as JAX shards them: batch over (pod, data), SEQUENCE
    over model (its flash-decode-style distributed softmax); SSM states
    shard their head dim on `model`.  The port's plan holds attention
    caches sharded by KV head instead (the heads its column-parallel q / k
    / v produce), with the same numbers; these specs are JAX's, as data."""
    from ..models.blocks import stack_plan
    dp = ("pod", "data") if "pod" in _axes(mesh) else ("data",)

    def one(kind):
        kv = {"k": _P(None, dp, "model", None, None), "v": _P(None, dp, "model", None, None)}
        if cfg.attn_type == "mla":
            kv = {"latent": _P(None, dp, "model", None)}
        ssm = {"state": _P(None, dp, "model", None, None), "conv_x": _P(None, dp, None, "model"),
               "conv_B": _P(None, dp, None, None), "conv_C": _P(None, dp, None, None)}
        if kind in ("dense", "moe"):
            return kv
        if kind == "pair":
            return {"moe_blk": kv, "dense_blk": kv}
        if kind == "ssm":
            return ssm
        if kind == "hybrid_super":
            ssm2 = {k: (*s[:1], None, *s[1:]) for k, s in ssm.items()}
            return {"ssm": ssm2, "shared_attn": kv}
        raise ValueError(kind)

    return [one(kind) for kind, _ in stack_plan(cfg)]


def strip_axis(spec_tree: Any, axis: str = "model") -> Any:
    """Remove one mesh axis from every spec (e.g. disable TP for models whose
    per-shard widths fall under the 128-lane tile)."""
    def fix(_, p):
        return tuple(None if e == axis else
                     (tuple(a for a in e if a != axis) if isinstance(e, tuple) else e)
                     for e in p)
    return _map(fix, spec_tree)


def validate_divisibility(cfg: ModelConfig, mesh_cfg: MeshConfig,
                          global_batch: int) -> list[str]:
    """Hard constraints that must hold before lowering (paper §VI-B rules)."""
    errs = []
    t, d = mesh_cfg.model, mesh_cfg.dp
    if global_batch % d:
        errs.append(f"global_batch {global_batch} % dp {d} != 0")
    if cfg.num_heads and cfg.num_heads % t:
        errs.append(f"num_heads {cfg.num_heads} % tp {t} != 0")
    if cfg.d_ff and cfg.d_ff % t:
        errs.append(f"d_ff {cfg.d_ff} % tp {t} != 0")
    if cfg.num_experts and cfg.num_experts % t:
        errs.append(f"experts {cfg.num_experts} % ep {t} != 0")
    if cfg.ssm_state and cfg.ssm_d_inner % t:
        errs.append(f"ssm_d_inner {cfg.ssm_d_inner} % tp {t} != 0")
    return errs


def spec_axes(spec) -> tuple:
    """The mesh axes a spec shards over, in dim order."""
    out = []
    for e in spec:
        out.extend(() if e is None else (e,) if isinstance(e, str) else e)
    return tuple(out)


# --- leaves on a mesh --------------------------------------------------------------------

def _split(mesh, e, rep: int) -> tuple:
    """(blocks, this rank's block) of a dim sharded over `e`; a KV leaf
    replicated `rep` times over `model` splits into model / rep blocks,
    rank r holding block r // rep."""
    n, i = mesh.axis_size(e), mesh.index(e)
    if rep > 1 and e == "model":
        return n // rep, i // rep
    return n, i


def local_shard(t: torch.Tensor, spec, mesh, rep: int = 1) -> torch.Tensor:
    """This rank's block of the whole leaf `t` (a copy, outside autograd);
    `rep`: the leaf's KV replication over `model` (`kv_replication`)."""
    t = t.detach()
    for dim, e in enumerate(spec):
        n, i = _split(mesh, e, rep)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does not split "
                             f"{n} ways over {e}")
        step = t.shape[dim] // n
        t = t.narrow(dim, i * step, step)
    return t.clone()


def gather_leaf(t: torch.Tensor, spec, mesh, rep: int = 1) -> torch.Tensor:
    """The whole leaf from every rank's block (a collective over the axes
    that shard it; no gradient); of a KV leaf replicated `rep` times, one
    replica of each block."""
    with torch.no_grad():
        for dim, e in enumerate(spec):
            n = mesh.axis_size(e)
            if n > 1:
                t = comm.all_gather(t, mesh.group(e), dim)
                if _split(mesh, e, rep)[0] < n:
                    t = torch.cat(t.chunk(n, dim)[::rep], dim)
    return t


def gather_leaf_to_host(t: torch.Tensor, spec, mesh, rep: int = 1) -> Optional[torch.Tensor]:
    """The whole leaf as a host tensor on the mesh's rank 0 (None on the
    others): each rank sends its block once, and rank 0 places every block
    by its sender's coordinates (the replicas of a KV block, `rep`, on one
    place)."""
    group = mesh.group(mesh.axis_names)
    blocks = comm.gather_to_host(t, torch.distributed.get_process_group_ranks(group)[0]
                                 if group is not None else 0, group)
    if blocks is None:
        return None
    shape = [n * _split(mesh, e, rep)[0] for n, e in zip(t.shape, spec)] + \
        list(t.shape[len(spec):])
    whole = torch.empty(shape, dtype=t.dtype)
    for r, block in enumerate(blocks):
        at = type(mesh)(mesh.cfg, rank=r)
        view = whole
        for dim, e in enumerate(spec):
            n = block.shape[dim]
            view = view.narrow(dim, _split(at, e, rep)[1] * n, n)
        view.copy_(block)
    return whole


# --- KV heads replicated over `model` ----------------------------------------------
#
# A GQA layer whose KV heads are fewer than `model` ranks (t a multiple of
# num_kv_heads) takes Megatron's route: rank r holds query columns
# [r a hd / t, (r + 1) a hd / t) (whole heads where t divides num_heads,
# else halo heads: below) and the one KV head they read,
# r nkv // t, as its wk / wv (bk / bv) columns and its cache.  A KV head's
# columns then live on t / nkv ranks, whose partial gradients are summed
# over that replica group (`Plan.kv_group`) before the data axes.  JAX's
# spec trees split those columns mid-head over all t ranks instead; they
# stay JAX's, as data, and `Plan.rep_of` says which leaves are replicated.

KV_LEAVES = frozenset(("wk", "wv", "bk", "bv"))


def kv_replication(cfg: ModelConfig, t: int) -> int:
    """Ranks of `model` that hold each KV head: t / num_kv_heads where t is
    a larger multiple of num_kv_heads, else 1 (whole KV groups a rank, or
    halo heads)."""
    nkv = cfg.num_kv_heads
    if cfg.attn_type != "gqa" or not nkv or t <= nkv or t % nkv:
        return 1
    return t // nkv


# --- halo heads ---------------------------------------------------------------------
#
# Where query heads do not split over `model` (qwen1.5-4b's 20 at 16), or
# KV heads neither split into whole groups nor replicate, the spec trees
# still split wq / wk / wv (bq / bk / bv) and wo's rows mid-head over all t
# ranks, as JAX's GSPMD does.  A rank then computes its column slices of
# q / k / v, all-gathers them over `model` (`gather_heads`) and keeps the
# heads its own query columns touch, each head whole: rotary, the flash,
# paged and naive kernels run unchanged on them, and the rank keeps its own
# columns of the attention output for wo.  Each head's attention is what
# one device computes; a head that straddles two ranks is computed on both
# (a redundancy `head_span` counts), and the gather's backward
# reduce-scatters the heads' partial gradients onto the owners' columns.
# Where KV heads replicate (`kv_replication`), a rank's touched query heads
# lie in its one KV head's group, and only q is gathered.


class HeadSpan(NamedTuple):
    """A rank's attention heads under tensor parallelism (`head_span`)."""
    cols: Tuple[int, int]    # its own query columns [c0, c1): JAX's wq / bq / wo-row slice
    q: Tuple[int, int]       # the query heads it computes, whole: [h0, h1)
    kv: Tuple[int, int]      # the KV heads those read, whole: [k0, k1)
    halo: bool               # q (and k / v, unless replicated) gathered over `model`


def head_span(cfg: ModelConfig, t: int, r: int) -> HeadSpan:
    """Rank r of t's heads: its own query columns (mid-head where the split
    falls), the query heads those columns touch, and the KV heads those
    read.  Replicated KV heads (`kv_replication`): the rank's one KV head,
    whose group must hold its touched query heads.  Otherwise the touched
    query heads are widened to whole KV groups, so that each rank's query
    heads are g = num_heads / num_kv_heads to a KV head, as the kernels
    take them.  `halo` is False where the heads split evenly: the span is
    then the rank's own heads and nothing is gathered."""
    a, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g, w = a // nkv, a * hd // t
    c0, c1 = r * w, (r + 1) * w
    h0, h1 = c0 // hd, -(-c1 // hd)
    rep = kv_replication(cfg, t)
    if rep > 1:
        k0 = r // rep
        if not (k0 * g <= h0 and h1 <= (k0 + 1) * g):
            raise ValueError(f"{cfg.name}: rank {r} of {t} touches query heads [{h0}, {h1}) "
                             f"outside KV head {k0}'s group of {g}")
        k1 = k0 + 1
    else:
        k0, k1 = h0 // g, -(-h1 // g)
        h0, h1 = k0 * g, k1 * g
    halo = not (a % t == 0 and (rep > 1 or nkv % t == 0))
    return HeadSpan((c0, c1), (h0, h1), (k0, k1), halo)


def local_span(cfg: ModelConfig) -> HeadSpan:
    """`head_span` of this rank under the plan in force."""
    return head_span(cfg, tp_size(), tp_rank())


def local_kv_heads(cfg: ModelConfig) -> int:
    """KV heads a rank holds (its cache's heads) under the plan in force:
    the KV heads its query heads read, whole."""
    if tp_size() == 1:
        return cfg.num_kv_heads
    k0, k1 = local_span(cfg).kv
    return k1 - k0


def divisibility(cfg: ModelConfig, mesh_cfg: MeshConfig,
                 global_batch: int) -> Tuple[list, list]:
    """`validate_divisibility`'s entries as (errors, warnings): a query head
    count that does not divide `model` is a warning (the heads run as halo
    heads, `head_span`), as JAX's launchers print it; every other entry is
    an error."""
    errors = validate_divisibility(dataclasses.replace(cfg, num_heads=0), mesh_cfg,
                                   global_batch)
    return errors, [e for e in validate_divisibility(cfg, mesh_cfg, global_batch)
                    if e not in errors]


def check_supported(cfg: ModelConfig, mesh_cfg: MeshConfig) -> None:
    """Raise for what the explicit plan does not cover: `divisibility`'s
    errors (query heads that do not split over `model` run as halo heads,
    `head_span`; KV heads split into whole groups, replicate where `model`
    is a multiple of them, or run as halo heads), and the widths that must
    split over `model`: the q / k / v columns, the padded vocab, the MoE
    shared expert, MLA's down projections and heads (MLA has no halo), the
    SSM's heads and groups.  Every family runs under data and tensor
    parallelism and under `seq_parallel`, int8 weights included."""
    t = mesh_cfg.model
    if t == 1:
        return
    errs, _ = divisibility(cfg, mesh_cfg, mesh_cfg.dp)
    if cfg.padded_vocab_size % t:
        errs.append(f"padded vocab {cfg.padded_vocab_size} % tp {t} != 0")
    if cfg.num_experts and cfg.num_shared_experts and cfg.moe_d_ff % t:
        errs.append(f"moe_d_ff {cfg.moe_d_ff} % tp {t} != 0")
    if cfg.attn_type == "gqa" and cfg.num_heads:
        hd = cfg.head_dim
        cols = [("q columns", cfg.num_heads * hd)]
        if kv_replication(cfg, t) == 1:
            cols.append(("k / v columns", cfg.num_kv_heads * hd))
        errs += [f"{name} {n} % tp {t} != 0" for name, n in cols if n % t]
    if cfg.attn_type == "mla":
        if cfg.num_heads % t:
            errs.append(f"MLA num_heads {cfg.num_heads} % tp {t} != 0 (no halo heads)")
        # the down projections are column-sharded (their outputs gathered)
        for name, n in (("q_lora_rank", cfg.q_lora_rank),
                        ("kv_lora_rank + qk_rope_dim", cfg.kv_lora_rank + cfg.qk_rope_dim)):
            if n % t:
                errs.append(f"{name} {n} % tp {t} != 0")
    if cfg.ssm_state:
        nh, g = cfg.ssm_nheads, cfg.ssm_ngroups
        if nh % t:
            errs.append(f"ssm heads {nh} % tp {t} != 0")
        if g % t and t % g:
            errs.append(f"ssm_ngroups {g} and tp {t}: neither divides the other")
    if errs:
        raise ValueError(f"{cfg.name}: " + "; ".join(errs))


# --- the plan ----------------------------------------------------------------------------

class Plan:
    """Where each collective of a sharded step goes, for one config on one
    mesh (`launch/mesh.make_mesh`)."""

    def __init__(self, cfg: ModelConfig, mesh):
        check_supported(cfg, mesh.cfg)
        self.cfg, self.mesh = cfg, mesh
        self.fsdp = mesh.cfg.fsdp
        self.tp, self.tp_rank = mesh.shape["model"], mesh.coords["model"]
        self.tp_group = mesh.group("model")
        self.dp_axes = (("pod", "data") if mesh.cfg.pod > 1 and mesh.cfg.pod_role == "data"
                        else ("data",))
        self.dp, self.dp_rank = mesh.axis_size(self.dp_axes), mesh.index(self.dp_axes)
        self.dp_group = mesh.group(self.dp_axes)
        # the ranks of `model` that hold this rank's KV head (None: no replication)
        self.kv_rep = kv_replication(cfg, self.tp)
        self.kv_group = mesh.replica_group("model", self.kv_rep) if self.kv_rep > 1 else None

    def rep_of(self, path) -> int:
        """The KV replication of the leaf at `path` (1: not replicated)."""
        if self.kv_rep > 1 and any(str(k) in KV_LEAVES for k in path):
            return self.kv_rep
        return 1

    def specs(self, tree) -> Any:
        return param_specs(tree, self.cfg, self.mesh, self.fsdp)

    @property
    def data_sharded(self) -> bool:
        """Whether the params are sharded over `data` (FSDP on a data axis
        of more than one rank)."""
        return self.fsdp and self.mesh.shape["data"] > 1

    def shard(self, tree, specs=None, device=None) -> Any:
        """This rank's blocks of a tree of whole leaves (moved to `device`
        leaf by leaf, where one is given)."""
        specs = self.specs(tree) if specs is None else specs

        def one(path, t):
            spec, rep = _at(specs, path), self.rep_of(path)
            if isinstance(t, QuantizedTensor):
                # the payload by the leaf's spec; the scales keep the reduced axis whole
                ax = t.q.dim() + t.axis if t.axis < 0 else t.axis
                sspec = tuple(None if i == ax else e for i, e in enumerate(spec))
                return QuantizedTensor(
                    k_major(local_shard(t.q, spec, self.mesh, rep).to(device or t.q.device)),
                    local_shard(t.scale, sspec, self.mesh, rep).to(device or t.scale.device),
                    t.axis)
            return local_shard(t, spec, self.mesh, rep).to(device or t.device)
        return _map(one, tree)

    def gather(self, tree, specs=None) -> Any:
        """Whole leaves from every rank's blocks (a collective)."""
        specs = self.specs(tree) if specs is None else specs
        return _map(lambda path, t: gather_leaf(t, _at(specs, path), self.mesh,
                                                self.rep_of(path)), tree)

    def fsdp_gather(self, tree, specs) -> Any:
        """Every data-sharded dim gathered, differentiably (its gradient is
        reduce-scattered back to the shard)."""
        group = self.mesh.group("data")

        def one(path, t):
            for dim, e in enumerate(_at(specs, path)):
                if e == "data" and group is not None:
                    t = comm.fsdp_gather(t, group, dim)
            return t
        return _map(one, tree)

    def reduce_grads(self, grads, specs) -> Any:
        """Sum each gradient over the data axes that do not shard its leaf
        (the sharded ones were reduce-scattered by `fsdp_gather`); a
        replicated KV block's first over the ranks that hold it."""
        def one(path, g):
            if self.rep_of(path) > 1:
                g = comm.all_reduce(g, self.kv_group)
            axes = tuple(a for a in self.dp_axes if a not in spec_axes(_at(specs, path)))
            return comm.all_reduce(g, self.mesh.group(axes))
        return _map(one, grads)

    def global_sq_sum(self, tree, specs) -> torch.Tensor:
        """The sum of squares of the global tree: each leaf's local sum,
        summed over the axes that shard it (a replicated leaf counts once,
        a KV block replicated over `model` once per replica group)."""
        by_axes = {}
        for path, t in _paths(tree):
            key = frozenset(a for a in spec_axes(_at(specs, path)) if self.mesh.shape[a] > 1)
            s = torch.sum(torch.square(t.float())) / self.rep_of(path)
            by_axes[key] = by_axes[key] + s if key in by_axes else s
        total = None
        for key in sorted(by_axes, key=sorted):
            s = comm.all_reduce(by_axes[key], self.mesh.group(tuple(sorted(key))))
            total = s if total is None else total + s
        return total

    def row_absmax(self, amax: torch.Tensor, spec) -> torch.Tensor:
        """A row's absmax (over the last dim) across the ranks that shard
        the last dim."""
        last = spec[-1] if len(spec) else None
        return comm.all_reduce(amax, self.mesh.group(last), op="max") if last else amax

    def batch_rows(self, batch, n_micro: int = 1):
        """This data rank's rows of a global batch: its slice of each of the
        n_micro global microbatches, as JAX shards each microbatch.  A
        microbatch of fewer rows than dp is replicated over the data ranks
        (JAX's `_fix_small_batch`): each takes it whole, and the loss
        shares (`lm_loss`, over every rank's token count) still sum to its
        mean."""
        if self.dp == 1:
            return batch

        def rows(v):
            mb = v.shape[0] // n_micro
            if mb < self.dp:
                return v
            if mb % self.dp:
                raise ValueError(f"a microbatch of {mb} rows does not split over dp {self.dp}")
            loc = mb // self.dp
            v = v.reshape(n_micro, mb, *v.shape[1:])[:, self.dp_rank * loc:(self.dp_rank + 1) * loc]
            return v.reshape(n_micro * loc, *v.shape[2:])
        return {k: rows(v) for k, v in batch.items()}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


# --- the plan in force, and the model's collectives -----------------------------------

_ACTIVE: Optional[Plan] = None


@contextlib.contextmanager
def use(plan: Optional[Plan]):
    """Run the model under `plan` (None: single device)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = before


def under(plan: Optional[Plan]):
    """Decorator: run the function under `plan`."""
    def wrap(fn):
        if plan is None:
            return fn

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with use(plan):
                return fn(*args, **kwargs)
        return run
    return wrap


def active() -> Optional[Plan]:
    return _ACTIVE


def fsdp_use(tree, name: Optional[str] = None):
    """Data-sharded params made whole where the model uses them, under a
    plan whose params are sharded over `data` (the identity otherwise):
    a differentiable all-gather whose backward reduce-scatters the
    gradient to the rank's block.  `tree`: one leaf named `name`, or a
    subtree whose paths the spec rules read (a layer, a block)."""
    plan = _ACTIVE
    if tree is None or plan is None or not plan.data_sharded:
        return tree
    if name is not None:
        return plan.fsdp_gather({name: tree}, plan.specs({name: tree}))[name]
    return plan.fsdp_gather(tree, plan.specs(tree))


def tp_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.tp


def tp_rank() -> int:
    return 0 if _ACTIVE is None else _ACTIVE.tp_rank


def dp_size() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.dp


def _tp_group():
    return None if _ACTIVE is None else _ACTIVE.tp_group


def _dp_group():
    return None if _ACTIVE is None else _ACTIVE.dp_group


def copy_to_tp(x):
    """A replicated input to column-parallel layers (Megatron's f)."""
    return comm.copy_to(x, _tp_group())


def reduce_from_tp(x):
    """The all-reduce after a row-parallel layer (Megatron's g)."""
    return comm.reduce_from(x, _tp_group())


def gather_from_tp(x, dim: int):
    """Column shards concatenated along `dim` (the logits' vocab)."""
    return comm.gather_from(x, _tp_group(), dim)


def gather_latent(x, dim: int = -1):
    """MLA's down projections' column shards made whole for this rank's
    heads, which all read the whole latent: all-gather forward, and the
    heads' partial gradients reduce-scattered back (`comm.fsdp_gather`)."""
    return comm.fsdp_gather(x, _tp_group(), dim % x.dim())


def scatter_to_tp(x, dim: int):
    """This rank's block of a replicated tensor along `dim` (its heads'
    columns), whose gradient is all-gathered back."""
    return comm.scatter_to(x, _tp_group(), dim % x.dim())


def max_over_tp(x):
    """An absmax of this rank's columns made the whole row's (or a weight
    column's over this rank's rows, the whole column's): the MAX over
    `model`, outside autograd.  A maximum is exact, so int8 codes taken
    with it are the unsharded run's, bit for bit."""
    return comm.all_reduce(x, _tp_group(), op="max")


class _GatherHeads(torch.autograd.Function):
    """Every rank's columns along the last dim, all-gathered over `model`,
    then [lo, hi) of them: the whole heads a rank's slice touches.  The
    backward reduce-scatters: each rank's gradient for [lo, hi) lands on
    the ranks whose columns they are, summed.  The census counts both
    under `comm.HALO_KINDS`."""

    @staticmethod
    def forward(ctx, x, group, lo, hi):
        ctx.group, ctx.lo, ctx.hi = group, lo, hi
        whole = comm.all_gather(x, group, x.dim() - 1, kind="halo all-gather")
        ctx.width = whole.shape[-1]
        return whole[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros((*g.shape[:-1], ctx.width))
        full[..., ctx.lo:ctx.hi] = g
        return (comm.reduce_scatter(full, ctx.group, g.dim() - 1, kind="halo reduce-scatter"),
                None, None, None)


def gather_heads(x, lo: int, hi: int, hd: int):
    """Heads [lo, hi) of width hd, whole, from every rank's column slice
    of the last dim (`_GatherHeads`)."""
    return _GatherHeads.apply(x, _tp_group(), lo * hd, hi * hd)


def sum_over_tp(x):
    """A statistic of this rank's columns summed over `model`, both ways
    (the SSD gated norm's mean square over the sharded d_inner)."""
    return comm.sum_across(x, _tp_group())


def sum_over_dp(x):
    """A statistic summed over the data ranks, differentiably: each rank's
    loss is its share of the global one."""
    return comm.sum_across(x, _dp_group())


def gather_dp(x, dim: int = 0):
    """Every data rank's `x` concatenated along `dim` (no gradient)."""
    return comm.all_gather(x, _dp_group(), dim)


# --- sequence parallelism (cfg.seq_parallel) ------------------------------------------
#
# Between the dense and MoE layers' blocks the residual stream is split on
# the sequence (dim 1) over `model` (JAX's "btd_sp" constraint,
# blocks.py:173-175 of the JAX package), so the norms run on each rank's
# shard.  Inside such a layer (`seq_region`) each column-parallel entry is
# an all-gather on the sequence, whose backward reduce-scatters the
# gradient, and each row-parallel exit a reduce-scatter on the sequence,
# whose backward all-gathers it; outside one they are `copy_to_tp` and
# `reduce_from_tp`.

SEQ_DIM = 1
_SEQ = False


def seq_parallel(cfg: ModelConfig, s: int) -> bool:
    """Whether a pass over `s` positions splits the residual stream on the
    sequence: the flag, tensor parallelism, and s > 1 (decode keeps its
    plain placement, as JAX's constraint does)."""
    return bool(cfg.seq_parallel) and tp_size() > 1 and s > 1


@contextlib.contextmanager
def seq_region():
    """Inside: the layer's input is this rank's sequence shard."""
    global _SEQ
    before, _SEQ = _SEQ, True
    try:
        yield
    finally:
        _SEQ = before


def scatter_seq(x):
    """The residual stream split on the sequence: this rank's block (its
    gradient all-gathered back).  t must divide the sequence."""
    s, t = x.shape[SEQ_DIM], tp_size()
    if s % t:
        raise ValueError(f"seq_parallel: sequence length {s} does not split over model {t} "
                         f"({s} % {t} != 0)")
    return comm.scatter_to(x, _tp_group(), SEQ_DIM)


def gather_seq(x):
    """The sequence shards made whole for replicated work after them (the
    head, a kind that runs whole): all-gather, this rank's slice back."""
    return comm.gather_from(x, _tp_group(), SEQ_DIM)


def seq_reduce_scatter(x):
    """A row-parallel exit inside a sequence region: the partial sums
    reduce-scattered on the sequence."""
    return comm.reduce_scatter_from(x, _tp_group(), SEQ_DIM)


def tp_enter(x):
    """The input of column-parallel layers: `copy_to_tp`, or inside a
    sequence region the all-gather of the sequence shards."""
    if _SEQ:
        return comm.fsdp_gather(x, _tp_group(), SEQ_DIM)
    return copy_to_tp(x)


def tp_exit(x):
    """The output of a row-parallel layer: `reduce_from_tp`, or inside a
    sequence region the reduce-scatter on the sequence."""
    if _SEQ:
        return seq_reduce_scatter(x)
    return reduce_from_tp(x)


def tokens_whole(x):
    """A layer that runs every token whole on each rank (the MoE router and
    dispatch, whose replicated inputs take `copy_to_tp` themselves): inside
    a sequence region the shards all-gathered, this rank's slice back."""
    return gather_seq(x) if _SEQ else x
