"""Collectives over process groups, and their autograd forms.

Every function takes a `ProcessGroup` (or None: a group of one rank, where
each collective is the identity).  On a gloo group a CUDA tensor is staged
through host memory explicitly: gloo has no reduce-scatter at all, and its
point-to-point ops take host tensors, so every gloo collective here runs on
a host copy and the result is copied back to the tensor's device.  NCCL
takes the tensors where they are.  Sums of 16-bit floats are taken in
float32 and rounded once.

The autograd forms say what the objective is across the group:
  copy_to        identity forward, all-reduce backward: a replicated input
                 to a sharded computation (Megatron's f)
  reduce_from    all-reduce forward, identity backward: partial sums whose
                 total every rank then uses alike (Megatron's g)
  sum_across     all-reduce both ways: a statistic of every rank's data in
                 an objective that is the sum of the ranks' losses
  gather_from    all-gather forward, this rank's slice backward
  fsdp_gather    all-gather forward, reduce-scatter (sum) backward: a
                 sharded tensor used whole by ranks whose losses add up
                 (a parameter over `data`; MLA's latent, and a sequence
                 shard entering column-parallel layers, over `model`)
  scatter_to     this rank's slice forward, all-gather backward
  reduce_scatter_from
                 reduce-scatter forward, all-gather backward: partial
                 sums of which each rank keeps its slice (a row-parallel
                 exit under sequence parallelism)

The census: inside `census()` every collective adds the bytes it puts on
the wire to its kind (JAX's HLO names: "all-reduce", "all-gather",
"reduce-scatter"; "collective-permute" for a point-to-point send): the
output buffer in the wire's dtype (float32 for a widened sum), as the JAX
package's HLO walk counts output-shape bytes.  A gloo reduce-scatter, run
as an all-reduce and a slice, counts as one reduce-scatter of the slice,
so gloo, NCCL and the dry run's virtual groups agree.  The halo heads'
gathers (`sharding.gather_heads`) are counted under kinds of their own,
`HALO_KINDS`, each an instance of the JAX kind it maps to.

A `VirtualGroup` stands for a group of a mesh that does not exist (the dry
run, `launch/mesh.virtual_mesh`): each collective makes the same buffers
as on NCCL and returns a tensor of the right shape and dtype, without
communicating.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist


class VirtualGroup:
    """A group of `size` ranks in which this one is `rank`; nothing is sent."""

    def __init__(self, size: int, rank: int):
        self.size, self.rank = size, rank

    def __repr__(self):
        return f"VirtualGroup(size={self.size}, rank={self.rank})"


def _virtual(group) -> bool:
    return isinstance(group, VirtualGroup)


def size(group) -> int:
    if group is None:
        return 1
    return group.size if _virtual(group) else dist.get_world_size(group)


def rank(group) -> int:
    if group is None:
        return 0
    return group.rank if _virtual(group) else dist.get_rank(group)


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and not _virtual(group) and dist.get_backend(group) == "gloo"


def _gloo(group) -> bool:
    return not _virtual(group) and dist.get_backend(group) == "gloo"


_LISTENERS: List[Callable[[str, float], None]] = []
HALO_KINDS = {"halo all-gather": "all-gather", "halo reduce-scatter": "reduce-scatter"}


@contextlib.contextmanager
def listen(fn: Callable[[str, float], None]):
    """fn(kind, wire bytes) for every collective run inside."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


@contextlib.contextmanager
def census():
    """{kind: wire bytes} of every collective run inside."""
    rec: Dict[str, float] = {}
    with listen(lambda kind, n: rec.__setitem__(kind, rec.get(kind, 0.0) + n)):
        yield rec


def _record(kind: str, numel: int, dtype) -> None:
    for fn in _LISTENERS:
        fn(kind, float(numel * dtype.itemsize))


def _wire(t: torch.Tensor, group, widen: bool) -> torch.Tensor:
    """A private copy of `t` in the form the group's backend takes."""
    t = t.detach()
    if widen and t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.to("cpu", copy=True) if _host_staged(t, group) else t.clone()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(t: torch.Tensor, group, op: str) -> torch.Tensor:
    buf = _wire(t, group, widen=op == "sum")
    if not _virtual(group):
        dist.all_reduce(buf, _OPS[op], group=group)
    return buf


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise sum (or max) over the group, on every rank."""
    if group is None:
        return t
    buf = _all_reduce(t, group, op)
    _record("all-reduce", buf.numel(), buf.dtype)
    return buf.to(t.device, t.dtype)


def all_gather(t: torch.Tensor, group, dim: int, kind: str = "all-gather") -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order
    (counted under `kind`)."""
    if group is None:
        return t
    buf = _wire(t.contiguous(), group, widen=False)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    if _virtual(group):
        parts[rank(group)] = buf
    else:
        dist.all_gather(parts, buf, group=group)
    _record(kind, buf.numel() * len(parts), buf.dtype)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int,
                   kind: str = "reduce-scatter") -> torch.Tensor:
    """This rank's slice along `dim` of the group's elementwise sum
    (counted under `kind`)."""
    if group is None:
        return t
    n, r = size(group), rank(group)
    if _gloo(group):
        # gloo has no reduce-scatter: the whole sum, then this rank's slice
        buf = _all_reduce(t, group, "sum")
        _record(kind, buf.numel() // n, buf.dtype)
        return buf.to(t.device, t.dtype).chunk(n, dim=dim)[r].contiguous()
    src = t.movedim(dim, 0).contiguous()
    wide = src.float() if src.dtype in (torch.bfloat16, torch.float16) else src
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=wide.dtype, device=src.device)
    if not _virtual(group):
        dist.reduce_scatter_tensor(out, wide, group=group)
    _record(kind, out.numel(), out.dtype)
    return out.to(t.dtype).movedim(0, dim).contiguous()


def gather_to_host(t: torch.Tensor, dst: int, group) -> Optional[List[torch.Tensor]]:
    """Every rank's `t`, in group-rank order, as host tensors on the global
    rank `dst`; None on the other ranks."""
    if group is None:
        return [t.detach().to("cpu", copy=True)]
    buf = t.detach().contiguous()
    if _gloo(group):
        buf = buf.to("cpu", copy=True)
    mine = dist.get_rank() == dst
    parts = [torch.empty_like(buf) for _ in range(size(group))] if mine else None
    dist.gather(buf, parts, dst=dst, group=group)
    return [p.cpu() for p in parts] if mine else None


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` of the group's rank `src` (a global rank), on every rank."""
    if group is None:
        return t
    buf = _wire(t.contiguous(), group, widen=False)
    if not _virtual(group):
        dist.broadcast(buf, src, group=group)
    _record("broadcast", buf.numel(), buf.dtype)
    return buf.to(t.device)


def send(t: torch.Tensor, dst: int, tag: int, group):
    """Start sending `t` to global rank `dst`; returns (work, buffer): keep
    both until `work.wait()`."""
    buf = _wire(t.contiguous(), group, widen=False)
    _record("collective-permute", buf.numel(), buf.dtype)
    return dist.isend(buf, dst, group=group, tag=tag), buf


def recv(like: torch.Tensor, src: int, tag: int, group) -> torch.Tensor:
    """A tensor shaped like `like` from global rank `src`."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _host_staged(like, group) else like.device)
    dist.recv(buf, src, group=group, tag=tag)
    return buf.to(like.device)


# --- autograd forms -------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(size(ctx.group), dim=ctx.dim)[rank(ctx.group)].contiguous(), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return x.chunk(size(group), dim=dim)[rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to(x, group):
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group is None else _ReduceFrom.apply(x, group)


def sum_across(x, group):
    return x if group is None else _SumAcross.apply(x, group)


def gather_from(x, group, dim: int):
    return x if group is None else _GatherFrom.apply(x, group, dim)


def fsdp_gather(x, group, dim: int):
    return x if group is None else _FsdpGather.apply(x, group, dim)


def scatter_to(x, group, dim: int):
    return x if group is None else _ScatterTo.apply(x, group, dim)


def reduce_scatter_from(x, group, dim: int):
    return x if group is None else _ReduceScatterFrom.apply(x, group, dim)


# --- point to point under autograd (the pipeline's hops) ------------------------------

class _Send(torch.autograd.Function):
    """Forward: send x to `dst`; returns a 0-d token the caller keeps in its
    graph.  Backward: receive x's gradient from `dst` (the receiver sends
    it back from `_Recv.backward`), under the same tag."""

    @staticmethod
    def forward(ctx, x, dst, tag, group, pending: List):
        ctx.dst, ctx.tag, ctx.group = dst, tag, group
        ctx.meta = (x.shape, x.dtype, x.device)
        pending.append(send(x, dst, tag, group))
        return torch.zeros((), dtype=x.dtype, device=x.device)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.meta
        like = torch.empty(shape, dtype=dtype, device=device)
        return recv(like, ctx.dst, ctx.tag, ctx.group), None, None, None, None


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor like `like` from `src`; `anchor` (a 0-d
    tensor that requires grad) puts the receive in the graph.  Backward:
    send the gradient back to `src`, waited on at once."""

    @staticmethod
    def forward(ctx, anchor, like, src, tag, group):
        ctx.src, ctx.tag, ctx.group = src, tag, group
        return recv(like, src, tag, group)

    @staticmethod
    def backward(ctx, g):
        work, _buf = send(g, ctx.src, ctx.tag, ctx.group)
        work.wait()
        return None, None, None, None, None


def send_grad(x, dst: int, tag: int, group, pending: List) -> torch.Tensor:
    """Send x to `dst` (differentiably when x requires grad); returns the
    0-d token to keep in the graph."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Send.apply(x, dst, tag, group, pending)
    pending.append(send(x, dst, tag, group))
    return torch.zeros((), dtype=x.dtype, device=x.device)


def recv_grad(like, src: int, tag: int, group, anchor: Optional[torch.Tensor]):
    """Receive from `src`; differentiable when `anchor` (0-d, requires grad)
    is given."""
    if anchor is not None and torch.is_grad_enabled():
        return _Recv.apply(anchor, like, src, tag, group)
    return recv(like, src, tag, group)
