"""Instruments that hold tensor parallelism to the unsharded run, and the
wrong forms of its collectives that those checks must catch.

`row_codes()` watches every row-parallel int8 product (`linear._int8`
with `row`: wo, w_down, out_proj) and gathers the activation's int8 codes
and row scales over `model`: on one device they are the codes the product
took, so the gathered codes of a sharded run can be held to an unsharded
run's.  It also holds each call to the quantization of its own gathered
operands (`quantize_int8` of the activation, and of a per-call weight).

The planted faults are drop-in replacements, each for the function it is
named after:
  halo_grad_unsummed     `sharding.gather_heads` whose backward keeps this
                         rank's own gradient for its columns (the other
                         ranks' partials never summed in)
  neighbour_head         `sharding.gather_heads` that takes each head's
                         neighbour: the columns one head to the right
  activation_absmax_unreduced / weight_absmax_unreduced
                         `linear.row_activation_absmax` / `row_weight_absmax`
                         over this rank's columns (rows) only: no MAX over
                         `model`
  codes_at_shard_absmax  `linear.quantize_int8` that takes the codes at
                         this shard's own absmax but keeps the MAX over
                         `model` as the scale (the codes and their scale
                         disagree by the ratio of the two)
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..kernels.quantized import ops as qops
from ..models import linear as linear_mod
from ..quant import QuantizedTensor, quantize_int8
from . import comm
from . import sharding as sh


@dataclasses.dataclass
class RowCodes:
    """What `row_codes` saw, one entry per row-parallel int8 product in
    call order: `unequal`, the count of codes and scales that differ from
    the quantization of the operands gathered over `model` (0: bit for
    bit); `codes`, the activation's (int8 codes, f32 row scales) gathered
    over `model`, for the first `keep` products (all with keep None)."""
    keep: int | None
    unequal: list = dataclasses.field(default_factory=list)
    codes: list = dataclasses.field(default_factory=list)


def _group():
    return sh._tp_group() if sh.tp_size() > 1 else None


@contextlib.contextmanager
def row_codes(keep: int | None = 0):
    """Inside: every row-parallel int8 product recorded in the `RowCodes`
    it yields."""
    rec = RowCodes(keep)
    real_int8, real_q, seen = linear_mod._int8, qops.int8_matmul_q, {}

    def spy_q(a_q, a_scale, b_q, b_scale, *args, **kw):
        seen.update(a_q=a_q, a_scale=a_scale, b_q=b_q, b_scale=b_scale)
        return real_q(a_q, a_scale, b_q, b_scale, *args, **kw)

    def int8(x2, w, row):
        out = real_int8(x2, w, row)
        if not row:
            return out
        group = _group()
        a_q, a_scale = comm.all_gather(seen["a_q"], group, 1), seen["a_scale"]
        want_q, want_s = quantize_int8(comm.all_gather(x2.detach(), group, 1), -1)
        bad = int((a_q != want_q).sum().item()) + int((a_scale != want_s).sum().item())
        if not isinstance(w, QuantizedTensor):
            want_q, want_s = quantize_int8(comm.all_gather(w.detach(), group, 0), -2)
            got = comm.all_gather(seen["b_q"].contiguous(), group, 0)
            bad += int((got != want_q).sum().item())
            bad += int((seen["b_scale"].reshape(want_s.shape) != want_s).sum().item())
        rec.unequal.append(bad)
        if rec.keep is None or len(rec.codes) < rec.keep:
            rec.codes.append((a_q, a_scale))
        return out

    linear_mod._int8, linear_mod.int8_matmul_q, qops.int8_matmul_q = int8, spy_q, spy_q
    try:
        yield rec
    finally:
        linear_mod._int8, linear_mod.int8_matmul_q, qops.int8_matmul_q = (real_int8, real_q,
                                                                          real_q)


# --- planted faults --------------------------------------------------------------------

def halo_grad_unsummed(x, lo: int, hi: int, hd: int):
    return comm.gather_from(x, sh._tp_group(), x.dim() - 1)[..., lo * hd:hi * hd].contiguous()


def neighbour_head(x, lo: int, hi: int, hd: int):
    whole = comm.fsdp_gather(x, sh._tp_group(), x.dim() - 1)
    return torch.roll(whole, -hd, dims=-1)[..., lo * hd:hi * hd].contiguous()


def activation_absmax_unreduced(x2):
    return x2.float().abs().amax(dim=-1, keepdim=True)


def weight_absmax_unreduced(w):
    return w.float().abs().amax(dim=-2, keepdim=True)


def codes_at_shard_absmax(x, axis: int = -1, absmax=None):
    q, _ = quantize_int8(x, axis)
    return q, quantize_int8(x, axis, absmax)[1]
