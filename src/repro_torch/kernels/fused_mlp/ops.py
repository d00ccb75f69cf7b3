"""Public wrappers of the fused SwiGLU/MLP hidden kernel (`csrc/fused_mlp.cu`)
and its backward (`csrc/fused_mlp_bwd.cu`).

`fused_mlp_hidden` flattens (..., h) activations to 2-D and dispatches on
the device: a CPU tensor runs the plain version (`ref.fused_mlp_hidden_ref`,
`backward.fused_mlp_bwd_ref`), a CUDA tensor launches the kernel — or
raises.  It is differentiable, as JAX's `_fused_gated` / `_fused_plain`
custom VJPs: the forward saves only its inputs and the backward recomputes
the gate/up pre-activations.  The autograd.Function is taken only when a
gradient is recorded; a forward under `no_grad` (serving) calls the kernel
wrapper directly.

`fused_mlp_bwd` launches the recompute kernel (dg, du in the compute dtype)
and finishes with the tile GEMM: dx over both pairs in one launch, dwg and
dwu with A transposed.  `fused_mlp_bwd.launches` counts the recompute
kernel; the GEMMs count in `matmul.launches`.
"""
from __future__ import annotations

import torch

from .. import _build
from ..matmul.ops import matmul
from .backward import fused_mlp_bwd_ref
from .ref import MLP_TYPES, fused_mlp_hidden_ref, is_gated

# csrc/gemm_tile.cuh `Act`
ACT_CODES = {"swiglu": 1, "gelu": 2, "relu2": 3}
# Output tiles (rows, columns) of the forward and the recompute kernel in
# bf16 (csrc/gemm_sm90.cuh, two accumulator sets): 64 x 64 for at most 64
# rows, so f / 64 blocks fill the card with no split of k; 128 x 128
# above.  f32 runs on csrc/gemm_tile.cuh's 64 x 64 FMA tiles.
DECODE_TILE, TRAIN_TILE, F32_TILE = (64, 64), (128, 128), (64, 64)


def pick_tile(m: int, dtype) -> tuple[int, int]:
    if dtype == torch.float32:
        return F32_TILE
    return DECODE_TILE if m <= DECODE_TILE[0] else TRAIN_TILE


def _check_type(mlp_type: str) -> None:
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"unknown mlp_type {mlp_type!r}; valid: {list(MLP_TYPES)}")


def fused_mlp_hidden(x, w_gate, w_up, *, mlp_type: str = "swiglu"):
    """hidden = act-combine(x @ w_gate, x @ w_up).  x: (..., h) -> (..., f)."""
    _check_type(mlp_type)
    lead, h = x.shape[:-1], x.shape[-1]
    f = w_up.shape[-1]
    x2 = x.reshape(-1, h)
    if not is_gated(mlp_type):
        w_gate = None
    ins = (x2, w_up) if w_gate is None else (x2, w_gate, w_up)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        out = _FusedHidden.apply(x2, w_gate, w_up, mlp_type)
    else:
        out = _hidden(x2, w_gate, w_up, mlp_type)
    return out.reshape(*lead, f)


def _hidden(x2, w_gate, w_up, mlp_type: str):
    if _build.dispatch_device("fused_mlp_hidden", x2) == "cpu":
        return fused_mlp_hidden_ref(x2, w_gate, w_up, mlp_type)
    return _fused_cuda(x2, w_gate, w_up, mlp_type)


fused_mlp_hidden.launches = 0


class _FusedHidden(torch.autograd.Function):
    """JAX's `_fused_gated` / `_fused_plain` (fused_mlp/ops.py:92-123)."""

    @staticmethod
    def forward(ctx, x2, w_gate, w_up, mlp_type):
        ctx.mlp_type = mlp_type
        ctx.save_for_backward(x2, w_gate, w_up)
        return _hidden(x2, w_gate, w_up, mlp_type)

    @staticmethod
    def backward(ctx, dh):
        x2, w_gate, w_up = ctx.saved_tensors
        dx, dwg, dwu = fused_mlp_bwd(x2, w_gate, w_up, dh.contiguous(), mlp_type=ctx.mlp_type)
        return dx, dwg, dwu, None


def _check_operands(what, x, w_gate, w_up, *rest):
    ws = (w_up,) if w_gate is None else (w_gate, w_up)
    _build.cuda_operands(what, x, *ws, *rest)
    for w in ws:
        if w.dim() != 2 or w.shape != w_up.shape or w.shape[0] != x.shape[1]:
            raise ValueError(f"{what}: x {tuple(x.shape)} against "
                             f"weights {[tuple(t.shape) for t in ws]}")
    for t in (*ws, *rest):
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: dtypes {x.dtype} and {t.dtype}")
    return ws


def _fused_cuda(x, w_gate, w_up, mlp_type: str):
    ws = _check_operands("fused_mlp_hidden", x, w_gate, w_up)
    dt = _build.dtype_code(x.dtype)
    m, k = x.shape
    f = w_up.shape[1]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return out
    chunk = 16 // x.element_size()
    vec = int(k % chunk == 0 and f % chunk == 0 and _build.aligned16(x, *ws))
    lib = _build.build().lib
    with torch.cuda.device(x.device):
        status = lib.repro_fused_mlp(_build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up),
                                     _build.ptr(out), m, f, k, ACT_CODES[mlp_type], dt, vec,
                                     *pick_tile(m, x.dtype), _build.stream_of(x.device))
    _build.check(status, "fused_mlp_hidden")
    fused_mlp_hidden.launches += 1
    return out


def fused_mlp_bwd(x, w_gate, w_up, dh, *, mlp_type: str = "swiglu"):
    """(dx, dwg, dwu) of the fused hidden op; dwg None on the un-gated path.
    x: (..., h); w_gate (gated only), w_up: (h, f); dh: (..., f)."""
    _check_type(mlp_type)
    lead, h = x.shape[:-1], x.shape[-1]
    x2, dh2 = x.reshape(-1, h), dh.reshape(-1, w_up.shape[-1])
    if not is_gated(mlp_type):
        w_gate = None
    if _build.dispatch_device("fused_mlp_bwd", x2) == "cpu":
        dx, dwg, dwu = fused_mlp_bwd_ref(x2, w_gate, w_up, dh2, mlp_type)
    else:
        dx, dwg, dwu = _bwd_cuda(x2, w_gate, w_up, dh2, mlp_type)
    return dx.reshape(*lead, h), dwg, dwu


fused_mlp_bwd.launches = 0


def _bwd_cuda(x, w_gate, w_up, dh, mlp_type: str):
    ws = _check_operands("fused_mlp_bwd", x, w_gate, w_up, dh)
    if dh.shape != (x.shape[0], w_up.shape[1]):
        raise ValueError(f"fused_mlp_bwd: dh {tuple(dh.shape)} for x {tuple(x.shape)} and "
                         f"weights {tuple(w_up.shape)}")
    dt = _build.dtype_code(x.dtype)
    m, h = x.shape
    f = w_up.shape[1]
    du = torch.empty_like(dh)
    dg = None if w_gate is None else torch.empty_like(dh)
    if m and f:
        chunk = 16 // x.element_size()
        vec = int(h % chunk == 0 and f % chunk == 0 and _build.aligned16(x, *ws))
        lib = _build.build().lib
        with torch.cuda.device(x.device):
            status = lib.repro_fused_mlp_bwd(
                _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(dh),
                _build.ptr(dg), _build.ptr(du), m, f, h, ACT_CODES[mlp_type], dt, vec,
                *pick_tile(m, x.dtype), _build.stream_of(x.device))
        _build.check(status, "fused_mlp_bwd")
        fused_mlp_bwd.launches += 1
    if w_gate is None:
        return matmul(du, w_up.T), None, matmul(x.T, du)
    dx = matmul(dg, w_gate.T, du, w_up.T)
    return dx, matmul(x.T, dg), matmul(x.T, du)
