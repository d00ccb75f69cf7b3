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

With `tuned=True` (linear_impl "fused" passes it) the forward's tile comes
from the tuning cache's "fused_mlp_<mlp_type>" entry for (m, h, f, dtype,
hardware) when there is one (`geometry`; a miss keeps `pick_tile`), and
the backward's three GEMMs look up their own (m, k, n) keys; the recompute
kernel keeps `pick_tile`.  `fused_mlp_hidden.tuned_hits` / `tuned_misses`
count the forward's lookups.

`fused_mlp_hidden_expert` is the MoE layer's batched hidden: every expert
of a stack in ONE launch of the forward kernel (the grid's z axis is the
expert), swiglu or gelu, forward only; it counts its own launches.
"""
from __future__ import annotations

import torch

from ...core.hardware import get_hardware
from ...tuning.cache import TunedConfig, dtype_name, lookup
from .. import _build
from ..matmul.ops import MOE_TRAINING, matmul
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


def fused_mlp_op_name(mlp_type: str) -> str:
    """Tuning-cache op key: fused_mlp_swiglu | fused_mlp_gelu | ..."""
    return f"fused_mlp_{mlp_type}"


def geometry(m: int, h: int, f: int, dtype, mlp_type: str, *, tuned: bool = False,
             hw_name: str | None = None) -> tuple[tuple[int, int], TunedConfig | None]:
    """((tile rows, tile columns), the cache entry used or None) of the
    forward kernel for x (m, h) against (h, f) weights: with `tuned`, the
    default cache's "fused_mlp_<mlp_type>" entry (blocks block_m, block_f)
    when there is one, else `pick_tile`."""
    if tuned:
        cfg = lookup(fused_mlp_op_name(mlp_type), (m, h, f), dtype_name(dtype),
                     hw_name or get_hardware().name)
        if cfg is not None:
            return (cfg.blocks["block_m"], cfg.blocks["block_f"]), cfg
    return pick_tile(m, dtype), None


def _check_type(mlp_type: str) -> None:
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"unknown mlp_type {mlp_type!r}; valid: {list(MLP_TYPES)}")


def fused_mlp_hidden(x, w_gate, w_up, *, mlp_type: str = "swiglu", tuned: bool = False,
                     hw_name: str | None = None):
    """hidden = act-combine(x @ w_gate, x @ w_up).  x: (..., h) -> (..., f).
    The tuning cache keys the flattened (m, h, f) problem."""
    _check_type(mlp_type)
    lead, h = x.shape[:-1], x.shape[-1]
    f = w_up.shape[-1]
    x2 = x.reshape(-1, h)
    if not is_gated(mlp_type):
        w_gate = None
    ins = (x2, w_up) if w_gate is None else (x2, w_gate, w_up)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        out = _FusedHidden.apply(x2, w_gate, w_up, mlp_type, tuned, hw_name)
    else:
        out = _hidden(x2, w_gate, w_up, mlp_type, tuned, hw_name)
    return out.reshape(*lead, f)


def _hidden(x2, w_gate, w_up, mlp_type: str, tuned: bool, hw_name):
    if _build.dispatch_device("fused_mlp_hidden", x2) == "cpu":
        return fused_mlp_hidden_ref(x2, w_gate, w_up, mlp_type)
    return _fused_cuda(x2, w_gate, w_up, mlp_type, tuned, hw_name)


fused_mlp_hidden.launches = 0
fused_mlp_hidden.tuned_hits = 0
fused_mlp_hidden.tuned_misses = 0


class _FusedHidden(torch.autograd.Function):
    """JAX's `_fused_gated` / `_fused_plain` (fused_mlp/ops.py:92-123)."""

    @staticmethod
    def forward(ctx, x2, w_gate, w_up, mlp_type, tuned, hw_name):
        ctx.mlp_type, ctx.tuned, ctx.hw_name = mlp_type, tuned, hw_name
        ctx.save_for_backward(x2, w_gate, w_up)
        return _hidden(x2, w_gate, w_up, mlp_type, tuned, hw_name)

    @staticmethod
    def backward(ctx, dh):
        x2, w_gate, w_up = ctx.saved_tensors
        dx, dwg, dwu = fused_mlp_bwd(x2, w_gate, w_up, dh.contiguous(), mlp_type=ctx.mlp_type,
                                     tuned=ctx.tuned, hw_name=ctx.hw_name)
        return dx, dwg, dwu, None, None, None


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


def _fused_cuda(x, w_gate, w_up, mlp_type: str, tuned: bool = False, hw_name=None,
                forced=None):
    """Launch csrc/fused_mlp.cu; `forced` (tile rows, tile columns)
    launches that tile, bypassing rule and cache."""
    ws = _check_operands("fused_mlp_hidden", x, w_gate, w_up)
    dt = _build.dtype_code(x.dtype)
    m, k = x.shape
    f = w_up.shape[1]
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return out
    if forced is not None:
        tile = forced
    else:
        tile, cfg = geometry(m, k, f, x.dtype, mlp_type, tuned=tuned, hw_name=hw_name)
        if tuned:
            if cfg is None:
                fused_mlp_hidden.tuned_misses += 1
            else:
                fused_mlp_hidden.tuned_hits += 1
    chunk = 16 // x.element_size()
    vec = int(k % chunk == 0 and f % chunk == 0 and _build.aligned16(x, *ws))
    lib = _build.build().lib
    with torch.cuda.device(x.device):
        status = lib.repro_fused_mlp(_build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up),
                                     _build.ptr(out), m, f, k, ACT_CODES[mlp_type], dt, vec,
                                     *tile, _build.stream_of(x.device))
    _build.check(status, "fused_mlp_hidden")
    fused_mlp_hidden.launches += 1
    return out


# --- the expert-batched launch (the MoE layer's hidden under linear_impl="fused") -------

EXPERT_MLP_TYPES = ("swiglu", "gelu")   # the MoE layer maps every un-gated MLP to gelu


def fused_mlp_hidden_expert(x, w_gate, w_up, *, mlp_type: str = "swiglu", tuned: bool = False,
                            hw_name: str | None = None):
    """Per-expert hidden[e] = act-combine(x[e] @ w_gate[e], x[e] @ w_up[e]).
    x: (E, m, h); w_gate (swiglu only), w_up: (E, h, f) -> (E, m, f).  A
    CUDA tensor launches csrc/fused_mlp.cu `repro_fused_mlp_expert` once for
    all E experts, each at `geometry(m, h, f)`'s tile (the per-expert
    tuning key); forward only (raises under autograd).  A CPU tensor runs
    the plain version (`fused_mlp_hidden_ref`, whose products batch over
    the expert axis).  `fused_mlp_hidden_expert.launches` counts launches."""
    if mlp_type not in EXPERT_MLP_TYPES:
        raise ValueError(f"fused_mlp_hidden_expert: mlp_type {mlp_type!r}; valid: "
                         f"{list(EXPERT_MLP_TYPES)}")
    if not is_gated(mlp_type):
        w_gate = None
    if _build.dispatch_device("fused_mlp_hidden_expert", x) == "cpu":
        return fused_mlp_hidden_ref(x, w_gate, w_up, mlp_type)
    ins = (x, w_up) if w_gate is None else (x, w_gate, w_up)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(f"fused_mlp_hidden_expert: {MOE_TRAINING}")
    return _fused_expert_cuda(x, w_gate, w_up, mlp_type, tuned, hw_name)


fused_mlp_hidden_expert.launches = 0


def _fused_expert_cuda(x, w_gate, w_up, mlp_type: str, tuned: bool = False, hw_name=None):
    """Launch csrc/fused_mlp.cu `repro_fused_mlp_expert`."""
    ws = (w_up,) if w_gate is None else (w_gate, w_up)
    _build.cuda_operands("fused_mlp_hidden_expert", x, *ws)
    for w in ws:
        if w.dtype != x.dtype:
            raise TypeError(f"fused_mlp_hidden_expert: dtypes {x.dtype} and {w.dtype}")
        if x.dim() != 3 or w.shape != w_up.shape or w.dim() != 3 \
                or w.shape[:2] != (x.shape[0], x.shape[2]):
            raise ValueError(f"fused_mlp_hidden_expert: x {tuple(x.shape)} against "
                             f"weights {[tuple(t.shape) for t in ws]}")
    e, m, k = x.shape
    f = w_up.shape[2]
    out = torch.empty((e, m, f), dtype=x.dtype, device=x.device)
    if e == 0 or m == 0 or f == 0:
        return out
    tile, _ = geometry(m, k, f, x.dtype, mlp_type, tuned=tuned, hw_name=hw_name)
    chunk = 16 // x.element_size()
    vec = int(k % chunk == 0 and f % chunk == 0 and _build.aligned16(x, *ws))
    lib = _build.build().lib
    with torch.cuda.device(x.device):
        status = lib.repro_fused_mlp_expert(
            _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(out), e, m, f, k,
            ACT_CODES[mlp_type], _build.dtype_code(x.dtype), vec, *tile,
            _build.stream_of(x.device))
    _build.check(status, "fused_mlp_hidden_expert")
    fused_mlp_hidden_expert.launches += 1
    return out


def fused_mlp_bwd(x, w_gate, w_up, dh, *, mlp_type: str = "swiglu", tuned: bool = False,
                  hw_name: str | None = None):
    """(dx, dwg, dwu) of the fused hidden op; dwg None on the un-gated path.
    x: (..., h); w_gate (gated only), w_up: (h, f); dh: (..., f).  `tuned`
    and `hw_name` pass to the three tile GEMMs."""
    _check_type(mlp_type)
    lead, h = x.shape[:-1], x.shape[-1]
    x2, dh2 = x.reshape(-1, h), dh.reshape(-1, w_up.shape[-1])
    if not is_gated(mlp_type):
        w_gate = None
    if _build.dispatch_device("fused_mlp_bwd", x2) == "cpu":
        dx, dwg, dwu = fused_mlp_bwd_ref(x2, w_gate, w_up, dh2, mlp_type)
    else:
        dx, dwg, dwu = _bwd_cuda(x2, w_gate, w_up, dh2, mlp_type, tuned, hw_name)
    return dx.reshape(*lead, h), dwg, dwu


fused_mlp_bwd.launches = 0


def _bwd_cuda(x, w_gate, w_up, dh, mlp_type: str, tuned: bool, hw_name):
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
    kw = dict(tuned=tuned, hw_name=hw_name)
    if w_gate is None:
        return matmul(du, w_up.T, **kw), None, matmul(x.T, du, **kw)
    dx = matmul(dg, w_gate.T, du, w_up.T, **kw)
    return dx, matmul(x.T, dg, **kw), matmul(x.T, du, **kw)
