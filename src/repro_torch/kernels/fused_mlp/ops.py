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
expert), swiglu or gelu.  `fused_mlp_bwd_expert` is its backward: ONE
launch of the batched recompute kernel, then the batched tile GEMM
(`matmul_expert`): dx over both pairs in one nt launch, dwg and dwu in two
tn launches.  Each counts its own launches.  The recompute takes the TMA
route (`csrc/fused_mlp_bwd_expert.cu` on `gemm_sm90_tma.cuh`) where every
bf16 operand takes a tensor map (`matmul.ops.tma_operand`), else the
grid-z launch of `csrc/fused_mlp_bwd.cu`; `fused_mlp_bwd_expert.tma`
counts the TMA route's launches.

`cost` (the forward kernel) and `bwd_cost` (the recompute kernel) are the
kernels' work; `bwd_launches` lists every launch of the backward, its tile
GEMMs' included: what a call charges the op counter
(`core/op_analysis.py`) on any device.  `bwd_function_cost` is the
backward's work as a function (each operand read once, each gradient
written once), what chip_smoke's bound for the whole backward is computed
from: the launches' sum also counts the design's own traffic (the weights
read again by the recompute, dg and du written and read back).

With observability on, each forward and backward records its dispatch (op
"fused_mlp_<mlp_type>", "fused_mlp_hidden_expert", "fused_mlp_bwd" or
"fused_mlp_bwd_expert", "cuda" or "plain", the flattened shape, the tile),
each distinct one once.
"""
from __future__ import annotations

from typing import Optional

import torch

from ... import obs
from ...core import op_analysis
from ...core.hardware import get_hardware
from ...tuning.cache import TunedConfig, dtype_name, lookup
from .. import _build
from ..matmul.ops import TMA_BOX, matmul, matmul_expert, tma_a_rows, tma_descs
from ..matmul.ops import cost as matmul_cost
from .backward import fused_mlp_bwd_expert_ref, fused_mlp_bwd_ref
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


def cost(m: int, h: int, f: int, gated: bool, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward launch: x (m, h) against the gate/up
    pair (or w_up alone), hidden (m, f) written."""
    nw = 2 if gated else 1
    return 2.0 * nw * m * h * f, float(itemsize * (m * h + nw * h * f + m * f))


def bwd_cost(m: int, h: int, f: int, gated: bool, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one recompute launch: the gate/up pre-activations
    again from x and the weights, dh read, dg and du written."""
    nw = 2 if gated else 1
    return 2.0 * nw * m * h * f, float(itemsize * (m * h + nw * h * f + m * f + nw * m * f))


def bwd_launches(m: int, h: int, f: int, gated: bool, itemsize: int, e: int = 0) -> list:
    """[(kernel, FLOPs, bytes)] of the backward's launches: the recompute,
    then the tile GEMM's dx (both pairs in one launch) and the weight
    gradients; `e` experts: the batched launches, each e times the work."""
    k = max(e, 1)
    rec = bwd_cost(m, h, f, gated, itemsize)
    dx = matmul_cost(m, f, h, itemsize, 2 if gated else 1)
    dw = matmul_cost(h, m, f, itemsize)
    suffix = "_expert" if e else ""
    out = [("fused_mlp_bwd" + suffix, *rec), ("matmul" + suffix, *dx)]
    out += [("matmul" + suffix, *dw)] * (2 if gated else 1)
    return [(name, k * fl, k * nb) for name, fl, nb in out]


def bwd_function_cost(m: int, h: int, f: int, gated: bool, itemsize: int,
                      e: int = 0) -> tuple[float, float]:
    """(FLOPs, bytes) of the backward as a function: the launches' FLOPs;
    x, the weights and dh read once, dx and the weight gradients written
    once; `e` experts: e times the work."""
    nw, k = (2 if gated else 1), max(e, 1)
    flops = sum(fl for _, fl, _ in bwd_launches(m, h, f, gated, itemsize, e))
    return flops, float(k * itemsize * (2 * m * h + 2 * nw * h * f + m * f))


def _check_type(mlp_type: str) -> None:
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"unknown mlp_type {mlp_type!r}; valid: {list(MLP_TYPES)}")


def fused_mlp_hidden(x, w_gate, w_up, *, mlp_type: str = "swiglu", tuned: bool = False,
                     hw_name: str | None = None, as_op: bool = False):
    """hidden = act-combine(x @ w_gate, x @ w_up).  x: (..., h) -> (..., f).
    The tuning cache keys the flattened (m, h, f) problem.  `as_op`: when a
    gradient is recorded, run the forward as the dispatcher op
    `repro_torch::fused_mlp_hidden` (which a dispatch mode, such as
    remat="dots"'s policy, can see) instead of `_FusedHidden`."""
    _check_type(mlp_type)
    lead, h = x.shape[:-1], x.shape[-1]
    f = w_up.shape[-1]
    x2 = x.reshape(-1, h)
    if not is_gated(mlp_type):
        w_gate = None
    ins = (x2, w_up) if w_gate is None else (x2, w_gate, w_up)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        fn = fused_hidden_op if as_op else _FusedHidden.apply
        out = fn(x2, w_gate, w_up, mlp_type, tuned, hw_name)
    else:
        out = _hidden(x2, w_gate, w_up, mlp_type, tuned, hw_name)
    return out.reshape(*lead, f)


def _hidden(x2, w_gate, w_up, mlp_type: str, tuned: bool, hw_name):
    cpu = _build.dispatch_device("fused_mlp_hidden", x2) == "cpu"
    with op_analysis.kernel("fused_mlp_hidden", lambda: cost(
            *x2.shape, w_up.shape[-1], w_gate is not None, x2.element_size())):
        if cpu:
            if obs.enabled():
                obs.record_dispatch(fused_mlp_op_name(mlp_type), impl="plain",
                                    shape=(*x2.shape, w_up.shape[-1]))
            return fused_mlp_hidden_ref(x2, w_gate, w_up, mlp_type)
        return _fused_cuda(x2, w_gate, w_up, mlp_type, tuned, hw_name)


fused_mlp_hidden.launches = 0
fused_mlp_hidden.tuned_hits = 0
fused_mlp_hidden.tuned_misses = 0


def _hidden_setup(ctx, inputs, output):
    x2, w_gate, w_up, ctx.mlp_type, ctx.tuned, ctx.hw_name = inputs
    ctx.save_for_backward(x2, w_gate, w_up)


def _hidden_backward(ctx, dh):
    x2, w_gate, w_up = ctx.saved_tensors
    dx, dwg, dwu = fused_mlp_bwd(x2, w_gate, w_up, dh.contiguous(), mlp_type=ctx.mlp_type,
                                 tuned=ctx.tuned, hw_name=ctx.hw_name)
    return dx, dwg, dwu, None, None, None


class _FusedHidden(torch.autograd.Function):
    """JAX's `_fused_gated` / `_fused_plain` (fused_mlp/ops.py:92-123)."""

    forward = staticmethod(_hidden)
    setup_context = staticmethod(_hidden_setup)
    backward = staticmethod(_hidden_backward)


@torch.library.custom_op("repro_torch::fused_mlp_hidden", mutates_args=())
def fused_hidden_op(x2: torch.Tensor, w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
                    mlp_type: str, tuned: bool, hw_name: Optional[str]) -> torch.Tensor:
    """`_FusedHidden` as one dispatcher op with the same backward (the
    kernel on a CUDA tensor, the plain version on a CPU one).  A dispatcher
    op costs the host more per call than the Function, so only callers
    that need a dispatch mode to see the product take it."""
    return _hidden(x2, w_gate, w_up, mlp_type, tuned, hw_name)


fused_hidden_op.register_autograd(_hidden_backward, setup_context=_hidden_setup)


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
        if obs.enabled():
            obs.record_dispatch(fused_mlp_op_name(mlp_type), impl="cuda", shape=(m, k, f),
                                blocks={"block_m": tile[0], "block_f": tile[1]},
                                tuned_hit=(cfg is not None) if tuned else None)
    if _build.traced(x.device):
        return out
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
    tuning key).  A CPU tensor runs the plain version
    (`fused_mlp_hidden_ref`, whose products batch over the expert axis).
    `fused_mlp_hidden_expert.launches` counts launches."""
    _check_expert_type("fused_mlp_hidden_expert", mlp_type)
    if not is_gated(mlp_type):
        w_gate = None
    cpu = _build.dispatch_device("fused_mlp_hidden_expert", x) == "cpu"

    def work():
        e, m, h = x.shape
        fl, nb = cost(m, h, w_up.shape[-1], w_gate is not None, x.element_size())
        return e * fl, e * nb
    with op_analysis.kernel("fused_mlp_hidden_expert", work):
        if cpu:
            if obs.enabled():
                obs.record_dispatch("fused_mlp_hidden_expert", impl="plain",
                                    shape=(*x.shape, w_up.shape[-1]), site=mlp_type)
            return fused_mlp_hidden_ref(x, w_gate, w_up, mlp_type)
        return _fused_expert_cuda(x, w_gate, w_up, mlp_type, tuned, hw_name)


fused_mlp_hidden_expert.launches = 0


def _check_expert_type(what: str, mlp_type: str) -> None:
    if mlp_type not in EXPERT_MLP_TYPES:
        raise ValueError(f"{what}: mlp_type {mlp_type!r}; valid: {list(EXPERT_MLP_TYPES)}")


def _check_expert_operands(what, x, w_gate, w_up, *rest):
    """Raise unless x (E, m, h) and the (E, h, f) weights (and `rest`) are
    contiguous CUDA tensors of one dtype on one device; the weights."""
    ws = (w_up,) if w_gate is None else (w_gate, w_up)
    _build.cuda_operands(what, x, *ws, *rest)
    for w in ws:
        if x.dim() != 3 or w.shape != w_up.shape or w.dim() != 3 \
                or w.shape[:2] != (x.shape[0], x.shape[2]):
            raise ValueError(f"{what}: x {tuple(x.shape)} against "
                             f"weights {[tuple(t.shape) for t in ws]}")
    for t in (*ws, *rest):
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: dtypes {x.dtype} and {t.dtype}")
    return ws


def _fused_expert_cuda(x, w_gate, w_up, mlp_type: str, tuned: bool = False, hw_name=None):
    """Launch csrc/fused_mlp.cu `repro_fused_mlp_expert`."""
    ws = _check_expert_operands("fused_mlp_hidden_expert", x, w_gate, w_up)
    e, m, k = x.shape
    f = w_up.shape[2]
    out = torch.empty((e, m, f), dtype=x.dtype, device=x.device)
    if e == 0 or m == 0 or f == 0:
        return out
    tile, cfg = geometry(m, k, f, x.dtype, mlp_type, tuned=tuned, hw_name=hw_name)
    if obs.enabled():
        obs.record_dispatch("fused_mlp_hidden_expert", impl="cuda", shape=(e, m, k, f),
                            site=mlp_type, blocks={"block_m": tile[0], "block_f": tile[1]},
                            tuned_hit=(cfg is not None) if tuned else None)
    if _build.traced(x.device):
        return out
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
    cpu = _build.dispatch_device("fused_mlp_bwd", x2) == "cpu"
    if obs.enabled():
        obs.record_dispatch("fused_mlp_bwd", impl="plain" if cpu else "cuda",
                            shape=(*x2.shape, w_up.shape[-1]), site=mlp_type,
                            blocks=None if cpu else dict(zip(("block_m", "block_f"),
                                                             pick_tile(x2.shape[0], x2.dtype))))
    # the recompute and its three tile GEMMs, charged here, not by `matmul`
    with op_analysis.kernel(None, lambda: bwd_launches(
            *x2.shape, w_up.shape[-1], w_gate is not None, x2.element_size())):
        if cpu:
            dx, dwg, dwu = fused_mlp_bwd_ref(x2, w_gate, w_up, dh2, mlp_type)
        else:
            dx, dwg, dwu = _bwd_cuda(x2, w_gate, w_up, dh2, mlp_type, tuned, hw_name)
    return dx.reshape(*lead, h), dwg, dwu


fused_mlp_bwd.launches = 0


def _recompute_cuda(x, w_gate, w_up, dh, mlp_type: str):
    """Launch csrc/fused_mlp_bwd.cu `repro_fused_mlp_bwd`: (dg, du) in the
    compute dtype, dg None on the un-gated path."""
    ws = _check_operands("fused_mlp_bwd", x, w_gate, w_up, dh)
    if dh.shape != (x.shape[0], w_up.shape[1]):
        raise ValueError(f"fused_mlp_bwd: dh {tuple(dh.shape)} for x {tuple(x.shape)} and "
                         f"weights {tuple(w_up.shape)}")
    m, h = x.shape
    f = w_up.shape[1]
    du = torch.empty_like(dh)
    dg = None if w_gate is None else torch.empty_like(dh)
    if m and f:
        if _build.traced(x.device):
            return dg, du
        chunk = 16 // x.element_size()
        vec = int(h % chunk == 0 and f % chunk == 0 and _build.aligned16(x, *ws))
        lib = _build.build().lib
        with torch.cuda.device(x.device):
            status = lib.repro_fused_mlp_bwd(
                _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(dh),
                _build.ptr(dg), _build.ptr(du), m, f, h, ACT_CODES[mlp_type],
                _build.dtype_code(x.dtype), vec, *pick_tile(m, x.dtype),
                _build.stream_of(x.device))
        _build.check(status, "fused_mlp_bwd")
        fused_mlp_bwd.launches += 1
    return dg, du


def _bwd_cuda(x, w_gate, w_up, dh, mlp_type: str, tuned: bool, hw_name):
    dg, du = _recompute_cuda(x, w_gate, w_up, dh, mlp_type)
    kw = dict(tuned=tuned, hw_name=hw_name)
    if w_gate is None:
        return matmul(du, w_up.T, **kw), None, matmul(x.T, du, **kw)
    dx = matmul(dg, w_gate.T, du, w_up.T, **kw)
    return dx, matmul(x.T, dg, **kw), matmul(x.T, du, **kw)

def fused_mlp_bwd_expert(x, w_gate, w_up, dh, *, mlp_type: str = "swiglu", tuned: bool = False,
                         hw_name: str | None = None):
    """(dx, dwg, dwu) of `fused_mlp_hidden_expert`; dwg None for gelu.
    x: (E, m, h); w_gate (swiglu only), w_up: (E, h, f); dh: (E, m, f).  A
    CUDA tensor launches csrc/fused_mlp_bwd.cu `repro_fused_mlp_bwd_expert`
    once for all E experts (dg, du in the compute dtype), then
    `matmul_expert` three times: dx over both pairs (nt), dwg and dwu (tn),
    operands read in place; `tuned` and `hw_name` pass to those.  A CPU
    tensor runs the plain version, per expert (`fused_mlp_bwd_expert_ref`).
    `fused_mlp_bwd_expert.launches` counts the recompute launches,
    `fused_mlp_bwd_expert.tma` those of the TMA route."""
    _check_expert_type("fused_mlp_bwd_expert", mlp_type)
    if not is_gated(mlp_type):
        w_gate = None
    cpu = _build.dispatch_device("fused_mlp_bwd_expert", x) == "cpu"
    if obs.enabled():
        blocks = None
        if not cpu:
            tile = pick_tile(x.shape[1], x.dtype)
            # the recompute's route (dg and du are allocated like dh)
            tma = recompute_route(x, w_gate, w_up, dh, dh, dh, tile) is not None
            blocks = {"block_m": tile[0], "block_f": tile[1], "tma": int(tma)}
        obs.record_dispatch("fused_mlp_bwd_expert", impl="plain" if cpu else "cuda",
                            shape=(*x.shape, w_up.shape[-1]), site=mlp_type, blocks=blocks)
    with op_analysis.kernel(None, lambda: bwd_launches(
            *x.shape[1:], w_up.shape[-1], w_gate is not None, x.element_size(), x.shape[0])):
        if cpu:
            return fused_mlp_bwd_expert_ref(x, w_gate, w_up, dh, mlp_type)
        return _bwd_expert_cuda(x, w_gate, w_up, dh, mlp_type, tuned, hw_name)


fused_mlp_bwd_expert.launches = 0
fused_mlp_bwd_expert.tma = 0


def recompute_route(x, w_gate, w_up, dh, dg, du, tile):
    """The TMA route's description array for the batched recompute at
    `tile` (x K-major in boxes of `tma_a_rows`, the weights MN-major, dh in
    boxes of the tile's rows, dg and du in 64-row boxes), or None: the
    grid-z route (f32, or a stack the TMA cannot describe)."""
    if x.dtype != torch.bfloat16:
        return None
    tm, tn = tile
    gated = w_gate is not None
    # every operand is a row-major stack (`_check_expert_operands`)
    return tma_descs({"a": (x, 2, tma_a_rows(x.shape[1], tm), False),
                      "b0": (w_gate if gated else w_up, 1, tn, False),
                      "b1": (w_up, 1, tn, False) if gated else None,
                      "dh": (dh, None, tm, False),
                      "dg": (dg, None, TMA_BOX, False) if gated else None,
                      "du": (du, None, TMA_BOX, False)})


def _recompute_expert_cuda(x, w_gate, w_up, dh, mlp_type: str):
    """Launch the batched recompute, the TMA route (csrc/fused_mlp_bwd_expert.cu)
    where `recompute_route` gives descriptions, else csrc/fused_mlp_bwd.cu
    `repro_fused_mlp_bwd_expert`: (dg, du) of every expert in the compute
    dtype, dg None for gelu."""
    ws = _check_expert_operands("fused_mlp_bwd_expert", x, w_gate, w_up, dh)
    e, m, h = x.shape
    f = w_up.shape[2]
    if dh.shape != (e, m, f):
        raise ValueError(f"fused_mlp_bwd_expert: dh {tuple(dh.shape)} for x {tuple(x.shape)} "
                         f"and weights {tuple(w_up.shape)}")
    du = torch.empty_like(dh)
    dg = None if w_gate is None else torch.empty_like(dh)
    if e and m and f:
        if _build.traced(x.device):
            return dg, du
        tile = pick_tile(m, x.dtype)
        desc = recompute_route(x, w_gate, w_up, dh, dg, du, tile)
        lib = _build.build().lib
        with torch.cuda.device(x.device):
            if desc is not None:
                counter = torch.empty(1, dtype=torch.int32, device=x.device)  # the tile queue's
                status = lib.repro_fused_mlp_bwd_expert_tma(
                    _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(dh),
                    _build.ptr(dg), _build.ptr(du), desc.buffer_info()[0], _build.ptr(counter),
                    e, m, f, h,
                    ACT_CODES[mlp_type], *tile, _build.num_sms(x.device),
                    _build.stream_of(x.device))
            else:
                chunk = 16 // x.element_size()
                vec = int(h % chunk == 0 and f % chunk == 0 and _build.aligned16(x, *ws, dh))
                status = lib.repro_fused_mlp_bwd_expert(
                    _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(dh),
                    _build.ptr(dg), _build.ptr(du), e, m, f, h, ACT_CODES[mlp_type],
                    _build.dtype_code(x.dtype), vec, *tile, _build.stream_of(x.device))
        _build.check(status, "fused_mlp_bwd_expert")
        fused_mlp_bwd_expert.launches += 1
        fused_mlp_bwd_expert.tma += desc is not None
    return dg, du


def _bwd_expert_cuda(x, w_gate, w_up, dh, mlp_type: str, tuned: bool, hw_name):
    dg, du = _recompute_expert_cuda(x, w_gate, w_up, dh, mlp_type)
    kw = dict(tuned=tuned, hw_name=hw_name)
    if w_gate is None:
        return matmul_expert(du, w_up.mT, **kw), None, matmul_expert(x.mT, du, **kw)
    dx = matmul_expert(dg, w_gate.mT, du, w_up.mT, **kw)
    return dx, matmul_expert(x.mT, dg, **kw), matmul_expert(x.mT, du, **kw)
