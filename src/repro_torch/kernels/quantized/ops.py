"""Public wrappers of the low-precision GEMM kernels: the int8 GEMM
(`csrc/int8_matmul.cu`), the int8-weight fused MLP hidden
(`csrc/int8_fused_mlp.cu`) and the emulated-fp8 GEMM.

Quantization policy, as the JAX package's `kernels/quantized/ops.py`:
  * weights quantize per output channel, once — pass a `QuantizedTensor`
    (from `quant.quantize_weight`) — or per call from a float matrix;
  * activations quantize per row on every call (dynamic quantization), in
    plain PyTorch (`quant.quantize_int8`): in the JAX package XLA fuses this
    step into the surrounding program, outside any Pallas kernel;
  * fp8 is emulated: both operands round through fp8 storage and the
    product runs the ported tile GEMM (`kernels/matmul`), no new kernel.

`int8_matmul_q` / `int8_fused_mlp_q` take the quantized operands and
dispatch on the device: a CPU tensor runs the plain version (`ref.py`), a
CUDA tensor launches the kernel — or raises.  `int8_matmul.launches` and
`int8_fused_mlp_hidden.launches` count kernel launches.

`int8_matmul_expert` is the MoE layer's expert stacks on the int8 path:
each expert's rows quantized per row, each expert's weight per output
channel (a float stack per call, as JAX quantizes per expert under
`lax.map`), then ONE launch of `csrc/int8_matmul.cu`
`repro_int8_matmul_expert` for all experts (the grid's z axis), each at
the 2-D kernel's tile for the per-expert (m, k, n), unsplit.

The kernels (`csrc/gemm_sm90_s8.cuh`, s8 `wgmma`) read each weight K-major:
a (k, n) payload that is the `.mT` view of a contiguous (n, k) tensor, as
`quant.quantize_weight` and `params_from_jax` hold it.  A row-major (k, n)
payload is relaid on the call that gets it (a copy of the weight), and
counted in `int8_matmul.relayouts` / `int8_fused_mlp_hidden.relayouts`; a
serving path holds its weights K-major and shows none.  `launch_shape`
picks the GEMM's tile and split on the host, `fused_tile` the fused MLP's
tile: the rules.  With `tuned=True` (linear_impl "quantized" passes it) a
tuning-cache entry replaces the rule's pick: "int8_matmul" (block_m,
block_n, split_k) and "int8_fused_mlp_<mlp_type>" (block_m, block_f) under
the mixed dtype key (activation x weight, e.g. "bfloat16xint8"), and the
emulated fp8 GEMM's "fp8_matmul" entries (the tile GEMM's knobs) under
e.g. "bfloat16xfloat8_e4m3fn" (`int8_geometry`, `int8_fused_geometry`; a
miss keeps the rule).  `.tuned_hits` / `.tuned_misses` count the lookups.
"""
from __future__ import annotations

import torch

from ... import obs
from ...core import op_analysis
from ...core.hardware import get_hardware
from ...quant import QuantizedTensor, fp8_round_trip, k_major, quantize_int8, quantize_weight
from ...tuning.cache import TunedConfig, dtype_name, lookup, mixed_dtype
from ...tuning.candidates import split_depth
from .. import _build
from ..fused_mlp.ops import ACT_CODES, _check_type
from ..fused_mlp.ref import is_gated
from ..matmul.ops import keyed_matmul, split_k
from .ref import int8_fused_mlp_ref, int8_matmul_expert_ref, int8_matmul_ref

BLOCK_K = 128            # csrc/gemm_sm90_s8.cuh I8_BK: the k step (one 128-byte atom), the split's unit
DECODE_TILE = (64, 128)  # (rows, columns) at most 64 rows: one warpgroup, every weight byte read once
WIDE_TILE = (128, 256)   # more rows: two warpgroups
FUSED_TILE = (64, 32)    # the fused MLP's output tile at most 64 rows (two accumulator sets)
FUSED_WIDE_TILE = (128, 32)  # ... more rows: two warpgroups
# A split of k: its blocks form one thread-block cluster (at most 8, the
# portable size) that sums the int32 partials in distributed shared memory;
# one wave of blocks (one per SM), each split at least two steps deep.
MAX_SPLITS, SPLIT_WAVES, SPLIT_MIN_STEPS = 8, 1, 2


def launch_shape(m: int, n: int, k: int, num_sms: int) -> tuple[int, int, int]:
    """(tile rows, tile columns, k per split) of one launch of
    csrc/int8_matmul.cu: 64 x 128 at most 64 rows, else 128 x 256 (on the
    H100 the fastest tile at 4096 rows and for the lm_head at 128 and 256
    rows; at 128-256 rows other projections ran up to 1.47x faster on
    64 x 128 tiles: PERF.md, from `tuning/int8_tiles.py`); k split in
    steps of BLOCK_K until one wave fills the card (`split_k`)."""
    tile = DECODE_TILE if m <= DECODE_TILE[0] else WIDE_TILE
    return (*tile, split_k(m, n, k, num_sms, BLOCK_K, tile, waves=SPLIT_WAVES,
                           min_steps=SPLIT_MIN_STEPS, most=MAX_SPLITS))


def fused_tile(m: int) -> tuple[int, int]:
    """The int8 fused MLP's output tile (rows, columns) for m rows: 64 x 32
    of one warpgroup at most 64 rows, else 128 x 32 of two (the fastest of
    64 / 128 x 32 / 64 at 16-4096 rows of the SwiGLU at 2048 x 8192 on the
    H100; `tuning/int8_tiles.py`)."""
    return FUSED_TILE if m <= FUSED_TILE[0] else FUSED_WIDE_TILE


def int8_fused_mlp_op_name(mlp_type: str) -> str:
    """Tuning-cache op key for the int8 fused-MLP hidden kernel."""
    return f"int8_fused_mlp_{mlp_type}"


def _key_dtype(act_dtype) -> str:
    return mixed_dtype(dtype_name(act_dtype), "int8")


def int8_geometry(m: int, k: int, n: int, act_dtype, *, tuned: bool = False,
                  hw_name: str | None = None, num_sms: int = 132
                  ) -> tuple[tuple[int, int, int], TunedConfig | None]:
    """((tile rows, tile columns, k per split), the cache entry used or
    None) of one int8 GEMM launch for an (m, k, n) product whose activation
    is `act_dtype`: with `tuned`, the "int8_matmul" entry (blocks block_m,
    block_n, split_k) when there is one, else `launch_shape`."""
    if tuned:
        cfg = lookup("int8_matmul", (m, k, n), _key_dtype(act_dtype),
                     hw_name or get_hardware().name)
        if cfg is not None:
            b = cfg.blocks
            return (b["block_m"], b["block_n"], split_depth(k, b["split_k"], BLOCK_K)), cfg
    return launch_shape(m, n, k, num_sms), None


def int8_fused_geometry(m: int, h: int, f: int, act_dtype, mlp_type: str, *,
                        tuned: bool = False, hw_name: str | None = None
                        ) -> tuple[tuple[int, int], TunedConfig | None]:
    """((tile rows, tile columns), the cache entry used or None) of the
    int8 fused MLP for x (m, h) against (h, f) weights: with `tuned`, the
    "int8_fused_mlp_<mlp_type>" entry (blocks block_m, block_f) when there
    is one, else `fused_tile`.  The kernel takes the tile's rows; its
    columns are 32 in every instantiation."""
    if tuned:
        cfg = lookup(int8_fused_mlp_op_name(mlp_type), (m, h, f), _key_dtype(act_dtype),
                     hw_name or get_hardware().name)
        if cfg is not None:
            return (cfg.blocks["block_m"], cfg.blocks["block_f"]), cfg
    return fused_tile(m), None


def _count(fn, tuned: bool, cfg) -> None:
    if tuned:
        if cfg is None:
            fn.tuned_misses += 1
        else:
            fn.tuned_hits += 1


def cost(m: int, k: int, n: int, out_itemsize: int, e: int = 1) -> tuple[float, float]:
    """(operations, bytes) of one int8 GEMM launch (e experts): int8
    operands read once, their f32 row and column scales, the output
    written.  What a call charges the op counter (core/op_analysis.py)
    and chip_smoke's bounds read."""
    return 2.0 * e * m * k * n, float(e * (m * k + k * n + 4 * (m + n) + out_itemsize * m * n))


def fused_cost(m: int, h: int, f: int, gated: bool, out_itemsize: int) -> tuple[float, float]:
    """(operations, bytes) of one int8 fused-MLP launch: x and each weight
    read once with their f32 scales, the hidden written."""
    nw = 2 if gated else 1
    return (2.0 * nw * m * h * f,
            float(m * h + nw * h * f + 4 * (m + nw * f) + out_itemsize * m * f))


def _as_quantized(w, name: str = "weight") -> QuantizedTensor:
    """A prequantized container passes through; a float matrix quantizes
    per output channel."""
    if isinstance(w, QuantizedTensor):
        return w
    if w.dtype == torch.int8:
        raise ValueError(f"{name}: a raw int8 tensor is ambiguous — wrap the payload and its "
                         f"scales in repro_torch.quant.QuantizedTensor")
    return quantize_weight(w, "int8")


def _flat(x):
    return x.reshape(-1, x.shape[-1])


# --- int8 GEMM ----------------------------------------------------------------------

def int8_matmul(a: torch.Tensor, w, *, out_dtype=None, tuned: bool = False,
                hw_name: str | None = None) -> torch.Tensor:
    """C = dequant(quant(A) @ quant(W)).  A: (..., k) float; W: (k, n) float
    or a `QuantizedTensor`.  Output in `out_dtype` (default A's).  The
    tuning cache keys the flattened (m, k, n) and A's dtype with int8."""
    lead = a.shape[:-1]
    wq = _as_quantized(w)
    a_q, a_scale = quantize_int8(_flat(a), axis=-1)
    out = int8_matmul_q(a_q, a_scale, wq.q, wq.scale.reshape(1, -1), out_dtype or a.dtype,
                        tuned=tuned, hw_name=hw_name, act_dtype=a.dtype)
    return out.reshape(*lead, wq.q.shape[-1])


int8_matmul.launches = 0
int8_matmul.relayouts = 0
int8_matmul.tuned_hits = 0
int8_matmul.tuned_misses = 0


def int8_matmul_q(a_q, a_scale, b_q, b_scale, out_dtype=torch.float32, *, tuned: bool = False,
                  hw_name: str | None = None, act_dtype=None) -> torch.Tensor:
    """The kernel's function on quantized operands: a_q (m, k) int8, a_scale
    (m, 1) f32; b_q (k, n) int8 (K-major, or row-major and relaid), b_scale
    (1, n) f32 -> (m, n) `out_dtype`.  A tuned lookup keys the activation's
    dtype, `act_dtype` (default `out_dtype`)."""
    cpu = _build.dispatch_device("int8_matmul", a_q) == "cpu"
    with op_analysis.kernel("int8_matmul", lambda: cost(*a_q.shape, b_q.shape[-1],
                                                        out_dtype.itemsize)):
        if cpu:
            if obs.enabled():
                obs.record_dispatch("int8_matmul", impl="plain",
                                    shape=(*a_q.shape, b_q.shape[-1]))
            return int8_matmul_ref(a_q, a_scale, b_q, b_scale, out_dtype)
        return _int8_matmul_cuda(a_q, a_scale, b_q, b_scale, out_dtype, tuned, hw_name,
                                 act_dtype or out_dtype)


def _check_int8(what: str, x_q, x_scale, ws) -> None:
    """Raise unless the payloads are int8 and the scales f32 of the shapes
    the kernels take: (m, 1) for the rows of x, (1, n) for each weight; x
    and the scales contiguous, on one device with the weights."""
    m, k = x_q.shape
    for t in (x_q, *(q for q, _ in ws)):
        if t.dtype != torch.int8:
            raise TypeError(f"{what}: payloads must be int8, got {t.dtype}")
    for s in (x_scale, *(s for _, s in ws)):
        if s.dtype != torch.float32:
            raise TypeError(f"{what}: scales must be float32, got {s.dtype}")
    if tuple(x_scale.shape) != (m, 1):
        raise ValueError(f"{what}: activation scales {tuple(x_scale.shape)} for {m} rows")
    n = ws[-1][0].shape[-1]
    for q, s in ws:
        if q.dim() != 2 or q.shape != (k, n) or tuple(s.shape) != (1, n):
            raise ValueError(f"{what}: x {tuple(x_q.shape)} against weight {tuple(q.shape)} "
                             f"with scales {tuple(s.shape)}")
    _build.cuda_operands(what, x_q, x_scale, *(s for _, s in ws))
    for q, _ in ws:
        if q.device != x_q.device:
            raise ValueError(f"{what}: operands on {x_q.device} and {q.device}")


def _k_major(what: str, fn, b_q):
    """The (n, k) row-major storage of a (k, n) weight: the payload's own
    when it is held K-major, else a relayout of a row-major payload, counted
    on `fn.relayouts`.  Raise for any other strides."""
    if b_q.mT.is_contiguous():
        return b_q.mT
    if not b_q.is_contiguous():
        raise ValueError(f"{what}: the kernel takes a K-major or a row-major weight "
                         f"(got strides {b_q.stride()} for shape {tuple(b_q.shape)})")
    fn.relayouts += 1
    return k_major(b_q).mT


def _vec(k: int, *tensors) -> int:
    """16-byte loads allowed: rows (k bytes, every operand K-major) of
    16-byte multiples, aligned bases."""
    return int(k % 16 == 0 and _build.aligned16(*tensors))


def _int8_matmul_cuda(a_q, a_scale, b_q, b_scale, out_dtype, tuned=False, hw_name=None,
                      act_dtype=None, forced=None):
    """Launch csrc/int8_matmul.cu; `forced` (tile rows, tile columns, k per
    split) launches that geometry, bypassing rule and cache."""
    _check_int8("int8_matmul", a_q, a_scale, [(b_q, b_scale)])
    dt = _build.dtype_code(out_dtype)
    m, k = a_q.shape
    n = b_q.shape[1]
    dev = a_q.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bt = _k_major("int8_matmul", int8_matmul, b_q)
    if forced is not None:
        tm, tn, ks = forced
    else:
        (tm, tn, ks), cfg = int8_geometry(m, k, n, act_dtype or out_dtype, tuned=tuned,
                                          hw_name=hw_name, num_sms=_build.num_sms(dev))
        _count(int8_matmul, tuned, cfg)
        if obs.enabled():
            obs.record_dispatch("int8_matmul", impl="cuda", shape=(m, k, n),
                                blocks={"block_m": tm, "block_n": tn,
                                        "split_k": -(-k // ks)},
                                tuned_hit=(cfg is not None) if tuned else None)
    if _build.traced(dev):
        return out
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_int8_matmul(
            _build.ptr(a_q), _build.ptr(bt), _build.ptr(a_scale), _build.ptr(b_scale),
            _build.ptr(out), m, n, k, ks, dt, _vec(k, a_q, bt), tm, tn, _build.stream_of(dev))
    _build.check(status, "int8_matmul")
    int8_matmul.launches += 1
    return out


# --- the expert-batched int8 GEMM (the MoE layer's stacks under "quantized") -------

EXPERT_QUANT_ELEMS = 1 << 28   # weight elements quantized at once: 1 GiB of f32 temporaries


def quantize_experts(w: torch.Tensor) -> QuantizedTensor:
    """`quantize_weight` of an (E, k, n) float expert stack, a slice of
    experts at a time: each expert's scales reduce over its own k, so the
    slices give the whole stack's payload and scales, while the f32
    temporaries of a whole stack (21 GB for llama4-maverick's 128 experts)
    would not fit beside the weights."""
    e, k, n = w.shape
    step = max(1, EXPERT_QUANT_ELEMS // max(1, k * n))
    if step >= e:
        return quantize_weight(w, "int8")
    q = torch.empty((e, n, k), dtype=torch.int8, device=w.device)
    scale = torch.empty((e, 1, n), dtype=torch.float32, device=w.device)
    for s in range(0, e, step):
        part = quantize_weight(w[s:s + step], "int8")
        q[s:s + step] = part.q.mT
        scale[s:s + step] = part.scale
    return QuantizedTensor(q=q.mT, scale=scale, axis=-2)


def int8_matmul_expert(x: torch.Tensor, w, *, out_dtype=None, tuned: bool = False,
                       hw_name: str | None = None) -> torch.Tensor:
    """Per-expert C[e] = dequant(quant(X[e]) @ quant(W[e])).  x: (E, m, k)
    float, quantized per row; w: (E, k, n) float, quantized per output
    channel of each expert (`quantize_experts`: a K-major payload, (E, 1, n)
    scales), or such a `QuantizedTensor`.  Output (E, m, n) in `out_dtype`
    (default x's).  A tuned lookup keys the per-expert (m, k, n), which
    every expert shares, with x's dtype and int8."""
    if isinstance(w, QuantizedTensor) or w.dtype == torch.int8:
        wq = _as_quantized(w)
    else:
        wq = quantize_experts(w)
    a_q, a_scale = quantize_int8(x, axis=-1)
    return int8_matmul_expert_q(a_q, a_scale, wq.q, wq.scale, out_dtype or x.dtype,
                                tuned=tuned, hw_name=hw_name, act_dtype=x.dtype)


int8_matmul_expert.launches = 0
int8_matmul_expert.relayouts = 0
int8_matmul_expert.tuned_hits = 0
int8_matmul_expert.tuned_misses = 0


def int8_matmul_expert_q(a_q, a_scale, b_q, b_scale, out_dtype=torch.float32, *,
                         tuned: bool = False, hw_name: str | None = None,
                         act_dtype=None) -> torch.Tensor:
    """The batched kernel's function on quantized operands: a_q (E, m, k)
    int8, a_scale (E, m, 1) f32; b_q (E, k, n) int8 (K-major, or row-major
    and relaid), b_scale (E, 1, n) f32 -> (E, m, n) `out_dtype`.  A CPU
    tensor runs the plain version, one expert at a time."""
    cpu = _build.dispatch_device("int8_matmul_expert", a_q) == "cpu"
    with op_analysis.kernel("int8_matmul_expert", lambda: cost(
            *a_q.shape[1:], b_q.shape[-1], out_dtype.itemsize, a_q.shape[0])):
        if cpu:
            if obs.enabled():
                obs.record_dispatch("int8_matmul", impl="plain", site="expert",
                                    shape=(*a_q.shape, b_q.shape[-1]))
            return int8_matmul_expert_ref(a_q, a_scale, b_q, b_scale, out_dtype)
        return _int8_matmul_expert_cuda(a_q, a_scale, b_q, b_scale, out_dtype, tuned, hw_name,
                                        act_dtype or out_dtype)


def _int8_matmul_expert_cuda(a_q, a_scale, b_q, b_scale, out_dtype, tuned=False, hw_name=None,
                             act_dtype=None):
    """Launch csrc/int8_matmul.cu `repro_int8_matmul_expert`."""
    what = "int8_matmul_expert"
    if a_q.dim() != 3 or b_q.dim() != 3 or b_q.shape[:2] != (a_q.shape[0], a_q.shape[2]):
        raise ValueError(f"{what}: x {tuple(a_q.shape)} against weight {tuple(b_q.shape)}")
    e, m, k = a_q.shape
    n = b_q.shape[2]
    for t in (a_q, b_q):
        if t.dtype != torch.int8:
            raise TypeError(f"{what}: payloads must be int8, got {t.dtype}")
    for s, want in ((a_scale, (e, m, 1)), (b_scale, (e, 1, n))):
        if s.dtype != torch.float32 or tuple(s.shape) != want:
            raise ValueError(f"{what}: scales {tuple(s.shape)} {s.dtype}, want {want} float32")
    _build.cuda_operands(what, a_q, a_scale, b_scale)
    if b_q.device != a_q.device:
        raise ValueError(f"{what}: operands on {a_q.device} and {b_q.device}")
    dev = a_q.device
    out = torch.empty((e, m, n), dtype=out_dtype, device=dev)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bt = _k_major(what, int8_matmul_expert, b_q)
    (tm, tn, _), cfg = int8_geometry(m, k, n, act_dtype or out_dtype, tuned=tuned,
                                     hw_name=hw_name, num_sms=_build.num_sms(dev))
    _count(int8_matmul_expert, tuned, cfg)
    if obs.enabled():
        obs.record_dispatch("int8_matmul", impl="cuda", shape=(e, m, k, n), site="expert",
                            blocks={"block_m": tm, "block_n": tn},
                            tuned_hit=(cfg is not None) if tuned else None)
    if _build.traced(dev):
        return out
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_int8_matmul_expert(
            _build.ptr(a_q), _build.ptr(bt), _build.ptr(a_scale), _build.ptr(b_scale),
            _build.ptr(out), e, m, n, k, _build.dtype_code(out_dtype), _vec(k, a_q, bt), tm, tn,
            _build.stream_of(dev))
    _build.check(status, what)
    int8_matmul_expert.launches += 1
    return out


# --- int8 fused MLP hidden ----------------------------------------------------------

def int8_fused_mlp_hidden(x: torch.Tensor, w_gate, w_up, *, mlp_type: str = "swiglu",
                          out_dtype=None, tuned: bool = False,
                          hw_name: str | None = None) -> torch.Tensor:
    """int8-weight fused-MLP hidden.  x: (..., h) float; w_gate / w_up:
    (h, f) float or `QuantizedTensor` (w_gate ignored for the ungated
    types).  Returns (..., f) in `out_dtype` (default x's)."""
    _check_type(mlp_type)
    lead = x.shape[:-1]
    wu = _as_quantized(w_up, "w_up")
    wg = _as_quantized(w_gate, "w_gate") if is_gated(mlp_type) else None
    x_q, x_scale = quantize_int8(_flat(x), axis=-1)
    out = int8_fused_mlp_q(
        x_q, x_scale, None if wg is None else wg.q,
        None if wg is None else wg.scale.reshape(1, -1), wu.q,
        wu.scale.reshape(1, -1), mlp_type=mlp_type, out_dtype=out_dtype or x.dtype,
        tuned=tuned, hw_name=hw_name, act_dtype=x.dtype)
    return out.reshape(*lead, wu.q.shape[-1])


int8_fused_mlp_hidden.launches = 0
int8_fused_mlp_hidden.relayouts = 0
int8_fused_mlp_hidden.tuned_hits = 0
int8_fused_mlp_hidden.tuned_misses = 0


def int8_fused_mlp_q(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, *,
                     mlp_type: str = "swiglu", out_dtype=torch.float32, tuned: bool = False,
                     hw_name: str | None = None, act_dtype=None) -> torch.Tensor:
    """The kernel's function on quantized operands (see `int8_fused_mlp_ref`);
    a tuned lookup keys `act_dtype` (default `out_dtype`)."""
    _check_type(mlp_type)
    if not is_gated(mlp_type):
        wg_q = wg_scale = None
    cpu = _build.dispatch_device("int8_fused_mlp_hidden", x_q) == "cpu"
    with op_analysis.kernel("int8_fused_mlp_hidden", lambda: fused_cost(
            *x_q.shape, wu_q.shape[-1], wg_q is not None, out_dtype.itemsize)):
        if cpu:
            if obs.enabled():
                obs.record_dispatch(int8_fused_mlp_op_name(mlp_type), impl="plain",
                                    shape=(*x_q.shape, wu_q.shape[-1]))
            return int8_fused_mlp_ref(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale,
                                      mlp_type=mlp_type, out_dtype=out_dtype)
        return _int8_fused_cuda(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, mlp_type,
                                out_dtype, tuned, hw_name, act_dtype or out_dtype)


def _int8_fused_cuda(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, mlp_type, out_dtype,
                     tuned=False, hw_name=None, act_dtype=None, forced=None):
    """Launch csrc/int8_fused_mlp.cu; `forced` (tile rows, tile columns)
    launches that tile, bypassing rule and cache."""
    ws = [(wu_q, wu_scale)] if wg_q is None else [(wg_q, wg_scale), (wu_q, wu_scale)]
    _check_int8("int8_fused_mlp_hidden", x_q, x_scale, ws)
    dt = _build.dtype_code(out_dtype)
    m, k = x_q.shape
    f = wu_q.shape[1]
    out = torch.empty((m, f), dtype=out_dtype, device=x_q.device)
    if m == 0 or f == 0:
        return out
    wts = [_k_major("int8_fused_mlp_hidden", int8_fused_mlp_hidden, q) for q, _ in ws]
    wgt, wut = (None, *wts) if wg_q is None else wts
    if forced is not None:
        tile = forced
    else:
        tile, cfg = int8_fused_geometry(m, k, f, act_dtype or out_dtype, mlp_type, tuned=tuned,
                                        hw_name=hw_name)
        _count(int8_fused_mlp_hidden, tuned, cfg)
        if obs.enabled():
            obs.record_dispatch(int8_fused_mlp_op_name(mlp_type), impl="cuda", shape=(m, k, f),
                                blocks={"block_m": tile[0], "block_f": tile[1]},
                                tuned_hit=(cfg is not None) if tuned else None)
    if tile[1] != FUSED_TILE[1]:
        raise ValueError(f"int8_fused_mlp_hidden: tile {tile[0]} x {tile[1]}: the library "
                         f"instantiates {FUSED_TILE[1]} columns only (csrc/int8_fused_mlp.cu)")
    if _build.traced(x_q.device):
        return out
    lib = _build.build().lib
    with torch.cuda.device(x_q.device):
        status = lib.repro_int8_fused_mlp(
            _build.ptr(x_q), _build.ptr(wgt), _build.ptr(wut), _build.ptr(x_scale),
            _build.ptr(wg_scale), _build.ptr(wu_scale), _build.ptr(out), m, f, k,
            ACT_CODES[mlp_type], dt, _vec(k, x_q, *wts), tile[0],
            _build.stream_of(x_q.device))
    _build.check(status, "int8_fused_mlp_hidden")
    int8_fused_mlp_hidden.launches += 1
    return out


# --- emulated fp8 GEMM --------------------------------------------------------------

def fp8_matmul(a: torch.Tensor, b: torch.Tensor, *, fp8_dtype: str = "float8_e4m3fn",
               tuned: bool = False, hw_name: str | None = None) -> torch.Tensor:
    """Round A (..., k) and B (k, n) through fp8 storage (e4m3 or e5m2) and
    contract on the tile GEMM (f32 accumulation, output in A's dtype).  A
    tuned lookup takes op "fp8_matmul" under the mixed dtype key, e.g.
    "bfloat16xfloat8_e4m3fn"; launches and lookups count on `matmul`."""
    return keyed_matmul(fp8_round_trip(a, fp8_dtype), fp8_round_trip(b, fp8_dtype),
                        tuned=tuned, hw_name=hw_name, op="fp8_matmul",
                        key_dtype=mixed_dtype(dtype_name(a.dtype), fp8_dtype))
