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

The kernels (`csrc/gemm_sm90_s8.cuh`, s8 `wgmma`) read each weight K-major:
a (k, n) payload that is the `.mT` view of a contiguous (n, k) tensor, as
`quant.quantize_weight` and `params_from_jax` hold it.  A row-major (k, n)
payload is relaid on the call that gets it (a copy of the weight), and
counted in `int8_matmul.relayouts` / `int8_fused_mlp_hidden.relayouts`; a
serving path holds its weights K-major and shows none.  `launch_shape`
picks the GEMM's tile and split on the host, `fused_tile` the fused MLP's
tile.
"""
from __future__ import annotations

import torch

from ...quant import QuantizedTensor, fp8_round_trip, k_major, quantize_int8, quantize_weight
from .. import _build
from ..fused_mlp.ops import ACT_CODES, _check_type
from ..fused_mlp.ref import is_gated
from ..matmul.ops import matmul, split_k
from .ref import int8_fused_mlp_ref, int8_matmul_ref

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

def int8_matmul(a: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """C = dequant(quant(A) @ quant(W)).  A: (..., k) float; W: (k, n) float
    or a `QuantizedTensor`.  Output in `out_dtype` (default A's)."""
    lead = a.shape[:-1]
    wq = _as_quantized(w)
    a_q, a_scale = quantize_int8(_flat(a), axis=-1)
    out = int8_matmul_q(a_q, a_scale, wq.q, wq.scale.reshape(1, -1), out_dtype or a.dtype)
    return out.reshape(*lead, wq.q.shape[-1])


int8_matmul.launches = 0
int8_matmul.relayouts = 0


def int8_matmul_q(a_q, a_scale, b_q, b_scale, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function on quantized operands: a_q (m, k) int8, a_scale
    (m, 1) f32; b_q (k, n) int8 (K-major, or row-major and relaid), b_scale
    (1, n) f32 -> (m, n) `out_dtype`."""
    if _build.dispatch_device("int8_matmul", a_q) == "cpu":
        return int8_matmul_ref(a_q, a_scale, b_q, b_scale, out_dtype)
    return _int8_matmul_cuda(a_q, a_scale, b_q, b_scale, out_dtype)


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


def _int8_matmul_cuda(a_q, a_scale, b_q, b_scale, out_dtype):
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
    tm, tn, ks = launch_shape(m, n, k, _build.num_sms(dev))
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_int8_matmul(
            _build.ptr(a_q), _build.ptr(bt), _build.ptr(a_scale), _build.ptr(b_scale),
            _build.ptr(out), m, n, k, ks, dt, _vec(k, a_q, bt), tm, tn, _build.stream_of(dev))
    _build.check(status, "int8_matmul")
    int8_matmul.launches += 1
    return out


# --- int8 fused MLP hidden ----------------------------------------------------------

def int8_fused_mlp_hidden(x: torch.Tensor, w_gate, w_up, *, mlp_type: str = "swiglu",
                          out_dtype=None) -> torch.Tensor:
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
        wu.scale.reshape(1, -1), mlp_type=mlp_type, out_dtype=out_dtype or x.dtype)
    return out.reshape(*lead, wu.q.shape[-1])


int8_fused_mlp_hidden.launches = 0
int8_fused_mlp_hidden.relayouts = 0


def int8_fused_mlp_q(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, *,
                     mlp_type: str = "swiglu", out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function on quantized operands (see `int8_fused_mlp_ref`)."""
    _check_type(mlp_type)
    if not is_gated(mlp_type):
        wg_q = wg_scale = None
    if _build.dispatch_device("int8_fused_mlp_hidden", x_q) == "cpu":
        return int8_fused_mlp_ref(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale,
                                  mlp_type=mlp_type, out_dtype=out_dtype)
    return _int8_fused_cuda(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, mlp_type, out_dtype)


def _int8_fused_cuda(x_q, x_scale, wg_q, wg_scale, wu_q, wu_scale, mlp_type, out_dtype):
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
    lib = _build.build().lib
    with torch.cuda.device(x_q.device):
        status = lib.repro_int8_fused_mlp(
            _build.ptr(x_q), _build.ptr(wgt), _build.ptr(wut), _build.ptr(x_scale),
            _build.ptr(wg_scale), _build.ptr(wu_scale), _build.ptr(out), m, f, k,
            ACT_CODES[mlp_type], dt, _vec(k, x_q, *wts), fused_tile(m)[0],
            _build.stream_of(x_q.device))
    _build.check(status, "int8_fused_mlp_hidden")
    int8_fused_mlp_hidden.launches += 1
    return out


# --- emulated fp8 GEMM --------------------------------------------------------------

def fp8_matmul(a: torch.Tensor, b: torch.Tensor, *,
               fp8_dtype: str = "float8_e4m3fn") -> torch.Tensor:
    """Round A (..., k) and B (k, n) through fp8 storage (e4m3 or e5m2) and
    contract on the tile GEMM (f32 accumulation, output in A's dtype)."""
    return matmul(fp8_round_trip(a, fp8_dtype), fp8_round_trip(b, fp8_dtype))
