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
`int8_fused_mlp_hidden.launches` count kernel launches (the split-K reduce
rides with its GEMM).  The kernels' tiles are fixed, as the tile GEMM's.
"""
from __future__ import annotations

import torch

from ...core.quantization import ceil_div
from ...quant import QuantizedTensor, fp8_round_trip, quantize_int8, quantize_weight
from .. import _build
from ..fused_mlp.ops import ACT_CODES, _check_type
from ..fused_mlp.ref import is_gated
from ..matmul.ops import matmul, split_k
from .ref import int8_fused_mlp_ref, int8_matmul_ref

BLOCK_K = 64             # csrc/int8_tile.cuh I8_BK: the k step, and the split's unit
TILE = (64, 64)          # csrc/int8_tile.cuh's output tile (gemm_tile.cuh BM, BN)


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
    out = int8_matmul_q(a_q, a_scale, wq.q.contiguous(), wq.scale.reshape(1, -1),
                        out_dtype or a.dtype)
    return out.reshape(*lead, wq.q.shape[-1])


int8_matmul.launches = 0


def int8_matmul_q(a_q, a_scale, b_q, b_scale, out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function on quantized operands: a_q (m, k) int8, a_scale
    (m, 1) f32; b_q (k, n) int8, b_scale (1, n) f32 -> (m, n) `out_dtype`."""
    if _build.dispatch_device("int8_matmul", a_q) == "cpu":
        return int8_matmul_ref(a_q, a_scale, b_q, b_scale, out_dtype)
    return _int8_matmul_cuda(a_q, a_scale, b_q, b_scale, out_dtype)


def _check_int8(what: str, x_q, x_scale, ws) -> None:
    """Raise unless the payloads are int8 and the scales f32 of the shapes
    the kernels take: (m, 1) for the rows of x, (1, n) for each weight."""
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
    _build.cuda_operands(what, x_q, x_scale, *(t for pair in ws for t in pair))


def _vec(k: int, n: int, *tensors) -> int:
    """16-byte loads allowed: rows of 16-byte multiples, aligned bases."""
    return int(k % 16 == 0 and n % 16 == 0 and _build.aligned16(*tensors))


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
    ks = split_k(m, n, k, _build.num_sms(dev), BLOCK_K, TILE)
    splits = ceil_div(k, ks)
    work = torch.empty((splits, m, n), dtype=torch.int32, device=dev) if splits > 1 else None
    lib = _build.build().lib
    with torch.cuda.device(dev):
        status = lib.repro_int8_matmul(
            _build.ptr(a_q), _build.ptr(b_q), _build.ptr(a_scale), _build.ptr(b_scale),
            _build.ptr(out), _build.ptr(work), m, n, k, ks, dt, _vec(k, n, a_q, b_q),
            _build.stream_of(dev))
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
        x_q, x_scale, None if wg is None else wg.q.contiguous(),
        None if wg is None else wg.scale.reshape(1, -1), wu.q.contiguous(),
        wu.scale.reshape(1, -1), mlp_type=mlp_type, out_dtype=out_dtype or x.dtype)
    return out.reshape(*lead, wu.q.shape[-1])


int8_fused_mlp_hidden.launches = 0


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
    lib = _build.build().lib
    with torch.cuda.device(x_q.device):
        status = lib.repro_int8_fused_mlp(
            _build.ptr(x_q), _build.ptr(wg_q), _build.ptr(wu_q), _build.ptr(x_scale),
            _build.ptr(wg_scale), _build.ptr(wu_scale), _build.ptr(out), m, f, k,
            ACT_CODES[mlp_type], dt, _vec(k, f, x_q, *(q for q, _ in ws)),
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
