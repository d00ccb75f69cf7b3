"""Public wrapper of the fused SwiGLU/MLP hidden kernel (`csrc/fused_mlp.cu`).

`fused_mlp_hidden` flattens (..., h) activations to 2-D and dispatches on
the device: a CPU tensor runs the plain version (`ref.fused_mlp_hidden_ref`),
a CUDA tensor launches the kernel — or raises.  Forward only: the
recompute-based backward comes with the training slice.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import MLP_TYPES, fused_mlp_hidden_ref, is_gated

# csrc/gemm_tile.cuh `Act`
ACT_CODES = {"swiglu": 1, "gelu": 2, "relu2": 3}


def fused_mlp_hidden(x, w_gate, w_up, *, mlp_type: str = "swiglu"):
    """hidden = act-combine(x @ w_gate, x @ w_up).  x: (..., h) -> (..., f)."""
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"unknown mlp_type {mlp_type!r}; valid: {list(MLP_TYPES)}")
    lead, h = x.shape[:-1], x.shape[-1]
    f = w_up.shape[-1]
    x2 = x.reshape(-1, h)
    if not is_gated(mlp_type):
        w_gate = None
    if _build.dispatch_device("fused_mlp_hidden", x2) == "cpu":
        out = fused_mlp_hidden_ref(x2, w_gate, w_up, mlp_type)
    else:
        out = _fused_cuda(x2, w_gate, w_up, mlp_type)
    return out.reshape(*lead, f)


fused_mlp_hidden.launches = 0


def _fused_cuda(x, w_gate, w_up, mlp_type: str):
    ws = (w_up,) if w_gate is None else (w_gate, w_up)
    _build.cuda_operands("fused_mlp_hidden", x, *ws)
    for w in ws:
        if w.dim() != 2 or w.shape != w_up.shape or w.shape[0] != x.shape[1]:
            raise ValueError(f"fused_mlp_hidden: x {tuple(x.shape)} against "
                             f"weights {[tuple(t.shape) for t in ws]}")
        if w.dtype != x.dtype:
            raise TypeError(f"fused_mlp_hidden: dtypes {x.dtype} and {w.dtype}")
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
                                     _build.stream_of(x.device))
    _build.check(status, "fused_mlp_hidden")
    fused_mlp_hidden.launches += 1
    return out
