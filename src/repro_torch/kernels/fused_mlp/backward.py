"""Plain PyTorch version of the fused MLP hidden op's backward (the CPU
path, and what the CUDA backward is held against).

For hidden = act(x @ wg) * (x @ wu) (gated; the plain types drop the gate):

    g = x @ wg, u = x @ wu                    (recomputed, never saved)
    dg = dh * u * act'(g);  du = dh * act(g)  (plain: du = dh * act'(u))
    dx = dg @ wg^T + du @ wu^T;  dwg = x^T @ dg;  dwu = x^T @ du

all in f32, each result rounded once to its operand's dtype.  The CUDA path
rounds dg and du to the compute dtype before the last three products
(csrc/fused_mlp_bwd.cu); kernels/tolerance.py charges that rounding.
"""
from __future__ import annotations

import torch

from .ref import ACTS, DACTS, is_gated


def fused_mlp_bwd_ref(x, w_gate, w_up, dh, mlp_type: str = "swiglu"):
    """x: (m, h); w_gate (gated only), w_up: (h, f); dh: (m, f).
    Returns (dx, dwg, dwu), dwg None on the un-gated path."""
    act, dact = ACTS[mlp_type], DACTS[mlp_type]
    xf, dhf, wu = x.float(), dh.float(), w_up.float()
    u = xf @ wu
    if not is_gated(mlp_type):
        du = dhf * dact(u)
        return (du @ wu.T).to(x.dtype), None, (xf.T @ du).to(w_up.dtype)
    wg = w_gate.float()
    g = xf @ wg
    dg = dhf * u * dact(g)
    du = dhf * act(g)
    dx = dg @ wg.T + du @ wu.T
    return dx.to(x.dtype), (xf.T @ dg).to(w_gate.dtype), (xf.T @ du).to(w_up.dtype)
