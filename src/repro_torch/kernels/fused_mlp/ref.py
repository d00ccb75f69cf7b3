"""Plain PyTorch version of the fused MLP hidden computation (the CPU path,
and what the CUDA kernel is held against):

    swiglu:       h = silu(x @ w_gate) * (x @ w_up)     (gated, 2 GEMMs)
    gelu / relu2: h = act(x @ w_up)                     (plain, 1 GEMM)

`DACTS` holds each activation's derivative (the JAX module's derivative
pairs): the backward recomputes the pre-activations and needs the slope as
a plain function of them.
"""
from __future__ import annotations

import torch

MLP_TYPES = ("swiglu", "gelu", "relu2")


def is_gated(mlp_type: str) -> bool:
    return mlp_type == "swiglu"


def _silu(z):
    return z * torch.sigmoid(z)


def _dsilu(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


# tanh-approximate gelu (jax.nn.gelu's default)
_C = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715


def _gelu(z):
    return 0.5 * z * (1.0 + torch.tanh(_C * (z + _A * z * z * z)))


def _dgelu(z):
    t = torch.tanh(_C * (z + _A * z * z * z))
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * _C * (1.0 + 3.0 * _A * z * z)


def _relu2(z):
    return torch.square(torch.clamp_min(z, 0.0))


def _drelu2(z):
    return 2.0 * torch.clamp_min(z, 0.0)


# mlp_type -> activation, and its derivative; swiglu's gates w_gate's GEMM
ACTS = {"swiglu": _silu, "gelu": _gelu, "relu2": _relu2}
DACTS = {"swiglu": _dsilu, "gelu": _dgelu, "relu2": _drelu2}


def fused_mlp_hidden_ref(x, w_gate, w_up, mlp_type: str = "swiglu"):
    """x: (m, h); w_gate (gated only), w_up: (h, f).  Returns (m, f).  With
    a leading expert axis on all three, (E, m, h) against (E, h, f), the
    products batch per expert: the plain version of the batched launch."""
    act = ACTS[mlp_type]
    u = x.float() @ w_up.float()
    if is_gated(mlp_type):
        g = x.float() @ w_gate.float()
        return (act(g) * u).to(x.dtype)
    return act(u).to(x.dtype)
