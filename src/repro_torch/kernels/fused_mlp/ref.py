"""Plain PyTorch version of the fused MLP hidden computation (the CPU path,
and what the CUDA kernel is held against):

    swiglu:       h = silu(x @ w_gate) * (x @ w_up)     (gated, 2 GEMMs)
    gelu / relu2: h = act(x @ w_up)                     (plain, 1 GEMM)

The derivative pairs of the JAX module come with the backward slice.
"""
from __future__ import annotations

import torch

MLP_TYPES = ("swiglu", "gelu", "relu2")


def is_gated(mlp_type: str) -> bool:
    return mlp_type == "swiglu"


def _silu(z):
    return z * torch.sigmoid(z)


# tanh-approximate gelu (jax.nn.gelu's default)
_C = 0.7978845608028654  # sqrt(2/pi)
_A = 0.044715


def _gelu(z):
    return 0.5 * z * (1.0 + torch.tanh(_C * (z + _A * z * z * z)))


def _relu2(z):
    return torch.square(torch.clamp_min(z, 0.0))


ACTS = {"swiglu": _silu, "gelu": _gelu, "relu2": _relu2}


def fused_mlp_hidden_ref(x, w_gate, w_up, mlp_type: str = "swiglu"):
    """x: (m, h); w_gate (gated only), w_up: (h, f).  Returns (m, f)."""
    act = ACTS[mlp_type]
    u = x.float() @ w_up.float()
    if is_gated(mlp_type):
        g = x.float() @ w_gate.float()
        return (act(g) * u).to(x.dtype)
    return act(u).to(x.dtype)
