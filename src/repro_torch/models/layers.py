"""Basic layers: norms, rotary, initializers.

Plain functions on tensors over dict params (the JAX package's pytrees,
key for key).  GEMM weights live in the compute dtype (cast once, by
`convert.params_from_jax` or `lm.init_lm`); norm gains stay float32, since
norms compute in float32.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def compute_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# --- initializers -------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], fan_in: int, fan_out: int,
               scale: float = 1.0, *, lead=(), device=None, dtype=torch.float32):
    """N(0, (scale / sqrt(fan_in))^2) weights, (*lead, fan_in, fan_out)."""
    std = scale / np.sqrt(fan_in)
    w = torch.randn((*lead, fan_in, fan_out), generator=gen, device=device)
    # scaled in place: a full-width expert stack is 15-21 GB in f32
    return w.mul_(std).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, dim: int, *,
               device=None, dtype=torch.float32):
    w = torch.randn((vocab, dim), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# --- norms --------------------------------------------------------------------------

def norm_init(dim: int, kind: str = "rmsnorm", *, lead=(), device=None):
    p = {"scale": torch.ones((*lead, dim), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, dim), dtype=torch.float32, device=device)
    return p


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-5):
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# --- rotary embeddings --------------------------------------------------------------

def rotary_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rotary_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """`rotary_freqs` as a tensor on `device`, copied there once: a copy
    from pageable host memory per call would wait for the device each time."""
    return torch.from_numpy(rotary_freqs(head_dim, theta)).to(device)


def apply_rotary(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Computed in
    float32 and cast back, as the JAX package does."""
    hd = x.shape[-1]
    inv = _rotary_freqs_on(hd, float(theta), x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * inv  # (..., s, hd/2)
    sin, cos = torch.sin(ang)[..., :, None, :], torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- activations --------------------------------------------------------------------

def _gelu_tanh(x):
    return torch.nn.functional.gelu(x, approximate="tanh")  # jax.nn.gelu's default


_ACTIVATIONS = {
    "gelu": _gelu_tanh,
    "silu": torch.nn.functional.silu,
    "relu2": lambda x: torch.square(torch.relu(x)),  # nemotron-4 squared ReLU
}


def activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; valid: {sorted(_ACTIVATIONS)}"
        ) from None

