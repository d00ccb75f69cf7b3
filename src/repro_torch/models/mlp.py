"""MLP variants: standard 2-matrix (gelu / squared-ReLU) and SwiGLU (3-matrix)."""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .layers import activation, dense_init
from .linear import fused_mlp, linear, quantized_mlp


def init_mlp(gen: Optional[torch.Generator], cfg: ModelConfig, d_ff: int | None = None,
             *, lead=(), device=None, dtype=torch.float32):
    h = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    out_scale = 1.0 / (2 * cfg.num_layers) ** 0.5
    kw = dict(lead=lead, device=device, dtype=dtype)
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, h, f, **kw),
            "w_up": dense_init(gen, h, f, **kw),
            "w_down": dense_init(gen, f, h, scale=out_scale, **kw),
        }
    return {
        "w_up": dense_init(gen, h, f, **kw),
        "w_down": dense_init(gen, f, h, scale=out_scale, **kw),
    }


def apply_mlp(p, x, cfg: ModelConfig):
    impl = cfg.linear_impl
    if impl == "fused":
        # gate+up GEMM pair and the silu*mul combine run as ONE kernel
        # (kernels/fused_mlp); the down GEMM runs the tile GEMM
        return fused_mlp(x, p, cfg)
    if impl == "quantized":
        # int8-weight fused hidden + quantized down projection
        return quantized_mlp(x, p, cfg)
    if cfg.mlp_type == "swiglu":
        g = torch.nn.functional.silu(linear(x, p["w_gate"], impl=impl))
        u = linear(x, p["w_up"], impl=impl)
        return linear(g * u, p["w_down"], impl=impl)
    act = activation("relu2" if cfg.mlp_type == "relu2" else "gelu")
    u = act(linear(x, p["w_up"], impl=impl))
    return linear(u, p["w_down"], impl=impl)
