"""Bridge from the JAX package's params to the port's.

`params_from_jax` takes the JAX param pytree as nested dicts of numpy arrays
(`jax.tree.map(np.asarray, params)`) and returns the port's params: the
same keys and shapes (stacked `seg{i}` leaves keep their leading layer
axis), GEMM weights and the embedding cast ONCE to the compute dtype, norm
gains and the SSM's float32 leaves (conv kernels and biases, A_log, D,
dt_bias) kept in float32.  The JAX package casts its float32 masters at every
call; float32 -> bfloat16 round-to-nearest-even gives the same values
either way, and gigabytes of weights are not recast every step.

A GEMM weight may also arrive quantized, as JAX's `quantize_linear_params`
leaves it: a `repro.quant.QuantizedTensor` of numpy arrays (q int8, scale
f32, axis), recognised by its fields.  It becomes the port's
`QuantizedTensor`, payload and scales unchanged.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..quant import QuantizedTensor, k_major
from .linear import QUANT_WEIGHT_KEYS
from .lm import init_lm


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _tensor(arr) -> torch.Tensor:
    with warnings.catch_warnings():
        # JAX hands out read-only buffers; the copies made from them never write them
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.asarray(arr))


def _is_quantized(leaf) -> bool:
    return isinstance(leaf, tuple) and all(hasattr(leaf, f) for f in ("q", "scale", "axis"))


def _quantized(path: str, leaf, want, device) -> QuantizedTensor:
    """A JAX QuantizedTensor leaf where the port holds the float weight `want`;
    the payload is stored K-major (`quant.k_major`), as `quantize_weight`
    stores it."""
    if path.rsplit("/", 1)[-1] not in QUANT_WEIGHT_KEYS:
        raise ValueError(f"params_from_jax: {path} is quantized but is no GEMM weight")
    q, scale, axis = _tensor(leaf.q), _tensor(leaf.scale), int(np.asarray(leaf.axis))
    scale_shape = (*want.shape[:-2], 1, want.shape[-1])
    if q.dtype != torch.int8 or tuple(q.shape) != tuple(want.shape) or axis != -2 \
            or tuple(scale.shape) != scale_shape:
        raise ValueError(f"params_from_jax: {path} is quantized as {q.dtype} {tuple(q.shape)} "
                         f"with scales {tuple(scale.shape)} over axis {axis}; the port expects "
                         f"int8 {tuple(want.shape)} with scales {scale_shape} over axis -2")
    return QuantizedTensor(k_major(q.to(device, copy=True)),
                           scale.to(device=device, dtype=torch.float32, copy=True), axis)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Convert; raises on a missing leaf, a shape mismatch, or any leaf of
    `tree` the port's layout does not consume."""
    template = init_lm(None, cfg, device="meta", dtype=dtype)
    leaves = dict(_walk(tree))
    out: Dict[str, Any] = {}
    for path, want in _walk(template):
        if path not in leaves:
            raise KeyError(f"params_from_jax: missing leaf {path!r}")
        leaf = leaves.pop(path)
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        if _is_quantized(leaf):
            node[name] = _quantized(path, leaf, want, device)
            continue
        t = _tensor(leaf)
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"params_from_jax: {path} has shape {tuple(t.shape)}, "
                             f"the port expects {tuple(want.shape)}")
        # always a copy: a float32 leaf on the CPU would otherwise share the
        # JAX buffer, and the optimizer updates params in place
        node[name] = t.to(device=device, dtype=want.dtype, copy=True)
    if leaves:
        raise ValueError(f"params_from_jax: leaves the port does not consume: {sorted(leaves)}")
    return out
