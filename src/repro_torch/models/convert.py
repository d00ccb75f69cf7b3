"""Bridge from the JAX package's params to the port's.

`params_from_jax` takes the JAX param pytree as nested dicts of numpy arrays
(`jax.tree.map(np.asarray, params)`) and returns the port's params: the
same keys and shapes (stacked `seg{i}` leaves keep their leading layer
axis), GEMM weights and the embedding cast ONCE to the compute dtype, norm
gains kept in float32.  The JAX package casts its float32 masters at every
call; float32 -> bfloat16 round-to-nearest-even gives the same values
either way, and gigabytes of weights are not recast every step.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from .lm import init_lm


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


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
        arr = np.asarray(leaves.pop(path))
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"params_from_jax: {path} has shape {arr.shape}, "
                             f"the port expects {tuple(want.shape)}")
        with warnings.catch_warnings():
            # JAX hands out read-only buffers; .to() below copies, never writes
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.from_numpy(arr)
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t.to(device=device, dtype=want.dtype)
    if leaves:
        raise ValueError(f"params_from_jax: leaves the port does not consume: {sorted(leaves)}")
    return out
