"""Kernel autotuning: measured launch-geometry search + persistent tuning
cache (the JAX package's `tuning`, ported; the same names where the port
has the piece).

    candidates.py  the launch geometries the CUDA library instantiates
    measure.py     the timer (CUDA events on the card, perf_counter on the host)
    search.py      sweep + time candidates on the card, persist winners
    cache.py       JSON cache keyed by (op, shape, dtype, hw_name)

Kernel wrappers (`kernels/*/ops.py`) consult the default cache when called
with `tuned=True`; `core.gemm_model.MeasuredProfile` turns the same cache
into a calibration layer for `core.advisor` predictions.  Flash attention's
search (`autotune_flash_attention`, `autotune_flash_backward`) is not
ported: its kernels take no geometry yet.

`search` is imported lazily (PEP 562) because it imports the kernel
wrappers, which themselves import `tuning.cache` — eager import would cycle.
"""
from .cache import (TunedConfig, TuningCache, cache_key, default_cache_path, dtype_name,
                    get_default_cache, lookup, mixed_dtype, set_default_cache)
from .candidates import (bucket_steps, fp8_matmul_candidates, fused_mlp_candidates,
                         int8_fused_mlp_candidates, int8_matmul_candidates, matmul_candidates,
                         paged_blocktable_candidates, paged_decode_candidates)
from .measure import time_ms, wall_us

_SEARCH_EXPORTS = ("autotune_matmul", "autotune_fused_mlp",
                   "autotune_int8_matmul", "autotune_fp8_matmul",
                   "autotune_int8_fused_mlp",
                   "autotune_paged_decode",
                   "autotune_paged_decode_blocktable")

__all__ = [
    "TunedConfig", "TuningCache", "cache_key", "default_cache_path", "dtype_name",
    "get_default_cache", "lookup", "mixed_dtype", "set_default_cache",
    "bucket_steps", "fp8_matmul_candidates", "fused_mlp_candidates",
    "int8_fused_mlp_candidates", "int8_matmul_candidates", "matmul_candidates",
    "paged_blocktable_candidates", "paged_decode_candidates",
    "time_ms", "wall_us", *_SEARCH_EXPORTS,
]


def __getattr__(name):
    if name in _SEARCH_EXPORTS:
        from . import search
        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
