"""Persistent tuning cache: measured-best kernel configs, keyed by
(op, shape, dtype, hw_name) (a copy of the JAX package's `tuning/cache.py`:
the same JSON, keys and defaults, so one file holds TPU and H100 entries
side by side under their `hw_name`s and either package reads the other's).

The cache is a plain JSON file (documented in docs/codesign-guide.md) so it
can be committed, diffed, and shipped with a deployment:

    {
      "version": 1,
      "entries": {
        "matmul/512x512x512/bfloat16/tpu_v5e": {
          "op": "matmul", "shape": [512, 512, 512], "dtype": "bfloat16",
          "hw_name": "tpu_v5e", "blocks": {"block_m": 512, ...},
          "time_us": 812.4, "baseline_us": 1034.9, "candidates_tried": 12
        }, ...
      }
    }

`kernels/*/ops.py` consult the *default* cache (module-level, loaded lazily
from $REPRO_TUNING_CACHE or ./tuning_cache.json) when called with
`tuned=True`; `core.gemm_model.MeasuredProfile` reads the same entries to
calibrate the analytic cost model.

The port's `blocks` are its kernels' own launch knobs (`tuning/search.py`):
`block_m`, `block_n`, `split_k` (the number of k splits) for the GEMMs,
`block_m`, `block_f` for the fused MLPs, `tile`, `splits` for paged decode
and `block_size`, `tile`, `splits` for the block-table pool entry.

`lookup` is what the kernel wrappers call on every tuned launch (~170 a
decode step on the serving path, which the host paces), so it memoizes its
answers, hits and misses, by (op, shape, dtype, hw_name): after the first
call of a shape a lookup is one dict read.  `set_default_cache`,
`get_default_cache(reload=True)` and any `put` clear the memo.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional, Tuple

CACHE_VERSION = 1
ENV_VAR = "REPRO_TUNING_CACHE"
DEFAULT_FILENAME = "tuning_cache.json"


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One measured-best kernel configuration."""

    op: str                    # "matmul" | "flash_attention_causal" | ...
    shape: Tuple[int, ...]     # op-specific problem shape
    dtype: str                 # dtype name (`dtype_name`), e.g. "bfloat16"
    hw_name: str               # core.hardware name the timing was taken on
    blocks: Dict[str, int]     # kernel kwargs, e.g. {"block_m": 512, ...}
    time_us: float             # best measured wall time per call
    baseline_us: float = 0.0   # measured time of the default (the rule's pick)
    candidates_tried: int = 0
    time_us_std: float = 0.0   # per-iteration std of the winner's timing

    @property
    def speedup_vs_default(self) -> float:
        if self.baseline_us <= 0 or self.time_us <= 0:
            return 1.0
        return self.baseline_us / self.time_us

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TunedConfig":
        return cls(op=d["op"], shape=tuple(d["shape"]), dtype=d["dtype"],
                   hw_name=d["hw_name"],
                   blocks={k: int(v) for k, v in d["blocks"].items()},
                   time_us=float(d["time_us"]),
                   baseline_us=float(d.get("baseline_us", 0.0)),
                   candidates_tried=int(d.get("candidates_tried", 0)),
                   time_us_std=float(d.get("time_us_std", 0.0)))


def cache_key(op: str, shape: Iterable[int], dtype: str, hw_name: str) -> str:
    return f"{op}/{'x'.join(str(int(s)) for s in shape)}/{dtype}/{hw_name}"


# torch dtype -> the JAX package's dtype name (the cache's dtype key)
DTYPE_NAMES = ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn", "float8_e5m2")
_DTYPE_NAME: Dict[object, str] = {}


def dtype_name(dtype) -> str:
    """The cache's name of a torch dtype: JAX's `jnp.dtype(...).name`."""
    name = _DTYPE_NAME.get(dtype)
    if name is None:
        name = str(dtype).removeprefix("torch.")
        if name not in DTYPE_NAMES:
            raise ValueError(f"no tuning-cache name for dtype {dtype}; have {DTYPE_NAMES}")
        _DTYPE_NAME[dtype] = name
    return name


def mixed_dtype(act_dtype: str, weight_dtype: str) -> str:
    """Cache dtype key for mixed-precision ops: encodes *both* operand
    dtypes (e.g. ``bfloat16xint8``) so an int8-weight entry can never
    shadow — or be shadowed by — a uniform-dtype entry for the same shape.
    Uniform ops keep the plain single-dtype key unchanged."""
    if act_dtype == weight_dtype:
        return act_dtype
    return f"{act_dtype}x{weight_dtype}"


class TuningCache:
    """In-memory view of the JSON tuning cache."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, TunedConfig] = {}

    # -- persistence ---------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "TuningCache":
        """Load from `path`; a missing file yields an empty cache bound to
        that path (so the first save() creates it)."""
        cache = cls(path)
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            if raw.get("version", 1) != CACHE_VERSION:
                raise ValueError(
                    f"tuning cache {path}: version {raw.get('version')} "
                    f"unsupported (expected {CACHE_VERSION})")
            for key, d in raw.get("entries", {}).items():
                cache.entries[key] = TunedConfig.from_json(d)
        return cache

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("TuningCache.save: no path given or bound")
        payload = {
            "version": CACHE_VERSION,
            "entries": {k: v.to_json() for k, v in sorted(self.entries.items())},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path

    # -- access --------------------------------------------------------------
    def get(self, op: str, shape: Iterable[int], dtype: str,
            hw_name: str) -> Optional[TunedConfig]:
        return self.entries.get(cache_key(op, shape, dtype, hw_name))

    def put(self, cfg: TunedConfig) -> None:
        self.entries[cache_key(cfg.op, cfg.shape, cfg.dtype, cfg.hw_name)] = cfg
        _memo.clear()

    def by_op(self, op: str, hw_name: Optional[str] = None) -> list:
        return [c for c in self.entries.values()
                if c.op == op and (hw_name is None or c.hw_name == hw_name)]

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries.values())


# -- default cache (what `tuned=True` kernel calls consult) -------------------
_default_cache: Optional[TuningCache] = None
# (op, shape, dtype, hw_name) -> the default cache's entry, or None
_memo: Dict[Tuple, Optional[TunedConfig]] = {}


def default_cache_path() -> str:
    return os.environ.get(ENV_VAR, DEFAULT_FILENAME)


def get_default_cache(reload: bool = False) -> TuningCache:
    global _default_cache
    if _default_cache is None or reload:
        _default_cache = TuningCache.load(default_cache_path())
        _memo.clear()
    return _default_cache


def set_default_cache(cache: "TuningCache | str | None") -> None:
    """Install `cache` (a TuningCache, a path to load, or None to reset) as
    the process-wide cache that `tuned=True` kernel calls consult."""
    global _default_cache
    if isinstance(cache, str):
        cache = TuningCache.load(cache)
    _default_cache = cache
    _memo.clear()


def lookup(op: str, shape: Iterable[int], dtype: str,
           hw_name: str) -> Optional[TunedConfig]:
    """Default-cache lookup used by kernels/*/ops.py `tuned=True` paths
    (`shape` a tuple of ints: it keys the memo)."""
    key = (op, shape, dtype, hw_name)
    try:
        return _memo[key]
    except KeyError:
        cfg = _memo[key] = get_default_cache().get(op, shape, dtype, hw_name)
        return cfg
