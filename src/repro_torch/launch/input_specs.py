"""Meta-tensor stand-ins for every input of a step (the JAX package's
`launch/input_specs.py`): shapes and dtypes, nothing allocated.  This is
what the dry run (`launch/dryrun.py`) traces.

JAX's structs are whole arrays that its partitioner places by the spec
trees; the port's are one rank's blocks under a `Plan` (`Plan.shard` on
the meta device, KV blocks replicated over `model` included), since the
port's step takes a rank's blocks.  Without a plan they are the whole
leaves.  Batches are the global batch, as the train step takes it (it
keeps its rows, `Plan.batch_rows`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..models import init_caches, init_lm
from ..models.layers import compute_dtype
from ..optim.adamw import init_opt, tree_map
from ..parallel import sharding as sh

META = torch.device("meta")


def param_structs(cfg: ModelConfig, dtype=None, plan: Optional[sh.Plan] = None) -> Any:
    """Parameters (f32 masters, or `dtype`), this rank's blocks under `plan`."""
    params = init_lm(None, cfg, device=META, dtype=torch.float32)
    if dtype is not None:
        params = tree_map(lambda t: t.to(dtype), params)
    return params if plan is None else plan.shard(params)


def opt_structs(cfg: ModelConfig, tc: TrainConfig, plan: Optional[sh.Plan] = None) -> Any:
    """The optimizer state of `param_structs` (adamw or adamw8bit)."""
    return init_opt(param_structs(cfg, plan=plan), tc)


def cache_structs(cfg: ModelConfig, batch: int, s_max: int,
                  plan: Optional[sh.Plan] = None) -> Any:
    """Decode caches of `batch` rows and depth s_max: this rank's KV heads
    under `plan`."""
    with sh.use(plan):
        return init_caches(cfg, batch, s_max, compute_dtype(cfg.dtype), META)


def batch_shapes(cfg: ModelConfig, shape: ShapeConfig, rows: Optional[int] = None) -> Dict:
    """A train or prefill batch of `rows` (default the global batch): tokens
    and labels; a VLM's patch_embeds (the tokens shortened by the patches),
    an encoder-decoder's encoder_frames, both bf16 as JAX's structs."""
    b, s = rows or shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=META)}
    if cfg.family == "vlm" and cfg.num_patches:
        out["tokens"] = torch.empty((b, s - cfg.num_patches), dtype=torch.int32, device=META)
        out["patch_embeds"] = torch.empty((b, cfg.num_patches, cfg.d_model),
                                          dtype=torch.bfloat16, device=META)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                            dtype=torch.bfloat16, device=META)
    out["labels"] = out["tokens"]
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig, plan: Optional[sh.Plan] = None,
                rows: Optional[int] = None) -> Dict[str, Any]:
    """Model inputs for one cell: train / prefill get the batch (`rows`,
    default the global batch); decode gets (token, caches, index) for
    `rows` rows (default the global batch) with caches as deep as the
    sequence."""
    if shape.mode in ("train", "prefill"):
        return batch_shapes(cfg, shape, rows)
    b = rows or shape.global_batch
    return {"token": torch.empty((b, 1), dtype=torch.int32, device=META),
            "caches": cache_structs(cfg, b, shape.seq_len, plan),
            "index": shape.seq_len - 1}


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (dicts, lists, tuples, OptState)."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
