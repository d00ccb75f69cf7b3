"""Deterministic synthetic LM data (pure numpy, copied from the JAX
package's `data/pipeline.py`, so both packages draw identical streams).

Stateless: batch(step) is a pure function of (seed, step, shape), and each
process materializes only its slice of the global batch, with the
deterministic VLM patch-embedding and audio-frame stubs where the
architecture needs them."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


def _keys(seed: int, step: int, rows: int, row0: int = 0) -> np.ndarray:
    """Per-row deterministic RNG keys (uint64 wraparound is intended).
    row0 offsets the GLOBAL row index so host shards tile the global batch."""
    with np.errstate(over="ignore"):
        return ((np.uint64(row0) + np.arange(rows, dtype=np.uint64))
                * np.uint64(0xD1B54A32D192ED03)
                + np.uint64(step) * np.uint64(0x9E3779B97F4A7C15)
                + np.uint64(seed) * np.uint64(0xBF58476D1CE4E5B9))


def _xorshift(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(12))
    x = x ^ (x << np.uint64(25))
    x = x ^ (x >> np.uint64(27))
    return x * np.uint64(0x2545F4914F6CDD1D)


def synthetic_tokens(seed: int, step: int, batch: int, seq: int,
                     vocab: int, row0: int = 0) -> np.ndarray:
    """(batch, seq) int32 tokens, Zipf-flavored, deterministic in
    (seed, step, global row index)."""
    state = _keys(seed, step, batch, row0)[:, None] + np.arange(seq, dtype=np.uint64)[None, :]
    r = _xorshift(state)
    u = (r >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    # Zipf-ish marginal via inverse power transform
    toks = np.floor((vocab - 1) * np.power(u, 3.0)).astype(np.int32)
    return toks


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               seed: int = 1234, process_index: int = 0,
               process_count: int = 1) -> Dict[str, np.ndarray]:
    """The (host-local slice of the) training batch for `step`: tokens and
    labels, (rows, seq_len) int32.  A VLM's batch adds "patch_embeds" (rows,
    num_patches, d_model) f32 and shortens the tokens to seq_len -
    num_patches, so the stream stays seq_len long; an encoder-decoder's adds
    "encoder_frames" (rows, encoder_seq, d_model) f32."""
    gb = shape.global_batch
    assert gb % process_count == 0, "global batch must divide hosts"
    local = gb // process_count
    row0 = process_index * local
    toks = synthetic_tokens(seed, step, local, shape.seq_len, cfg.vocab_size, row0=row0)
    batch: Dict[str, np.ndarray] = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm" and cfg.num_patches:
        r = _xorshift(_keys(seed + 7, step, local, row0))[:, None, None]
        grid = (np.arange(cfg.num_patches)[None, :, None]
                + np.arange(cfg.d_model)[None, None, :])
        batch["patch_embeds"] = (np.sin(0.01 * (grid + (r % 1000).astype(np.int64)))
                                 ).astype(np.float32)
        batch["tokens"] = toks[:, : shape.seq_len - cfg.num_patches]
        batch["labels"] = batch["tokens"]
    if cfg.is_encoder_decoder:
        r = _xorshift(_keys(seed + 13, step, local, row0))[:, None, None]
        grid = (np.arange(cfg.encoder_seq)[None, :, None]
                + np.arange(cfg.d_model)[None, None, :])
        batch["encoder_frames"] = (np.sin(0.02 * (grid + (r % 997).astype(np.int64)))
                                   ).astype(np.float32)
    return batch
