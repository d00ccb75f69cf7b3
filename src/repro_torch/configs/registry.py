"""Architecture registry: full configs + reduced smoke configs per arch.

Full configs are exercised ONLY via the dry-run (ShapeDtypeStruct lowering);
smoke configs instantiate real parameters on CPU in tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from .base import ModelConfig

_ARCHS = [
    "zamba2_2p7b", "qwen1p5_4b", "nemotron4_340b", "internlm2_1p8b",
    "command_r_plus_104b", "deepseek_v3_671b", "llama4_maverick",
    "internvl2_76b", "whisper_small", "mamba2_780m",
    # paper case-study configs (not part of the 40-cell table)
    "gpt3_2p7b",
]

_REGISTRY: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    # Smoke configs are deliberately tiny (and sometimes deliberately
    # misaligned); never let their shape findings gate CI.
    if smoke.production:
        smoke = dataclasses.replace(smoke, production=False)
    _SMOKE[cfg.name] = smoke
    return cfg


def _load_all():
    if _REGISTRY:
        return
    for m in _ARCHS:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    _load_all()
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise ValueError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}") from e


def get_smoke_config(name: str) -> ModelConfig:
    _load_all()
    return _SMOKE[name]


def list_archs(assigned_only: bool = False):
    _load_all()
    names = sorted(_REGISTRY)
    if assigned_only:
        names = [n for n in names if not n.startswith("gpt3") and not n.startswith("pythia")]
    return names
