"""Checkpoint save / restore on the JAX package's on-disk layout (`ckpt.py`)."""
from .ckpt import Checkpointer

__all__ = ["Checkpointer"]
