from .lm import apply_lm, init_caches, init_lm

__all__ = ["apply_lm", "init_caches", "init_lm"]
