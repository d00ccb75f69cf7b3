from .lm import apply_lm, init_caches, init_lm, lm_loss, softmax_xent

__all__ = ["apply_lm", "init_caches", "init_lm", "lm_loss", "softmax_xent"]
