"""PyTorch + CUDA port of the `repro` co-design system.

Mirrors the JAX package's layout module for module (`repro.models.lm` ->
`repro_torch.models.lm`, ...).  Imports torch and numpy only: never jax and
nothing of `repro`.  Every kernel the JAX package wrote in Pallas for the
TPU is a hand-written CUDA C++ kernel for Hopper (`kernels/csrc`), built on
first use; on CPU tensors each kernel wrapper runs its plain PyTorch
version instead.
"""
