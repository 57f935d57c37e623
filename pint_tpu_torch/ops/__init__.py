"""SWAR word formulas, their kernels, and the kernel build/launch gate."""

from pint_tpu_torch.ops import kernels, split64, swar, word

__all__ = ["kernels", "split64", "swar", "word"]
