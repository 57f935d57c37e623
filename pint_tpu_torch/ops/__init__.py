"""SWAR word formulas and the kernel build/launch gate."""

from pint_tpu_torch.ops import kernels, word

__all__ = ["kernels", "word"]
