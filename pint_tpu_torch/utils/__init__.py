"""Utilities: CUDA-event timing, the per-lane oracle, roofline reporting."""

from pint_tpu_torch.utils.oracle import Oracle

__all__ = ["Oracle"]
