"""Quantized dynamics models."""

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    Unicycle,
    pack_controls,
    unpack_controls,
)

__all__ = ["CONTROL_LAYOUT", "Unicycle", "pack_controls", "unpack_controls"]
