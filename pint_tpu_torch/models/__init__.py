"""Quantized dynamics models."""

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    DoubleIntegrator,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.models.pendulum import Pendulum
from pint_tpu_torch.models.quadrotor import PlanarQuadrotor

__all__ = ["CONTROL_LAYOUT", "DoubleIntegrator", "Pendulum", "PlanarQuadrotor",
           "Unicycle", "pack_controls", "unpack_controls"]
