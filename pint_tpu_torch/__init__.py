"""pint_tpu_torch: the PyTorch and CUDA port of pint_tpu, for an NVIDIA H100.

The JAX package ``pint_tpu`` stays beside it as the reference.  This package
imports torch and numpy and never jax (nor ``pint_tpu``).  Ported so far:
the SWAR word formulas, the unicycle model, the LTI box-QP PGD solvers, the
on-device SQP (default path) and the two serving endpoints, with
hand-written CUDA kernels for FusedPGD (K2), lipq (K3) and the per-problem
PGD inner (K4).  ROADMAP.md lists what is still to port.
"""

from pint_tpu_torch import convert
from pint_tpu_torch.layout import PackedLayout, word_bits_for
from pint_tpu_torch.models import CONTROL_LAYOUT, Unicycle, pack_controls, unpack_controls
from pint_tpu_torch.mpc import (
    CondensedQP,
    DeviceSQP,
    FixedPointPGD,
    FusedPGD,
    QuantizedQP,
    condense_double_integrator,
    condense_lti,
    quantize,
)
from pint_tpu_torch.serving import MPCService, RTIService, ServiceStats

__all__ = [
    "CONTROL_LAYOUT",
    "CondensedQP",
    "DeviceSQP",
    "FixedPointPGD",
    "FusedPGD",
    "MPCService",
    "PackedLayout",
    "QuantizedQP",
    "RTIService",
    "ServiceStats",
    "Unicycle",
    "condense_double_integrator",
    "condense_lti",
    "convert",
    "pack_controls",
    "quantize",
    "unpack_controls",
    "word_bits_for",
]
