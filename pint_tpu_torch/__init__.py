"""pint_tpu_torch: the PyTorch and CUDA port of pint_tpu, for an NVIDIA H100.

The JAX package ``pint_tpu`` stays beside it as the reference.  This package
imports torch and numpy and never jax (nor ``pint_tpu``).  Ported so far:
the SWAR substrate (``PackedArray`` and its free functions, 8- to 64-bit
words, runtime shifts), the unicycle model, the LTI box-QP PGD solvers, the
on-device SQP (default path) and the two serving endpoints, with
hand-written CUDA kernels for the SWAR binops, shifts and saturating
accumulate (K1, K9, K8, K11a-c), FusedPGD (K2), lipq (K3) and the
per-problem PGD inner (K4).  ROADMAP.md lists what is still to port.
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
from pint_tpu_torch.packed import (
    PackedArray,
    add_signed_saturate,
    add_unsigned_saturate,
    add_wrap,
    get,
    get_signed,
    max_signed,
    max_unsigned,
    min_signed,
    min_unsigned,
    shift_left,
    shift_right_unsigned,
    slice_lanes,
    sub_signed_saturate,
    sub_unsigned_saturate,
    sub_wrap,
)
from pint_tpu_torch.serving import MPCService, RTIService, ServiceStats

__all__ = [
    "PackedLayout",
    "PackedArray",
    "word_bits_for",
    "get",
    "get_signed",
    "add_wrap",
    "add_unsigned_saturate",
    "add_signed_saturate",
    "sub_wrap",
    "sub_unsigned_saturate",
    "sub_signed_saturate",
    "min_unsigned",
    "max_unsigned",
    "min_signed",
    "max_signed",
    "shift_left",
    "shift_right_unsigned",
    "slice_lanes",
    "CONTROL_LAYOUT",
    "CondensedQP",
    "DeviceSQP",
    "FixedPointPGD",
    "FusedPGD",
    "MPCService",
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
]
