"""pint_tpu_torch: the PyTorch and CUDA port of pint_tpu, for an NVIDIA H100.

The JAX package ``pint_tpu`` stays beside it as the reference.  This package
imports torch and numpy and never jax (nor ``pint_tpu``).  Ported so far:
the SWAR substrate (``PackedArray`` and its free functions, 8- to 64-bit
words, runtime shifts), the four models (double integrator, unicycle,
planar quadrotor, pendulum), the LTI box-QP PGD solvers and their
closed-loop controllers (``LTIController``, ``RecedingHorizonController``),
the host SQP tier (``QuantizedSQP``, ``SQPController``, ``ConstrainedSQP``),
the sampling and gradient planners (``QuantizedMPPI``,
``QuantizedNonlinearPGD``) with their costs, the on-device SQP with every
propagation and contraction form, the state-constrained tier (the LTI ``ConstrainedPGD`` and its closed loop
``ConstrainedController``, and the on-device ``DeviceConstrainedSQP``), the four
serving endpoints (``MPPIService`` serves the sampling planner) and the
multi-device tier (:mod:`pint_tpu_torch.parallel`:
a (dp, tp) process mesh under ``torch.distributed``, the sharded PGD and
ALM solvers, and the sharded SQP solves), with hand-written CUDA kernels
for the SWAR binops, shifts and saturating accumulate (K1, K9, K8,
K11a-c), FusedPGD with lane and packed-word I/O (K2, K2p), lipq (K3), the
per-problem PGD inner (K4), the per-problem and shared-operand ALM inners
(K5, K7), the penalty power iteration (K6) and the tp column matvec (K10),
checkpoints of words, solver state and sharded blocks
(:mod:`pint_tpu_torch.utils.checkpoint`, files the reference reads and
writes too) and the native host SWAR tier (:mod:`pint_tpu_torch.native`).
That is everything ``pint_tpu`` does; ROADMAP.md lists what was left out on
purpose (TPU and JAX plumbing).
"""

from pint_tpu_torch import convert, parallel
from pint_tpu_torch.layout import PackedLayout, word_bits_for
from pint_tpu_torch.models import (
    CONTROL_LAYOUT,
    DoubleIntegrator,
    Pendulum,
    PlanarQuadrotor,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.mpc import (
    CondensedQP,
    ConstrainedController,
    ConstrainedPGD,
    ConstrainedSQP,
    DeviceConstrainedSQP,
    DeviceSQP,
    FixedPointPGD,
    FusedPGD,
    LTIController,
    QuantizedMPPI,
    QuantizedNonlinearPGD,
    QuantizedQP,
    QuantizedSQP,
    RecedingHorizonController,
    SQPController,
    condense_double_integrator,
    condense_lti,
    condense_ltv,
    constrain_states,
    dare_terminal,
    quantize,
    quantize_constrained,
    unicycle_goal_cost,
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
from pint_tpu_torch.serving import (
    ConstrainedRTIService,
    MPCService,
    MPPIService,
    RTIService,
    ServiceStats,
)

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
    "ConstrainedController",
    "ConstrainedPGD",
    "ConstrainedSQP",
    "DoubleIntegrator",
    "Pendulum",
    "PlanarQuadrotor",
    "ConstrainedRTIService",
    "DeviceConstrainedSQP",
    "DeviceSQP",
    "FixedPointPGD",
    "FusedPGD",
    "LTIController",
    "MPCService",
    "MPPIService",
    "QuantizedMPPI",
    "QuantizedNonlinearPGD",
    "QuantizedQP",
    "QuantizedSQP",
    "RTIService",
    "RecedingHorizonController",
    "SQPController",
    "ServiceStats",
    "Unicycle",
    "condense_double_integrator",
    "condense_lti",
    "condense_ltv",
    "constrain_states",
    "convert",
    "dare_terminal",
    "parallel",
    "pack_controls",
    "quantize",
    "quantize_constrained",
    "unicycle_goal_cost",
    "unpack_controls",
]
