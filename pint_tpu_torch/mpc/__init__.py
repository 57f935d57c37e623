"""Fixed-point MPC: condensation, PGD solvers, the host and on-device SQP
tiers, the closed-loop controllers and the sampling and gradient planners
(the trajectory costs live in :mod:`pint_tpu_torch.mpc.costs`)."""

from pint_tpu_torch.mpc.accelerated import AcceleratedPGD
from pint_tpu_torch.mpc.condense_fused import (
    lipq_fits,
    lipq_fused,
    lipq_plain,
    pen_fits,
    pen_fused,
    pen_plain,
)
from pint_tpu_torch.mpc.condensed import (
    CondensedQP,
    QuantizedQP,
    condense_double_integrator,
    condense_lti,
    condense_ltv,
    condense_ltv_batch,
    dare_terminal,
    quantize,
)
from pint_tpu_torch.mpc.constrained import (
    ConstrainedController,
    ConstrainedPGD,
    QuantizedConstrainedQP,
    StateConstrainedQP,
    constrain_states,
    quantize_constrained,
)
from pint_tpu_torch.mpc.controller import LTIController, RecedingHorizonController
from pint_tpu_torch.mpc.device_constrained import DeviceConstrainedSQP
from pint_tpu_torch.mpc.device_sqp import DeviceSQP
from pint_tpu_torch.mpc.fused import (
    FusedPGD,
    fused_pgd,
    fused_pgd_packed,
    fused_pgd_packed_plain,
    fused_pgd_plain,
)
from pint_tpu_torch.mpc.fused_alm import (
    alm_fits,
    alm_fused_words,
    alm_fused_words_pre,
    alm_hqt,
    alm_hqt_plain,
    alm_shared,
    alm_shared_fused_words,
    alm_shared_plain,
    pgd_fits,
    pgd_fused_words,
    pgd_fused_words_pre,
    pgd_fused_words_pre_plain,
    pgd_hqt,
    pgd_hqt_plain,
    pgd_matvec_cols,
    pgd_matvec_cols_plain,
)
from pint_tpu_torch.mpc.ltv import QuantizedSQP, SQPController, quantize_batch
from pint_tpu_torch.mpc.mppi import QuantizedMPPI, unicycle_goal_cost
from pint_tpu_torch.mpc.nonlinear import QuantizedNonlinearPGD
from pint_tpu_torch.mpc.solver import FixedPointPGD
from pint_tpu_torch.mpc.sqp_constrained import ConstrainedSQP

__all__ = [
    "AcceleratedPGD",
    "CondensedQP",
    "ConstrainedController",
    "ConstrainedPGD",
    "ConstrainedSQP",
    "DeviceConstrainedSQP",
    "DeviceSQP",
    "FixedPointPGD",
    "FusedPGD",
    "LTIController",
    "QuantizedConstrainedQP",
    "QuantizedMPPI",
    "QuantizedNonlinearPGD",
    "QuantizedQP",
    "QuantizedSQP",
    "RecedingHorizonController",
    "SQPController",
    "StateConstrainedQP",
    "alm_fits",
    "alm_fused_words",
    "alm_fused_words_pre",
    "alm_hqt",
    "alm_hqt_plain",
    "alm_shared",
    "alm_shared_fused_words",
    "alm_shared_plain",
    "condense_double_integrator",
    "condense_lti",
    "condense_ltv",
    "condense_ltv_batch",
    "constrain_states",
    "dare_terminal",
    "fused_pgd",
    "fused_pgd_packed",
    "fused_pgd_packed_plain",
    "fused_pgd_plain",
    "lipq_fits",
    "lipq_fused",
    "lipq_plain",
    "pen_fits",
    "pen_fused",
    "pen_plain",
    "pgd_fits",
    "pgd_fused_words",
    "pgd_fused_words_pre",
    "pgd_fused_words_pre_plain",
    "pgd_hqt",
    "pgd_hqt_plain",
    "pgd_matvec_cols",
    "pgd_matvec_cols_plain",
    "quantize",
    "quantize_batch",
    "quantize_constrained",
    "unicycle_goal_cost",
]
