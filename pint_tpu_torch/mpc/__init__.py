"""Fixed-point MPC: condensation, PGD solvers and the on-device SQP."""

from pint_tpu_torch.mpc.condense_fused import lipq_fused, lipq_plain
from pint_tpu_torch.mpc.condensed import (
    CondensedQP,
    QuantizedQP,
    condense_double_integrator,
    condense_lti,
    quantize,
)
from pint_tpu_torch.mpc.device_sqp import DeviceSQP
from pint_tpu_torch.mpc.fused import FusedPGD, fused_pgd, fused_pgd_plain
from pint_tpu_torch.mpc.fused_alm import (
    pgd_fused_words,
    pgd_fused_words_pre,
    pgd_hqt,
    pgd_hqt_plain,
)
from pint_tpu_torch.mpc.solver import FixedPointPGD

__all__ = [
    "CondensedQP",
    "DeviceSQP",
    "FixedPointPGD",
    "FusedPGD",
    "QuantizedQP",
    "condense_double_integrator",
    "condense_lti",
    "fused_pgd",
    "fused_pgd_plain",
    "lipq_fused",
    "lipq_plain",
    "pgd_fused_words",
    "pgd_fused_words_pre",
    "pgd_hqt",
    "pgd_hqt_plain",
    "quantize",
]
