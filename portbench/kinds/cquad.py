"""``ConstrainedRTIService`` over ``DeviceConstrainedSQP`` on the planar
quadrotor: real-time iterations under hard per-step state bounds
``lo <= F x_k <= hi`` for a fleet of six-state birotors.

The tick of :mod:`portbench.kinds.crti` on another model: one SQP
iteration of ``alm_outer`` x ``pgd_iters`` fixed-point ALM steps a tick;
the warm state is the packed plan and the int32 multipliers; the tick
should launch K3 (``lipq``), K6 (``pen``) and K5 (``alm``) once each."""

from __future__ import annotations

import numpy as np

from portbench.kinds import crti
from portbench.reference import cquad as ref

RECORD_IN = crti.RECORD_IN
LAUNCHES = {"lipq": 1, "pen": 1, "alm": 1}
solver = crti.solver
record_out = crti.record_out
work = crti.work


def build(config: dict, batch: int, device):
    from pint_tpu_torch import (ConstrainedRTIService, DeviceConstrainedSQP, DeviceSQP,
                                PlanarQuadrotor)

    m, s, c = config["model"], config["solver"], config["constraints"]
    model = PlanarQuadrotor(dt_shift=m["dt_shift"], frac_bits=m["frac_bits"],
                            f_shift=m["f_shift"], torque_shift=m["torque_shift"])
    sqp = DeviceSQP(
        model=model, horizon=s["horizon"], Q=np.diag(s["Q_diag"]), R=np.diag(s["R_diag"]),
        qf_scale=s["qf_scale"], x_ref=np.asarray(s["x_ref"]), sqp_iters=s["sqp_iters"],
        pgd_iters=s["pgd_iters"], g_shift=s["g_shift"], power_iters=s["power_iters"],
        device=device)
    csqp = DeviceConstrainedSQP(
        sqp, F=np.asarray(c["F"]), lo=c["lo"], hi=c["hi"], rho=c["rho"],
        alm_outer=c["alm_outer"], row_pad=c["row_pad"])
    return ConstrainedRTIService(csqp, batch=batch)


class Reference(crti.Reference):
    """:func:`portbench.reference.cquad.cquad_step` and its shift."""

    def __init__(self, config: dict, device):
        if config["solver"]["sqp_iters"] != 1:
            raise ValueError("the reference runs one SQP iteration a tick")
        self.pr = ref.QuadProblem(
            {**config["model"], **config["solver"], **config["constraints"]}, device)
        self.device = self.pr.device
        self.m = self.pr.m
        self.lane_scales = self.pr.lane_scales

    def step(self, x0, ins: dict) -> dict:
        words, lam = ref.cquad_step(self.pr, x0, ins["words"], ins["lam"])
        return {"words": words, "lam": lam}


