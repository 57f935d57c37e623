"""``ConstrainedRTIService`` over ``DeviceConstrainedSQP``: real-time
iterations under hard per-step state bounds ``lo <= F x_k <= hi``.

One SQP iteration of ``alm_outer`` x ``pgd_iters`` fixed-point ALM steps a
tick; the warm state is the packed plan and the int32 multipliers.  The
tick should launch the port's K3 (``lipq``), K6 (power iteration and int8
quantization of the constraint rows, ``pen``) and K5 (the ALM inner,
``alm``) once each."""

from __future__ import annotations

import numpy as np

from portbench.kinds import rti
from portbench.reference import crti as ref

RECORD_IN = {"words": "u_words", "lam": "lam"}
LAUNCHES = {"lipq": 1, "pen": 1, "alm": 1}


def build(config: dict, batch: int, device):
    from pint_tpu_torch import ConstrainedRTIService, DeviceConstrainedSQP

    c = config["constraints"]
    csqp = DeviceConstrainedSQP(
        rti._sqp(config, device), F=np.asarray(c["F"]), lo=c["lo"], hi=c["hi"],
        rho=c["rho"], alm_outer=c["alm_outer"], row_pad=c["row_pad"])
    return ConstrainedRTIService(csqp, batch=batch)


def solver(service):
    return service.csqp


def record_out(result) -> dict:
    return {"words": result[0], "lam": result[1]}


def work(config: dict, batch: int) -> list:
    s, c = config["solver"], config["constraints"]
    T = s["horizon"]
    Tm, C = 2 * T, len(c["F"]) * T
    Cp = -(-C // c["row_pad"]) * c["row_pad"]
    return [("lipq", dict(B=batch, Tm=Tm, power_iters=s["power_iters"])),
            ("pen", dict(B=batch, C=C, Tm=Tm, power_iters=s["power_iters"])),
            ("alm", dict(B=batch, Tp=Tm, Cp=Cp, outer=c["alm_outer"],
                         inners=s["pgd_iters"]))]


class Reference(rti.Reference):
    """:func:`portbench.reference.crti.crti_step` and its shift."""

    def __init__(self, config: dict, device):
        if config["solver"]["sqp_iters"] != 1:
            raise ValueError("the reference runs one SQP iteration a tick")
        self.pr = ref.ConstrainedProblem(
            {**config["model"], **config["solver"], **config["constraints"]}, device)
        self.device = self.pr.device
        self.m = self.pr.m
        self.lane_scales = self.pr.lane_scales

    def zeros(self, n: int) -> dict:
        z = super().zeros(n)
        z["lam"] = z["words"].new_zeros((n, self.pr.Cp))
        return z

    def step(self, x0, ins: dict) -> dict:
        words, lam = ref.crti_step(self.pr, x0, ins["words"], ins["lam"])
        return {"words": words, "lam": lam}

    def shift(self, outs: dict) -> dict:
        return {"words": ref.shift_plan(outs["words"], self.m),
                "lam": ref.shift_lam(self.pr, outs["lam"])}
