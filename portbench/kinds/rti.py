"""``RTIService`` over ``DeviceSQP``: nonlinear MPC by real-time iterations.

One SQP iteration of ``pgd_iters`` fixed-point PGD steps a tick; the warm
state is the packed int8 plan.  The tick should launch the port's K3
(power iteration and int8 quantization, ``lipq``) and K4 (the PGD inner on
the words, ``pgd_hqt``) once each."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import rti as ref

RECORD_IN = {"words": "u_words"}
LAUNCHES = {"lipq": 1, "pgd_hqt": 1}


def _sqp(config: dict, device):
    from pint_tpu_torch import DeviceSQP, Unicycle

    m, s = config["model"], config["solver"]
    model = Unicycle(dt_shift=m["dt_shift"], frac_bits=m["frac_bits"],
                     v_shift=m["v_shift"], w_shift=m["w_shift"])
    return DeviceSQP(
        model=model, horizon=s["horizon"], Q=np.diag(s["Q_diag"]),
        R=np.diag(s["R_diag"]), qf_scale=s["qf_scale"], x_ref=np.asarray(s["x_ref"]),
        sqp_iters=s["sqp_iters"], pgd_iters=s["pgd_iters"], g_shift=s["g_shift"],
        power_iters=s["power_iters"], device=device)


def build(config: dict, batch: int, device):
    from pint_tpu_torch import RTIService

    return RTIService(_sqp(config, device), batch=batch)


def solver(service):
    return service.sqp


def record_out(result) -> dict:
    return {"words": result}


def work(config: dict, batch: int) -> list:
    s = config["solver"]
    Tm = 2 * s["horizon"]
    return [("lipq", dict(B=batch, Tm=Tm, power_iters=s["power_iters"])),
            ("pgd_hqt", dict(B=batch, Tp=Tm, iters=s["pgd_iters"], words=True))]


class Reference:
    """:func:`portbench.reference.rti.rti_step` and its shift."""

    def __init__(self, config: dict, device):
        if config["solver"]["sqp_iters"] != 1:
            raise ValueError("the reference runs one SQP iteration a tick")
        self.pr = ref.Problem({**config["model"], **config["solver"]}, device)
        self.device = self.pr.device
        self.m = self.pr.m
        self.lane_scales = self.pr.lane_scales

    def zeros(self, n: int) -> dict:
        return {"words": torch.zeros((n, self.pr.Tm // 4), dtype=torch.int32,
                                     device=self.device)}

    def step(self, x0: torch.Tensor, ins: dict) -> dict:
        return {"words": ref.rti_step(self.pr, x0, ins["words"])}

    def shift(self, outs: dict) -> dict:
        return {"words": ref.shift_plan(outs["words"], self.m)}

    def lanes(self, words: torch.Tensor) -> torch.Tensor:
        return ref.unpack(words)
