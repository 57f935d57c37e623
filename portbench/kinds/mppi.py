"""``MPPIService`` over ``QuantizedMPPI``: sampling-based MPC of the
unicycle (model predictive path-integral control).

``updates_per_tick`` updates a tick, each of ``samples`` int8 perturbation
plans of ``horizon`` steps a plant, on the noise the service drew the tick
before (a cold plant's from the cold-row table); the warm state is the
packed plan and that noise.  A tick launches none of the port's kernel
entries: the update is torch operations on the lanes and words."""

from __future__ import annotations

import torch

from portbench.reference import mppi as ref
from portbench.reference import rti as ref_rti

RECORD_IN = {"words": "words", "noise": "noise"}
LAUNCHES = {}
NO_DRAW = -0x7F7F7F80        # four lanes of -128 in a word


def build(config: dict, batch: int, device):
    from pint_tpu_torch import MPPIService, QuantizedMPPI, Unicycle

    m, s = config["model"], config["solver"]
    model = Unicycle(dt_shift=m["dt_shift"], frac_bits=m["frac_bits"],
                     v_shift=m["v_shift"], w_shift=m["w_shift"])
    mppi = QuantizedMPPI(model, horizon=s["horizon"], samples=s["samples"],
                         noise_lanes=s["noise_lanes"], temperature=s["temperature"],
                         device=device)
    return MPPIService(mppi, batch, s["goal"], updates_per_tick=s["updates_per_tick"],
                       noise_seed=s["noise_seed"])


def solver(service):
    return service.mppi


def record_out(result) -> dict:
    return {"words": result}


def work(config: dict, batch: int) -> list:
    return []


class Reference:
    """:func:`portbench.reference.mppi.mppi_step`, its cold rows and its
    shift.

    The carry holds the words alone: the next tick's noise is a draw on
    the card, which the reference cannot rebuild.  So the step owes a plan
    only to a row whose noise can be a fresh draw
    (:func:`portbench.reference.mppi.fresh_rows`); to any other it owes
    :data:`NO_DRAW`, lanes of -128, which no plan holds (a plan lies in
    [-127, 127]), so that the row counts in ``plan_diff_pct`` and
    ``control_diff_pct``."""

    def __init__(self, config: dict, device):
        self.pr = ref.MPPIProblem({**config["model"], **config["solver"]}, device)
        self.device = self.pr.device
        self.m = 2
        self.lane_scales = self.pr.lane_scales

    def zeros(self, n: int) -> dict:
        t = self.pr.table
        return {"words": torch.zeros((n, self.pr.L // 4), dtype=torch.int32,
                                     device=self.device),
                "noise": t.expand(n, *t.shape)}

    def step(self, x0: torch.Tensor, ins: dict) -> dict:
        words = ref.mppi_step(self.pr, x0, ins["words"], ins["noise"])
        fresh = ref.fresh_rows(self.pr, ins["words"], ins["noise"])
        return {"words": torch.where(fresh[:, None], words, NO_DRAW)}

    def shift(self, outs: dict) -> dict:
        return {"words": ref_rti.shift_plan(outs["words"], self.m)}

    def lanes(self, words: torch.Tensor) -> torch.Tensor:
        return ref_rti.unpack(words)
