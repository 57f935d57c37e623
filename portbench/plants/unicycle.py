"""The unicycle as a plant: the model's own discrete map in float64.

    x' = x + v sin(theta + 1/4) dt,  y' = y + v sin(theta) dt,  theta' = theta + w dt

with angles in turns and the model's parabolic sine
(:func:`portbench.reference.rti.sin_turns`), dt = 2**-dt_shift, and the
controls (v, w) in physical units, each inside 127 of its lane steps."""

from __future__ import annotations

import numpy as np

from portbench.reference.rti import sin_turns


class Plant:
    def __init__(self, model: dict):
        self.dt = 2.0 ** -model["dt_shift"]
        self.box = 127.0 * np.array([2.0 ** (model["v_shift"] - model["frac_bits"]),
                                     2.0 ** (model["w_shift"] - model["frac_bits"])])

    def step(self, x: np.ndarray, u: np.ndarray) -> np.ndarray:
        th, v, w = x[:, 2], u[:, 0], u[:, 1]
        return np.stack([x[:, 0] + v * sin_turns(th + 0.25) * self.dt,
                         x[:, 1] + v * sin_turns(th) * self.dt,
                         th + w * self.dt], axis=-1)
