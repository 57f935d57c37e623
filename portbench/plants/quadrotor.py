"""The planar quadrotor as a plant: the model's own discrete map in float64.

    x' = x + vx dt,  y' = y + vy dt,  theta' = theta + omega dt,
    vx' = vx - (f1 + f2) s(theta) dt,  vy' = vy + ((f1 + f2) c(theta) - g) dt,
    omega' = omega + (f2 - f1) 2**-torque_shift dt

with theta in turns, the model's parabolic sine s and c(theta) =
s(theta + 1/4) (:func:`portbench.reference.rti.sin_turns`), dt =
2**-dt_shift, and f_i the hover thrust plus the rotor's control u_i in
Newtons, each inside 127 of its lane steps (2**(f_shift - frac_bits) N)."""

from __future__ import annotations

import numpy as np

from portbench.reference.cquad import GRAVITY, constants
from portbench.reference.rti import sin_turns


class Plant:
    def __init__(self, model: dict):
        self.dt, self.hover, self.k, lane = constants(model)
        self.box = 127.0 * np.array([lane, lane])

    def step(self, x: np.ndarray, u: np.ndarray) -> np.ndarray:
        th, vx, vy, om = x[:, 2], x[:, 3], x[:, 4], x[:, 5]
        f1, f2 = self.hover + u[:, 0], self.hover + u[:, 1]
        dt = self.dt
        return np.stack([x[:, 0] + vx * dt, x[:, 1] + vy * dt, th + om * dt,
                         vx - (f1 + f2) * sin_turns(th) * dt,
                         vy + ((f1 + f2) * sin_turns(th + 0.25) - GRAVITY) * dt,
                         om + (f2 - f1) * self.k * dt], axis=-1)
