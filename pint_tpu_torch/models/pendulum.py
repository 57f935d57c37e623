"""Torque-limited pendulum: the underactuated swing-up family.

PyTorch port of ``pint_tpu/models/pendulum.py``.  State (theta, omega):
theta int32 Q16 turns from upright (wraps mod one turn at the Q16
boundary), omega int32 Q16 turns/s; one int8 torque lane.  In turns::

    theta'' = k_g sin_q(theta) + u_lane * u_scale

with the quadratic sine of the unicycle, by semi-implicit Euler at
dt = 2**-dt_shift: omega' = omega + dt (k_g sin_q(theta) + u), then
theta' = theta + dt omega'.  The float references use the same quantized
gain (``_kg_fp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    _dsin_turns_f32,
    _dsin_turns_f64,
    _sin_turns_f32,
    _sin_turns_f64,
    _sin_turns_q14,
    unpack_controls,
)

__all__ = ["Pendulum"]


@dataclasses.dataclass(frozen=True)
class Pendulum:
    """Fixed-point torque-limited pendulum (theta in Q16 turns from
    upright)."""

    dt_shift: int = 5          # dt = 1/32 s
    k_g: float = 2.5           # gravity gain, turns/s^2 (= g / (2 pi l))
    u_shift: int = 9           # u = lane << u_shift, Q16 turns/s^2

    def __post_init__(self):
        if not (1 <= self.dt_shift <= 16):
            raise ValueError(f"dt_shift={self.dt_shift} out of range")
        if not (0 <= self.u_shift <= 20):
            raise ValueError(f"u_shift={self.u_shift} out of range")
        if not (0 < self.k_g < 8.0):
            raise ValueError(
                f"k_g={self.k_g}: the fixed-point gravity product needs "
                "0 < k_g < 8 turns/s^2 (rescale l instead)"
            )

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def u_scale(self) -> float:
        """Turns/s^2 of angular acceleration per int8 lane unit."""
        return 2.0 ** (self.u_shift - 16)

    @property
    def u_max(self) -> float:
        return 127.0 * self.u_scale

    @property
    def lane_scales(self) -> np.ndarray:
        """(1,) physical scale of the one control channel."""
        return np.array([self.u_scale])

    @property
    def _kg_fp(self) -> int:
        """k_g in Q16 turns/s^2, a multiple of 4 so that the step's ``>> 2``
        headroom split is exact."""
        return int(round(self.k_g * 16384.0)) << 2

    # -- fixed point --------------------------------------------------------------

    def step(self, state, u_lane) -> torch.Tensor:
        """One semi-implicit step: state (..., 2) int32 [theta, omega],
        u_lane (...) int32 in [-128, 127]."""
        th, om = state[..., 0], state[..., 1]
        grav = ((_sin_turns_q14(th) * (self._kg_fp >> 2)) >> 12)   # Q16 turns/s^2
        accel = grav + (u_lane << self.u_shift)
        om_next = om + (accel >> self.dt_shift)
        th_next = th + (om_next >> self.dt_shift)
        return torch.stack([th_next, om_next], dim=-1)

    def rollout(self, state0, controls) -> torch.Tensor:
        """controls (..., T) int32 lanes -> states (..., T+1, 2)."""
        states = [state0]
        for k in range(controls.shape[-1]):
            states.append(self.step(states[-1], controls[..., k]))
        return torch.stack(states, dim=-2)

    def rollout_packed(self, state0, control_words) -> torch.Tensor:
        return self.rollout(state0, unpack_controls(control_words))

    # -- float64 reference ---------------------------------------------------------

    def reference_rollout(self, state0_f: np.ndarray, controls_f: np.ndarray) -> np.ndarray:
        """controls_f (..., T, 1) physical turns/s^2; state (..., 2)
        [theta in turns, omega]."""
        dt = self.dt
        state0_f = np.asarray(state0_f, np.float64)
        controls_f = np.asarray(controls_f, np.float64)
        T = controls_f.shape[-2]
        out = np.empty(state0_f.shape[:-1] + (T + 1, 2), np.float64)
        out[..., 0, :] = state0_f
        th = state0_f[..., 0].copy()
        om = state0_f[..., 1].copy()
        kg = self._kg_fp * 2.0**-16
        for k in range(T):
            om = om + dt * (kg * _sin_turns_f64(th) + controls_f[..., k, 0])
            th = th + dt * om
            out[..., k + 1, 0], out[..., k + 1, 1] = th, om
        return out

    def linearize(self, states_f: np.ndarray, controls_f: np.ndarray) -> tuple:
        """Exact Jacobians of the float64 semi-implicit map."""
        states_f = np.asarray(states_f, np.float64)
        th = states_f[..., 0]
        dt = self.dt
        ds = self._kg_fp * 2.0**-16 * _dsin_turns_f64(th)
        batch = states_f.shape[:-1]
        A = np.zeros(batch + (2, 2))
        A[..., 0, 0] = 1.0 + dt * dt * ds
        A[..., 0, 1] = dt
        A[..., 1, 0] = dt * ds
        A[..., 1, 1] = 1.0
        B = np.zeros(batch + (2, 1))
        B[..., 0, 0] = dt * dt
        B[..., 1, 0] = dt
        return A, B

    # -- float32 twins (the device solvers) -------------------------------------------

    def rollout_f32(self, state0_f, controls_f) -> torch.Tensor:
        """float32 rollout of the same map: state0_f (..., 2), controls_f
        (..., T, 1) -> (..., T+1, 2)."""
        dt = float(np.float32(self.dt))
        kg = float(np.float32(self._kg_fp * 2.0**-16))
        st = state0_f.to(torch.float32)
        u = controls_f.to(torch.float32)
        th, om = st[..., 0], st[..., 1]
        out = [st]
        for k in range(u.shape[-2]):
            om = om + dt * (kg * _sin_turns_f32(th) + u[..., k, 0])
            th = th + dt * om
            out.append(torch.stack([th, om], dim=-1))
        return torch.stack(out, dim=-2)

    def linearize_f32(self, states_f, controls_f) -> tuple:
        """float32 twin of :meth:`linearize`."""
        th = states_f[..., 0]
        dt = float(np.float32(self.dt))
        kg = float(np.float32(self._kg_fp * 2.0**-16))
        ds = kg * _dsin_turns_f32(th)
        one = torch.ones_like(th)
        A = torch.stack([
            torch.stack([one + dt * dt * ds, torch.full_like(th, dt)], -1),
            torch.stack([dt * ds, one], -1),
        ], -2)
        B = torch.stack([torch.full_like(th, dt * dt)[..., None],
                         torch.full_like(th, dt)[..., None]], -2)
        return A, B

    # -- units -----------------------------------------------------------------------

    def to_fixed(self, x: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(x) * 65536.0).astype(np.int32)

    def to_float(self, x) -> np.ndarray:
        return np.asarray(x, np.float64) * 2.0**-16
