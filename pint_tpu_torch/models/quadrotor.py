"""Planar quadrotor (birotor): 6 states, 2 inputs, fixed point.

PyTorch port of ``pint_tpu/models/quadrotor.py``: the same Q16 plant, hover
linearization, float64 reference and Jacobians, and float32 twins for the
device solvers (``rollout_f32``, ``linearize_f32``).

State (all int32): x, y [Q16 m], theta [Q16 turns], vx, vy [Q16 m/s],
omega [Q16 turns/s].  Controls: two int8 rotor lanes, thrust deltas around
hover: f_i = f_hover + lane * 2^(f_shift - 16).  With mass 1 and the
quadratic trig s(t) ~ sin(2 pi t)::

    ax = -(f1 + f2) s(theta),  ay = (f1 + f2) c(theta) - g,
    domega = (f2 - f1) 2^-torque_shift

by explicit Euler at dt = 2^-dt_shift.  The fixed-point step keeps every
operand an int32 tensor: the products and sums wrap and the shifts are
arithmetic, as XLA's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    _dsin_turns_f32,
    _dsin_turns_f64,
    _sin_turns_f32,
    _sin_turns_f64,
    _sin_turns_q14,
)

__all__ = ["PlanarQuadrotor"]

_GRAVITY = 9.8125  # g_fp = round(g * 2^16) is exact; Q16


@dataclasses.dataclass(frozen=True)
class PlanarQuadrotor:
    dt_shift: int = 5       # dt = 1/32 s
    frac_bits: int = 16
    f_shift: int = 9        # thrust delta per lane: 2^(9-16) = 1/128 N
    torque_shift: int = 4   # domega = (f2-f1) >> 4  [turns/s^2 per N]

    def __post_init__(self):
        if not (0 <= self.f_shift <= 11):
            # (total_fp >> 2) * trig_q14 must fit int32
            raise ValueError(f"f_shift={self.f_shift} out of range")

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def f_scale(self) -> float:
        """Thrust units per int8 lane."""
        return 2.0 ** (self.f_shift - self.frac_bits)

    @property
    def lane_scales(self) -> np.ndarray:
        """(2,) physical thrust-delta Newtons per int8 lane unit."""
        return np.array([self.f_scale, self.f_scale])

    @property
    def hover_fp(self) -> int:
        """Per-rotor hover thrust, Q16 (total = g)."""
        return int(round(_GRAVITY * 2.0**self.frac_bits)) // 2

    @property
    def g_fp(self) -> int:
        return int(round(_GRAVITY * 2.0**self.frac_bits))

    # -- fixed point ------------------------------------------------------------

    def step(self, state, u1, u2) -> torch.Tensor:
        """state (..., 6) int32; u1, u2 (...) int32 lanes in [-128, 127]."""
        x, y, th = state[..., 0], state[..., 1], state[..., 2]
        vx, vy, om = state[..., 3], state[..., 4], state[..., 5]
        f1 = (u1 << self.f_shift) + self.hover_fp   # int32 tensor + int: int32
        f2 = (u2 << self.f_shift) + self.hover_fp
        total = f1 + f2
        s = _sin_turns_q14(th)
        c = _sin_turns_q14(th + (1 << 14))
        ax = -(((total >> 4) * s) >> 10)
        ay = (((total >> 4) * c) >> 10) - self.g_fp
        dom = (f2 - f1) >> self.torque_shift
        ds = self.dt_shift
        return torch.stack([x + (vx >> ds), y + (vy >> ds), th + (om >> ds),
                            vx + (ax >> ds), vy + (ay >> ds), om + (dom >> ds)], dim=-1)

    def rollout(self, state0, controls) -> torch.Tensor:
        """controls (..., T, 2) int32 lanes -> states (..., T+1, 6)."""
        states = [state0]
        for k in range(controls.shape[-2]):
            states.append(self.step(states[-1], controls[..., k, 0], controls[..., k, 1]))
        return torch.stack(states, dim=-2)

    # -- hover linearization for the condensed QP -------------------------------

    def hover_lti(self) -> Tuple[np.ndarray, np.ndarray]:
        """(A, B) of the Euler-discretized hover linearization in physical
        units, with the parabola's trig slope (8 per turn at zero)."""
        dt = self.dt
        n = 6
        Ac = np.zeros((n, n))
        Ac[0, 3] = Ac[1, 4] = Ac[2, 5] = 1.0
        Ac[3, 2] = -_GRAVITY * 8.0
        Bc = np.zeros((n, 2))
        Bc[4, 0] = Bc[4, 1] = 1.0
        k = 2.0**-self.torque_shift
        Bc[5, 0], Bc[5, 1] = -k, k
        return np.eye(n) + dt * Ac, dt * Bc

    # -- unit helpers -------------------------------------------------------------

    def to_fixed(self, state_phys: np.ndarray) -> np.ndarray:
        s = np.asarray(state_phys, np.float64)
        return np.round(s * 2.0**self.frac_bits).astype(np.int32)

    def to_float(self, state_fp) -> np.ndarray:
        return np.asarray(state_fp, np.float64) * 2.0**-self.frac_bits

    # -- float64 reference ----------------------------------------------------------

    def reference_rollout(self, state0_f: np.ndarray, controls_f: np.ndarray) -> np.ndarray:
        """float64 twin (same discrete map, same quadratic trig); controls_f
        (..., T, 2) thrust deltas in Newtons."""
        dt = self.dt
        st = np.asarray(state0_f, np.float64).copy()
        controls_f = np.asarray(controls_f, np.float64)
        T = controls_f.shape[-2]
        out = np.empty(st.shape[:-1] + (T + 1, 6), np.float64)
        out[..., 0, :] = st
        hover = self.hover_fp * 2.0**-self.frac_bits
        for k in range(T):
            x, y, th, vx, vy, om = (st[..., i] for i in range(6))
            f1 = hover + controls_f[..., k, 0]
            f2 = hover + controls_f[..., k, 1]
            total = f1 + f2
            ax = -total * _sin_turns_f64(th)
            ay = total * _sin_turns_f64(th + 0.25) - _GRAVITY
            dom = (f2 - f1) * 2.0**-self.torque_shift
            st = np.stack([x + vx * dt, y + vy * dt, th + om * dt, vx + ax * dt,
                           vy + ay * dt, om + dom * dt], axis=-1)
            out[..., k + 1, :] = st
        return out

    def linearize(self, states_f: np.ndarray, controls_f: np.ndarray) -> tuple:
        """Exact Jacobians of the float64 map (the quadratic trig's own
        derivative included): states (..., 6), controls (..., 2) ->
        (A (..., 6, 6), B (..., 6, 2))."""
        states_f = np.asarray(states_f, np.float64)
        controls_f = np.asarray(controls_f, np.float64)
        th = states_f[..., 2]
        hover = self.hover_fp * 2.0**-self.frac_bits
        total = 2.0 * hover + controls_f[..., 0] + controls_f[..., 1]
        dt = self.dt
        s, c = _sin_turns_f64(th), _sin_turns_f64(th + 0.25)
        k = 2.0**-self.torque_shift
        batch = states_f.shape[:-1]
        A = np.zeros(batch + (6, 6))
        for i in range(6):
            A[..., i, i] = 1.0
        A[..., 0, 3] = A[..., 1, 4] = A[..., 2, 5] = dt
        A[..., 3, 2] = -dt * total * _dsin_turns_f64(th)
        A[..., 4, 2] = dt * total * _dsin_turns_f64(th + 0.25)
        B = np.zeros(batch + (6, 2))
        B[..., 3, 0] = B[..., 3, 1] = -dt * s
        B[..., 4, 0] = B[..., 4, 1] = dt * c
        B[..., 5, 0], B[..., 5, 1] = -dt * k, dt * k
        return A, B

    # -- float32 twins (the device solvers) ---------------------------------------

    def _f32_consts(self):
        return (float(np.float32(self.dt)), float(np.float32(_GRAVITY)),
                float(np.float32(2.0 * self.hover_fp * 2.0**-self.frac_bits)),
                float(np.float32(2.0**-self.torque_shift)))

    def rollout_f32(self, state0_f, controls_f) -> torch.Tensor:
        """float32 rollout of the same Euler map: state0_f (..., 6),
        controls_f (..., T, 2) thrust deltas -> (..., T+1, 6)."""
        dt, g, hover2, k = self._f32_consts()
        st = state0_f.to(torch.float32)
        u = controls_f.to(torch.float32)
        out = [st]
        for t in range(u.shape[-2]):
            x, y, th = st[..., 0], st[..., 1], st[..., 2]
            vx, vy, om = st[..., 3], st[..., 4], st[..., 5]
            total = hover2 + u[..., t, 0] + u[..., t, 1]
            ax = -total * _sin_turns_f32(th)
            ay = total * _sin_turns_f32(th + 0.25) - g
            dom = (u[..., t, 1] - u[..., t, 0]) * k
            st = torch.stack([x + vx * dt, y + vy * dt, th + om * dt, vx + ax * dt,
                              vy + ay * dt, om + dom * dt], dim=-1)
            out.append(st)
        return torch.stack(out, dim=-2)

    def linearize_f32(self, states_f, controls_f) -> tuple:
        """float32 twin of :meth:`linearize`: (A (..., 6, 6), B (..., 6, 2))."""
        dt, _, hover2, k = self._f32_consts()
        th = states_f[..., 2]
        total = hover2 + controls_f[..., 0] + controls_f[..., 1]
        s, c = _sin_turns_f32(th), _sin_turns_f32(th + 0.25)
        ds, dc = _dsin_turns_f32(th), _dsin_turns_f32(th + 0.25)
        z = torch.zeros_like(th)
        one = torch.ones_like(th)
        dtc = torch.full_like(th, dt)
        A = torch.stack([
            torch.stack([one, z, z, dtc, z, z], -1),
            torch.stack([z, one, z, z, dtc, z], -1),
            torch.stack([z, z, one, z, z, dtc], -1),
            torch.stack([z, z, -dt * total * ds, one, z, z], -1),
            torch.stack([z, z, dt * total * dc, z, one, z], -1),
            torch.stack([z, z, z, z, z, one], -1),
        ], -2)
        B = torch.stack([
            torch.stack([z, z], -1),
            torch.stack([z, z], -1),
            torch.stack([z, z], -1),
            torch.stack([-dt * s, -dt * s], -1),
            torch.stack([dt * c, dt * c], -1),
            torch.stack([torch.full_like(th, -dt * k), torch.full_like(th, dt * k)], -1),
        ], -2)
        return A, B
