"""Quantized dynamics models (PyTorch port of ``pint_tpu/models/dynamics.py``).

Ported here: the packed control plan (:func:`pack_controls`,
:func:`unpack_controls`), the quadratic-trig twins, :class:`DoubleIntegrator`
(the Q16 plant of the LTI tier: fixed-point step and rollouts, float64
reference) and :class:`Unicycle` with its fixed-point step, its float32
twin (``rollout_f32``, ``linearize_f32``) and its float64 numpy host half
(``reference_rollout``, ``linearize`` and the fixed-point conversions).
The planar quadrotor and the pendulum live in their own modules.

The reference scans the horizon with ``lax.scan``; here a rollout is a
Python loop of plain int32 torch ops, a few launches a step.

Controls are int8 lanes packed four to a 32-bit word
(``PackedLayout(8, 8, 8, 8)``); words live in ``torch.int32`` containers
holding the uint32 bits (see :mod:`pint_tpu_torch.ops.word`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.ops import word as W

CONTROL_LAYOUT = PackedLayout(8, 8, 8, 8)  # 4 int8 control lanes per word

__all__ = ["CONTROL_LAYOUT", "DoubleIntegrator", "Unicycle", "pack_controls",
           "unpack_controls"]


def pack_controls(
    controls: torch.Tensor, layout: PackedLayout = CONTROL_LAYOUT
) -> torch.Tensor:
    """(..., T) int control lanes -> (..., T/k) packed words (k lanes a
    word); lane k of word j holds control step k_lanes*j + k."""
    k = layout.num_lanes
    t = controls.shape[-1]
    if t % k:
        raise ValueError(f"control horizon {t} must be a multiple of {k} lanes")
    lanes = controls.reshape(*controls.shape[:-1], t // k, k)
    return W.pack(layout, lanes.to(torch.int32))


def unpack_controls(
    words: torch.Tensor, layout: PackedLayout = CONTROL_LAYOUT
) -> torch.Tensor:
    """(..., T/k) packed words -> (..., T) sign-extended int32 lanes."""
    lanes = W.unpack_signed(layout, words).to(torch.int32)
    return lanes.reshape(*words.shape[:-1], words.shape[-1] * layout.num_lanes)


# -- quadratic trig (angles in turns) ---------------------------------------


def _sin_turns_q14(theta_q16: torch.Tensor) -> torch.Tensor:
    """sin(2*pi*theta), theta int32 Q16 turns -> int32 Q14 (the parabola of
    ``pint_tpu``'s ``_sin_turns_q14``)."""
    t = theta_q16 & 0xFFFF
    half = t & 0x7FFF
    val = (half * (0x8000 - half)) >> 14
    return torch.where(((t >> 15) & 1) == 1, -val, val)


def _sin_turns_f64(theta_turns: np.ndarray) -> np.ndarray:
    """float64 twin of :func:`_sin_turns_q14` (same parabola)."""
    t = np.mod(theta_turns, 1.0)
    half = np.mod(t, 0.5)
    val = 16.0 * half * (0.5 - half)
    return np.where(t >= 0.5, -val, val)


def _dsin_turns_f64(theta_turns: np.ndarray) -> np.ndarray:
    """d/dtheta of :func:`_sin_turns_f64` (piecewise linear, float64)."""
    t = np.mod(theta_turns, 1.0)
    half = np.mod(t, 0.5)
    dval = 16.0 * (0.5 - 2.0 * half)
    return np.where(t >= 0.5, -dval, dval)


def _sin_turns_f32(theta_turns: torch.Tensor) -> torch.Tensor:
    """float32 twin of the quadratic sine.  ``torch.remainder`` is floor-mod
    like ``jnp.mod``; ``torch.fmod`` would not be."""
    t = torch.remainder(theta_turns, 1.0)
    half = torch.remainder(t, 0.5)
    val = 16.0 * half * (0.5 - half)
    return torch.where(t >= 0.5, -val, val)


def _dsin_turns_f32(theta_turns: torch.Tensor) -> torch.Tensor:
    """d/dtheta of :func:`_sin_turns_f32` (piecewise linear)."""
    t = torch.remainder(theta_turns, 1.0)
    half = torch.remainder(t, 0.5)
    dval = 16.0 * (0.5 - 2.0 * half)
    return torch.where(t >= 0.5, -dval, dval)


@dataclasses.dataclass(frozen=True)
class DoubleIntegrator:
    """1-D double integrator, exactly discretized, fixed point (the same
    discrete map as ``pint_tpu.models.DoubleIntegrator``).

    p' = v, v' = u with dt = 2**-dt_shift::

        p[k+1] = p[k] + v[k] dt + u[k] dt^2 / 2,   v[k+1] = v[k] + u[k] dt

    State (p, v) int32 Q``frac_bits``; an int8 control lane scales by
    ``2**u_shift`` into Q``frac_bits`` acceleration.  Every product by dt is
    an arithmetic shift and every sum wraps in int32, as XLA's."""

    dt_shift: int = 5
    frac_bits: int = 16
    u_shift: int = 8

    def __post_init__(self):
        if not (0 <= self.u_shift <= 23):
            raise ValueError(f"u_shift={self.u_shift}: lane<<u_shift must fit int32")
        if not (1 <= self.dt_shift <= 16):
            raise ValueError(f"dt_shift={self.dt_shift} out of range")

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def u_scale(self) -> float:
        """Physical acceleration units per int8 control step."""
        return 2.0 ** (self.u_shift - self.frac_bits)

    def step(self, state, u_lane) -> torch.Tensor:
        """One fixed-point step: state (..., 2) int32, u_lane (...) int32 in
        [-128, 127]."""
        p, v = state[..., 0], state[..., 1]
        u_fp = u_lane << self.u_shift
        p_next = p + (v >> self.dt_shift) + (u_fp >> (2 * self.dt_shift + 1))
        v_next = v + (u_fp >> self.dt_shift)
        return torch.stack([p_next, v_next], dim=-1)

    def rollout(self, state0, controls) -> torch.Tensor:
        """state0 (..., 2) int32; controls (..., T) int32 lanes -> states
        (..., T+1, 2)."""
        states = [state0]
        for k in range(controls.shape[-1]):
            states.append(self.step(states[-1], controls[..., k]))
        return torch.stack(states, dim=-2)

    def rollout_packed(self, state0, control_words) -> torch.Tensor:
        """Rollout from packed control words (..., T/4)."""
        return self.rollout(state0, unpack_controls(control_words))

    def reference_rollout(self, state0_f: np.ndarray, controls_f: np.ndarray) -> np.ndarray:
        """float64 rollout of the same discrete map; controls in physical
        units (lane * u_scale)."""
        dt = self.dt
        state0_f = np.asarray(state0_f, dtype=np.float64)
        controls_f = np.asarray(controls_f, dtype=np.float64)
        T = controls_f.shape[-1]
        out = np.empty(state0_f.shape[:-1] + (T + 1, 2), dtype=np.float64)
        out[..., 0, :] = state0_f
        p, v = state0_f[..., 0].copy(), state0_f[..., 1].copy()
        for k in range(T):
            u = controls_f[..., k]
            p = p + v * dt + 0.5 * u * dt * dt
            v = v + u * dt
            out[..., k + 1, 0], out[..., k + 1, 1] = p, v
        return out

    def to_fixed(self, x: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(x) * 2.0**self.frac_bits).astype(np.int32)

    def to_float(self, x) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) * 2.0**-self.frac_bits


@dataclasses.dataclass(frozen=True)
class Unicycle:
    """Planar unicycle with quadratic trig (same discrete map as
    ``pint_tpu.models.Unicycle``).

    State (x, y, theta): x, y int32 Q``frac_bits``; theta int32 Q16 turns.
    Controls per step: (v_lane, w_lane) int8.  dt = 2**-dt_shift::

        x' = x + v*cos(theta)*dt,  y' = y + v*sin(theta)*dt,  theta' = theta + w*dt
    """

    dt_shift: int = 5
    frac_bits: int = 16
    v_shift: int = 8
    w_shift: int = 6

    fused_chain = True
    """Whether an SQP iteration's serial chain on this map (``rollout_f32``,
    ``linearize_f32`` and the propagator recursion) has a kernel of its own,
    :func:`~pint_tpu_torch.mpc.propagate.chain_fused`; a model without the
    attribute has none."""

    def __post_init__(self):
        if not (0 <= self.v_shift <= 10):
            raise ValueError(
                f"v_shift={self.v_shift}: (lane<<v_shift>>2)*Q14 must fit int32"
            )
        if not (0 <= self.w_shift <= 23):
            raise ValueError(f"w_shift={self.w_shift} out of range")
        if not (1 <= self.dt_shift <= 16):
            raise ValueError(f"dt_shift={self.dt_shift} out of range")

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def v_scale(self) -> float:
        return 2.0 ** (self.v_shift - self.frac_bits)

    @property
    def w_scale(self) -> float:
        return 2.0 ** (self.w_shift - self.frac_bits)

    @property
    def lane_scales(self) -> np.ndarray:
        """(2,) physical units per int8 lane for (v, w)."""
        return np.array([self.v_scale, self.w_scale])

    # -- fixed point ----------------------------------------------------------

    def step(self, state, v_lane, w_lane) -> torch.Tensor:
        """One fixed-point step: state (..., 3) int32, lanes (...) int32."""
        x, y, th = state[..., 0], state[..., 1], state[..., 2]
        v_fp = v_lane << self.v_shift
        cos_q14 = _sin_turns_q14(th + (1 << 14))
        sin_q14 = _sin_turns_q14(th)
        vx = ((v_fp >> 2) * cos_q14) >> 12
        vy = ((v_fp >> 2) * sin_q14) >> 12
        x_next = x + (vx >> self.dt_shift)
        y_next = y + (vy >> self.dt_shift)
        th_next = th + ((w_lane << self.w_shift) >> self.dt_shift)
        return torch.stack([x_next, y_next, th_next], dim=-1)

    def rollout(self, state0, controls) -> torch.Tensor:
        """controls (..., T, 2) int32 lanes -> states (..., T+1, 3)."""
        states = [state0]
        for k in range(controls.shape[-2]):
            u = controls[..., k, :]
            states.append(self.step(states[-1], u[..., 0], u[..., 1]))
        return torch.stack(states, dim=-2)

    def rollout_packed(self, state0, control_words) -> torch.Tensor:
        """control_words (..., T/2): two (v, w) pairs a word."""
        lanes = unpack_controls(control_words)
        return self.rollout(
            state0, lanes.reshape(*lanes.shape[:-1], lanes.shape[-1] // 2, 2)
        )

    # -- float32 twin -----------------------------------------------------------

    def rollout_f32(self, state0_f, controls_f) -> torch.Tensor:
        """float32 rollout of the same discrete map.  state0_f (..., 3)
        [x, y, theta-in-turns], controls_f (..., T, 2) physical units ->
        (..., T+1, 3)."""
        dt = float(np.float32(self.dt))
        s = state0_f.to(torch.float32)
        u = controls_f.to(torch.float32)
        x, y, th = s[..., 0], s[..., 1], s[..., 2]
        out = [s]
        for k in range(u.shape[-2]):
            v, w = u[..., k, 0], u[..., k, 1]
            x = x + v * _sin_turns_f32(th + 0.25) * dt
            y = y + v * _sin_turns_f32(th) * dt
            th = th + w * dt
            out.append(torch.stack([x, y, th], dim=-1))
        return torch.stack(out, dim=-2)

    def linearize_f32(self, states_f, controls_f):
        """Analytic Jacobians of the f32 map: states_f (..., 3), controls_f
        (..., 2) -> (A (..., 3, 3), B (..., 3, 2))."""
        th = states_f[..., 2]
        v = controls_f[..., 0]
        dt = float(np.float32(self.dt))
        cos_q = _sin_turns_f32(th + 0.25)
        sin_q = _sin_turns_f32(th)
        dcos = _dsin_turns_f32(th + 0.25)
        dsin = _dsin_turns_f32(th)
        z = torch.zeros_like(th)
        one = torch.ones_like(th)
        A = torch.stack(
            [
                torch.stack([one, z, v * dcos * dt], -1),
                torch.stack([z, one, v * dsin * dt], -1),
                torch.stack([z, z, one], -1),
            ],
            -2,
        )
        B = torch.stack(
            [
                torch.stack([cos_q * dt, z], -1),
                torch.stack([sin_q * dt, z], -1),
                torch.stack([z, torch.full_like(th, dt)], -1),
            ],
            -2,
        )
        return A, B

    # -- float64 reference (numpy) ----------------------------------------------

    def reference_rollout(
        self, state0_f: np.ndarray, controls_f: np.ndarray
    ) -> np.ndarray:
        """float64 rollout with the same quadratic trig; controls_f
        (..., T, 2) physical units; theta in turns."""
        dt = self.dt
        state0_f = np.asarray(state0_f, dtype=np.float64)
        controls_f = np.asarray(controls_f, dtype=np.float64)
        T = controls_f.shape[-2]
        out = np.empty(state0_f.shape[:-1] + (T + 1, 3), dtype=np.float64)
        out[..., 0, :] = state0_f
        x = state0_f[..., 0].copy()
        y = state0_f[..., 1].copy()
        th = state0_f[..., 2].copy()
        for k in range(T):
            v = controls_f[..., k, 0]
            w = controls_f[..., k, 1]
            x = x + v * _sin_turns_f64(th + 0.25) * dt
            y = y + v * _sin_turns_f64(th) * dt
            th = th + w * dt
            out[..., k + 1, 0], out[..., k + 1, 1], out[..., k + 1, 2] = x, y, th
        return out

    # -- linearization (the LTV/SQP inner-QP ingredient) ---------------------

    def linearize(self, states_f: np.ndarray, controls_f: np.ndarray) -> tuple:
        """Jacobians of the float64 discrete map at (states_f, controls_f).

        states_f (..., 3) [x, y, theta-in-turns] and controls_f (..., 2)
        [v, w], physical units.  Returns (A (..., 3, 3), B (..., 3, 2)): the
        exact derivatives of :meth:`reference_rollout`'s step, quadratic
        trig included."""
        states_f = np.asarray(states_f, np.float64)
        controls_f = np.asarray(controls_f, np.float64)
        th = states_f[..., 2]
        v = controls_f[..., 0]
        dt = self.dt
        cos_q = _sin_turns_f64(th + 0.25)
        sin_q = _sin_turns_f64(th)
        dcos = _dsin_turns_f64(th + 0.25)
        dsin = _dsin_turns_f64(th)
        batch = states_f.shape[:-1]
        A = np.zeros(batch + (3, 3))
        A[..., 0, 0] = 1.0
        A[..., 1, 1] = 1.0
        A[..., 2, 2] = 1.0
        A[..., 0, 2] = v * dcos * dt
        A[..., 1, 2] = v * dsin * dt
        B = np.zeros(batch + (3, 2))
        B[..., 0, 0] = cos_q * dt
        B[..., 1, 0] = sin_q * dt
        B[..., 2, 1] = dt
        return A, B

    # -- fixed-point conversions (numpy) ----------------------------------------

    def to_fixed_xy(self, x: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(x) * 2.0**self.frac_bits).astype(np.int32)

    def to_fixed_theta(self, t: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(t) * 2.0**16).astype(np.int32)

    def to_fixed(self, state_f: np.ndarray) -> np.ndarray:
        """Whole-state (..., 3) conversion (xy Q``frac_bits``, theta Q16)."""
        state_f = np.asarray(state_f, np.float64)
        return np.concatenate(
            [self.to_fixed_xy(state_f[..., :2]), self.to_fixed_theta(state_f[..., 2:])],
            axis=-1,
        )

    def to_float(self, state_fp) -> np.ndarray:
        """Whole-state inverse of :meth:`to_fixed`."""
        state_fp = np.asarray(state_fp)
        return np.concatenate(
            [self.to_float_xy(state_fp[..., :2]), self.to_float_theta(state_fp[..., 2:])],
            axis=-1,
        )

    def to_float_xy(self, x) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) * 2.0**-self.frac_bits

    def to_float_theta(self, t) -> np.ndarray:
        return np.asarray(t, dtype=np.float64) * 2.0**-16
