"""Receding-horizon MPC controllers: closed loops of solve -> apply -> re-solve.

PyTorch port of ``pint_tpu/mpc/controller.py``.  Each control tick maps the
fixed-point state to the QP's linear term (a folded float32 product,
rounded), solves the condensed QP from the warm-started packed plan,
applies the first control lane(s) to the fixed-point plant and shifts the
plan by one step.  The reference runs the loop as one jitted ``lax.scan``;
here it is a Python loop of ticks on the solver's device.

With ``use_fused=True`` every tick solves through
:class:`~pint_tpu_torch.mpc.fused.FusedPGD`, the K2 kernel on the card (one
launch a tick); otherwise through the word-space
:class:`~pint_tpu_torch.mpc.solver.FixedPointPGD`.  The two are
bit-identical.  The tick's f32 map reproduces XLA's CPU dot
(:func:`~pint_tpu_torch.mpc.constrained._mat_round`), so the loops equal the
reference's jitted ``run`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    DoubleIntegrator,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.mpc.constrained import _mat_round
from pint_tpu_torch.mpc.fused import FusedPGD
from pint_tpu_torch.mpc.solver import FixedPointPGD
from pint_tpu_torch.ops import kernels as K

__all__ = ["LTIController", "RecedingHorizonController"]


def _g_maps(qqp: QuantizedQP, frac_bits: int, device) -> tuple:
    """The folded f32 map state_fp -> g_pre: (G (n, Tp), g_ref (Tp,)), built
    in numpy as the reference builds them, on ``device``."""
    scale = qqp.Gq_scale * 2.0**-frac_bits
    n = qqp.qp.G.shape[1]
    G = np.zeros((n, qqp.padded), np.float32)
    G[:, : qqp.horizon] = (qqp.qp.G * scale).T.astype(np.float32)
    gr = np.zeros((qqp.padded,), np.float32)
    gr[: qqp.horizon] = (qqp.qp.g_ref * qqp.Gq_scale).astype(np.float32)
    return torch.as_tensor(G, device=device), torch.as_tensor(gr, device=device)


def _run(tick, state0_fp: torch.Tensor, words: torch.Tensor, ticks: int):
    """The closed loop of ``tick(state, words) -> (state, words, u0)``:
    (states (..., ticks+1, n), the applied u0 of every tick)."""
    states, applied = [state0_fp], []
    state = state0_fp
    for _ in range(ticks):
        state, words, u0 = tick(state, words)
        states.append(state)
        applied.append(u0)
    return torch.stack(states, dim=-2), applied


@dataclasses.dataclass(frozen=True)
class LTIController:
    """Receding-horizon controller for any quantized LTI MPC.

    Couples a :class:`~pint_tpu_torch.mpc.condensed.QuantizedQP` (from
    ``condense_lti``, any n and m) to a fixed-point plant step
    ``plant_step(state_fp, u_lanes) -> state_fp`` where ``u_lanes`` is the
    (..., m) int32 first-step control.  States are int32 Q``frac_bits``;
    the warm start shifts the packed plan by ``inputs_per_step`` lanes.

    ``use_fused=True`` solves each tick through K2; K2 has no error
    feedback, so ``use_fused=True`` with ``error_feedback=True`` raises
    (the reference quietly drops the error feedback there)."""

    qqp: QuantizedQP
    plant_step: callable = dataclasses.field(repr=False)
    inputs_per_step: int = 1
    frac_bits: int = 16
    iters_per_tick: int = 15
    use_fused: bool = False
    error_feedback: bool = False
    device: object = "cuda"

    def __post_init__(self):
        if self.use_fused and self.error_feedback:
            raise ValueError("use_fused runs K2, which has no error feedback: "
                             "use one or the other")
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @functools.cached_property
    def _solver(self):
        if self.use_fused:
            return FusedPGD(self.qqp, iters=self.iters_per_tick, device=self.device)
        return FixedPointPGD(self.qqp, iters=self.iters_per_tick,
                             error_feedback=self.error_feedback, device=self.device)

    @functools.cached_property
    def _maps(self) -> tuple:
        return _g_maps(self.qqp, self.frac_bits, self.device)

    def tick(self, state_fp: torch.Tensor, u_words: torch.Tensor):
        """One tick: (next state, shifted words, applied lanes (..., m))."""
        g = _mat_round(state_fp.to(torch.float32), *self._maps)
        u_words = self._solver.solve_words(u_words, g)
        lanes = unpack_controls(u_words)
        m = self.inputs_per_step
        u0 = lanes[..., :m]
        state2 = self.plant_step(state_fp, u0)
        shifted = torch.cat([lanes[..., m:], torch.zeros_like(lanes[..., :m])], dim=-1)
        return state2, pack_controls(shifted), u0

    def run(self, state0_fp: torch.Tensor, ticks: int):
        """Closed loop from state0_fp (B, n) int32: (states (B, ticks+1, n),
        applied controls (B, ticks, m))."""
        state0_fp = state0_fp.to(self.device)
        batch = state0_fp.shape[:-1]
        words = torch.zeros(batch + (self.qqp.padded // 4,), dtype=torch.int32,
                            device=self.device)
        states, applied = _run(self.tick, state0_fp, words, ticks)
        lanes = (torch.stack(applied, dim=-2) if applied
                 else torch.zeros(batch + (0, self.inputs_per_step), dtype=torch.int32,
                                  device=self.device))
        return states, lanes


@dataclasses.dataclass(frozen=True)
class RecedingHorizonController:
    """Closed-loop quantized MPC for the double integrator.

    The QP's control box and the model's lane scaling must agree: the
    plant applies ``lane * model.u_scale`` while the QP bounds
    ``|u| <= u_max`` with lane scale ``u_max / 127``.  :meth:`build` makes a
    matched pair (u_max = 127 * model.u_scale, dt = model.dt)."""

    qqp: QuantizedQP
    model: DoubleIntegrator = DoubleIntegrator()
    iters_per_tick: int = 15
    use_fused: bool = False
    device: object = "cuda"

    def __post_init__(self):
        if abs(self.qqp.u_scale - self.model.u_scale) > 1e-12:
            raise ValueError(
                f"QP lane scale {self.qqp.u_scale} != model lane scale "
                f"{self.model.u_scale}; build the QP with "
                f"u_max = 127 * model.u_scale (use .build())"
            )
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @classmethod
    def build(
        cls,
        model: DoubleIntegrator = DoubleIntegrator(),
        horizon: int = 50,
        iters_per_tick: int = 15,
        device="cuda",
        **qp_kwargs,
    ) -> "RecedingHorizonController":
        from pint_tpu_torch.mpc.condensed import condense_double_integrator, quantize

        qp = condense_double_integrator(
            T=horizon, dt=model.dt, u_max=127 * model.u_scale, **qp_kwargs,
        )
        return cls(quantize(qp), model, iters_per_tick, device=device)

    @functools.cached_property
    def _solver(self):
        if self.use_fused:
            return FusedPGD(self.qqp, iters=self.iters_per_tick, device=self.device)
        return FixedPointPGD(self.qqp, iters=self.iters_per_tick, device=self.device)

    @functools.cached_property
    def _maps(self) -> tuple:
        return _g_maps(self.qqp, self.model.frac_bits, self.device)

    def tick(self, state_fp: torch.Tensor, u_words: torch.Tensor):
        """One control tick.  state_fp (B, 2) int32; u_words (B, Tp/4).
        Returns (next_state, next_u_words, applied_lane (B,))."""
        g_pre = _mat_round(state_fp.to(torch.float32), *self._maps)
        u_words = self._solver.solve_words(u_words, g_pre)
        lanes = unpack_controls(u_words)
        u0 = lanes[..., 0]
        next_state = self.model.step(state_fp, u0)
        # warm start: lane k of word j holds step 4j+k, so the shift is
        # lanes[1:] ++ 0
        shifted = torch.cat([lanes[..., 1:], torch.zeros_like(lanes[..., :1])], dim=-1)
        return next_state, pack_controls(shifted), u0

    def run(self, state0_fp: torch.Tensor, ticks: int):
        """Closed loop for ``ticks`` steps: (states (B, ticks+1, 2), applied
        control lanes (B, ticks))."""
        state0_fp = state0_fp.to(self.device)
        batch = state0_fp.shape[:-1]
        words = torch.zeros(batch + (self.qqp.padded // 4,), dtype=torch.int32,
                            device=self.device)
        states, applied = _run(self.tick, state0_fp, words, ticks)
        lanes = (torch.stack(applied, dim=-1) if applied
                 else torch.zeros(batch + (0,), dtype=torch.int32, device=self.device))
        return states, lanes
