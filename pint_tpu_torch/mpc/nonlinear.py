"""Quantization-aware nonlinear MPC: autodiff gradients, packed iterates.

PyTorch port of ``pint_tpu/mpc/nonlinear.py``.  The iterate is the packed
int8 control plan itself; the gradient comes from ``torch.autograd``
through the float32 twin of the fixed-point dynamics
(:meth:`Unicycle.rollout_f32`, the same discrete map and quadratic trig) --
forward in int, backward in float -- where the reference takes
``jax.grad``; the update is normalized per problem (RMS over the plan),
scaled to lane units by a cosine-decayed step, rounded, and applied with
``add_signed_saturate`` and the ``max_signed`` -127 box floor.

The float32 gradient sums run in another order than XLA's, so a rounded
step lane can land one off the reference's: whole solves are held to cost
parity, not to bits.  No line search, no data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.mpc.ltv import _lower_words
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W

__all__ = ["QuantizedNonlinearPGD"]


@dataclasses.dataclass(frozen=True)
class QuantizedNonlinearPGD:
    """Normalized-gradient descent on packed int8 plans for the unicycle,
    on ``device`` (the card unless ``"cpu"`` is asked for; raises without
    a card)."""

    model: Unicycle = Unicycle()
    horizon: int = 50
    iters: int = 60
    step_lanes: float = 12.0   # initial step, int8 lane units (RMS)
    final_lanes: float = 0.5   # final step after cosine decay
    device: object = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @property
    def words_per_plan(self) -> int:
        return (2 * self.horizon) // 4

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.words_per_plan), dtype=torch.int32,
                           device=self.device)

    @property
    def _lane_scales(self) -> np.ndarray:
        """(2,) physical units a lane for the (v, w) channels."""
        return np.array([self.model.v_scale, self.model.w_scale], np.float32)

    def _lr(self, i: int) -> torch.Tensor:
        """The cosine-decayed step of iteration ``i``, in f32 as the
        reference's traced scalar."""
        def f32(x):
            return torch.tensor(np.float32(x), device=self.device)

        frac = f32(i) / f32(max(self.iters - 1, 1))
        cos = torch.cos(f32(np.pi) * frac)
        return f32(self.final_lanes) + f32(0.5 * (self.step_lanes - self.final_lanes)) * (
            1.0 + cos)

    def grad(self, u_phys: torch.Tensor, state0_f: torch.Tensor, cost_fn) -> torch.Tensor:
        """d/du of ``sum(cost_fn(rollout_f32(state0_f, u), u))`` at the
        physical plans u_phys (B, T, 2) float32: ``jax.grad`` of the
        reference's objective, by ``torch.autograd``."""
        u = u_phys.detach().requires_grad_(True)
        with torch.enable_grad():
            states = self.model.rollout_f32(state0_f, u)
            (g,) = torch.autograd.grad(torch.sum(cost_fn(states, u)), u)
        return g

    def solve_words(
        self,
        u_words: torch.Tensor,      # (B, words_per_plan) int32 words
        state0_f: torch.Tensor,     # (B, 3) float32 physical (theta in turns)
        cost_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    ) -> torch.Tensor:
        """``iters`` quantization-aware gradient steps on packed words."""
        scales = torch.as_tensor(self._lane_scales, device=self.device)
        lower = torch.full_like(u_words, _lower_words())
        state0_f = state0_f.to(self.device, torch.float32)
        words = u_words
        for i in range(self.iters):
            lanes = unpack_controls(words)                        # (B, 2T)
            ctrl = lanes.reshape(*lanes.shape[:-1], self.horizon, 2)
            g = self.grad(ctrl.to(torch.float32) * scales, state0_f, cost_fn)
            # per-problem RMS normalization -> a step in lane units
            g_lane = g * scales
            rms = torch.sqrt(torch.mean(g_lane * g_lane, dim=(-2, -1), keepdim=True)) + 1e-12
            delta = -self._lr(i) * g_lane / rms
            delta_lanes = torch.clamp(torch.round(delta), -127, 127).to(torch.int32)
            words = W.add_signed_saturate(
                CONTROL_LAYOUT, words, pack_controls(delta_lanes.reshape(lanes.shape))
            )
            words = W.max_signed(CONTROL_LAYOUT, words, lower)
        return words

    def _to_f(self, state_fp: torch.Tensor) -> torch.Tensor:
        """Fixed-point states -> float32 physical (xy Q``frac_bits``, theta
        Q16 turns)."""
        return torch.cat([
            state_fp[..., :2].to(torch.float32) * float(np.float32(2.0**-self.model.frac_bits)),
            state_fp[..., 2:].to(torch.float32) * float(np.float32(2.0**-16)),
        ], dim=-1)

    # -- closed loop ---------------------------------------------------------

    def run_closed_loop(
        self,
        state0_fp: torch.Tensor,   # (B, 3) int32
        cost_fn,
        ticks: int,
        iters_per_tick: int = 8,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Receding-horizon gradient MPC: a tick refines the warm-started plan
        with ``iters_per_tick`` gradient steps, applies the first (v, w) pair
        on the quantized plant and shifts the plan.  Deterministic.

        Returns (states (B, ticks+1, 3) int32, applied controls
        (B, ticks, 2) int32 lanes)."""
        tick_solver = dataclasses.replace(self, iters=iters_per_tick)
        state = state0_fp.to(self.device)
        words = self.init_words(state.shape[0])
        states, ctrl = [state], []
        for _ in range(ticks):
            words = tick_solver.solve_words(words, self._to_f(state), cost_fn)
            lanes = unpack_controls(words)
            v0, w0 = lanes[..., 0], lanes[..., 1]
            state = self.model.step(state, v0, w0)
            shifted = torch.cat([lanes[..., 2:], torch.zeros_like(lanes[..., :2])], dim=-1)
            words = pack_controls(shifted)
            states.append(state)
            ctrl.append(torch.stack([v0, w0], dim=-1))
        applied = (torch.stack(ctrl, dim=-2) if ctrl else
                   torch.zeros((state.shape[0], 0, 2), dtype=torch.int32, device=self.device))
        return torch.stack(states, dim=-2), applied

    def solve(self, state0_fp: torch.Tensor, cost_fn) -> Tuple[torch.Tensor, torch.Tensor]:
        """From fixed-point states; returns (words, the quantized trajectory
        (B, T+1, 3) int32)."""
        state0_fp = state0_fp.to(self.device)
        words = self.solve_words(self.init_words(state0_fp.shape[0]),
                                 self._to_f(state0_fp), cost_fn)
        lanes = unpack_controls(words)
        ctrl = lanes.reshape(*lanes.shape[:-1], self.horizon, 2)
        return words, self.model.rollout(state0_fp, ctrl)
