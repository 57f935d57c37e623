"""Quantized MPPI (sampling-based MPC) for the unicycle.

PyTorch port of ``pint_tpu/mpc/mppi.py``: path-integral MPC over packed
int8 control plans.  One update:

1. sample K int8 perturbation plans (scaled Gaussian noise, rounded);
2. candidates = ``add_signed_saturate(nominal_words, noise_words)`` -- the
   packed saturating update is the control-box projection;
3. roll every candidate through the fixed-point dynamics;
4. score each trajectory (float32 costs);
5. new nominal = round(softmax-weighted mean of the candidate lanes),
   re-packed.

Random numbers come from a ``torch.Generator`` the caller passes where the
reference takes a JAX key, and are drawn in :meth:`QuantizedMPPI.
_sample_noise` alone, on the generator's device, then moved to the
solver's.  :meth:`QuantizedMPPI.draw_noise` draws the noise of several
updates ahead, as int8 lanes, and :meth:`QuantizedMPPI.solve_words` runs
those updates on noise it is handed (the serving layer's
:class:`~pint_tpu_torch.serving.MPPIService`); :meth:`~QuantizedMPPI.step`
is a draw, then one such update.  A generator and a JAX key never draw
the same noise, so the port's sampled plans differ from the reference's
by design; given the same
noise (a test hands in JAX's), an update is the reference's: candidates and
rollouts bit-identical, costs and weights to f32 roundoff.  The median of
the costs averages the two middle values for an even K, as ``jnp.median``
does (``torch.median`` would return the lower one).

Each draw is one ``pint.mppi.sample`` range in a ``torch.profiler`` trace
and each update two, ``pint.mppi.rollout`` (the saturating add, the unpack
and the fixed-point rollout) then ``pint.mppi.score`` (the costs, the
median, the softmax, the weighted mean and the repack): host-only ranges
(:func:`~pint_tpu_torch.utils.profiling.span`).
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
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W
from pint_tpu_torch.utils.profiling import span

__all__ = ["QuantizedMPPI", "unicycle_goal_cost"]


def unicycle_goal_cost(model: Unicycle, goal_xy):
    """Quadratic goal-reaching cost on fixed-point unicycle trajectories.

    states (..., T+1, 3) int32, controls (..., T, 2) lanes -> (...) float32:
    running squared distance + 20 x terminal + 1e-4 x control effort.  The
    goal is converted to float32 once; one already on the trajectories'
    device is used there with no copy a call."""
    goal_t = torch.as_tensor(goal_xy if isinstance(goal_xy, torch.Tensor)
                             else np.asarray(goal_xy), dtype=torch.float32)

    def cost(states, controls):
        xy = states[..., :2].to(torch.float32) * float(np.float32(2.0**-model.frac_bits))
        goal = goal_t.to(xy.device)[..., None, :]
        d2 = torch.sum((xy - goal) ** 2, dim=-1)
        run = torch.sum(d2[..., 1:], dim=-1)
        term = 20.0 * d2[..., -1]
        effort = 1e-4 * torch.sum(controls.to(torch.float32) ** 2, dim=(-2, -1))
        return run + term + effort

    return cost


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=-1, keepdims=True)``: the mean of the two middle
    values of the sorted axis, (low + high) * 0.5 in x's dtype."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return ((s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5)[..., None]


@dataclasses.dataclass(frozen=True)
class QuantizedMPPI:
    """MPPI over packed int8 control plans for the unicycle, on ``device``
    (the card unless ``"cpu"`` is asked for; raises without a card)."""

    model: Unicycle = Unicycle()
    horizon: int = 50          # steps; 2 lanes (v, w) a step
    samples: int = 512         # K rollouts a problem an update
    noise_lanes: int = 24      # stddev of the int8 perturbation, lane units
    temperature: float = 0.1   # softmax temperature, in units of the robust
    #                            (median - best) cost spread
    device: object = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @property
    def lanes_per_plan(self) -> int:
        return 2 * self.horizon

    @property
    def words_per_plan(self) -> int:
        return self.lanes_per_plan // 4

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.words_per_plan), dtype=torch.int32,
                           device=self.device)

    def _sample_noise(self, gen: torch.Generator, batch: int) -> torch.Tensor:
        """(B, K, lanes) int32 discrete perturbations, clipped to int8,
        drawn on the generator's device and moved to the solver's."""
        z = torch.randn((batch, self.samples, self.lanes_per_plan), generator=gen,
                        dtype=torch.float32, device=gen.device)
        noise = torch.clamp(torch.round(z * self.noise_lanes), -127, 127)
        return noise.to(torch.int32).to(self.device)

    def draw_noise(self, gen: torch.Generator, batch: int, updates: int) -> torch.Tensor:
        """The noise of ``updates`` successive updates: (B, updates, K,
        lanes) int8, update u the draw :meth:`step` would make u-th from
        ``gen``."""
        with span("pint.mppi.sample"):
            out = torch.empty((batch, updates, self.samples, self.lanes_per_plan),
                              dtype=torch.int8, device=self.device)
            for u in range(updates):
                out[:, u] = self._sample_noise(gen, batch)
            return out

    def _rollouts(self, nominal_words, noise, state0):
        """The K candidates of every problem and their rollouts: (lanes
        (B, K, L), ctrl (B, K, T, 2), states (B, K, T+1, 3))."""
        batch = nominal_words.shape[0]
        cand_words = W.add_signed_saturate(
            CONTROL_LAYOUT, nominal_words[:, None, :], pack_controls(noise)
        )                                                      # (B, K, L/4)
        lanes = unpack_controls(cand_words)                    # (B, K, L)
        ctrl = lanes.reshape(batch, self.samples, self.horizon, 2)
        states = self.model.rollout(
            state0[:, None, :].expand(batch, self.samples, 3), ctrl
        )
        return lanes, ctrl, states

    def _update(self, nominal_words, noise, state0, cost_fn):
        """One MPPI update on the perturbations ``noise`` (B, K, lanes) of
        any integer dtype; returns (new nominal words, best cost a
        problem)."""
        with span("pint.mppi.rollout"):
            lanes, ctrl, states = self._rollouts(nominal_words, noise, state0)
        with span("pint.mppi.score"):
            costs = cost_fn(states, ctrl)                      # (B, K)
            # self-normalized exponential weighting: the temperature is in
            # units of (median - best), robust to heavy-tailed penalties
            mu = torch.amin(costs, dim=-1, keepdim=True)
            scale = (_median(costs) - mu) + 1e-6
            w = torch.softmax(-(costs - mu) / (scale * self.temperature), dim=-1)
            mean_lanes = torch.einsum("bk,bkl->bl", w, lanes.to(torch.float32))
            new_lanes = torch.clamp(torch.round(mean_lanes), -127, 127).to(torch.int32)
            return pack_controls(new_lanes), torch.amin(costs, dim=-1)

    def step(
        self,
        gen: torch.Generator,
        nominal_words: torch.Tensor,   # (B, words_per_plan) int32 words
        state0: torch.Tensor,          # (B, 3) int32
        cost_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One MPPI update; returns (new nominal words, best cost a problem)."""
        with span("pint.mppi.sample"):
            noise = self._sample_noise(gen, nominal_words.shape[0])   # (B, K, L)
        return self._update(nominal_words, noise, state0, cost_fn)

    def solve_words(
        self,
        words: torch.Tensor,           # (B, words_per_plan) int32 warm words
        state0: torch.Tensor,          # (B, 3) int32
        noise: torch.Tensor,           # (B, U, K, lanes) int8, as draw_noise gives
        cost_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    ) -> torch.Tensor:
        """``noise.shape[1]`` MPPI updates from ``words``, update u on
        ``noise[:, u]``; returns the last update's words, bit for bit those
        of as many :meth:`step` calls that drew the same noise."""
        for u in range(noise.shape[1]):
            words, _ = self._update(words, noise[:, u], state0, cost_fn)
        return words

    # -- closed loop ---------------------------------------------------------

    def run_closed_loop(
        self,
        gen: torch.Generator,
        state0: torch.Tensor,
        cost_fn,
        ticks: int,
        updates_per_tick: int = 2,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Receding-horizon MPPI: a tick refines the nominal plan with
        ``updates_per_tick`` updates, applies the first (v, w) pair, steps the
        plant and shifts the plan one step earlier.

        Returns (states (B, ticks+1, 3), applied controls (B, ticks, 2))."""
        state = state0.to(self.device)
        words = self.init_words(state.shape[0])
        states, ctrl = [state], []
        for _ in range(ticks):
            for _ in range(updates_per_tick):
                words, _ = self.step(gen, words, state, cost_fn)
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

    def plan(
        self,
        gen: torch.Generator,
        state0: torch.Tensor,
        cost_fn,
        updates: int = 8,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run ``updates`` MPPI iterations; returns (words, best costs)."""
        state0 = state0.to(self.device)
        batch = state0.shape[0]
        words = self.init_words(batch)
        best = torch.zeros((batch,), dtype=torch.float32, device=self.device)
        for _ in range(updates):
            words, best = self.step(gen, words, state0, cost_fn)
        return words, best
