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

On the card, for the model :class:`Unicycle` itself and the goal cost of
:func:`unicycle_goal_cost` with one goal, an update is one kernel launch
(:func:`mppi_update_fused`, ``csrc/mppi.cu``): one block a problem, one
thread a candidate, the noise read once and nothing of a candidate written
out.  It is bit for bit :func:`mppi_update_plain`, which repeats its order
of roundings; against the torch update, candidates and rollouts are
bit-identical and costs, weights and means agree to float32 roundoff.  The
solver decides at construction whether the model, K and the horizon fit
(:func:`update_fits`) and at each call from the words' device and the cost;
everything else (CPU tensors, any other cost or model) runs the torch
update.  Its launches count under "mppi" (:func:`launch_count`), beside and
not among :func:`~pint_tpu_torch.ops.kernels.launch_counts`.

Each draw is one ``pint.mppi.sample`` range in a ``torch.profiler`` trace
and each update two, ``pint.mppi.rollout`` (the saturating add, the unpack
and the fixed-point rollout; on the kernel path the launch) then
``pint.mppi.score`` (the costs, the median, the softmax, the weighted mean
and the repack; on the kernel path nothing is left for it): host-only
ranges (:func:`~pint_tpu_torch.utils.profiling.span`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    Unicycle,
    _sin_turns_q14,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W
from pint_tpu_torch.utils.profiling import span

__all__ = ["QuantizedMPPI", "UnicycleGoalCost", "launch_count", "merged_shifts",
           "mppi_update_fused", "mppi_update_plain", "unicycle_goal_cost", "update_fits"]


class UnicycleGoalCost:
    """Quadratic goal-reaching cost on fixed-point unicycle trajectories.

    states (..., T+1, 3) int32, controls (..., T, 2) lanes -> (...) float32:
    running squared distance + 20 x terminal + 1e-4 x control effort.  It
    carries what an update's kernel reads of it: ``goal`` (float32, on the
    device it was given on; one already on the trajectories' device is used
    there with no copy a call), ``frac_bits`` (the x, y scale), and
    ``shared_goal``, the goal's two values on the host where one goal serves
    every problem (shape (2,) or one of size 1 in front), else None."""

    def __init__(self, model: Unicycle, goal_xy):
        self.frac_bits = model.frac_bits
        self.goal = torch.as_tensor(goal_xy if isinstance(goal_xy, torch.Tensor)
                                    else np.asarray(goal_xy), dtype=torch.float32)
        self.shared_goal = (tuple(self.goal.reshape(2).tolist())
                            if self.goal.numel() == 2 and self.goal.shape[-1] == 2 else None)

    def __call__(self, states, controls):
        xy = states[..., :2].to(torch.float32) * float(np.float32(2.0**-self.frac_bits))
        goal = self.goal.to(xy.device)[..., None, :]
        d2 = torch.sum((xy - goal) ** 2, dim=-1)
        run = torch.sum(d2[..., 1:], dim=-1)
        term = 20.0 * d2[..., -1]
        effort = 1e-4 * torch.sum(controls.to(torch.float32) ** 2, dim=(-2, -1))
        return run + term + effort


def unicycle_goal_cost(model: Unicycle, goal_xy) -> UnicycleGoalCost:
    """The goal-reaching cost of :class:`UnicycleGoalCost`; the goal is
    converted to float32 once."""
    return UnicycleGoalCost(model, goal_xy)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=-1, keepdims=True)``: the mean of the two middle
    values of the sorted axis, (low + high) * 0.5 in x's dtype."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return ((s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5)[..., None]


# -- the update in one kernel ----------------------------------------------------

MIN_SAMPLES, MAX_SAMPLES = 32, 1024
"""The kernel's K: a power of two from a warp to a block of threads, one
thread a candidate."""

_MAX_SMEM = 232448
"""Shared memory a block may use on sm_90: the kernel's is the noise slab, K
x lanes bytes, and 8 K + K / 8 + 2 lanes bytes beside it (``csrc/mppi.cu``)."""


def launch_count() -> int:
    """Launches of the update kernel since the last
    :func:`~pint_tpu_torch.ops.kernels.reset_launch_counts`."""
    return K._counts.get("mppi", 0)


def merged_shifts(model) -> Tuple[int, int] | None:
    """(xs, ws) where the unicycle's fixed-point map may run with its shifts
    merged, ``x += (v c) >> xs`` and ``th += w << ws``, bit for bit the
    model's map on lanes |v|, |w| <= 128: ``2 <= v_shift <= 14 + dt_shift``
    and ``w_shift >= dt_shift``; else None."""
    if not (2 <= model.v_shift <= 14 + model.dt_shift and model.w_shift >= model.dt_shift):
        return None
    return 12 + model.dt_shift - (model.v_shift - 2), model.w_shift - model.dt_shift


def update_fits(model, samples: int, horizon: int) -> bool:
    """Whether the update kernel takes the model, K and the horizon: the
    model exactly :class:`Unicycle` (a subclass may change its map), its
    shifts mergeable (:func:`merged_shifts`), K a power of two in
    [:data:`MIN_SAMPLES`, :data:`MAX_SAMPLES`], an even horizon (whole
    words of two steps), and the K x lanes noise slab in shared memory."""
    lanes = 2 * horizon
    return (type(model) is Unicycle and merged_shifts(model) is not None
            and MIN_SAMPLES <= samples <= MAX_SAMPLES and samples & (samples - 1) == 0
            and horizon > 0 and horizon % 2 == 0
            and samples * lanes + 8 * samples + samples // 8 + 2 * lanes <= _MAX_SMEM)


def _merged_step(x, y, th, v, w, xs: int, ws: int):
    """The unicycle's fixed-point step with merged shifts (int32 tensors,
    every sum wrapping)."""
    c = _sin_turns_q14(th + (1 << 14))
    s = _sin_turns_q14(th)
    return x + ((v * c) >> xs), y + ((v * s) >> xs), th + (w << ws)


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power of two long) as a tree: the first half plus
    the second, until one is left; the dim is kept."""
    while x.shape[dim] > 1:
        a, b = x.split(x.shape[dim] // 2, dim=dim)
        x = a + b
    return x


def _costs_plain(model, cost: UnicycleGoalCost, state0: torch.Tensor,
                 lanes: torch.Tensor) -> torch.Tensor:
    """The candidates' costs (B, K) float32 in the kernel's order: the
    merged map step by step; each step's squared distance to the goal
    (x, y scaled, less the goal, squared, summed), the running sum from step
    1 in step order, plus 20 x the last, plus 1e-4 x the summed squared
    lanes (an exact int32 sum, exact in float32 below 2**24)."""
    B, Kc, L = lanes.shape
    xs, ws = merged_shifts(model)
    sc = float(np.float32(2.0**-cost.frac_bits))
    gx, gy = cost.shared_goal
    x, y, th = (state0[:, i, None].expand(B, Kc) for i in range(3))
    run = d2 = None
    for k in range(L // 2):
        x, y, th = _merged_step(x, y, th, lanes[..., 2 * k], lanes[..., 2 * k + 1], xs, ws)
        dx = x.to(torch.float32) * sc - gx
        dy = y.to(torch.float32) * sc - gy
        d2 = dx * dx + dy * dy
        run = d2 if run is None else run + d2
    effort = torch.sum(lanes * lanes, dim=-1).to(torch.float32)
    return (run + 20.0 * d2) + 1e-4 * effort


def _check_update(mppi, nominal_words, noise, state0, cost):
    """(B, K, lanes); raises on what the update kernel does not take."""
    if noise.dim() != 3:
        raise ValueError(f"noise must be (B, K, lanes), got {tuple(noise.shape)}")
    B, Kc, L = noise.shape
    if ((Kc, L) != (mppi.samples, mppi.lanes_per_plan) or tuple(nominal_words.shape) != (B, L // 4)
            or tuple(state0.shape) != (B, 3)):
        raise ValueError(f"mppi update: words {tuple(nominal_words.shape)}, noise "
                         f"{tuple(noise.shape)}, states {tuple(state0.shape)} for K "
                         f"{mppi.samples} and {mppi.lanes_per_plan} lanes")
    if noise.dtype.is_floating_point or noise.dtype == torch.bool:
        raise ValueError(f"mppi update: noise must be integers, got {noise.dtype}")
    if nominal_words.dtype != torch.int32 or state0.dtype != torch.int32:
        raise ValueError("mppi update: words and states must be int32")
    if not update_fits(mppi.model, Kc, L // 2):
        raise ValueError(f"mppi update: model {mppi.model}, K {Kc}, horizon {L // 2} past "
                         "the kernel's fit (update_fits)")
    if type(cost) is not UnicycleGoalCost or cost.shared_goal is None:
        raise ValueError("mppi update: the kernel scores the goal cost of "
                         "unicycle_goal_cost with one goal for every problem")
    return B, Kc, L


def mppi_update_plain(mppi, nominal_words: torch.Tensor, noise: torch.Tensor,
                      state0: torch.Tensor, cost: UnicycleGoalCost
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`mppi_update_fused`, on any device: the
    kernel's order of roundings, one elementwise operation a rounding.  The
    candidates and their rollouts are :meth:`QuantizedMPPI._update`'s bit for
    bit; the costs (:func:`_costs_plain`), the softmax's sum (a tree over K)
    and the weighted mean (a sum over k = t + 32 j in j order for each t <
    32, then a tree over t) are summed in the kernel's order, so they agree
    with the torch update to float32 roundoff.  Returns (new words (B,
    lanes / 4), best cost (B,))."""
    B, Kc, L = _check_update(mppi, nominal_words, noise, state0, cost)
    cand = W.add_signed_saturate(CONTROL_LAYOUT, nominal_words[:, None, :],
                                 pack_controls(noise))
    lanes = unpack_controls(cand)                                  # (B, K, L)
    costs = _costs_plain(mppi.model, cost, state0, lanes)
    mu = torch.amin(costs, dim=-1, keepdim=True)
    scale = (_median(costs) - mu) + 1e-6
    a = -(costs - mu) / (scale * mppi.temperature)
    e = torch.exp(a - torch.amax(a, dim=-1, keepdim=True))
    w = e / _tree_sum(e, -1)
    p = (w[..., None] * lanes.to(torch.float32)).reshape(B, Kc // 32, 32, L)
    acc = p[:, 0]
    for j in range(1, Kc // 32):
        acc = acc + p[:, j]
    mean = _tree_sum(acc, 1)[:, 0]
    new_lanes = torch.clamp(torch.round(mean), -127, 127).to(torch.int32)
    return pack_controls(new_lanes), mu[:, 0]


def mppi_update_fused(mppi, nominal_words: torch.Tensor, noise: torch.Tensor,
                      state0: torch.Tensor, cost: UnicycleGoalCost
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MPPI update in one kernel launch (``csrc/mppi.cu``): from the
    nominal words (B, lanes / 4) int32, the noise (B, K, lanes) of any
    integer dtype (int8 read in place where each problem's slab is
    contiguous and 16-byte aligned) and the start states (B, 3) int32, the
    new words and the best cost a problem, bit for bit
    :func:`mppi_update_plain`.  Kernel for CUDA tensors, the plain version
    for CPU tensors."""
    B, Kc, L = _check_update(mppi, nominal_words, noise, state0, cost)
    if nominal_words.device.type == "cpu":
        return mppi_update_plain(mppi, nominal_words, noise, state0, cost)
    if noise.dtype != torch.int8:
        noise = noise.to(torch.int8)
    if (noise.stride(2) != 1 or noise.stride(1) != L or noise.stride(0) % 16
            or noise.data_ptr() % 16):
        noise = noise.clone(memory_format=torch.contiguous_format)
    words, state0 = nominal_words.contiguous(), state0.contiguous()
    dev = K.require_cuda("mppi_update_fused", words, state0, slabs=(noise,))
    out = torch.empty((B, L // 4), dtype=torch.int32, device=dev)
    best = torch.empty((B,), dtype=torch.float32, device=dev)
    if B:
        xs, ws = merged_shifts(mppi.model)
        gx, gy = cost.shared_goal
        with torch.cuda.device(dev):
            err = K.library().pint_mppi_update(
                words.data_ptr(), noise.data_ptr(), state0.data_ptr(), out.data_ptr(),
                best.data_ptr(), B, Kc, L, noise.stride(0), xs, ws,
                float(np.float32(2.0**-cost.frac_bits)), gx, gy,
                float(np.float32(mppi.temperature)), K.stream_of(words))
        K.check(err, "mppi_update_fused")
        K.count_launch("mppi")
    return out, best


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
        object.__setattr__(self, "_fits", update_fits(self.model, self.samples, self.horizon))

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

    def _fused(self, nominal_words, cost_fn) -> bool:
        """Whether an update runs as one kernel launch
        (:func:`mppi_update_fused`): the words on the card, the model, K and
        horizon within :func:`update_fits` (decided at construction), and
        ``cost_fn`` a :class:`UnicycleGoalCost` with one goal for every
        problem.  Any other call runs the torch update."""
        return (self._fits and nominal_words.device.type == "cuda"
                and type(cost_fn) is UnicycleGoalCost and cost_fn.shared_goal is not None)

    def _update(self, nominal_words, noise, state0, cost_fn):
        """One MPPI update on the perturbations ``noise`` (B, K, lanes) of
        any integer dtype; returns (new nominal words, best cost a
        problem)."""
        if self._fused(nominal_words, cost_fn):
            with span("pint.mppi.rollout"):
                out = mppi_update_fused(self, nominal_words, noise, state0, cost_fn)
            with span("pint.mppi.score"):      # scored, weighed and packed in the launch
                return out
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
