"""Serving layer: persistent, warm-started MPC services (port of
``pint_tpu/serving.py``).

A long-lived service object owns the solver and the warm-start state (packed
control words per row of the client batch), accepts numpy state batches
per tick and returns physical controls.  Every response is validated --
states finite, controls inside the box -- and a failed row gets its warm
state reset instead of poisoning later ticks.

Each public ``solve`` is one ``pint.serve.solve`` range in a
``torch.profiler`` trace, cut into ``pint.serve.in`` (states onto the
device), the solver's own phases (``pint.sqp.*``, ``pint.crti.*``),
``pint.serve.shift`` (the next warm state), ``pint.serve.wait`` (blocked
until the device has drained and copied the controls back) and
``pint.serve.out`` (validation and scaling); :class:`ServiceStats` keeps
the host/wait split of every tick without a profiler.

Route selection follows the device: on a CUDA device the LTI service runs
the K2 kernel (:class:`~pint_tpu_torch.mpc.fused.FusedPGD`) and computes the
linear term on the device; on the CPU it runs the word-space
:class:`~pint_tpu_torch.mpc.solver.FixedPointPGD` with the float64 host
linear term.  The nonlinear services (:class:`RTIService`,
:class:`ConstrainedRTIService`) and the sampling-based
:class:`MPPIService` run their solver on its own device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.mpc.fused import FusedPGD
from pint_tpu_torch.mpc.mppi import QuantizedMPPI, unicycle_goal_cost
from pint_tpu_torch.mpc.solver import FixedPointPGD
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.utils.profiling import span

__all__ = ["ConstrainedRTIService", "MPCService", "MPPIService", "RTIService",
           "ServiceStats", "CRTI_BUDGET_S", "LTI_BUDGET_S", "MPPI_BUDGET_S",
           "RTI_BUDGET_S"]

LTI_BUDGET_S = 0.010
"""Real-time budget (SLO) of the LTI endpoint (:class:`MPCService`): a
100 Hz control loop."""

RTI_BUDGET_S = 0.020
"""Real-time budget (SLO) of the nonlinear RTI endpoint
(:class:`RTIService`): a 50 Hz control loop."""

CRTI_BUDGET_S = 0.020
"""Real-time budget (SLO) of the state-constrained RTI endpoint
(:class:`ConstrainedRTIService`): a 50 Hz control loop."""

MPPI_BUDGET_S = 0.03125
"""Real-time budget (SLO) of the sampling-based endpoint
(:class:`MPPIService`): one step of the default unicycle, dt = 2**-5 s, a
plan replanned every step."""


@dataclasses.dataclass
class ServiceStats:
    """Per-service counters.  ``deadline_misses`` counts ticks whose
    end-to-end ``solve()`` latency exceeded ``deadline_s``; a miss is an
    SLO violation, not an error.

    ``enqueue_s`` and ``wait_s`` split the summed latencies of all ticks:
    the host's time from each call's entry to the start of the controls'
    copy back (validation, states onto the device, issuing the solver's
    device work), and the time blocked in that copy, until the device has
    drained.  A host-bound service has ``wait_s`` small beside
    ``enqueue_s``; a device-bound one the reverse."""

    ticks: int = 0
    resets: int = 0
    last_latency_s: float = 0.0
    deadline_misses: int = 0
    enqueue_s: float = 0.0
    wait_s: float = 0.0

    def record_latency(self, seconds: float, deadline_s) -> None:
        self.last_latency_s = seconds
        self.ticks += 1
        if deadline_s is not None and seconds > deadline_s:
            self.deadline_misses += 1

    def record_tick(self, t0: float, t1: float, t2: float, deadline_s) -> None:
        """A tick that entered at ``t0``, began the copy back at ``t1`` and
        had the controls at ``t2`` (``time.perf_counter()``)."""
        self.enqueue_s += t1 - t0
        self.wait_s += t2 - t1
        self.record_latency(t2 - t0, deadline_s)


def _states(x0_phys, batch: int) -> np.ndarray:
    """A call's states as a (batch, n) float64 array; raises ValueError for
    another batch."""
    x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
    if x0.shape[0] != batch:
        raise ValueError(f"service built for batch {batch}, got {x0.shape[0]}")
    return x0


def _shift_plan(lanes: torch.Tensor, m: int, n_dec: int) -> torch.Tensor:
    """Warm start for the next tick: the plan moved one step (m lanes)
    earlier, zeros after, packed."""
    shifted = torch.cat(
        [lanes[:, m:n_dec], torch.zeros_like(lanes[:, :m]), lanes[:, n_dec:]],
        dim=-1,
    )
    return pack_controls(shifted)


class _Service:
    """The tick the four services share.  A service passes its batch, its
    deadline, its zero warm state (a tuple of tensors on its device, the
    plan words first) and the scale of its output lanes, and supplies
    ``_tick(*warm, inputs)``, which returns the next warm state and, last,
    the output lanes; :meth:`_inputs` and :meth:`_bad_rows` where they
    differ."""

    def __init__(self, batch: int, deadline_s, zero: tuple, scale):
        self.batch = batch
        self.deadline_s = deadline_s
        self.stats = ServiceStats()
        self._zero = zero
        self._warm = zero
        self._scale = scale

    def _inputs(self, x0: np.ndarray):
        """The tick's input from the validated states: f32 on the device."""
        return torch.as_tensor(x0.astype(np.float32), device=self._zero[0].device)

    def _bad_rows(self, x0: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Rows whose warm state is reset and whose output is zeroed: a
        non-finite state."""
        return ~np.isfinite(x0).all(axis=-1)

    def solve(self, x0_phys: np.ndarray) -> np.ndarray:
        """One service tick: (batch, n) physical states -> physical
        controls, the (batch, T) plans of :class:`MPCService`, the (batch,
        m) first controls of the RTI services.  Validates and self-heals
        the warm state."""
        with span("pint.serve.solve"):
            t0 = time.perf_counter()
            with span("pint.serve.in"):
                x0 = _states(x0_phys, self.batch)
                inputs = self._inputs(x0)
            *out, lanes = self._tick(*self._warm, inputs)
            warm = out[len(out) - len(self._zero):]   # MPCService's words come first
            t1 = time.perf_counter()
            with span("pint.serve.wait"):
                lanes_np = lanes.cpu().numpy()
            self.stats.record_tick(t0, t1, time.perf_counter(), self.deadline_s)

            with span("pint.serve.out"):
                bad = self._bad_rows(x0, lanes_np)
                if bad.any():
                    self.stats.resets += int(bad.sum())
                    keep = torch.as_tensor(~bad, device=self._zero[0].device)
                    warm = [torch.where(keep.view(-1, *(1,) * (w.dim() - 1)), w, z)
                            for w, z in zip(warm, self._zero)]
                    lanes_np = np.where(bad[:, None], 0, lanes_np)
                self._warm = tuple(warm)
                return lanes_np.astype(np.float64) * self._scale

    def reset(self) -> None:
        self._warm = self._zero


class MPCService(_Service):
    """Warm-started batched LTI MPC serving endpoint: each tick returns the
    whole (batch, T) plan."""

    def __init__(
        self,
        qqp: QuantizedQP,
        batch: int,
        iters_per_tick: int = 15,
        use_fused: Optional[bool] = None,
        inputs_per_step: int = 1,
        g_on_device: Optional[bool] = None,
        deadline_s: Optional[float] = LTI_BUDGET_S,
        device="cuda",
    ):
        """``use_fused`` and ``g_on_device`` default to "a CUDA device was
        asked for".  ``g_on_device`` computes the fixed-point linear term
        from the states in f32 on the device instead of
        ``QuantizedQP.g_lane_fixed``'s float64 numpy on the host (a
        self-consistent sibling: f32 can move int32 rounding ties)."""
        self.device = K.resolve_device(device)
        on_cuda = self.device.type == "cuda"
        self.qqp = qqp
        self.m = inputs_per_step
        self.g_on_device = on_cuda if g_on_device is None else g_on_device
        use_fused = on_cuda if use_fused is None else use_fused
        solver_cls = FusedPGD if use_fused else FixedPointPGD
        self._solver = solver_cls(qqp, iters=iters_per_tick, device=self.device)
        super().__init__(batch, deadline_s, (self._solver.init_words(batch),),
                         qqp.u_scale)
        self._GT = torch.as_tensor(
            np.asarray(qqp.qp.G, np.float32).T.copy(), device=self.device
        )
        self._g_ref = torch.as_tensor(
            np.asarray(qqp.qp.g_ref, np.float32), device=self.device
        )

    def _tick(self, words, g_pre):
        """Solve from the warm words; returns (words, next warm words,
        lanes (B, T))."""
        words = self._solver.solve_words(words, g_pre)
        with span("pint.serve.shift"):
            all_lanes = unpack_controls(words)
            warm = _shift_plan(all_lanes, self.m, all_lanes.shape[-1])
        return words, warm, all_lanes[:, : self.qqp.horizon]

    def _g_from_states(self, x0_f: torch.Tensor) -> torch.Tensor:
        """Device-side linear term with ``g_lane_fixed``'s non-finite
        guards, in f32."""
        g = (x0_f[:, :, None] * self._GT[None]).sum(1) + self._g_ref
        g = torch.nan_to_num(
            g * float(np.float32(self.qqp.Gq_scale)), nan=0.0,
            posinf=2.0**31 - 1, neginf=-(2.0**31),
        )
        gq = torch.clamp(torch.round(g).to(torch.float64), -(2.0**31),
                         2.0**31 - 1).to(torch.int32)
        pad = self.qqp.padded - self.qqp.horizon
        return torch.nn.functional.pad(gq, (0, pad)) if pad else gq

    def tick_from_states(self, words, x0_f):
        return self._tick(words, self._g_from_states(x0_f))

    def _inputs(self, x0):
        """The linear term: from the states on the device, or the host's."""
        if self.g_on_device:
            return self._g_from_states(super()._inputs(x0))
        return torch.as_tensor(self.qqp.g_lane_fixed(x0), device=self.device)

    def _bad_rows(self, x0, lanes):
        """Non-finite states, and plans whose lanes leave +-127."""
        return super()._bad_rows(x0, lanes) | (np.abs(lanes).max(axis=-1) > 127)


class RTIService(_Service):
    """Persistent nonlinear MPC endpoint: warm-started real-time iterations
    of :class:`~pint_tpu_torch.mpc.device_sqp.DeviceSQP` per tick.  Each
    tick takes physical states, returns the first control of every
    re-optimized plan, and shifts the plans one step.  Non-finite input
    rows get their warm plan reset and a zero control back."""

    def __init__(self, sqp, batch: int,
                 deadline_s: Optional[float] = RTI_BUDGET_S):
        """``sqp``: a configured DeviceSQP (its device is the service's);
        set its ``sqp_iters`` to the per-tick count (1 for classic RTI)."""
        self.sqp = sqp
        self.m = sqp.n_ctrl
        super().__init__(batch, deadline_s, (sqp.init_words(batch),),
                         np.asarray(sqp._lane_scales))

    def _tick(self, words, x0_f):
        """Returns (next warm words, first controls (B, m) int32 lanes)."""
        words = self.sqp.solve_words(words, x0_f)
        with span("pint.serve.shift"):
            lanes = unpack_controls(words)
            return _shift_plan(lanes, self.m, self.sqp.n_dec), lanes[:, : self.m]


def _shift_lam(lam: torch.Tensor, Cs: int, C: int) -> torch.Tensor:
    """Warm multipliers for the next tick: rows are time-major (row k*Cs+c
    is step k+1's constraint c), so drop the first step's Cs rows, append
    Cs zero rows for the new last step, and keep the inert padding rows."""
    return torch.cat([lam[:, Cs:C], torch.zeros_like(lam[:, :Cs]), lam[:, C:]],
                     dim=-1)


class ConstrainedRTIService(_Service):
    """Persistent state-constrained nonlinear MPC endpoint: warm-started
    real-time iterations of
    :class:`~pint_tpu_torch.mpc.device_constrained.DeviceConstrainedSQP`
    per tick.

    The warm state is the packed plan and the int32 multiplier plane; each
    tick shifts the plan by ``m`` lanes and the multipliers by one
    constraint-row block.  Non-finite input rows get plan and multipliers
    reset and a zero control back."""

    def __init__(self, csqp, batch: int,
                 deadline_s: Optional[float] = CRTI_BUDGET_S):
        """``csqp``: a configured DeviceConstrainedSQP (its device is the
        service's); set its ``dev.sqp_iters`` to the per-tick RTI count (1
        for classic RTI)."""
        self.csqp = csqp
        self.m = csqp.dev.n_ctrl
        super().__init__(batch, deadline_s,
                         (csqp.init_words(batch), csqp.init_lam(batch)),
                         np.asarray(csqp.dev._lane_scales))

    def _tick(self, words, lam, x0_f):
        """Returns (next warm words, next warm lam, first controls (B, m)
        int32 lanes)."""
        csqp = self.csqp
        words, lam = csqp.solve_words(words, x0_f, lam)
        with span("pint.serve.shift"):
            lanes = unpack_controls(words)
            warm = _shift_plan(lanes, self.m, csqp.dev.n_dec)
            return (warm, _shift_lam(lam, csqp._F.shape[0], csqp.n_rows),
                    lanes[:, : self.m])


class MPPIService(_Service):
    """Persistent sampling-based MPC endpoint: ``updates_per_tick``
    warm-started :class:`~pint_tpu_torch.mpc.mppi.QuantizedMPPI` updates a
    tick towards ``goal`` (:func:`~pint_tpu_torch.mpc.mppi.
    unicycle_goal_cost`), as ``QuantizedMPPI.run_closed_loop`` runs them.
    Each tick takes physical states, returns the first (v, w) of every
    refined plan, and shifts the plans one step.

    The warm state is the packed plan and the noise of the next tick's
    updates, (B, U, K, lanes) int8, drawn after each tick's updates from a
    generator on the service's device seeded by ``noise_seed + 1`` (on the
    CPU, one seeded by ``noise_seed`` would draw the table again).  The zero
    warm state is zero words and a cold-row table: one (U, K, lanes) draw
    from a CPU generator seeded by ``noise_seed``, the same for every row.
    So a row's first tick, and the tick after it was reset, samples from
    numbers that the seed alone fixes.  Non-finite input rows get their
    warm state reset and a zero control back."""

    def __init__(self, mppi: QuantizedMPPI, batch: int, goal=(0.0, 0.0),
                 updates_per_tick: int = 2, noise_seed: int = 0,
                 deadline_s: Optional[float] = MPPI_BUDGET_S):
        """``mppi``: the planner (its device is the service's)."""
        self.mppi = mppi
        self.updates = updates_per_tick
        self.device = dev = mppi.device
        self._cost = unicycle_goal_cost(mppi.model,
                                        torch.tensor(goal, dtype=torch.float32, device=dev))
        # x, y in Q frac_bits, theta in Q16 turns, as Unicycle.to_fixed
        self._q = torch.tensor([2.0**mppi.model.frac_bits] * 2 + [2.0**16], device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(noise_seed + 1)
        table = mppi.draw_noise(torch.Generator().manual_seed(noise_seed), 1,
                                updates_per_tick)
        zero = (mppi.init_words(batch), table.expand(batch, *table.shape[1:]))
        super().__init__(batch, deadline_s, zero, mppi.model.lane_scales)

    def _tick(self, words, noise, x0_f):
        """Returns (next warm words, next noise, first controls (B, 2) int32
        lanes)."""
        mppi = self.mppi
        # rounded half to even as Unicycle.to_fixed rounds; a component that
        # is not finite reads 0 (its row is reset in any case), one past
        # int32's range its end (2**31 - 128 is float32's last below 2**31)
        q = torch.round(torch.nan_to_num(x0_f, nan=0.0, posinf=0.0, neginf=0.0) * self._q)
        state = torch.clamp(q, -(2.0**31), 2.0**31 - 128).to(torch.int32)
        words = mppi.solve_words(words, state, noise, self._cost)
        with span("pint.serve.shift"):
            lanes = unpack_controls(words)
            warm = _shift_plan(lanes, 2, mppi.lanes_per_plan)
        return warm, mppi.draw_noise(self._gen, self.batch, self.updates), lanes[:, :2]
