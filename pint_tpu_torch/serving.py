"""Serving layer: persistent, warm-started MPC services (port of
``pint_tpu/serving.py``).

A long-lived service object owns the solver and the warm-start state (packed
control words per row of the client batch), accepts numpy state batches
per tick and returns physical controls.  Every response is validated --
states finite, controls inside the box -- and a failed row gets its warm
state reset instead of poisoning later ticks.

Each public ``solve`` is one ``pint.serve.solve`` range in a
``torch.profiler`` trace, cut into ``pint.serve.in`` (states onto the
device), the solver's own phases (``pint.sqp.*``, ``pint.crti.*``,
``pint.mppi.*``), ``pint.serve.shift`` (the next warm state),
``pint.serve.wait`` (blocked until the device has drained and copied the
controls back) and ``pint.serve.out`` (validation and scaling).
:class:`ServiceStats` is each service's phase clock: the host time of each
phase of every tick without a profiler, and, while its device clock is on,
the device time of every span.

Route selection follows the device: on a CUDA device the LTI service runs
the K2 kernel (:class:`~pint_tpu_torch.mpc.fused.FusedPGD`) and computes the
linear term on the device; on the CPU it runs the word-space
:class:`~pint_tpu_torch.mpc.solver.FixedPointPGD` with the float64 host
linear term.  The nonlinear services (:class:`RTIService`,
:class:`ConstrainedRTIService`) and the sampling-based
:class:`MPPIService` run their solver on its own device.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.mpc.fused import FusedPGD
from pint_tpu_torch.mpc.mppi import QuantizedMPPI, unicycle_goal_cost
from pint_tpu_torch.mpc.solver import FixedPointPGD
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.utils import graphs, profiling
from pint_tpu_torch.utils.graphs import launch_ns
from pint_tpu_torch.utils.profiling import span, stamp

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


_profiler_on = profiling.profiling

RING = 1024
"""Ticks each of a service's rings of phase rows keeps, the last ones."""

PHASES = ("in", "call", "launch", "shift", "wait", "out")
"""The host phases of a tick: states onto the device (``in``); the solver's
``solve_words`` call (``call``), of which ``launch`` is the part in CUDA
graph launches; from the call's return to the copy back (``shift``: the
next warm state, at MPPI also the draw's launches); the wait for the
controls (``wait``); validation and scaling (``out``).  ``in``, ``call``,
``shift``, ``wait`` and ``out`` add up to the tick."""


@dataclasses.dataclass(eq=False, slots=True)
class ServiceStats:
    """Per-service counters and the service's phase clock.
    ``deadline_misses`` counts ticks whose end-to-end ``solve()`` latency
    (entry to the controls' return from the device, as ``last_latency_s``)
    exceeded ``deadline_s``; a miss is an SLO violation, not an error.

    ``enqueue_s`` and ``wait_s`` (``enqueue_ns``, ``wait_ns``) split the
    summed latencies of all ticks: the host's time from each call's entry
    to the start of the controls' copy back (validation, states onto the
    device, issuing the solver's device work), and the time blocked in that
    copy, until the device has drained.  A host-bound service has
    ``wait_s`` small beside ``enqueue_s``; a device-bound one the reverse.

    The host phase clock is always on: each tick (``_Service.solve``)
    stamps its phase boundaries (:data:`PHASES`) and keeps them as one row
    (entry, the end of each of ``in``, ``call``, ``shift``, ``wait`` and
    ``out``, then the graph launches' nanoseconds) of a ring of the
    last :data:`RING` ticks, or of a second ring for the instrumented
    ticks, those during which a ``torch.profiler`` session records or the
    device clock is on, so their cost stays out of the first
    (:meth:`phase_rows`, :meth:`phase_ms`).  ``enqueue_s`` and ``wait_s``
    come from the same stamps.

    The device clock (:class:`~pint_tpu_torch.utils.profiling.DeviceClock`)
    is on in the ticks of a service on a CUDA device during which a
    profiler records, and in every ``device_every``-th tick (0, the
    default: never).  A shape's first clocked tick captures the clocked
    variant of its CUDA graph inside that tick, a slow tick.  Its
    readings: ``device_ms`` (for unprofiled, then profiled ticks: span
    name -> device ms summed over the ticks), ``device_ticks`` (the ticks
    read), ``device_spans`` (the last such tick's spans placed on the
    profiler's clock) and ``offsets_ns`` (each tick's anchor offset,
    :meth:`offset_us`).  ``ticks`` counts the rows of both rings.  Only the
    counters and ``device_every`` are arguments of the constructor."""

    resets: int = 0
    deadline_misses: int = 0
    enqueue_ns: int = 0
    wait_ns: int = 0
    device_every: int = 0
    rings: tuple = dataclasses.field(
        init=False, default_factory=lambda: ([None] * RING, [None] * RING), repr=False)
    rows: list = dataclasses.field(init=False, default_factory=lambda: [0, 0])
    device_ms: tuple = dataclasses.field(
        init=False, default_factory=lambda: ({}, {}), repr=False)
    device_ticks: list = dataclasses.field(init=False, default_factory=lambda: [0, 0])
    device_spans: list = dataclasses.field(init=False, default_factory=list, repr=False)
    offsets_ns: collections.deque = dataclasses.field(
        init=False, default_factory=lambda: collections.deque(maxlen=RING), repr=False)

    @property
    def ticks(self) -> int:
        return self.rows[0] + self.rows[1]

    @property
    def enqueue_s(self) -> float:
        return self.enqueue_ns * 1e-9

    @property
    def wait_s(self) -> float:
        return self.wait_ns * 1e-9

    @property
    def last_latency_s(self) -> float:
        newest = [self.rings[p][(n - 1) % RING] for p, n in enumerate(self.rows) if n]
        if not newest:
            return 0.0
        row = max(newest)                     # the later entry
        return (row[4] - row[0]) * 1e-9

    def record_device(self, readings, profiled: bool) -> None:
        """A clocked tick's :meth:`DeviceClock.read`."""
        ms, self.device_spans, offset = readings
        total = self.device_ms[profiled]
        for name, v in ms.items():
            total[name] = total.get(name, 0.0) + v
        self.device_ticks[profiled] += 1
        self.offsets_ns.append(offset)

    def phase_rows(self, profiled: bool = False) -> np.ndarray:
        """The ring's rows (``profiled``: the instrumented ticks'), oldest
        first, as (ticks, 7) int64 nanoseconds: the entry on the profiler's
        clock, then :data:`PHASES`."""
        n = self.rows[profiled]
        ring = self.rings[profiled]
        raw = np.asarray([ring[i % RING] for i in range(max(0, n - RING), n)],
                         np.int64).reshape(-1, 7)
        out = np.empty_like(raw)
        out[:, 0] = raw[:, 0] + profiling.PROFILER_CLOCK_NS
        out[:, 1] = raw[:, 1] - raw[:, 0]
        out[:, 2] = raw[:, 2] - raw[:, 1]
        out[:, 3] = raw[:, 6]
        out[:, 4:] = np.diff(raw[:, 2:6], axis=1)
        return out

    def phase_ms(self, q: float = 50, profiled: bool = False) -> Optional[Dict[str, float]]:
        """Each phase's ``q``-th percentile over a ring, in milliseconds;
        None while the ring is empty."""
        rows = self.phase_rows(profiled)
        if not len(rows):
            return None
        return dict(zip(PHASES, np.percentile(rows[:, 1:], q, axis=0) / 1e6))

    def device_phase_ms(self, name: str, profiled: bool = True) -> Optional[float]:
        """The device clock's milliseconds a tick in the spans ``name``,
        over the profiled (or the other) clocked ticks; None where none of
        them held such a span."""
        ticks = self.device_ticks[profiled]
        v = self.device_ms[profiled].get(name)
        return None if v is None or not ticks else v / ticks

    def offset_us(self) -> Optional[tuple]:
        """The anchor offset of the clocked ticks in the ring, microseconds:
        (median, the distance between its quartiles)."""
        if not self.offsets_ns:
            return None
        q1, q2, q3 = np.percentile(np.asarray(self.offsets_ns) / 1e3, [25, 50, 75])
        return float(q2), float(q3 - q1)


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
    ``_call(*warm, inputs)``, the solver's call, which returns a tuple,
    and ``_shift(*that tuple)``, which returns the next warm state and,
    last, the output lanes (``_tick`` is the two in turn);
    :meth:`_inputs` and :meth:`_bad_rows` where they differ."""

    def __init__(self, batch: int, deadline_s, zero: tuple, scale):
        self.batch = batch
        self.deadline_s = deadline_s
        self.stats = ServiceStats()
        profiling.register(self)
        self._zero = zero
        self._warm = zero
        self._scale = scale
        self._on_card = zero[0].is_cuda

    def _inputs(self, x0: np.ndarray):
        """The tick's input from the validated states: f32 on the device."""
        return torch.as_tensor(x0.astype(np.float32), device=self._zero[0].device)

    def _bad_rows(self, x0: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Rows whose warm state is reset and whose output is zeroed: a
        non-finite state."""
        return ~np.isfinite(x0).all(axis=-1)

    def _tick(self, *args):
        return self._shift(*self._call(*args))

    def solve(self, x0_phys: np.ndarray) -> np.ndarray:
        """One service tick: (batch, n) physical states -> physical
        controls, the (batch, T) plans of :class:`MPCService`, the (batch,
        m) first controls of the RTI services.  Validates and self-heals
        the warm state.  Its phases are stamped; with the device clock on,
        its spans are timed on the device too."""
        st = self.stats
        ring = profiled = _profiler_on()     # the second ring: an instrumented tick
        clock = None
        if self._on_card and (profiled or (
                st.device_every and st.ticks % st.device_every == 0)):
            clock = profiling.DEVICE_CLOCK.start(
                torch.cuda.current_stream(self._zero[0].device))
            ring = True
        launch = launch_ns[0]
        try:
            with span("pint.serve.solve"):
                t0 = stamp()
                with span("pint.serve.in"):
                    x0 = _states(x0_phys, self.batch)
                    inputs = self._inputs(x0)
                t1 = stamp()
                res = self._call(*self._warm, inputs)
                t2 = stamp()
                *out, lanes = self._shift(*res)
                warm = out[len(out) - len(self._zero):]   # MPCService's words come first
                t3 = stamp()
                with span("pint.serve.wait"):
                    if clock is None:
                        lanes_np = lanes.cpu().numpy()
                    else:
                        lanes_np, anchor = clock.fetch(lanes)
                t4 = stamp()
                with span("pint.serve.out"):
                    bad = self._bad_rows(x0, lanes_np)
                    if bad.any():
                        st.resets += int(bad.sum())
                        keep = torch.as_tensor(~bad, device=self._zero[0].device)
                        warm = [torch.where(keep.view(-1, *(1,) * (w.dim() - 1)), w, z)
                                for w, z in zip(warm, self._zero)]
                        lanes_np = np.where(bad[:, None], 0, lanes_np)
                    self._warm = tuple(warm)
                    result = lanes_np.astype(np.float64) * self._scale
                # the tick's row, written here and not by a method of the
                # stats: a call would cost a sixth of the clock's budget
                n = st.rows[ring]
                st.rings[ring][n % RING] = (t0, t1, t2, t3, t4, stamp(), launch_ns[0] - launch)
                st.rows[ring] = n + 1
                st.enqueue_ns += t3 - t0
                st.wait_ns += t4 - t3
                if self.deadline_s is not None and t4 - t0 > self.deadline_s * 1e9:
                    st.deadline_misses += 1
        except BaseException:
            if clock is not None:
                clock.stop()
                clock.discard()
            raise
        if clock is not None:
            clock.stop()
            st.record_device(clock.read(anchor, t4), profiled)
        return result

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

    def _call(self, words, g_pre):
        return (self._solver.solve_words(words, g_pre),)

    def _shift(self, words):
        """Returns (words, next warm words, lanes (B, T))."""
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

    def _call(self, words, x0_f):
        return (self.sqp.solve_words(words, x0_f),)

    def _shift(self, words):
        """Returns (next warm words, first controls (B, m) int32 lanes)."""
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

    def _call(self, words, lam, x0_f):
        return self.csqp.solve_words(words, x0_f, lam)

    def _shift(self, words, lam):
        """Returns (next warm words, next warm lam, first controls (B, m)
        int32 lanes)."""
        csqp = self.csqp
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

    def _call(self, words, noise, x0_f):
        mppi = self.mppi
        # rounded half to even as Unicycle.to_fixed rounds; a component that
        # is not finite reads 0 (its row is reset in any case), one past
        # int32's range its end (2**31 - 128 is float32's last below 2**31)
        q = torch.round(torch.nan_to_num(x0_f, nan=0.0, posinf=0.0, neginf=0.0) * self._q)
        state = torch.clamp(q, -(2.0**31), 2.0**31 - 128).to(torch.int32)
        return (mppi.solve_words(words, state, noise, self._cost),)

    def _shift(self, words):
        """Returns (next warm words, next noise, first controls (B, 2) int32
        lanes): the plan shifted, then the next tick's draw."""
        mppi = self.mppi
        with span("pint.serve.shift"):
            lanes = unpack_controls(words)
            warm = _shift_plan(lanes, 2, mppi.lanes_per_plan)
        return warm, mppi.draw_noise(self._gen, self.batch, self.updates), lanes[:, :2]
