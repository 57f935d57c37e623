"""Reduce a profiled slice of ticks to what the per-layer readers read.

The runner profiles a bounded slice of ticks with ``torch.profiler`` (host
operations and ranges, CUDA runtime calls, device operations) and marks
its own ranges with ``record_function``: ``portbench.tick`` around each
public call, ``portbench.solver`` around the solver's ``solve_words``,
``portbench.record`` around the benchmark's own copies for the check, and
``portbench.plant`` around the plant step.  Each device operation (kernel,
copy or fill) is placed by the host time of the runtime call that
launched it (a CPU event named for a CUDA runtime or driver call, such as
``cudaLaunchKernel``, shares its correlation id with the operation):
launched inside a solver range it belongs to the solver, inside a record
range to the benchmark, elsewhere inside a tick to the serving layer.  The
device's idle time is counted inside the ticks only: the plant step
between them is the benchmark's own host work, not the system's.

The port's own kernels are those whose name holds one of the ``__global__``
functions declared under ``pint_tpu_torch/csrc/`` (:func:`port_kernels`),
read when the run starts, so a kernel renamed or added is still the port's.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")   # cudaLaunchKernel, cuLaunchKernelEx, ...
SPANS = ("portbench.tick", "portbench.solver", "portbench.record", "portbench.plant")


def port_kernels(csrc: Path) -> List[str]:
    """The names of the ``__global__`` functions declared in the CUDA
    sources under ``csrc``: after ``__global__``, an optional
    ``__launch_bounds__(...)`` and the return type ``void``, the name."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+void\s+", text):
            i = m.end()
            if text.startswith("__launch_bounds__", i):
                i = text.index("(", i)
                depth = 0
                while True:
                    depth += {"(": 1, ")": -1}.get(text[i], 0)
                    i += 1
                    if depth == 0:
                        break
            name = re.match(r"\s*([A-Za-z_]\w*)", text[i:])
            if name:
                names.add(name.group(1))
    return sorted(names)


def short_name(name: str) -> str:
    """A device operation's name without template arguments and parameter
    list, at most 96 characters."""
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    s = s[5:] if s.startswith("void ") else s
    return (s or name)[:96]


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    where: str          # "solver", "serve", "record" or "other"
    port: bool          # one of the port's own kernels


@dataclasses.dataclass
class Summary:
    """One profiled slice: its ticks, its wall time, its device
    operations and the host activity.  ``calls`` is set by the runner: the
    port's kernel entries called a tick in the slice (by
    ``ops.kernels.launch_counts()``)."""

    ticks_iv: List[Tuple[int, int]]      # (start, end) of each public call
    t0_ns: int
    t1_ns: int
    ops: List[DeviceOp]
    host: List[Tuple[int, int, str]]     # (start, end, name) of host activity
    unplaced: int                        # device operations outside every tick
    plant_ns: int                        # the benchmark's own plant steps
    calls: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def ticks(self) -> int:
        return len(self.ticks_iv)

    @property
    def wall_ns(self) -> int:
        return self.t1_ns - self.t0_ns

    @property
    def tick_ns(self) -> int:
        """The time inside the public calls, the plant steps between them
        left out."""
        return sum(b - a for a, b in self.ticks_iv)

    def select(self, where=None, port=None) -> List[DeviceOp]:
        return [o for o in self.ops
                if (where is None or o.where == where) and (port is None or o.port == port)]

    def busy_ns(self, ops: Optional[List[DeviceOp]] = None) -> int:
        """Length of the union of the intervals of ``ops`` (all device
        operations by default)."""
        return sum(b - a for a, b in self.union(self.ops if ops is None else ops))

    def union(self, ops: List[DeviceOp]) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for a, b in sorted((o.start_ns, o.end_ns) for o in ops):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_in_ticks_ns(self) -> int:
        """Device time of the operations launched inside the public calls.
        Placed by launch and not by the device's time stamps, which may
        run a millisecond or so apart from the host's clock: each call
        waits for its own operations in any case."""
        return self.busy_ns([o for o in self.ops if o.where != "other"])

    def idle_gaps(self) -> List[Tuple[int, int]]:
        """The intervals inside the public calls in which no device
        operation ran."""
        busy = self.union(self.ops)
        ends = [e for _, e in busy]
        gaps = []
        for a, b in self.ticks_iv:
            t = a
            for s, e in busy[bisect.bisect_right(ends, a):]:
                if s >= b:
                    break
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
            if b > t:
                gaps.append((t, b))
        return gaps

    def label(self, a: int, b: int) -> str:
        """The innermost host activity open at the middle of (a, b), after
        the innermost of the benchmark's own ranges inside a tick that holds
        it."""
        if not hasattr(self, "_host_np"):
            self._host_np = (np.array([h[0] for h in self.host], dtype=np.int64),
                             np.array([h[1] for h in self.host], dtype=np.int64))
        starts, ends = self._host_np
        mid = (a + b) // 2
        open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
        inner, outer = None, None
        for i in open_[np.argsort(ends[open_] - starts[open_])]:
            name = self.host[i][2]
            if name == "portbench.tick":
                continue
            if name in SPANS:
                outer = outer or name
            else:
                inner = inner or name
        parts = [x for x in (outer, inner) if x is not None]
        return " > ".join(parts) if parts else "host code between operations"

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps inside the public calls, each with its seconds."""
        by_name: Dict[str, int] = {}
        for o in self.ops:
            k = short_name(o.name)
            by_name[k] = by_name.get(k, 0) + (o.end_ns - o.start_ns)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v / 1e9] for k, v in top],
                "idle_gaps": [[self.label(a, b), (b - a) / 1e9] for a, b in gaps]}


def _spans(intervals: List[Tuple[int, int]]):
    """A membership test for a host time in sorted, disjoint intervals."""
    intervals = sorted(intervals)
    starts = [a for a, _ in intervals]

    def inside(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= intervals[i][1]

    return inside


def summarize(events, kernels: List[str]) -> Summary:
    """:class:`Summary` of the raw profiler events (``prof.profiler.
    kineto_results.events()``) of one slice."""
    from torch.autograd import DeviceType

    pattern = re.compile(r"\b(" + "|".join(map(re.escape, kernels)) + r")\b") \
        if kernels else None
    spans: Dict[str, List[Tuple[int, int]]] = {k: [] for k in SPANS}
    runtime: Dict[int, int] = {}
    host: List[Tuple[int, int, str]] = []
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("portbench."):    # not a range drawn on the device
                device.append(e)
            continue
        s = e.start_ns()
        iv = (s, s + e.duration_ns())
        if name in spans:
            spans[name].append(iv)
        if RUNTIME_CALL.match(name):
            runtime[e.correlation_id()] = s
        host.append((iv[0], iv[1], name))
    ticks = sorted(spans["portbench.tick"])
    if not ticks:
        raise RuntimeError("the profiled slice holds no tick")
    in_solver = _spans(spans["portbench.solver"])
    in_record = _spans(spans["portbench.record"])
    in_tick = _spans(ticks)
    ops = []
    for e in device:
        t = runtime.get(e.correlation_id())
        if t is None:
            where = "other"
        elif in_record(t):
            where = "record"
        elif in_solver(t):
            where = "solver"
        elif in_tick(t):
            where = "serve"
        else:
            where = "other"
        s = e.start_ns()
        ops.append(DeviceOp(e.name(), s, s + e.duration_ns(), where,
                            bool(pattern and pattern.search(e.name()))))
    unplaced = sum(o.where == "other" for o in ops)
    plant = sum(b - a for a, b in spans["portbench.plant"])
    return Summary(ticks, ticks[0][0], ticks[-1][1], ops, host, unplaced, plant)
