"""The program's own phase clocks (``pint_tpu_torch.utils.profiling.clocks``).

Each service of ``pint_tpu_torch`` keeps a phase clock
(``serving.ServiceStats``): the host time of each phase of its last ticks,
one ring for the ticks no profiler saw and one for those it did, and, for
the profiled ticks, the device time of each span from timing events on the
stream, inside the solver's CUDA graph too.  The readers of
``portbench/layers/*_clock_*.py`` read them here once the traced slice is
over, while the cell's service is still alive: its untraced ring then
holds the window's last ticks, its profiled ring and device counters the
slice's.  A program without the clocks (one built before them), or a clock
that holds no tick, gives None, and the runner leaves the metric out."""

from __future__ import annotations

from typing import Optional

import numpy as np


def service_clock():
    """The phase clock of the live service that ticked most, or None."""
    try:
        from pint_tpu_torch.utils import profiling
    except ImportError:
        return None
    clocks = getattr(profiling, "clocks", None)
    if clocks is None:
        return None
    live = [c for c in list(clocks()) if c.ticks]
    return max(live, key=lambda c: c.ticks) if live else None


def host_phase_ms(phase: str) -> Optional[float]:
    """The median milliseconds of the host phase ``phase`` (``in``,
    ``call``, ``launch``, ``shift``, ``wait``, ``out``) over the ticks no
    profiler saw."""
    clock = service_clock()
    ms = clock.phase_ms(50) if clock is not None else None
    return None if ms is None else float(ms[phase])


def call_ms() -> Optional[float]:
    """The median milliseconds of a whole public call over the ticks no
    profiler saw: entry to the end of ``out``."""
    clock = service_clock()
    if clock is None:
        return None
    rows = clock.phase_rows()
    if not len(rows):
        return None
    # in, call, shift, wait and out: every phase but the launch, a part of the call
    return float(np.median(rows[:, [1, 2, 4, 5, 6]].sum(axis=1))) / 1e6


def device_ms(span: str) -> Optional[float]:
    """The device clock's milliseconds a tick in the spans named ``span``
    over the profiled ticks."""
    clock = service_clock()
    return None if clock is None else clock.device_phase_ms(span, profiled=True)
