"""The program's own host ranges in a traced slice.

``pint_tpu_torch`` marks the phases of each public call with host-only
ranges on the profiler's clock (``pint_tpu_torch.utils.profiling.span``):
``pint.serve.*`` in the serving layer, ``pint.sqp.*`` and ``pint.crti.*``
in the device SQP solvers.  :func:`trace.summarize` keeps every host event
of the slice in ``Summary.host``; the per-layer readers of these ranges sum
their durations here.  A program that records none of them (one built
before them) gives None, and the runner leaves the metric out."""

from __future__ import annotations

from typing import Iterable, Optional

from portbench import trace


def per_tick_ms(summary, names: Iterable[str]) -> Optional[float]:
    """Milliseconds a tick of the host ranges named ``names`` that start
    inside a public call (``summary.ticks_iv``), or None when the slice
    holds none."""
    names = set(names)
    inside = trace._spans(summary.ticks_iv)
    found = [b - a for a, b, name in summary.host if name in names and inside(a)]
    return sum(found) / 1e6 / summary.ticks if found else None
