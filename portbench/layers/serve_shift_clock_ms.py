"""Serving: shift (the phase clock, untraced): the median host
milliseconds a tick from the solver call's return to the copy back: the
next warm state, at MPPI also the launches of the next tick's draw; over
the window's last ticks, which no profiler saw."""

from portbench import clocks


def read(summary, cell):
    return clocks.host_phase_ms("shift")
