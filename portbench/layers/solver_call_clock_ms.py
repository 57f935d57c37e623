"""Solver: the call (the phase clock, untraced): the median host
milliseconds a tick in the solver's ``solve_words`` call (at MPPI with the
states' rounding), over the window's last ticks, which no profiler saw."""

from portbench import clocks


def read(summary, cell):
    return clocks.host_phase_ms("call")
