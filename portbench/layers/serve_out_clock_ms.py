"""Serving: out (the phase clock, untraced): the median host milliseconds
a tick in validation and scaling after the controls are back, over the
window's last ticks, which no profiler saw."""

from portbench import clocks


def read(summary, cell):
    return clocks.host_phase_ms("out")
