"""Serving: states in (the phase clock, untraced): the median host
milliseconds a tick from the public call's entry to the states on the
device (``in``), over the window's last ticks, which no profiler saw."""

from portbench import clocks


def read(summary, cell):
    return clocks.host_phase_ms("in")
