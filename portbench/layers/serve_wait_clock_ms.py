"""Serving: wait for the device (the phase clock, untraced): the median
host milliseconds a tick blocked in the copy of the controls back, until
the device has drained, over the window's last ticks, which no profiler
saw."""

from portbench import clocks


def read(summary, cell):
    return clocks.host_phase_ms("wait")
