"""Solver: K3 and rationals, device time (the device clock): milliseconds
a tick between the timing events of the ``pint.sqp.quantize`` spans, inside
the solve's CUDA graph, over the traced slice's ticks."""

from portbench import clocks


def read(summary, cell):
    return clocks.device_ms("pint.sqp.quantize")
