"""Solver: the ALM's scaling, device time (the device clock): milliseconds
a tick between the timing events of the ``pint.crti.scale`` spans (the
rationals, bounds and offsets, then the multipliers' rescale), inside the
solve's CUDA graph, over the traced slice's ticks."""

from portbench import clocks


def read(summary, cell):
    return clocks.device_ms("pint.crti.scale")
