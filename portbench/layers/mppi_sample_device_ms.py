"""MPPI: sample, device time (the device clock): milliseconds a tick
between the timing events of the ``pint.mppi.sample`` spans, the draw of
the next tick's noise, over the traced slice's ticks."""

from portbench import clocks


def read(summary, cell):
    return clocks.device_ms("pint.mppi.sample")
