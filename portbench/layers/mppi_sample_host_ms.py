"""MPPI: sample (the draw of the next tick's noise, after the updates):
host milliseconds a tick in the ``pint.mppi.sample`` ranges; nothing in a
program without them."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.mppi.sample"])
