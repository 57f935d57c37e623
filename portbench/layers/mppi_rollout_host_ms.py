"""MPPI: rollout (each update's saturating add, unpack and fixed-point
rollout): host milliseconds a tick in the ``pint.mppi.rollout`` ranges;
nothing in a program without them."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.mppi.rollout"])
