"""MPPI: score (each update's costs, median, softmax, weighted mean and
repack): host milliseconds a tick in the ``pint.mppi.score`` ranges;
nothing in a program without them."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.mppi.score"])
