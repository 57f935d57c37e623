"""Solver: K4 / K5 (the fixed-point PGD or ALM inner, kernel or plain
form): host milliseconds a tick in the ``pint.sqp.inner`` ranges."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.sqp.inner"])
