"""Solver: propagate (the propagator recursion, or the all-pairs closed
form): host milliseconds a tick in the ``pint.sqp.propagate`` ranges."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.sqp.propagate"])
