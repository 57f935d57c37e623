"""Solver: reduce (the Hessian and linear-term contractions of every
``reduce`` form, and the Hessian's hand-over): host milliseconds a tick in
the ``pint.sqp.reduce`` ranges."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.sqp.reduce"])
