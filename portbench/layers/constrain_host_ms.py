"""Solver: constraints (``DeviceConstrainedSQP``'s stacking of S, P, r;
K6 or its torch phases; the ALM's rationals, bounds, offsets and the
multiplier rescale): host milliseconds a tick in the ``pint.crti.stack``,
``pint.crti.pen`` and ``pint.crti.scale`` ranges."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.crti.stack", "pint.crti.pen",
                                       "pint.crti.scale"])
