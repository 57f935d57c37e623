"""Serving: host dispatch (``serving.py``'s public ``solve``): milliseconds
a tick of the host's time in the call outside the wait for the device, the
``pint.serve.solve`` ranges less the ``pint.serve.wait`` ranges inside them
(validation, the states' copy, issuing the solver's work, the shift)."""

from portbench import spans


def read(summary, cell):
    solve = spans.per_tick_ms(summary, ["pint.serve.solve"])
    if solve is None:
        return None
    return solve - (spans.per_tick_ms(summary, ["pint.serve.wait"]) or 0.0)
