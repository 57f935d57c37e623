"""Solver: K3 and rationals (lambda_max and the int8 Hessian by K3 or the
torch phases, the int32 linear term, the step rationals): host
milliseconds a tick in the ``pint.sqp.quantize`` ranges."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.sqp.quantize"])
