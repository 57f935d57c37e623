"""The solver's torch operations (linearize, propagate, reduce, quantize,
constraint stacking): device milliseconds a tick, the union of the
intervals of the device operations launched inside ``solve_words`` that
are not the port's own kernels."""


def read(summary, cell):
    ops = summary.select("solver", port=False)
    return summary.busy_ns(ops) / 1e6 / summary.ticks if ops else None
