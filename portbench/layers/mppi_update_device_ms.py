"""MPPI updates (``QuantizedMPPI.solve_words``: the saturating adds, the
rollouts, the scores and the weighted means of a tick's updates): device
milliseconds a tick, the union of the intervals of the device operations
launched inside the solver's calls; nothing where none ran."""


def read(summary, cell):
    ops = summary.select("solver")
    return summary.busy_ns(ops) / 1e6 / summary.ticks if ops else None
