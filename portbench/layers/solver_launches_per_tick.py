"""Solver layer (``mpc/device_sqp.py``, ``mpc/device_constrained.py``):
device operations launched a tick inside ``solve_words``."""


def read(summary, cell):
    ops = summary.select("solver")
    return len(ops) / summary.ticks if ops else None
