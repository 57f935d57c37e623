"""Solver: CUDA graph (``pint_tpu_torch/utils/graphs.py``): percent of the
ticks whose solve replayed as one CUDA graph, 100 x the ``pint.sqp.replay``
host ranges that start inside a public call / the ticks of the slice.  A
program that replays no graph (one built before the graph, or a tick that
ran eagerly) reads nothing, and the runner leaves the metric out."""

from portbench import trace


def read(summary, cell):
    inside = trace._spans(summary.ticks_iv)
    n = sum(1 for a, _, name in summary.host if name == "pint.sqp.replay" and inside(a))
    return 100.0 * n / summary.ticks if n else None
