"""Serving layer (``serving.py``: states in, the warm plan's shift, controls
out): device operations (kernels, copies, fills) launched a tick outside
the solver's ``solve_words``."""


def read(summary, cell):
    return len(summary.select("serve")) / summary.ticks if summary.ops else None
