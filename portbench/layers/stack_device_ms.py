"""Solver torch ops: device milliseconds a tick of the kernels declared in
``pint_tpu_torch/csrc/stack.cu`` (an SQP iteration's constraint stacking,
S = F Bbar, P = F Abar and r = F Cbar batch-last, in one kernel), the union
of their intervals inside the solver's calls.  The kernels are read from the
source as :func:`portbench.entries.roofline` reads a file's; nothing where
none ran, or where the program has no such file."""

import re

from portbench import entries


def read(summary, cell):
    names = [k for k, f in entries.kernel_files(entries.csrc()).items()
             if f == "stack.cu"]
    if not names:
        return None
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    ops = [o for o in summary.select("solver", port=True) if pattern.search(o.name)]
    return summary.busy_ns(ops) / 1e6 / summary.ticks if ops else None
