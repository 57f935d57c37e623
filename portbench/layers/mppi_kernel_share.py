"""MPPI updates: percent of the tick's updates that ran as the update's
kernel, 100 x the launches of the kernels declared in
``pint_tpu_torch/csrc/mppi.cu`` inside the solver's calls / (ticks x the
configuration's ``updates_per_tick``).  The kernels are read from the source
as :func:`portbench.entries.roofline` reads a file's; nothing where none
ran, or where the program has no such file."""

import re

from portbench import entries


def read(summary, cell):
    names = [k for k, f in entries.kernel_files(entries.csrc()).items()
             if f == "mppi.cu"]
    if not names:
        return None
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    ops = [o for o in summary.select("solver", port=True) if pattern.search(o.name)]
    updates = summary.ticks * cell.config["solver"]["updates_per_tick"]
    return 100.0 * len(ops) / updates if ops else None
