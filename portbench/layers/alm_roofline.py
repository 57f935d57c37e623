"""MPC kernels: K5 (``alm``), percent of its roofline.  The least time an
H100 could take for the work of the tick's ``alm`` launch (:mod:`portbench.costs`,
at the cell's shape from the configuration) over the device ms a tick of
the kernels declared in ``pint_tpu_torch/csrc/alm.cu``
(:func:`portbench.entries.roofline`, which says when it reads nothing)."""

from portbench import entries


def read(summary, cell):
    return entries.roofline(summary, cell, "alm")
