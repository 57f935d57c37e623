"""Solver torch ops: the chain kernel, percent of its roofline.  The least
time an H100 could take for the tick's chain launches
(:func:`portbench.chain.cell_bound_ms`: their bytes over the HBM rate, or
their f32 operations over the f32 peak where that is larger) over the
device ms a tick of the kernels ``pint_tpu_torch/csrc/propagate.cu``
declares (``propagate_device_ms``'s reading); nothing where that reads
nothing."""

from portbench import chain
from portbench.layers import propagate_device_ms


def read(summary, cell):
    ms = propagate_device_ms.read(summary, cell)
    return None if ms is None else 100.0 * chain.cell_bound_ms(cell) / ms
