"""MPPI updates: percent of their roofline.  The least time an H100 could
take for the tick's updates (:func:`portbench.mppi_bound.cell_bound_ms`:
their int32 operations, float32 operations or bytes, whichever bounds)
over ``mppi_update_device_ms``'s reading; nothing where that reads
nothing."""

from portbench import mppi_bound
from portbench.layers import mppi_update_device_ms


def read(summary, cell):
    ms = mppi_update_device_ms.read(summary, cell)
    return None if ms is None else 100.0 * mppi_bound.cell_bound_ms(cell) / ms
