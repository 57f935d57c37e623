"""MPC kernels: percent of their roofline.  The least time an H100 could
take for the tick's inner work (:mod:`portbench.costs`, counted at the
cell's shapes from the configuration) over the device time of the port's
kernels a tick.

The share is read only while the port's kernels carry the whole inner: in
a slice whose kernel entries called a tick (``summary.calls``) are not
the kind's ``LAUNCHES``, part of that work ran elsewhere or not at all,
the time would leave it out, and the reader returns nothing."""

from portbench import costs


def read(summary, cell):
    ops = summary.select(port=True)
    if not ops or summary.calls != cell.kind.LAUNCHES:
        return None
    bound = sum(costs.bound_ms(costs.kernel_cost(k, **shape))[0]
                for k, shape in cell.kind.work(cell.config, cell.traffic["batch"]))
    return 100.0 * bound / (summary.busy_ns(ops) / 1e6 / summary.ticks)
