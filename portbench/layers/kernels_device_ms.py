"""MPC kernels (``pint_tpu_torch/csrc/``): device milliseconds a tick of the
port's own kernels, the union of their intervals."""


def read(summary, cell):
    ops = summary.select(port=True)
    return summary.busy_ns(ops) / 1e6 / summary.ticks if ops else None
