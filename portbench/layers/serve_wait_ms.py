"""Serving: wait for the device: milliseconds a tick the host is blocked in
the copy of the controls back (``pint.serve.wait``), until the device has
drained the tick's work."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.serve.wait"])
