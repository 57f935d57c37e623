"""Device (H100), against the untraced call: percent of a public call in
which no device operation ran, 100 x (1 - the traced slice's device busy
time a tick inside the calls / the median time of a call no profiler saw,
by the phase clock).  The busy time is the profiler's; the call's time is
the program's own, without the profiler's host cost."""

from portbench import clocks


def read(summary, cell):
    call = clocks.call_ms()
    if not summary.ops or not call:
        return None
    return 100.0 * (1.0 - summary.busy_in_ticks_ns() / 1e6 / summary.ticks / call)
