"""Device (H100): percent of the time inside the public calls in which no
device operation ran: 100 x (1 - the union of the intervals of the device
operations launched inside the calls / the calls' time).  The
benchmark's plant step between ticks is left out."""


def read(summary, cell):
    if not summary.ops:
        return None
    return 100.0 * (1.0 - summary.busy_in_ticks_ns() / summary.tick_ns)
