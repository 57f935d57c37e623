"""One module a loop, named by the traffic mix's ``loop``.

``<loop>.py`` defines ``due(traffic, j, w0, now)``: the host time
(``time.perf_counter()``) at which tick ``j`` of the window is due, given
the window's start ``w0`` and the time ``now`` at which the previous
tick's plant step ended.  The runner waits until then, starts the tick,
and counts its latency from the time it was due; the window ends at the
first tick due after it closes.
"""
