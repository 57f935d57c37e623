"""Solver: CUDA graph launch (the phase clock, untraced): the median host
milliseconds a tick in ``graph.replay()`` alone, the launch of the solve's
graph, over the window's last ticks, which no profiler saw."""

from portbench import clocks


def read(summary, cell):
    return clocks.host_phase_ms("launch")
