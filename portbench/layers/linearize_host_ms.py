"""Solver: linearize (``DeviceSQP._linearize_phase``: ``rollout_f32``,
``linearize_f32``, ``c_seq``): host milliseconds a tick in the
``pint.sqp.linearize`` ranges."""

from portbench import spans


def read(summary, cell):
    return spans.per_tick_ms(summary, ["pint.sqp.linearize"])
