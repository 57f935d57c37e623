"""The reader of ``solver_replay_share`` on hand-built slices: the
``pint.sqp.replay`` ranges that start inside a public call, a hundred times
a tick."""

from pathlib import Path

import pytest

from portbench import run, trace

ROOT = Path(__file__).resolve().parents[2]
TICKS = [(0, 100), (200, 300), (400, 500), (600, 700)]


def _summary(replays):
    """A slice of four ticks with a ``pint.sqp.replay`` range starting at
    each time of ``replays``, inside the solver's range of its tick."""
    host = [(a, b, "portbench.tick") for a, b in TICKS]
    host += [(a + 10, a + 90, "portbench.solver") for a, _ in TICKS]
    host += [(t, t + 20, "pint.sqp.replay") for t in replays]
    return trace.Summary(TICKS, 0, 700, [], host, 0, 0)


@pytest.mark.parametrize("replays, want", [
    ([20, 220, 420, 620], 100.0),           # one a tick
    ([20, 420], 50.0),                      # every other tick
    ([20, 220, 420, 620, 150, 550], 100.0),  # ranges between the calls do not count
    ([], None),                             # a program that replays no graph
    ([150, 350], None),
])
def test_solver_replay_share_counts_the_replays_inside_the_calls(replays, want):
    read = run.reader(ROOT, "solver_replay_share")
    got = read(_summary(replays), None)
    assert got == (None if want is None else pytest.approx(want))


def test_every_cell_reports_the_share():
    for cell in ("rti_t32-fleet4096", "crti_t32-fleet4096", "rti_t32-fleet16384",
                 "crti_t32-fleet16384"):
        names = [m["name"] for m in run.load_cell(ROOT, cell).per_layer]
        assert "solver_replay_share" in names
