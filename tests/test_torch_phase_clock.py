"""The serving layer's phase clocks (``serving.ServiceStats``,
``utils.profiling``) on the CPU.

Every tick of each of the four services writes one row of stamps to its
ring; the phases of a row add up to the call; ``enqueue_s`` and
``wait_s`` are sums of the same stamps; a tick under ``torch.profiler``
goes to the profiled ring alone; the ring keeps the last 1,024 ticks; a
tick's stamps line up with its ``pint.serve.*`` ranges in a CPU trace;
without a card the device clock records nothing; ``profiling.clocks()``
forgets a freed service; and the benchmark's readers of the clocks
(``portbench/layers/``) read them, and read nothing from a program
without them or from a clock with no tick.  With stand-ins for the card's
graph and clock, the graph wrapper keeps a clocked variant of a shape
beside the plain one, captured at once over the plain one's inputs and
pool, whose event pairs go to the clock at each replay."""

import contextlib
import gc
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pint_tpu_torch import MPCService, condense_double_integrator, quantize
from pint_tpu_torch.serving import PHASES, RING, ServiceStats
from pint_tpu_torch.utils import graphs, profiling
from portbench import run, trace

ROOT = Path(__file__).resolve().parent.parent
ACTS = [torch.profiler.ProfilerActivity.CPU]
# small sizes of each service on the CPU
SIZES = {"rti": (4, dict(horizon=8, pgd_iters=4)),
         "crti": (4, dict(horizon=8, pgd_iters=4)),
         "mppi": (2, dict(horizon=6, samples=8))}
CONFIGS = {"rti": "rti_t32", "crti": "crti_t32", "mppi": "mppi_t50"}


def _mpc(batch=4, T=6):
    return MPCService(quantize(condense_double_integrator(T=T)), batch=batch, device="cpu")


def _service(name):
    """A service of each kind, and a draw of its states from a seed."""
    if name == "mpc":
        svc = _mpc()
        return svc, lambda seed: np.random.default_rng(seed).uniform(-1, 1, (4, 2))
    kind = importlib.import_module(f"portbench.kinds.{name}")
    config = json.loads((ROOT / f"portbench/configs/{CONFIGS[name]}.json").read_text())
    batch, solver = SIZES[name]
    config["solver"] = dict(config["solver"], **solver)
    if name == "crti":
        config["constraints"] = dict(config["constraints"], alm_outer=1)
    init = config["initial_states"]
    svc = kind.build(config, batch, "cpu")
    return svc, lambda seed: np.random.default_rng(seed).uniform(
        init["low"], init["high"], (batch, len(init["low"])))


SERVICES = ["mpc", "rti", "crti", "mppi"]


@pytest.mark.parametrize("name", SERVICES)
def test_one_ring_row_a_tick(name):
    svc, states = _service(name)
    for t in range(3):
        svc.solve(states(t))
        assert svc.stats.rows == [t + 1, 0]
    rows = svc.stats.phase_rows()
    assert rows.shape == (3, 1 + len(PHASES))
    assert (rows[:, 1:] >= 0).all() and (np.diff(rows[:, 0]) > 0).all()
    with pytest.raises(ValueError, match="batch"):
        svc.solve(states(3)[:1])
    assert svc.stats.rows == [3, 0]           # a tick that raised leaves no row


@pytest.mark.parametrize("name", SERVICES)
def test_the_phases_of_a_row_add_up_to_the_call(name):
    svc, states = _service(name)
    st = svc.stats
    for t in range(3):
        svc.solve(states(t))
        raw = st.rings[False][t]
        row = st.phase_rows()[-1]
        ph = dict(zip(PHASES, row[1:]))
        assert ph["in"] + ph["call"] + ph["shift"] + ph["wait"] + ph["out"] == raw[5] - raw[0]
        assert ph["in"] + ph["call"] + ph["shift"] + ph["wait"] == raw[4] - raw[0]
        assert abs((raw[4] - raw[0]) - st.last_latency_s * 1e9) < 1
        assert ph["launch"] == 0             # no graph on the CPU
        assert row[0] == raw[0] + profiling.PROFILER_CLOCK_NS


@pytest.mark.parametrize("name", SERVICES)
def test_enqueue_and_wait_are_sums_of_the_stamps(name):
    svc, states = _service(name)
    for t in range(4):
        svc.solve(states(t))
    rows = svc.stats.phase_rows()
    enqueue = rows[:, [1, 2, 4]].sum() / 1e9
    assert svc.stats.enqueue_s == pytest.approx(enqueue, abs=1e-9)
    assert svc.stats.wait_s == pytest.approx(rows[:, 5].sum() / 1e9, abs=1e-9)
    assert svc.stats.ticks == 4


@pytest.mark.parametrize("deadline_s, misses", [(0.0, 3), (60.0, 0), (None, 0)])
def test_a_tick_over_its_deadline_counts_a_miss(deadline_s, misses):
    svc = _mpc()
    svc.deadline_s = deadline_s
    for t in range(3):
        svc.solve(np.zeros((4, 2)))
    assert svc.stats.deadline_misses == misses and svc.stats.ticks == 3


def test_a_profiled_tick_goes_to_the_profiled_ring_alone():
    svc, states = _service("rti")
    svc.solve(states(0))
    with torch.profiler.profile(activities=ACTS):
        svc.solve(states(1))
        svc.solve(states(2))
    svc.solve(states(3))
    st = svc.stats
    assert st.rows == [2, 2] and st.ticks == 4
    assert len(st.phase_rows()) == 2 and len(st.phase_rows(profiled=True)) == 2
    assert set(st.phase_ms(profiled=True)) == set(PHASES)
    assert ServiceStats().phase_ms() is None


def test_the_ring_keeps_the_last_1024_ticks():
    svc = _mpc(batch=1, T=2)
    x = np.zeros((1, 2))
    for _ in range(RING + 7):
        svc.solve(x)
    rows = svc.stats.phase_rows()
    assert len(svc.stats.rings[False]) == RING and svc.stats.rows[False] == RING + 7
    assert rows.shape == (RING, 1 + len(PHASES))
    assert (np.diff(rows[:, 0]) > 0).all()    # oldest first, the first 7 gone
    assert rows[0, 0] == svc.stats.rings[False][7][0] + profiling.PROFILER_CLOCK_NS


def test_a_ticks_stamps_line_up_with_its_spans_in_a_cpu_trace():
    svc, states = _service("rti")
    svc.solve(states(0))
    with torch.profiler.profile(activities=ACTS) as prof:
        for t in range(3):
            svc.solve(states(1 + t))
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("pint.serve."):
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    rows = svc.stats.phase_rows(profiled=True)
    assert len(rows) == 3
    for i, (t0, d_in, d_call, _, d_shift, d_wait, d_out) in enumerate(rows):
        in_end = t0 + d_in
        wait_start = in_end + d_call + d_shift
        wait_end = wait_start + d_wait
        want = {"pint.serve.in": (t0, in_end), "pint.serve.wait": (wait_start, wait_end),
                "pint.serve.out": (wait_end, wait_end + d_out)}
        for name, (a, b) in want.items():
            sa, sb = spans[name][i]
            assert abs(sa - a) < 20_000 and abs(sb - b) < 20_000, (name, sa - a, sb - b)
        sa, sb = spans["pint.serve.solve"][i]
        assert sa <= t0 + 20_000 and wait_end + d_out <= sb + 20_000


def test_without_a_card_the_device_clock_records_nothing():
    svc, states = _service("crti")
    svc.stats.device_every = 1
    svc.solve(states(0))
    with torch.profiler.profile(activities=ACTS):
        svc.solve(states(1))
    st = svc.stats
    assert st.device_ticks == [0, 0] and st.device_ms == ({}, {})
    assert not st.offsets_ns and not st.device_spans and st.offset_us() is None
    assert st.device_phase_ms("pint.sqp.inner") is None
    assert profiling.device_clock() is None
    assert not profiling.DEVICE_CLOCK.pairs


class _Stream:
    def __init__(self, device):
        self.device = device


class _StubClock:
    """Stand-in for ``profiling.DEVICE_CLOCK``: the stream it was started
    on, and a copy back that hands the lanes over as they are."""

    def __init__(self):
        self.streams = []
        self.fetched = 0

    def start(self, stream):
        self.streams.append(stream)
        return self

    def fetch(self, lanes):
        self.fetched += 1
        return lanes.numpy(), "anchor"

    def stop(self):
        pass

    def read(self, anchor, anchor_ns):
        assert anchor == "anchor"
        return {"pint.serve.solve": 1.0}, [], 0


def test_the_device_clock_runs_on_the_services_own_stream(monkeypatch):
    """A clocked tick starts the clock on the current stream of the
    service's device, not of the current device, so the copy back and the
    anchor event share the stream that issued the tick's work; the tick's
    row goes to the instrumented ring."""
    svc = _mpc()
    plain = _mpc()
    asked = []

    def current_stream(device=None):
        asked.append(device)
        return _Stream(device)

    stub = _StubClock()
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(profiling, "DEVICE_CLOCK", stub)
    svc._on_card = True                       # a stand-in for a service on a card
    svc.stats.device_every = 2
    for t in range(4):
        x = np.random.default_rng(t).uniform(-1, 1, (4, 2))
        np.testing.assert_array_equal(svc.solve(x), plain.solve(x))
    assert asked == [svc._zero[0].device] * 2
    assert [s.device for s in stub.streams] == asked and stub.fetched == 2
    assert svc.stats.rows == [2, 2] and svc.stats.device_ticks == [2, 0]
    assert svc.stats.device_phase_ms("pint.serve.solve", profiled=False) == 1.0


def test_the_stats_take_only_their_counters_as_arguments():
    st = ServiceStats(resets=1, deadline_misses=2, enqueue_ns=5, wait_ns=6, device_every=4)
    assert (st.ticks, st.resets, st.device_every, st.rows) == (0, 1, 4, [0, 0])
    for name in ("ticks", "rings", "rows", "device_ms", "device_ticks", "device_spans",
                 "offsets_ns"):
        with pytest.raises(TypeError):
            ServiceStats(**{name: None})


def test_span_is_the_plain_range_while_the_device_clock_is_off():
    assert profiling.device_clock() is None
    assert type(profiling.span("pint.a")) is torch._C._profiler._RecordFunctionFast


def test_clocks_forget_a_freed_service():
    svc = _mpc()
    st = svc.stats
    assert any(c is st for c in profiling.clocks())
    svc.solve(np.zeros((4, 2)))
    del svc
    gc.collect()
    assert not any(c is st for c in profiling.clocks())
    assert st.ticks == 1                      # the clock itself outlives the service


# -- the benchmark's readers of the clocks ---------------------------------------

READERS = {
    # metric: (what its clock holds, the value it reads)
    "serve_in_clock_ms": ("host", 1.0),
    "solver_call_clock_ms": ("host", 2.0),
    "graph_launch_clock_ms": ("host", 0.5),
    "serve_shift_clock_ms": ("host", 3.0),
    "serve_wait_clock_ms": ("host", 4.0),
    "serve_out_clock_ms": ("host", 5.0),
    "device_idle_clock_share": ("host", 100.0 * (1 - 3.0 / 15.0)),
    "quantize_clock_device_ms": ("device", 0.25),
    "inner_clock_device_ms": ("device", 1.5),
    "scale_clock_device_ms": ("device", 0.75),
    "mppi_sample_device_ms": ("device", 6.0),
}
SPANS = {"quantize_clock_device_ms": "pint.sqp.quantize",
         "inner_clock_device_ms": "pint.sqp.inner",
         "scale_clock_device_ms": "pint.crti.scale",
         "mppi_sample_device_ms": "pint.mppi.sample"}


def _put(st, row, ring):
    """A row in one of a clock's rings, as a tick writes it."""
    n = st.rows[ring]
    st.rings[ring][n % RING] = row
    st.rows[ring] = n + 1


def _clock(ticks=5):
    """A phase clock of ``ticks`` ticks of 1, 2 (0.5 of it the launch),
    3, 4 and 5 ms, and as many profiled ticks whose device clock read
    each span's value a tick."""
    st = ServiceStats()
    ms = 1_000_000
    t = 10 * ms
    for i in range(ticks):
        stamps = np.cumsum([t, 1 * ms, 2 * ms, 3 * ms, 4 * ms, 5 * ms])
        _put(st, (*map(int, stamps), ms // 2), False)
        _put(st, (*map(int, stamps), ms // 2), True)
        st.record_device(({s: READERS[m][1] for m, s in SPANS.items()}, [], 1000 + i), True)
        t += 20 * ms
    return st


def _summary(ticks=2):
    """A traced slice whose device ran 3 ms a tick inside the calls."""
    ms = 1_000_000
    ivs = [(i * 20 * ms, i * 20 * ms + 16 * ms) for i in range(ticks)]
    ops = [trace.DeviceOp("k", a + ms, a + 4 * ms, "solver", True) for a, _ in ivs]
    return trace.Summary(ivs, ivs[0][0], ivs[-1][1], ops, [], 0, 0)


@pytest.fixture
def registry(monkeypatch):
    """``profiling.clocks()`` holding the clocks the test puts in it."""
    live = []
    monkeypatch.setattr(profiling, "clocks", lambda: live)
    return live


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_clock_reader_reads_its_counter_and_nothing_without_it(registry, monkeypatch,
                                                                     metric):
    read = run.reader(ROOT, metric)
    summary = _summary()
    st = _clock()
    assert read(summary, None) is None             # no live service
    registry.append(st)
    assert read(summary, None) == pytest.approx(READERS[metric][1], rel=1e-12)
    idle = ServiceStats()                          # a live clock with no tick
    registry.clear()
    registry.append(idle)
    assert read(summary, None) is None
    registry.append(st)
    monkeypatch.delattr(profiling, "clocks")        # a program without the clocks
    assert read(summary, None) is None


def test_the_device_clock_readers_need_profiled_ticks(registry):
    st = ServiceStats()
    ms = 1_000_000
    _put(st, (0, ms, 2 * ms, 3 * ms, 4 * ms, 5 * ms, 0), False)
    st.record_device(({"pint.sqp.inner": 1.0}, [], 0), False)   # a device_every tick
    registry.append(st)
    assert run.reader(ROOT, "inner_clock_device_ms")(_summary(), None) is None
    assert st.device_phase_ms("pint.sqp.inner", profiled=False) == 1.0
    assert st.offset_us() == (0.0, 0.0)


# -- the clocked graph variant, with stand-ins for the card ----------------------


class _Graph:
    """Stand-in for ``torch.cuda.CUDAGraph``: ``replay`` runs what the
    function under capture recorded; ``pool`` names it."""

    recording = None

    def __init__(self):
        self.body = []
        self.pool_of = None

    def pool(self):
        return ("pool", id(self))

    def replay(self):
        for step in self.body:
            step()


@contextlib.contextmanager
def _capture(graph, pool=None):
    graph.pool_of = pool
    _Graph.recording = graph
    try:
        yield
    finally:
        _Graph.recording = None


class _Clock:
    def __init__(self):
        self.pairs = []
        self.captured = 0

    def record(self):
        return object()

    @contextlib.contextmanager
    def capturing(self):
        self.captured += 1
        yield


@pytest.fixture
def card(monkeypatch):
    """The wrapper sees its inputs as on a card and captures with the
    stand-ins; ``card(clock)`` turns the stand-in clock on, ``card(None)``
    off."""
    monkeypatch.setattr(graphs, "_on_card", lambda args: True)
    monkeypatch.setattr(graphs, "_CUDAGraph", _Graph)
    monkeypatch.setattr(graphs, "_capture", _capture)
    return lambda clock: monkeypatch.setattr(profiling, "_ACTIVE", clock)


def _fn():
    """A stand-in solve with one span: under the clock it records a pair;
    under capture, its work over the static buffers it was given."""
    calls = []

    def fn(x, y):
        calls.append(_Graph.recording)
        clock = profiling.device_clock()
        if clock is not None:
            clock.pairs.append(("pint.sqp.inner", object(), object()))
        out = x * 2 + y
        if _Graph.recording is not None:
            _Graph.recording.body.append(lambda: out.copy_(x * 2 + y))
        return out

    fn.calls = calls
    return fn


def test_the_clocked_variant_captures_at_once_over_the_plain_graph(card):
    fn = _fn()
    w = graphs._Graphed(fn)
    clock = _Clock()
    seen = []
    for i, on in enumerate([False, False, True, True, False, True]):
        card(clock if on else None)
        clock.pairs.clear()
        x, y = torch.full((3,), float(i)), torch.ones(3)
        assert torch.equal(w(x, y), x * 2 + y)
        names = [p[0] for p in clock.pairs]
        seen.append((w.captures, w.replays, len(fn.calls), names.count("pint.sqp.inner"),
                     names.count("pint.sqp.replay")))
    # eager; the plain capture; the clocked capture at once, its pair
    # handed back by its replay, and the replay's own span timed; then
    # replays of either variant
    assert seen == [(0, 0, 1, 0, 0), (1, 1, 2, 0, 0), (2, 2, 3, 1, 1), (2, 3, 3, 1, 1),
                    (2, 4, 3, 0, 0), (2, 5, 3, 1, 1)]
    entries = {key[-1] == graphs._CLOCKED: e for key, e in w._keys.items()}
    plain, clocked = entries[False], entries[True]
    assert plain.events == () and len(clocked.events) == 1 and clock.captured == 1
    assert clocked.static_in is plain.static_in
    assert clocked.graph.pool_of == plain.graph.pool() and plain.graph.pool_of is None


def test_a_shape_first_seen_under_the_clock_is_eager_first(card):
    fn = _fn()
    w = graphs._Graphed(fn)
    card(_Clock())
    x, y = torch.ones(2), torch.ones(2)
    for _ in range(3):
        assert torch.equal(w(x, y), x * 2 + y)
    assert (w.captures, w.replays, len(fn.calls)) == (1, 2, 2)
    card(None)                           # the plain variant captures at once
    assert torch.equal(w(x, y), x * 2 + y)
    assert (w.captures, w.replays, len(fn.calls)) == (2, 3, 3)
