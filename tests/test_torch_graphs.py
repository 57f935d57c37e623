"""The CUDA graph of a solve (``pint_tpu_torch/utils/graphs.py``).

On the CPU, a stand-in for ``torch.cuda.CUDAGraph`` and for the capture
context runs the wrapper's policy without a card: the stand-in records what
the function under capture asks it to replay, over the static buffers, as a
graph replays fixed addresses.  On the card (``-m cuda``), the solves of the
benchmark's T 32 configurations at B 4096 over six warm-started ticks, the
first eager and the rest replays: words and multipliers bit-identical to the
eager iteration tick by tick, the same kernel launches, and a profiled
replay that holds the eager tick's kernels, each placed by the graph's
launch; the same at ``crti_t128``'s T 128 (Tm 256, C 128), where every
stage takes its long form: K3's ``lipq_long_kernel``, K6's and K5's cluster
kernels ``pen_wide_kernel`` and ``alm_wide_kernel``.

This file imports neither jax nor pint_tpu, so the card tests run on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import collections
import contextlib
import gc
import itertools
import re

from pathlib import Path

import numpy as np
import pytest
import torch

from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP, propagate
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.utils import graphs

ROOT = Path(__file__).resolve().parent.parent


# -- the policy, on the CPU, with a stand-in graph -------------------------------


class _Graph:
    """Stand-in for ``torch.cuda.CUDAGraph``: ``replay`` runs what the
    function under capture recorded."""

    recording = None

    def __init__(self):
        self.body = []
        self.replayed = 0

    def replay(self):
        self.replayed += 1
        for step in self.body:
            step()


@contextlib.contextmanager
def _capture(graph):
    _Graph.recording = graph
    try:
        yield
    finally:
        _Graph.recording = None


def _compute(x, y):
    return x * 2 + y, x - y


def _fn(single):
    """A stand-in solve: one launch of K3 and one of K4, then two outputs
    (or the first alone); under capture it records its work over the
    static buffers it was given."""
    calls = []

    def fn(x, y):
        calls.append(_Graph.recording)
        K.count_launch("lipq")
        K.count_launch("pgd_hqt")
        out = _compute(x, y)
        graph = _Graph.recording
        if graph is not None:
            graph.body.append(lambda: [o.copy_(v) for o, v in zip(out, _compute(x, y))])
        return out[0] if single else out

    fn.calls = calls
    return fn


@pytest.fixture
def card(monkeypatch):
    """The wrapper sees its inputs as on a card and captures with the
    stand-ins."""
    monkeypatch.setattr(graphs, "_on_card", lambda args: True)
    monkeypatch.setattr(graphs, "_CUDAGraph", _Graph)
    monkeypatch.setattr(graphs, "_capture", _capture)


def _ins(B, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(-100, 100, (B, 4), generator=g, dtype=torch.int32),
            torch.randint(-100, 100, (B, 4), generator=g, dtype=torch.int32))


def _as_tuple(out):
    return (out,) if isinstance(out, torch.Tensor) else out


def _want(x, y, single):
    out = _compute(x, y)
    return out[:1] if single else out


@pytest.mark.parametrize("single", [True, False])
def test_first_call_eager_second_captures_later_calls_replay(card, single):
    fn = _fn(single)
    w = graphs._Graphed(fn)
    seen = []
    for i in range(5):
        x, y = _ins(8, i)
        out = _as_tuple(w(x, y))
        for o, v in zip(out, _want(x, y, single), strict=True):
            assert torch.equal(o, v)
        seen.append((w.captures, w.replays, len(fn.calls)))
    # eager; capture and its replay; then replays that call nothing of fn's
    assert seen == [(0, 0, 1), (1, 1, 2), (1, 2, 2), (1, 3, 2), (1, 4, 2)]
    assert fn.calls[0] is None and isinstance(fn.calls[1], _Graph)
    (entry,) = [e for e in w._keys.values() if e is not None]
    assert entry.graph.replayed == 4
    x, y = _ins(8, 4)              # the last call's inputs are in the static buffers
    assert all(torch.equal(s, a) for s, a in zip(entry.static_in, (x, y)))


@pytest.mark.parametrize("single", [True, False])
def test_outputs_are_the_callers_own(card, single):
    w = graphs._Graphed(_fn(single))
    outs = []
    for i in range(5):
        x, y = _ins(8, i)
        outs.append((_as_tuple(w(x, y)), _want(x, y, single)))
    (entry,) = [e for e in w._keys.values() if e is not None]
    static = _as_tuple(entry.static_out)
    for got, want in outs:         # later replays overwrote none of them
        for o, v, s in zip(got, want, static, strict=True):
            assert torch.equal(o, v)
            assert o.data_ptr() != s.data_ptr()
            assert all(o.data_ptr() != t.data_ptr() for t in entry.static_in)


def test_each_shape_captures_once_and_the_least_recent_goes(card, monkeypatch):
    monkeypatch.setattr(graphs, "_KEYS", 3)
    w = graphs._Graphed(_fn(False))
    for B in (1, 2, 3, 1, 2, 3, 1, 2, 3):
        w(*_ins(B, B))
    assert w.captures == 3 and w.replays == 6
    assert [k[0][0][0] for k in w._keys] == [1, 2, 3]
    w(*_ins(4, 0))                 # a fourth shape: the batch of 1 goes
    assert [k[0][0][0] for k in w._keys] == [2, 3, 4]
    w(*_ins(1, 0))                 # seen again from the start: eager, no capture
    assert w.captures == 3 and [k[0][0][0] for k in w._keys] == [3, 4, 1]
    w(*_ins(1, 1))
    assert w.captures == 4


@pytest.mark.parametrize("key", ["shape", "dtype"])
def test_a_new_key_is_eager_first(card, key):
    w = graphs._Graphed(_fn(False))
    x, y = _ins(8, 0)
    w(x, y), w(x, y)
    other = (x[:4], y[:4]) if key == "shape" else (x.to(torch.int64), y.to(torch.int64))
    w(*other)
    assert w.captures == 1 and w.replays == 1
    w(*other)
    assert w.captures == 2 and w.replays == 2


def test_replays_add_the_captured_kernel_launches_and_nothing_else(card):
    w = graphs._Graphed(_fn(False))
    K.reset_launch_counts()
    keys = set(K.launch_counts())
    per_call = []
    for i in range(5):
        before = K.launch_counts()
        w(*_ins(8, i))
        after = K.launch_counts()
        per_call.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
    assert per_call == [{"lipq": 1, "pgd_hqt": 1}] * 5
    assert set(K.launch_counts()) == keys
    K.reset_launch_counts()


def test_replays_add_the_chain_kernels_launches_apart(card):
    """A replay adds the launches of the chain's kernel its capture
    recorded, to ``propagate.launch_count()`` and not to
    ``launch_counts()``."""
    def fn(x, y):
        K.count_launch("propagate")
        return _compute(x, y)

    w = graphs._Graphed(fn)
    for i in range(4):
        before, chain_before = K.launch_counts(), propagate.launch_count()
        w(*_ins(8, i))
        assert K.launch_counts() == before
        assert propagate.launch_count() - chain_before == 1
    assert w.captures == 1 and w.replays == 3


@pytest.mark.parametrize("calls", [1, 2, 5])
def test_on_the_cpu_fn_runs_directly(monkeypatch, calls):
    monkeypatch.setattr(graphs, "_CUDAGraph", None)      # never reached
    monkeypatch.setattr(graphs, "_capture", None)
    fn = _fn(False)
    w = graphs._Graphed(fn)
    for i in range(calls):
        x, y = _ins(8, i)
        out = w(x, y)
        assert all(torch.equal(o, v) for o, v in zip(out, _compute(x, y), strict=True))
    assert fn.calls == [None] * calls
    assert w.captures == 0 and w.replays == 0


def test_a_capture_that_fails_raises(card):
    def fn(x, y):
        if _Graph.recording is not None:
            raise RuntimeError("operation not permitted when stream is capturing")
        return x + y

    w = graphs._Graphed(fn)
    x, y = _ins(8, 0)
    w(x, y)
    with pytest.raises(RuntimeError, match="capturing"):
        w(x, y)
    assert w.captures == 0 and w.replays == 0


def test_a_graph_in_cyclic_garbage_is_not_destroyed_inside_a_capture(card, monkeypatch):
    """A solver dropped in a reference cycle (a solver and its wrapper refer
    to each other) keeps its graph until the cyclic collector runs; on the
    card a graph destroyed while another captures invalidates that capture.
    A collection the capture's own allocations set off is stood in for by
    one the captured function makes; the automatic collector is off, so
    only the wrapper's own collection can come first."""
    destroyed = []

    class _Held(_Graph):
        def __del__(self):
            destroyed.append(_Graph.recording is not None)

    monkeypatch.setattr(graphs, "_CUDAGraph", _Held)

    def collecting():
        inner = _fn(False)

        def fn(x, y):
            if _Graph.recording is not None:
                gc.collect()
            return inner(x, y)

        return fn

    was = gc.isenabled()
    gc.disable()
    try:
        holder = {"w": graphs._Graphed(collecting())}
        holder["self"] = holder
        for i in range(2):
            holder["w"](*_ins(8, i))
        assert holder["w"].captures == 1
        del holder
        w = graphs._Graphed(collecting())
        for i in range(2):
            w(*_ins(8, i))
    finally:
        if was:
            gc.enable()
    assert w.captures == 1
    assert destroyed == [False]


def _share_of(w, ticks):
    """``solver_replay_share`` read from a CPU profile of ``ticks`` calls
    of ``w``, traced as ``portbench/run.py`` traces its ticks."""
    from portbench import run, trace

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(ticks):
            with torch.profiler.record_function("portbench.tick"):
                with torch.profiler.record_function("portbench.solver"):
                    w(*_ins(8, i))
    summary = trace.summarize(prof.profiler.kineto_results.events(), [])
    assert summary.ticks == ticks
    return run.reader(ROOT, "solver_replay_share")(summary, None)


def test_each_replay_is_one_span_the_benchmark_reads(card):
    w = graphs._Graphed(_fn(False))
    assert _share_of(w, 1) is None                 # eager: no replay
    assert _share_of(w, 2) == pytest.approx(100.0)  # the capture's replay, then one
    assert w.replays == 2
    w = graphs._Graphed(_fn(False))
    assert _share_of(w, 4) == pytest.approx(75.0)   # eager, then three replays


KW = dict(horizon=8, sqp_iters=2, pgd_iters=6, x_ref=np.array([1.0, 0.0, 0.0]))
CON = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0)


def _x0(B, seed, lo=-np.pi, hi=np.pi):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(lo, hi, B)], -1).astype(np.float32)


@pytest.mark.parametrize("kind", ["rti", "crti"])
def test_the_cpu_solvers_stay_eager(kind):
    """Both solvers' ``solve_words`` on the CPU run the iteration as it
    was, every call: the same answer as ``_iterate``, no capture."""
    sqp = DeviceSQP(**KW, device="cpu")
    solver = sqp if kind == "rti" else DeviceConstrainedSQP(sqp, alm_outer=2, **CON)
    words = solver.init_words(3)
    for i in range(3):
        x0 = torch.as_tensor(_x0(3, i))
        if kind == "rti":
            got = (solver.solve_words(words, x0),)
            want = (sqp._iterate(words, x0, lambda lanes: lanes, sqp._run_inner),)
        else:
            lam = solver.init_lam(3)
            got = solver.solve_words(words, x0, lam)
            want = solver._iterate(words, x0, lam, lambda lanes: lanes, solver._run_inner)
        assert all(torch.equal(g, v) for g, v in zip(got, want, strict=True))
        words = got[0]
    assert solver._graphed.captures == 0 and solver._graphed.replays == 0


# -- on the card ----------------------------------------------------------------

SQP_CELLS = {
    "rti": dict(horizon=32, sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
                Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]), qf_scale=60.0,
                x_ref=np.array([0.2, 0.1, 0.0])),
    "crti": dict(horizon=32, sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
                 Q=np.diag([1.0, 1.0, 0.02]), R=np.diag([0.02, 0.02]), qf_scale=20.0,
                 x_ref=np.array([1.0, 0.0, 0.0])),
}
SQP_CELLS["crti_t128"] = dict(SQP_CELLS["crti"], horizon=128)
"""The benchmark's ``rti_t32``, ``crti_t32`` and ``crti_t128`` configurations."""
STATES = {"rti": (0.0, 1.0), "crti": (-np.pi, np.pi), "crti_t128": (-np.pi, np.pi)}
KINDS = ["rti", "crti", "crti_t128"]
PORT_KERNELS = {"rti": {"propagate_kernel", "lipq_reg_kernel", "pgd_hqt_kernel"},
                "crti": {"propagate_kernel", "lipq_reg_kernel", "pen_reg_kernel",
                         "alm_reg_kernel"},
                "crti_t128": {"propagate_kernel", "lipq_long_kernel", "pen_wide_kernel",
                              "alm_wide_kernel"}}
"""The port's kernels a tick of each configuration runs: the unicycle's
chain (rollout, linearization and recursion), then the register designs at
T 32, the long designs past 64 lanes."""
B_CARD = 4096
TICKS = 6


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _solver(kind, device):
    sqp = DeviceSQP(**SQP_CELLS[kind], device=device)
    if kind == "rti":
        return sqp
    return DeviceConstrainedSQP(sqp, rho=100.0, alm_outer=3, row_pad=64,
                                F=np.array([[0.0, 1.0, 0.0]]), lo=-0.03, hi=0.03)


def _eager(kind, solver, state):
    """The iteration as it runs without the graph."""
    if kind == "rti":
        return (solver._iterate(*state, lambda lanes: lanes, solver._run_inner),)
    return solver._iterate(*state, lambda lanes: lanes, solver._run_inner)


def _graphed(kind, solver, state):
    return _as_tuple(solver.solve_words(*state))


def _ticks(kind, solver, device, B=B_CARD):
    """The warm-started states of TICKS ticks (the plan shifted one step,
    the multipliers one block), each tick's from the graphed answer."""
    state = [solver.init_words(B), None,
             *(() if kind == "rti" else (solver.init_lam(B),))]
    for i in range(TICKS):
        state[1] = torch.as_tensor(_x0(B, 100 + i, *STATES[kind]), device=device)
        yield tuple(state)
        out = _graphed(kind, solver, state)
        state[0] = torch.roll(out[0], -1, dims=1)
        if kind != "rti":
            state[2] = torch.roll(out[1], -1, dims=1)


def _counts_of(call):
    before = K.launch_counts()
    out = call()
    torch.cuda.synchronize()
    after = K.launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_replays_are_bit_identical_to_the_eager_iteration(cuda, kind):
    solver = _solver(kind, cuda)
    want_launches = ({"lipq": 1, "pgd_hqt": 1} if kind == "rti"
                     else {"lipq": 1, "pen": 1, "alm": 1})
    state = [solver.init_words(B_CARD), None,
             *(() if kind == "rti" else (solver.init_lam(B_CARD),))]
    for i in range(TICKS):
        state[1] = torch.as_tensor(_x0(B_CARD, 100 + i, *STATES[kind]), device=cuda)
        want, eager_counts = _counts_of(lambda: _eager(kind, solver, state))
        got, counts = _counts_of(lambda: _graphed(kind, solver, state))
        assert eager_counts == counts == want_launches
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), f"tick {i}"
        state[0] = torch.roll(got[0], -1, dims=1)
        if kind != "rti":
            state[2] = torch.roll(got[1], -1, dims=1)
    assert solver._graphed.captures == 1 and solver._graphed.replays == TICKS - 1


def _device_kernels(call):
    """(kernel names, each kernel's launching runtime call) of one call
    profiled on the card; copies and fills left out."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    runtime, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.name().startswith(("Memcpy", "Memset")):
                kernels.append((e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.name()
    return [n for n, _ in kernels], [runtime.get(c) for _, c in kernels]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_a_profiled_replay_holds_the_eager_kernels(cuda, kind):
    """Profiled after the graph was made, as the benchmark's traced slice
    is: a replay's kernels appear one by one, the eager tick's names and
    number, each carrying the graph launch's correlation id; of the port's
    own kernels, the designs of the configuration's shapes and no other."""
    from portbench import trace

    solver = _solver(kind, cuda)
    states = list(itertools.islice(_ticks(kind, solver, cuda), 3))   # eager, capture
    assert solver._graphed.captures == 1
    eager, _ = _device_kernels(lambda: _eager(kind, solver, states[-1]))
    replay, launched_by = _device_kernels(lambda: _graphed(kind, solver, states[-1]))
    assert solver._graphed.replays == 2
    assert collections.Counter(replay) == collections.Counter(eager)
    assert launched_by and all(c and c.startswith("cudaGraphLaunch") for c in launched_by)
    names = trace.port_kernels(ROOT / "pint_tpu_torch" / "csrc")
    port = {n for k in replay for n in names if re.search(rf"\b{n}\b", k)}
    assert port == PORT_KERNELS[kind]


@pytest.mark.cuda
def test_a_batch_change_recaptures(cuda):
    solver = _solver("rti", cuda)
    for B in (B_CARD, B_CARD, B_CARD // 2, B_CARD // 2, B_CARD):
        x0 = torch.as_tensor(_x0(B, B, *STATES["rti"]), device=cuda)
        solver.solve_words(solver.init_words(B), x0)
    assert solver._graphed.captures == 2 and solver._graphed.replays == 3
