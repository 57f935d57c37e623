"""The port's own trace spans (``utils.profiling.span``) and the serving
layer's host/wait counters, on the CPU.

A tick of ``RTIService`` and of ``ConstrainedRTIService`` under
``torch.profiler`` records each ``pint.*`` span the expected number of
times, every span inside the tick's ``pint.serve.solve`` and no phase
inside another; the spans are host ranges only; ``ServiceStats`` splits
the summed latencies into ``enqueue_s`` and ``wait_s``; and the
benchmark's readers of the spans (``portbench/layers/``) read them from
the summary ``portbench.trace.summarize`` makes of the same profile, and
read nothing from a slice without them."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pint_tpu_torch.utils import profiling
from portbench import run, trace

ROOT = Path(__file__).resolve().parent.parent
SQP_ITERS = 2
TICKS = 2

SERVE = ("pint.serve.solve", "pint.serve.in", "pint.serve.shift", "pint.serve.wait",
         "pint.serve.out")
SQP = ("pint.sqp.linearize", "pint.sqp.propagate", "pint.sqp.reduce",
       "pint.sqp.quantize", "pint.sqp.inner")
# spans a tick: the serving spans once, each phase once an SQP iteration,
# the ALM's scaling twice (the rationals, then the multiplier rescale)
PER_TICK = {
    "rti": {**dict.fromkeys(SERVE, 1), **dict.fromkeys(SQP, SQP_ITERS)},
    "crti": {**dict.fromkeys(SERVE, 1), **dict.fromkeys(SQP, SQP_ITERS),
             "pint.crti.stack": SQP_ITERS, "pint.crti.pen": SQP_ITERS,
             "pint.crti.scale": 2 * SQP_ITERS},
}
METRICS = ("serve_enqueue_ms", "serve_wait_ms", "linearize_host_ms", "propagate_host_ms",
           "reduce_host_ms", "quantize_host_ms", "inner_host_ms", "constrain_host_ms")
# the sizes of tests/test_torch_serving.py, at two SQP iterations a tick
SIZES = {"rti": (8, dict(horizon=32, pgd_iters=30)),
         "crti": (6, dict(horizon=8, pgd_iters=6))}


def _service(kind_name):
    kind = importlib.import_module(f"portbench.kinds.{kind_name}")
    config = json.loads((ROOT / f"portbench/configs/{kind_name}_t32.json").read_text())
    batch, solver = SIZES[kind_name]
    config["solver"] = dict(config["solver"], sqp_iters=SQP_ITERS, **solver)
    if kind_name == "crti":
        config["constraints"] = dict(config["constraints"], alm_outer=2)
    return kind, config, batch, kind.build(config, batch, "cpu")


def _states(config, batch, seed):
    init = config["initial_states"]
    return np.random.default_rng(seed).uniform(init["low"], init["high"], (batch, 3))


def _pint(events):
    return [e for e in events if e.name().startswith("pint.")]


@pytest.fixture(scope="module", params=["rti", "crti"])
def profiled(request):
    """One warm tick, then ``TICKS`` ticks under the profiler, each inside
    the benchmark's ``portbench.tick`` and its solver inside
    ``portbench.solver``, as ``portbench/run.py`` traces them."""
    kind, config, batch, svc = _service(request.param)
    svc.solve(_states(config, batch, 0))
    probe = run.Probe(kind, svc, spans=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(TICKS):
            with torch.profiler.record_function("portbench.tick"):
                svc.solve(_states(config, batch, 1 + t))
    probe.restore()
    events = list(prof.profiler.kineto_results.events())
    return request.param, events, trace.summarize(events, [])


def test_every_span_is_recorded_the_expected_times(profiled):
    kind, events, _ = profiled
    counts = {}
    for e in _pint(events):
        counts[e.name()] = counts.get(e.name(), 0) + 1
    assert counts == {k: TICKS * n for k, n in PER_TICK[kind].items()}


def test_spans_nest_in_the_call_and_phases_are_siblings(profiled):
    _, events, summary = profiled
    iv = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in _pint(events)]
    calls = sorted((a, b) for a, b, n in iv if n == "pint.serve.solve")
    assert len(calls) == TICKS
    for a, b, n in iv:
        assert sum(c0 <= a and b <= c1 for c0, c1 in calls) == 1, n
    parts = sorted((a, b, n) for a, b, n in iv if n != "pint.serve.solve")
    for (a0, b0, n0), (a1, b1, n1) in zip(parts, parts[1:]):
        assert b0 <= a1, (n0, n1)           # no part of a call opens inside another
    solver = [(a, b) for a, b, n in summary.host if n == "portbench.solver"]
    assert len(solver) == TICKS
    phases = [(a, b) for a, b, n in parts if not n.startswith("pint.serve.")]
    assert all(any(s0 <= a and b <= s1 for s0, s1 in solver) for a, b in phases)


def test_spans_are_host_ranges_not_user_annotations(profiled):
    _, events, _ = profiled
    pint = _pint(events)
    assert pint
    assert not any(e.is_user_annotation() for e in pint)
    assert {e.device_type() for e in pint} == {torch.autograd.DeviceType.CPU}
    assert any(e.is_user_annotation() for e in events if e.name() == "portbench.tick")


def test_span_records_nothing_without_a_profiler():
    for _ in range(3):
        with profiling.span("pint.test.outside"):
            torch.ones(4).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "pint.test.outside" not in names and "aten::sum" in names


def test_span_falls_back_to_a_null_context(monkeypatch):
    assert profiling._RecordFunctionFast is torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
    assert profiling.span("pint.a") is profiling.span("pint.b") is profiling._NULL
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("pint.test.fallback"):
            torch.ones(4).sum()
    assert "pint.test.fallback" not in {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("kind_name", ["mpc", "rti", "crti"])
def test_service_stats_split_the_latencies(kind_name):
    if kind_name == "mpc":
        from pint_tpu_torch import MPCService, condense_double_integrator, quantize

        batch = 8
        svc = MPCService(quantize(condense_double_integrator(T=20)), batch=batch,
                         device="cpu")
        rng = np.random.default_rng(3)

        def states(t):
            return np.stack([rng.uniform(-3, 3, batch), rng.uniform(-1, 1, batch)], -1)
    else:
        _, config, batch, svc = _service(kind_name)

        def states(t):
            return _states(config, batch, t)
    lat = []
    for t in range(3):
        svc.solve(states(t))
        lat.append(svc.stats.last_latency_s)
    st = svc.stats
    assert st.ticks == 3 and st.enqueue_s > 0 and st.wait_s > 0
    assert st.enqueue_s + st.wait_s == pytest.approx(sum(lat), abs=1e-6)
    with pytest.raises(ValueError, match="batch"):
        svc.solve(states(3)[:2])
    assert st.ticks == 3 and st.enqueue_s + st.wait_s == pytest.approx(sum(lat), abs=1e-6)


def _read(metric, summary, kind):
    return run.reader(ROOT, metric)(summary, kind)


def _without_spans(summary):
    """The same slice as a program without the spans would record it."""
    return trace.Summary(summary.ticks_iv, summary.t0_ns, summary.t1_ns, summary.ops,
                         [h for h in summary.host if not h[2].startswith("pint.")],
                         summary.unplaced, summary.plant_ns)


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_reads_its_spans_and_nothing_without_them(profiled, metric):
    kind, _, summary = profiled
    v = _read(metric, summary, kind)
    if metric == "constrain_host_ms" and kind == "rti":
        assert v is None
    else:
        assert v is not None and v > 0
    assert _read(metric, _without_spans(summary), kind) is None


def test_readers_account_for_the_call_and_the_solver(profiled):
    kind, _, s = profiled
    enqueue, wait = (_read(m, s, kind) for m in ("serve_enqueue_ms", "serve_wait_ms"))
    assert enqueue + wait == pytest.approx(s.tick_ns / 1e6 / s.ticks, rel=0.02)
    phases = sum(_read(m, s, kind) or 0.0 for m in METRICS[2:])
    solver = sum(b - a for a, b, n in s.host if n == "portbench.solver") / 1e6 / s.ticks
    assert 0.9 * solver <= phases <= solver


def test_idle_gaps_are_labelled_by_the_programs_spans(profiled):
    """A gap whose middle lies in host code of a span, between its
    operations, is named by that span."""
    _, _, s = profiled
    for name, want in (("pint.serve.in", "pint.serve.in"),
                       ("pint.sqp.linearize", "portbench.solver > pint.sqp.linearize")):
        a, b = next((a, b) for a, b, n in s.host if n == name)
        t = a      # the first instant past a + 1 that no shorter host event covers
        for x, y in sorted((x, y) for x, y, n in s.host if a <= x and y <= b and n != name):
            if x > t + 2:
                break
            t = max(t, y)
        assert t + 2 < b
        assert s.label(t + 1, t + 1) == want
