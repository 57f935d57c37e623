"""The benchmark's ``crti_t128`` configuration on the CPU: the long-horizon
constrained fleet (``ConstrainedRTIService`` at T 128: Tm 256, C 128, Cp 128).

The port's CPU path (the plain versions of K3, K6 and K5) agrees with the
plain reference (``portbench/reference/crti.py``) under the limits that
``portbench/configs/crti_t128.json`` calibrated on the card, over a counted
number of ticks at batch 8; the same check fails when a lane of every
answer is altered inside the timed path; and the kernels' work at the
cell's shapes is the shapes the solver hands its kernels, in the order the
long forms take (problem-major), with the benchmark's frozen cost
arithmetic equal to the port's.

The CPU path reads higher than the card's (``PERF.md`` §2): torch's CPU
contractions add in another order than cuBLAS, and at batch 8 one problem
is 12.5% of the first tick's rows.  So the check runs 16 ticks (128 sampled
problems, 8 carried pairs).  This file imports neither jax nor pint_tpu.
"""

import functools
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import costs, run

ROOT = Path(__file__).resolve().parent.parent
CELL = "crti_t128-fleet4096"
SEED = 2**31 + 977
TICKS = 16


def _counted(n):
    """The cell at batch 8 whose window is ``n`` ticks, not a time."""
    cell = run.load_cell(ROOT, CELL)
    cell.traffic = dict(cell.traffic, batch=8)
    cell.loop = types.SimpleNamespace(due=lambda traffic, j, w0, now: now if j < n else math.inf)
    return cell


@pytest.fixture
def every_tick_sampled(monkeypatch):
    """Sample every pair of ticks, so that a short CPU window holds some."""
    monkeypatch.setattr(run, "SAMPLE_PERIOD", 2)


def test_the_cell_loads_by_name():
    cell = run.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["batch"] == 4096
    assert cell.config["solver"]["horizon"] == 128 and cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"tick_p95_ms", "plants_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "serve_launches_per_tick", "solver_launches_per_tick", "condense_device_ms",
        "kernels_device_ms", "kernels_roofline", "device_idle_share", "serve_enqueue_ms",
        "serve_wait_ms", "solver_replay_share", "lipq_roofline", "pen_roofline",
        "alm_roofline", "propagate_device_ms", "reduce_device_ms", "chain_roofline",
        "stack_device_ms", "serve_in_clock_ms", "solver_call_clock_ms",
        "graph_launch_clock_ms", "serve_shift_clock_ms", "serve_wait_clock_ms",
        "serve_out_clock_ms", "device_idle_clock_share", "quantize_clock_device_ms",
        "inner_clock_device_ms", "scale_clock_device_ms"}
    for m in cell.per_layer:
        assert callable(run.reader(ROOT, m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_the_ports_cpu_path_agrees_with_the_reference(every_tick_sampled):
    keep = {}
    res = run.run_cell(_counted(TICKS), SEED, 1e9, False, "cpu", keep=keep)
    for k, c in res["checks"].items():
        print(f"{k} = {c['value']!r} (limit {c['limit']!r})")
    assert res["correct"], res["checks"]
    assert len(keep["steps"]) == TICKS and len(keep["pairs"]) == TICKS // 2
    assert res["failed"] == 0 and res["attempted"] == 8 * TICKS


def _answer_altered(kind):
    """``kind`` whose solver alters lane 0 of every answer where it is made,
    so inside the runner's wrapper of ``solve_words``."""
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls

    def build(config, batch, device):
        service = kind.build(config, batch, device)
        sol = kind.solver(service)
        orig = sol.solve_words

        @functools.wraps(orig)         # the runner binds the warm state by name
        def solve_words(*a, **k):
            words, lam = orig(*a, **k)
            lanes = unpack_controls(words)
            lanes[:, 0] = torch.where(lanes[:, 0] < 127, lanes[:, 0] + 1, lanes[:, 0] - 1)
            return pack_controls(lanes), lam

        object.__setattr__(sol, "solve_words", solve_words)
        return service

    members = {k: getattr(kind, k) for k in dir(kind) if not k.startswith("__")}
    return types.SimpleNamespace(**dict(members, build=build))


def test_the_check_fails_an_altered_answer(every_tick_sampled):
    cell = _counted(4)
    cell.kind = _answer_altered(cell.kind)
    keep = {}
    res = run.run_cell(cell, SEED, 1e9, False, "cpu", keep=keep)
    assert len(keep["pairs"]) == 2
    assert not res["correct"], res["checks"]
    assert res["checks"]["plan_diff_pct"]["value"] > res["checks"]["plan_diff_pct"]["limit"]


def test_the_work_is_the_shapes_the_solver_launches():
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.ops import kernels as K
    from pint_tpu_torch.utils import profiling as P

    cell = run.load_cell(ROOT, CELL)
    work = cell.kind.work(cell.config, 4096)
    assert work == [("lipq", dict(B=4096, Tm=256, power_iters=16)),
                    ("pen", dict(B=4096, C=128, Tm=256, power_iters=16)),
                    ("alm", dict(B=4096, Tp=256, Cp=128, outer=3, inners=30))]
    assert [k for k, _ in work] == list(cell.kind.LAUNCHES)
    for kernel, shape in work:
        mine, theirs = costs.kernel_cost(kernel, **shape), P.kernel_cost(kernel, **shape)
        assert (mine.bytes, mine.ops, mine.op_type) == (theirs.bytes, theirs.ops, theirs.op_type)
        assert costs.bound_ms(mine) == P.bound_ms(theirs)

    B = 8
    csqp = cell.kind.solver(cell.kind.build(cell.config, B, "cpu"))
    assert (csqp.dev.n_dec, csqp.n_rows, csqp.padded_rows) == (256, 128, 128)
    assert csqp.forms == dict(chain="fused", reduce="kernel", stack="kernel",
                              condense="lipq", constraints="pen", inner="alm")
    rng = np.random.default_rng(0)
    box = cell.config["initial_states"]
    x0 = torch.as_tensor(rng.uniform(box["low"], box["high"], (B, 3)), dtype=torch.float32)
    lanes = unpack_controls(csqp.init_words(B))[:, :256]
    ops, _ = csqp._condense_constrained_dev(x0, lanes)
    # K3's hqt, K6's rows in both orientations: what K5 reads, problem-major
    assert tuple(ops["hqt"].shape) == (256, 256, B) and K.problem_major(ops["hqt"], 1)
    assert tuple(ops["sqc"].shape) == (128, 256, B) and K.problem_major(ops["sqc"], 0)
    assert tuple(ops["sqj"].shape) == (256, 128, B) and K.problem_major(ops["sqj"], 0)
    assert tuple(ops["g_pre"].shape) == (B, 256) and tuple(ops["c_off"].shape) == (B, 128)
