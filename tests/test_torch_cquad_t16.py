"""The benchmark's ``cquad_t16`` configuration on the CPU: the constrained
planar-quadrotor fleet (``ConstrainedRTIService`` over the six-state
birotor at T 16: Tm 32, C 16, Cp 64).

The cell loads by name with the metrics it reports; the port's CPU path
(the chain's and the reduce's plain versions, and those of K3, K6 and K5)
agrees with the plain reference (``portbench/reference/cquad.py``) under
the limits ``portbench/configs/cquad_t16.json`` calibrated on the card,
over a counted number of ticks at batch 8, and the same check fails when a
lane of every answer is altered; the plant is the model's float64 map and
the reference's Jacobians are the model's; the kernels' work at the cell's
shapes is the shapes the solver hands its kernels, with the benchmark's
frozen cost arithmetic (``portbench/costs.py``, ``portbench/chain.py``)
equal to the port's; and the readers of the chain kernel's time and share
read them from a hand-built slice.  This file imports neither jax nor
pint_tpu.
"""

import functools
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import chain, costs, run, trace
from portbench.plants import quadrotor as plant
from portbench.reference import cquad as ref

ROOT = Path(__file__).resolve().parent.parent
CELL = "cquad_t16-hover4096"
SEED = 2**31 + 1283
TICKS = 16
CELLS = ("rti_t32-fleet4096", "crti_t32-fleet4096", "rti_t32-fleet16384",
         "crti_t32-fleet16384", "crti_t128-fleet4096", CELL)


def _counted(n, batch=8):
    """The cell at ``batch`` whose window is ``n`` ticks, not a time."""
    cell = run.load_cell(ROOT, CELL)
    cell.traffic = dict(cell.traffic, batch=batch)
    cell.loop = types.SimpleNamespace(due=lambda traffic, j, w0, now: now if j < n else math.inf)
    return cell


@pytest.fixture
def every_tick_sampled(monkeypatch):
    """Sample every pair of ticks, so that a short CPU window holds some."""
    monkeypatch.setattr(run, "SAMPLE_PERIOD", 2)


def test_the_cell_loads_by_name():
    cell = run.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["batch"] == 4096
    assert cell.traffic["process_noise_std"] == [0.001] * 6
    assert cell.traffic["loop"] == "closed" and cell.traffic["redraw_share"] == 0.01
    s, c = cell.config["solver"], cell.config["constraints"]
    assert (s["horizon"], s["sqp_iters"], s["pgd_iters"]) == (16, 1, 30)
    assert s["Q_diag"] == [4.0, 4.0, 1.0, 0.2, 0.2, 0.1] and s["R_diag"] == [0.05, 0.05]
    assert c["F"] == [[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]] and (c["lo"], c["hi"]) == (-0.15, 0.15)
    assert cell.config["reduced"] == [] and cell.config["deadline_ms"] == 31.25
    assert {m["name"] for m in cell.end_to_end} == {"tick_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "serve_launches_per_tick", "solver_launches_per_tick", "device_idle_share",
        "serve_enqueue_ms", "serve_wait_ms", "solver_replay_share", "propagate_device_ms",
        "reduce_device_ms", "chain_roofline", "stack_device_ms"}
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


def _model_and_controls(seed, B=64, T=12):
    from pint_tpu_torch.models import PlanarQuadrotor

    cell = run.load_cell(ROOT, CELL)
    box = cell.config["initial_states"]
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(box["low"], box["high"], (B, 6))
    x0[:, 2] = rng.uniform(-1.5, 1.5, B)                  # tilts over whole turns too
    p = plant.Plant(cell.config["model"])
    u = rng.uniform(-1.0, 1.0, (B, T, 2)) * p.box
    return PlanarQuadrotor(), cell.config["model"], p, x0, u


def test_the_plant_is_the_models_float64_map():
    model, _, p, x0, u = _model_and_controls(5)
    want = model.reference_rollout(x0, u)
    x = x0
    for k in range(u.shape[1]):
        x = p.step(x, u[:, k])
        np.testing.assert_allclose(x, want[:, k + 1], rtol=0, atol=1e-12)
    assert np.array_equal(p.box, 127.0 * model.lane_scales)


def test_the_references_jacobians_are_the_models():
    """The reference's A and B along its f32 rollout against
    ``PlanarQuadrotor.linearize`` (float64) at the same states and
    controls, and its offsets close the step: x_{k+1} = A x_k + B u_k + c."""
    model, cfg, _, x0, u = _model_and_controls(6)
    x0_f = torch.as_tensor(x0, dtype=torch.float32)
    u_f = torch.as_tensor(u, dtype=torch.float32)
    A, B, c = ref.linearize(x0_f, u_f, cfg)
    traj = model.rollout_f32(x0_f, u_f)                   # the same f32 map
    wA, wB = model.linearize(traj[:, :-1].double().numpy(), u_f.double().numpy())
    np.testing.assert_allclose(A.numpy(), wA, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), wB, rtol=1e-5, atol=1e-7)
    step = (A @ traj[:, :-1, :, None])[..., 0] + (B @ u_f[..., None])[..., 0] + c
    np.testing.assert_allclose(step.numpy(), traj[:, 1:].numpy(), rtol=0, atol=1e-5)


def test_the_work_is_the_shapes_the_solver_launches():
    from pint_tpu_torch.utils import profiling as P

    cell = run.load_cell(ROOT, CELL)
    work = cell.kind.work(cell.config, 4096)
    assert work == [("lipq", dict(B=4096, Tm=32, power_iters=16)),
                    ("pen", dict(B=4096, C=16, Tm=32, power_iters=16)),
                    ("alm", dict(B=4096, Tp=32, Cp=64, outer=3, inners=30))]
    assert [k for k, _ in work] == list(cell.kind.LAUNCHES)
    for kernel, shape in work:
        mine, theirs = costs.kernel_cost(kernel, **shape), P.kernel_cost(kernel, **shape)
        assert (mine.bytes, mine.ops, mine.op_type) == (theirs.bytes, theirs.ops, theirs.op_type)
    csqp = cell.kind.solver(cell.kind.build(cell.config, 8, "cpu"))
    assert (csqp.dev.n_dec, csqp.n_rows, csqp.padded_rows) == (32, 16, 64)
    assert csqp.forms == dict(chain="fused", reduce="kernel", stack="kernel",
                              condense="lipq", constraints="pen", inner="alm")


@pytest.mark.parametrize("B, T, n, m", [(4096, 32, 3, 2), (16384, 32, 3, 2), (4096, 128, 3, 2),
                                        (4096, 16, 6, 2), (37, 5, 6, 2)],
                         ids=["rti_t32", "t32-16384", "crti_t128", "cquad_t16", "ragged"])
def test_the_chains_frozen_cost_is_the_ports(B, T, n, m):
    from pint_tpu_torch.utils import profiling as P

    mine, theirs = chain.chain_cost(B, T, n, m), P.kernel_cost("propagate", B=B, T=T, n=n, m=m)
    assert (mine.bytes, mine.ops, mine.op_type) == (theirs.bytes, theirs.ops, theirs.op_type)
    assert costs.bound_ms(mine) == P.bound_ms(theirs)


TICKS_IV = [(0, 100_000), (200_000, 300_000)]
CHAIN_NS = {"propagate_kernel<1>": 43_000, "propagate_quad_kernel<16, 1>": 21_000}
REDUCE_NS = 90_000


def _slice(chain_name):
    """Two ticks of a chain kernel (none where ``chain_name`` is None), the
    reduce kernel and a torch operation, as the profiler names them."""
    ops = []
    for a, _ in TICKS_IV:
        ops.append(trace.DeviceOp("void at::native::elementwise_kernel<128, 2>()", a, a + 900,
                                  "solver", False))
        if chain_name is not None:
            ops.append(trace.DeviceOp(f"void (anonymous namespace)::{chain_name}(int2 const*, "
                                      "float const*)", a + 1000, a + 1000 + CHAIN_NS[chain_name],
                                      "solver", True))
        ops.append(trace.DeviceOp("void (anonymous namespace)::reduce_kernel<6, 8>(ReduceArgs)",
                                  a + 50_000, a + 50_000 + REDUCE_NS, "solver", True))
    return trace.Summary(TICKS_IV, 0, TICKS_IV[-1][1], ops, [], 0, 0,
                         calls={"lipq": 1.0, "pen": 1.0, "alm": 1.0})


@pytest.mark.parametrize("workload", CELLS)
def test_the_chain_readers_read_a_synthetic_slice(workload):
    """``propagate_device_ms`` reads either form of the chain kernel by the
    names ``propagate.cu`` declares, ``reduce_device_ms`` the reduce's, and
    ``chain_roofline`` is 100 x the cell's chain bound over the first; with
    no chain kernel in the slice (the torch chain) both chain readers read
    nothing."""
    cell = run.load_cell(ROOT, workload)
    name = ("propagate_quad_kernel<16, 1>" if workload == CELL else "propagate_kernel<1>")
    s = _slice(name)
    ms = run.reader(ROOT, "propagate_device_ms")(s, cell)
    assert ms == pytest.approx(CHAIN_NS[name] / 1e6)
    assert run.reader(ROOT, "reduce_device_ms")(s, cell) == pytest.approx(REDUCE_NS / 1e6)
    share = run.reader(ROOT, "chain_roofline")(s, cell)
    assert share == pytest.approx(100.0 * chain.cell_bound_ms(cell) / ms)
    assert 0 < share
    none = _slice(None)
    assert run.reader(ROOT, "propagate_device_ms")(none, cell) is None
    assert run.reader(ROOT, "chain_roofline")(none, cell) is None


def test_the_cells_chain_bound_is_its_shape():
    cell = run.load_cell(ROOT, CELL)
    assert chain.cell_bound_ms(cell) == costs.bound_ms(chain.chain_cost(4096, 16, 6, 2))[0]
    assert chain.cell_bound_ms(cell) == pytest.approx(61.96e6 / 3.35e12 * 1e3, rel=1e-3)
