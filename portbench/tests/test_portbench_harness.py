"""The harness on the CPU at small sizes: it finds cells, mixes and metrics
by name from new files, its traffic repeats from the seed, its frozen cost
arithmetic is the program's, its reference agrees with the port's CPU path,
its check fails a broken timed path, and its trace reduction places device
operations by their launches.  A run on the card is ``portbench/run.py``."""

import functools
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import costs, fleet, run, trace
from portbench.reference import rti as ref_rti

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["rti_t32-fleet4096", "crti_t32-fleet4096", "rti_t32-fleet16384",
         "crti_t32-fleet16384"]
SEED = 2**31 + 977


def small(workload, batch=32, root=ROOT):
    cell = run.load_cell(root, workload)
    cell.traffic = dict(cell.traffic, batch=batch)
    return cell


@pytest.fixture
def dense_sampling(monkeypatch):
    """Sample every pair of ticks, so that a short CPU window holds some."""
    monkeypatch.setattr(run, "SAMPLE_PERIOD", 2)


# -- driven by data -------------------------------------------------------------


def test_every_cell_loads_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == CELLS
    for w in CELLS:
        cell = run.load_cell(ROOT, w)
        farm = cell.traffic["batch"] == 16384
        assert cell.traffic["batch"] == int(w.rsplit("fleet", 1)[1])
        assert {m["name"] for m in cell.end_to_end} == (
            {"tick_p95_ms", "setup_s"} | ({"plants_per_s"} if farm else set()))
        assert len(cell.per_layer) == (6 if farm else 3)
        for m in cell.per_layer:
            assert callable(run.reader(ROOT, m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_new_config_mix_and_metric_need_only_new_files(tmp_path, dense_sampling):
    """In a copy of the benchmark, a configuration, a traffic mix and a
    per-layer metric added as new files (and entries) run with every file
    that was there unchanged."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "portbench/configs/rti_t32.json").read_text())
    cfg["solver"]["horizon"] = 8
    (tmp_path / "portbench/configs/rti_t8.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/tiny16.json").write_text(json.dumps(
        {"loop": "closed", "batch": 16, "process_noise_std": [0.001, 0.001, 0.001],
         "redraw_share": 0.125}))
    (tmp_path / "portbench/layers/ticks_in_slice.py").write_text(
        "def read(summary, cell):\n    return summary.ticks\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="rti_t8",
                                 file="portbench/configs/rti_t8.json"))
    bench["workloads"].append({"name": "rti_t8-tiny16", "config": "rti_t8",
                               "traffic": "tiny16", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "ticks_in_slice", "unit": "ticks", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "plants_per_s", "workloads": ["rti_t8-tiny16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = run.load_cell(tmp_path, "rti_t8-tiny16")
    assert cell.config["solver"]["horizon"] == 8 and cell.traffic["batch"] == 16
    assert [m["name"] for m in cell.per_layer] == ["ticks_in_slice"]
    res = run.run_cell(cell, SEED, 1.0, True, "cpu", root=tmp_path)
    assert res["metrics"] == {"ticks_in_slice": {"value": float(run.TRACE_TICKS),
                                                 "unit": "ticks"}}
    assert res["correct"], res["checks"]
    assert all(p.read_bytes() == b for p, b in before.items())


LTI_KIND = '''"""A stand-in kind for the test: MPCService on the double integrator."""
import numpy as np
import torch
from portbench.reference import lti_stand_in as ref

RECORD_IN = {"words": "u_words"}
LAUNCHES = {"fused_pgd": 1}


def build(config, batch, device):
    from pint_tpu_torch import MPCService
    return MPCService(ref.qqp(config), batch=batch, iters_per_tick=config["solver"]["iters"],
                      g_on_device=True, device=device)


def solver(service):
    return service._solver


def record_out(result):
    return {"words": result}


def work(config, batch):
    return []


Reference = ref.Reference
'''

LTI_REFERENCE = '''"""Plumbing only: this stand-in re-solves a tick with the program's own
CPU path, which a real reference under this folder may not do."""
import numpy as np
import torch
from portbench.reference.rti import shift_plan, unpack


def qqp(config):
    from pint_tpu_torch import condense_double_integrator, quantize
    m = config["model"]
    return quantize(condense_double_integrator(T=config["solver"]["horizon"], dt=m["dt"],
                                               u_max=m["u_max"]))


class Reference:
    def __init__(self, config, device):
        from pint_tpu_torch import MPCService
        self.svc = MPCService(qqp(config), batch=1, iters_per_tick=config["solver"]["iters"],
                              g_on_device=True, device="cpu")
        self.device = torch.device("cpu")
        self.m = 1
        self.lane_scales = self.svc.qqp.u_scale

    def zeros(self, n):
        return {"words": torch.zeros((n, self.svc.qqp.padded // 4), dtype=torch.int32)}

    def step(self, x0, ins):
        return {"words": self.svc.tick_from_states(ins["words"], x0)[0]}

    def shift(self, outs):
        return {"words": shift_plan(outs["words"], 1)}

    def lanes(self, words):
        return unpack(words)
'''

DOUBLE_INTEGRATOR = '''import numpy as np


class Plant:
    def __init__(self, model):
        self.dt = model["dt"]
        self.box = np.array([model["u_max"]])

    def step(self, x, u):
        a = u[:, 0]
        return np.stack([x[:, 0] + x[:, 1] * self.dt + 0.5 * a * self.dt ** 2,
                         x[:, 1] + a * self.dt], axis=-1)
'''

PERIODIC = '''def due(traffic, j, w0, now):
    return w0 + j * traffic["period_ms"] / 1e3
'''


def test_a_new_kind_plant_and_loop_need_only_new_files(tmp_path):
    """In a copy of the benchmark, a service of another kind (the LTI
    MPCService), its plant (the double integrator), an open loop at a fixed
    period and a mix with sensor faults, all added as new files, run from
    that copy with every file that was there unchanged, and the check
    passes over the faults' resets."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "pint_tpu_torch").symlink_to(ROOT / "pint_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "kinds/lti.py").write_text(LTI_KIND)
    (pb / "reference/lti_stand_in.py").write_text(LTI_REFERENCE)
    (pb / "plants/double_integrator.py").write_text(DOUBLE_INTEGRATOR)
    (pb / "loops/periodic.py").write_text(PERIODIC)
    (pb / "configs/lti_t8.json").write_text(json.dumps({
        "kind": "lti", "model": {"name": "double_integrator", "dt": 0.03125, "u_max": 1.0},
        "solver": {"horizon": 8, "iters": 15},
        "initial_states": {"low": [-3.0, -1.0], "high": [3.0, 1.0]},
        "deadline_ms": 10, "reduced": [], "assumed": [],
        "limits": {"start_diff_pct": 0, "plan_diff_pct": 0, "control_diff_pct": 0,
                   "carry_mismatch": 0}}))
    (pb / "traffic/tiny16.period20ms.json").write_text(json.dumps({
        "loop": "periodic", "period_ms": 20, "batch": 16, "process_noise_std": [0.001, 0.001],
        "redraw_share": 0.0625, "fault_share": 0.125}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="lti_t8",
                                 file="portbench/configs/lti_t8.json"))
    bench["workloads"].append({"name": "lti_t8-tiny16.period20ms", "config": "lti_t8",
                               "traffic": "tiny16.period20ms", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, '.'); from pathlib import Path; "
            "from portbench import run; "
            "cell = run.load_cell(Path('.'), 'lti_t8-tiny16.period20ms'); "
            f"print(json.dumps(run.run_cell(cell, {SEED}, 1.0, False, 'cpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"], (res["checks"], out.stderr[-3000:])
    assert res["failed"] == 0 and res["attempted"] == 16 * 50
    assert set(res["metrics"]) == {"tick_p95_ms", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


# -- traffic --------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t32-fleet16384"])
def test_traffic_and_plant_repeat_from_the_seed(workload):
    cell = run.load_cell(ROOT, workload)

    def trajectory(seed):
        fl = fleet.Fleet(cell.traffic, cell.config, seed)
        xs = [fl.x.copy()]
        u = np.tile([[0.1, -0.05]], (fl.batch, 1))
        for _ in range(3):
            xs.append(fl.step(u).copy())
        return np.stack(xs)

    a, b, c = trajectory(SEED), trajectory(SEED), trajectory(SEED + 1)
    assert np.array_equal(a, b)
    assert not np.allclose(a, c)
    low, high = (np.asarray(cell.config["initial_states"][k]) for k in ("low", "high"))
    assert (a[0] >= low).all() and (a[0] <= high).all()


def test_every_seed_redraws_the_same_number_of_plants():
    cell = run.load_cell(ROOT, "rti_t32-fleet4096")
    for seed in (0, 1, 2**33 + 5, -7):
        fl = fleet.Fleet(cell.traffic, cell.config, seed)
        fl.noise = np.zeros(3)
        x0 = fl.x.copy()
        moved = fl.step(np.zeros((fl.batch, 2)))
        assert int((moved != x0).any(axis=1).sum()) == 41


def test_a_control_that_is_not_finite_acts_as_zero():
    cell = run.load_cell(ROOT, "rti_t32-fleet4096")
    fl = fleet.Fleet(dict(cell.traffic, redraw_share=0.0, process_noise_std=[0, 0, 0]),
                     cell.config, SEED)
    x0 = fl.x.copy()
    u = np.zeros((fl.batch, 2))
    u[0] = np.nan
    assert np.array_equal(fl.step(u), x0)


def test_faults_send_the_same_number_of_lost_states_and_the_plant_goes_on():
    cell = run.load_cell(ROOT, "rti_t32-fleet4096")
    for seed in (0, 2**33 + 5):
        fl = fleet.Fleet(dict(cell.traffic, fault_share=0.01), cell.config, seed)
        sent = fl.step(np.zeros((fl.batch, 2)))
        lost = ~np.isfinite(sent).all(axis=1)
        assert int(lost.sum()) == 41 and np.isfinite(fl.x).all()
        assert np.array_equal(sent[~lost], fl.x[~lost])


# -- the frozen arithmetic --------------------------------------------------------


@pytest.mark.parametrize("workload", CELLS)
def test_frozen_costs_equal_the_programs(workload):
    from pint_tpu_torch.utils import profiling as P

    cell = run.load_cell(ROOT, workload)
    work = cell.kind.work(cell.config, cell.traffic["batch"])
    assert [k for k, _ in work] == list(cell.kind.LAUNCHES)
    for kernel, shape in work:
        mine, theirs = costs.kernel_cost(kernel, **shape), P.kernel_cost(kernel, **shape)
        assert (mine.bytes, mine.ops, mine.op_type) == (theirs.bytes, theirs.ops,
                                                        theirs.op_type)
        assert costs.bound_ms(mine) == P.bound_ms(theirs)
    assert costs.H100_SXM == {k: P.H100_SXM[k] for k in costs.H100_SXM}


def test_reference_packs_as_the_port_does():
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls

    lanes = torch.as_tensor(np.random.default_rng(0).integers(-128, 128, (64, 64)),
                            dtype=torch.int32)
    words = pack_controls(lanes)
    assert torch.equal(ref_rti.pack(lanes), words)
    assert torch.equal(ref_rti.unpack(words), unpack_controls(words))


# -- the check --------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t32-fleet4096"])
def test_reference_agrees_with_the_ports_cpu_path(workload, dense_sampling):
    keep = {}
    res = run.run_cell(small(workload), SEED, 1.5, False, "cpu", keep=keep)
    assert res["correct"], res["checks"]
    assert len(keep["steps"]) >= 2 and keep["pairs"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"tick_p95_ms", "setup_s"}


def _broken(kind, fault):
    """``kind`` whose service's solver is broken underneath."""
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls

    def build(config, batch, device):
        service = kind.build(config, batch, device)
        sol = kind.solver(service)
        orig = sol.solve_words

        @functools.wraps(orig)
        def solve_words(*a, **k):
            if fault == "state_unchanged":
                return a[0] if len(a) < 3 else (a[0], a[2])
            if fault == "half_the_batch":
                h = a[0].shape[0] // 2
                out = orig(*(x[:h] for x in a), **k)
                if isinstance(out, tuple):
                    return tuple(torch.cat([o, x[h:]]) for o, x in zip(out, (a[0], a[2])))
                return torch.cat([out, a[0][h:]])
            out = orig(*a, **k)                      # an answer altered where produced
            words = out[0] if isinstance(out, tuple) else out
            lanes = unpack_controls(words)
            lanes[:, 0] = torch.where(lanes[:, 0] < 127, lanes[:, 0] + 1, lanes[:, 0] - 1)
            words = pack_controls(lanes)
            return (words, out[1]) if isinstance(out, tuple) else words

        object.__setattr__(sol, "solve_words", solve_words)
        return service

    members = {k: getattr(kind, k) for k in dir(kind) if not k.startswith("__")}
    return types.SimpleNamespace(**dict(members, build=build))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t32-fleet4096"])
def test_the_check_fails_a_broken_timed_path(workload, fault, dense_sampling):
    cell = small(workload)
    cell.kind = _broken(cell.kind, fault)
    res = run.run_cell(cell, SEED, 1.5, False, "cpu")
    assert not res["correct"], res["checks"]


def _origin_for_lost_sensors(kind):
    """``kind`` whose service solves a state that is not a number as the
    origin, where it owes a zero control and a fresh warm state."""

    def build(config, batch, device):
        service = kind.build(config, batch, device)
        orig = service.solve
        service.solve = lambda x: orig(np.nan_to_num(x, nan=0.0))
        return service

    members = {k: getattr(kind, k) for k in dir(kind) if not k.startswith("__")}
    return types.SimpleNamespace(**dict(members, build=build))


@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t32-fleet4096"])
def test_the_check_holds_the_reset_of_a_lost_sensor(workload, dense_sampling):
    cell = small(workload)
    cell.traffic = dict(cell.traffic, fault_share=0.125)
    keep = {}
    res = run.run_cell(cell, SEED, 1.5, False, "cpu", keep=keep)
    assert res["correct"], res["checks"]
    sent = np.concatenate([r["x0"] for r in keep["steps"]])
    assert (~np.isfinite(sent).all(axis=1)).any()
    cell.kind = _origin_for_lost_sensors(cell.kind)
    res = run.run_cell(cell, SEED, 1.5, False, "cpu")
    assert not res["correct"], res["checks"]


def test_without_a_card_the_command_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "rti_t32-fleet4096", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_a_directory_of_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from pathlib import Path; "
            "from portbench import run; "
            "cell = run.load_cell(Path('.'), 'rti_t32-fleet4096'); "
            "cell.traffic['batch'] = 8; run.run_cell(cell, 1, 0.1, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "pint_tpu_torch" in out.stderr


# -- the trace reduction ----------------------------------------------------------


def test_port_kernels_are_read_from_the_sources():
    names = trace.port_kernels(ROOT / "pint_tpu_torch" / "csrc")
    assert {"lipq_reg_kernel", "pgd_hqt_kernel", "alm_reg_kernel", "pen_reg_kernel",
            "lipq_long_kernel", "alm_wide_kernel", "binop_kernel"} <= set(names)
    assert len(names) == 18


class _Ev:
    def __init__(self, name, dev, kind, corr, linked, start, dur):
        self._v = (name, dev, kind, corr, linked, start, dur)    # as the profiler lists them

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[3]

    def start_ns(self):
        return self._v[5]

    def duration_ns(self):
        return self._v[6]


def test_summary_places_device_operations_by_their_launch():
    from torch.autograd import DeviceType

    C, G = DeviceType.CPU, DeviceType.CUDA
    ev = [
        _Ev("portbench.tick", C, "user_annotation", 1, 0, 0, 1000),
        _Ev("portbench.solver", C, "user_annotation", 2, 0, 100, 500),
        _Ev("aten::mul", C, "cpu_op", 3, 0, 120, 20),
        _Ev("cudaLaunchKernel", C, "cuda_runtime", 50, 3, 125, 5),
        _Ev("void at::native::mul_kernel<float>(float*)", G, "kernel", 50, 3, 200, 100),
        _Ev("cudaLaunchKernel", C, "cuda_runtime", 51, 0, 400, 5),
        _Ev("void lipq_reg_kernel<1>(float const*)", G, "kernel", 51, 0, 420, 200),
        _Ev("portbench.record", C, "user_annotation", 4, 0, 610, 50),
        _Ev("cudaLaunchKernel", C, "cuda_runtime", 52, 0, 620, 5),
        _Ev("void index_kernel(int*)", G, "kernel", 52, 0, 640, 10),
        _Ev("cudaMemcpyAsync", C, "cuda_runtime", 53, 0, 700, 200),
        _Ev("Memcpy DtoH (Device -> Pageable)", G, "gpu_memcpy", 53, 0, 850, 50),
        _Ev("portbench.solver", G, "gpu_user_annotation", 2, 0, 100, 600),
        _Ev("portbench.plant", C, "user_annotation", 5, 0, 1000, 400),
        _Ev("portbench.tick", C, "user_annotation", 6, 0, 1400, 100),
    ]
    s = trace.summarize(ev, ["lipq_reg_kernel", "pgd_hqt_kernel"])
    assert s.ticks == 2 and s.wall_ns == 1500
    assert s.tick_ns == 1100 and s.plant_ns == 400 and s.busy_in_ticks_ns() == 360
    assert [(o.where, o.port) for o in s.ops] == [
        ("solver", False), ("solver", True), ("record", False), ("serve", False)]
    assert s.unplaced == 0
    assert s.busy_ns() == 100 + 200 + 10 + 50
    assert s.busy_ns(s.select("solver", port=False)) == 100
    assert s.idle_gaps() == [(0, 200), (300, 420), (620, 640), (650, 850), (900, 1000),
                             (1400, 1500)]      # the plant step is no idle time of the device
    idle = run.reader(ROOT, "device_idle_share")(s, None)
    assert idle == pytest.approx(100 * (1 - 360 / 1100))
    assert s.label(0, 200) == "portbench.solver"
    assert s.label(110, 130) == "portbench.solver > aten::mul"
    b = s.breakdown()
    assert b["device_ops"][0] == ["lipq_reg_kernel", 200e-9]
    assert b["idle_gaps"][0][1] == 200e-9
    cell = run.load_cell(ROOT, "rti_t32-fleet4096")
    roofline = run.reader(ROOT, "kernels_roofline")
    work = sum(costs.bound_ms(costs.kernel_cost(k, **sh))[0]
               for k, sh in cell.kind.work(cell.config, 4096))
    s.calls = {"lipq": 1.0, "pgd_hqt": 1.0}
    assert roofline(s, cell) == pytest.approx(100 * work / (100 / 1e6))
    for calls in ({"lipq": 1.0}, {"lipq": 1.0, "pgd_hqt": 0.5}, {}):
        s.calls = calls             # part of the inner ran outside the port's kernels
        assert roofline(s, cell) is None


# -- the control, on the card ------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t32-fleet4096"])
def test_the_tf32_control_fails_the_check(workload):
    """The reference in TF32 in the program's place, on the inputs a short
    run of the program sampled, fails at least one compared number, where
    the program passes them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import compare

    cell = small(workload, batch=512)
    keep = {}
    res = run.run_cell(cell, SEED, 3.0, False, "cuda", keep=keep)
    assert res["correct"], res["checks"]
    ctl = compare.control_readings(keep["ref"], keep["start"], keep["steps"])
    limits = cell.config["limits"]
    assert any(ctl[k] > limits[k] for k in ctl if k in limits), ctl
