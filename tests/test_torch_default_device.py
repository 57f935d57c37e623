"""The port's entry points run on the card unless the caller asks for the CPU.

Constructed with no ``device``, each entry point resolves ``"cuda"``: on a
machine without a card that raises ``RuntimeError`` (nothing falls back to
the CPU), on a machine with one the result lives on the card.  With
``device="cpu"`` each one builds on the host and runs the plain versions.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import pint_tpu_torch as pt
from pint_tpu_torch.convert import words_from_numpy
from pint_tpu_torch.mpc import (
    AcceleratedPGD,
    ConstrainedController,
    ConstrainedPGD,
    ConstrainedSQP,
    DeviceSQP,
    FixedPointPGD,
    FusedPGD,
    LTIController,
    QuantizedMPPI,
    QuantizedNonlinearPGD,
    QuantizedSQP,
    RecedingHorizonController,
    SQPController,
    condense_double_integrator,
    constrain_states,
    quantize,
    quantize_constrained,
)
from pint_tpu_torch.parallel import host_local_mesh, make_mesh

REPO = pathlib.Path(__file__).resolve().parents[1]


def _qqp():
    return quantize(condense_double_integrator(T=8))


def _qcqp():
    T, dt = 20, 1.0 / 32.0
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    sc = constrain_states(condense_double_integrator(T=T, dt=dt, q_pos=4.0),
                          np.broadcast_to(A, (T, 2, 2)),
                          np.broadcast_to(Bm, (T, 2, 1)), None,
                          F=[[0.0, 1.0]], lo=-0.25, hi=0.25)
    return quantize_constrained(sc, rho=50.0)


def _device_of(obj):
    if isinstance(obj, torch.Tensor):
        return obj.device
    if isinstance(obj, pt.PackedArray):
        return obj.device
    if isinstance(obj, SQPController):
        return obj.sqp.device
    return torch.device(obj.device)


ENTRY_POINTS = {
    "MPCService": lambda **kw: pt.MPCService(_qqp(), batch=4, **kw),
    "DeviceSQP": lambda **kw: DeviceSQP(horizon=8, sqp_iters=1, pgd_iters=2, **kw),
    "FusedPGD": lambda **kw: FusedPGD(_qqp(), iters=2, **kw),
    "FixedPointPGD": lambda **kw: FixedPointPGD(_qqp(), iters=2, **kw),
    "AcceleratedPGD": lambda **kw: AcceleratedPGD(_qqp(), iters=2, **kw),
    "ConstrainedPGD": lambda **kw: ConstrainedPGD(_qcqp(), outer=1, inners=2, **kw),
    "ConstrainedController": lambda **kw: ConstrainedController(
        _qcqp(), plant_step=lambda s, u: pt.DoubleIntegrator().step(s, u[..., 0]), **kw),
    "DeviceSQP(PlanarQuadrotor)": lambda **kw: DeviceSQP(
        model=pt.PlanarQuadrotor(), horizon=8, sqp_iters=1, pgd_iters=2,
        Q=np.eye(6), R=np.eye(2), x_ref=np.zeros(6), propagate="allpairs",
        reduce="einsum", **kw),
    "DeviceSQP(Pendulum)": lambda **kw: DeviceSQP(
        model=pt.Pendulum(), horizon=8, sqp_iters=1, pgd_iters=2, Q=np.eye(2),
        R=np.eye(1), x_ref=np.zeros(2), propagate="scan", reduce="blocked", **kw),
    "QuantizedSQP": lambda **kw: QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, **kw),
    "SQPController": lambda **kw: SQPController(
        QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, **kw)),
    "ConstrainedSQP": lambda **kw: ConstrainedSQP(
        QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, x_ref=np.array([1.0, 0.0, 0.0]),
                     **kw), F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0),
    "LTIController": lambda **kw: LTIController(
        _qqp(), plant_step=lambda s, u: pt.DoubleIntegrator().step(s, u[..., 0]), **kw),
    "LTIController(use_fused)": lambda **kw: LTIController(
        _qqp(), plant_step=lambda s, u: pt.DoubleIntegrator().step(s, u[..., 0]),
        use_fused=True, **kw),
    "RecedingHorizonController": lambda **kw: RecedingHorizonController.build(
        pt.DoubleIntegrator(u_shift=10), horizon=8, iters_per_tick=2, **kw),
    "QuantizedMPPI": lambda **kw: QuantizedMPPI(horizon=8, samples=4, **kw),
    "MPPIService": lambda **kw: pt.MPPIService(QuantizedMPPI(horizon=8, samples=4, **kw), 2),
    "QuantizedNonlinearPGD": lambda **kw: QuantizedNonlinearPGD(horizon=8, iters=2, **kw),
    "PackedArray.zeros": lambda **kw: pt.PackedArray.zeros(
        pt.PackedLayout(8, 8, 8, 8), (3,), **kw),
    "words_from_numpy": lambda **kw: words_from_numpy(
        np.arange(6, dtype=np.uint32), **kw),
    "load_packed": lambda **kw: _load_packed(**kw),
    # host data, as the reference's quickstart gives it
    "PackedArray.pack(scalars)": lambda **kw: pt.PackedArray.pack(
        pt.PackedLayout(5, 6, 5), 1, 20, 10, **kw),
    "PackedArray.pack(list)": lambda **kw: pt.PackedArray.pack(
        pt.PackedLayout(5, 6, 5), [1, 20, 10], **kw),
    "PackedArray.pack(numpy lanes)": lambda **kw: pt.PackedArray.pack(
        pt.PackedLayout(5, 6, 5), np.arange(4), np.arange(4) + 20, np.arange(4) + 10, **kw),
    "PackedArray.pack(numpy stacked)": lambda **kw: pt.PackedArray.pack(
        pt.PackedLayout(5, 6, 5), np.array([[1, 20, 10], [3, 2, 1]]), **kw),
    "PackedArray.from_words": lambda **kw: pt.PackedArray.from_words(
        pt.PackedLayout(8, 8, 8, 8), np.arange(8, dtype=np.uint32), **kw),
    "make_mesh": lambda **kw: _in_one_rank_world(lambda: make_mesh(1, 1, **kw)),
    "host_local_mesh": lambda **kw: _in_one_rank_world(lambda: host_local_mesh(**kw)),
}


def _in_one_rank_world(build):
    """``build()`` in a one-rank gloo world that rendezvouses through a
    file and is torn down before this returns, raised or not."""
    import tempfile

    from pint_tpu_torch.parallel import distributed

    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/rendezvous", 1, 0, backend="gloo")
        try:
            return build()
        finally:
            torch.distributed.destroy_process_group()


def _load_packed(**kw):
    """A checkpoint written from the CPU, loaded with ``kw``."""
    import tempfile

    from pint_tpu_torch.utils.checkpoint import load_packed, save_packed

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/words.npz"
        save_packed(path, pt.PackedArray.from_words(pt.PackedLayout(8, 8, 8, 8),
                                                    np.arange(6, dtype=np.uint32),
                                                    device="cpu"))
        return load_packed(path, **kw)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert _device_of(make()).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_when_asked(name):
    assert _device_of(ENTRY_POINTS[name](device="cpu")) == torch.device("cpu")


def test_host_data_keeps_its_bits_on_the_cpu():
    """``device="cpu"`` packs host data as before: truncated lanes, unsigned
    words kept bit for bit, other values wrapped."""
    lay = pt.PackedLayout(5, 6, 5)
    want = 1 | (20 << 5) | (10 << 11)
    for make in ("PackedArray.pack(scalars)", "PackedArray.pack(list)"):
        assert int(ENTRY_POINTS[make](device="cpu").word) == want
    lanes = ENTRY_POINTS["PackedArray.pack(numpy lanes)"](device="cpu").lanes()
    np.testing.assert_array_equal(lanes.numpy(), np.stack(
        [np.arange(4), (np.arange(4) + 20) & 63, (np.arange(4) + 10) & 31], -1))
    stacked = ENTRY_POINTS["PackedArray.pack(numpy stacked)"](device="cpu")
    assert stacked.lanes().tolist() == [[1, 20, 10], [3, 2, 1]]
    words = pt.PackedArray.from_words(pt.PackedLayout(8, 8, 8, 8),
                                      np.array([2**32 - 1, 7], np.uint32), device="cpu")
    assert words.word.tolist() == [-1, 7]
    assert int(pt.PackedArray.pack(lay, 33, -1, 234, device="cpu").word) == \
        (33 & 31) | (63 << 5) | ((234 & 31) << 11)
    if not torch.cuda.is_available():   # a CPU tensor asked for the CPU
        assert pt.PackedArray.pack(lay, torch.tensor(1), 20, 10).device.type == "cpu"


def test_mesh_device_is_this_ranks_card(monkeypatch):
    """A bare ``"cuda"`` names this rank's card: ``cuda:LOCAL_RANK`` where
    the launcher sets it, else the current device; a mesh and a solver on
    one card compare equal however each named it."""
    from pint_tpu_torch.ops import kernels as K
    from pint_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert M._rank_device("cuda") == torch.device("cuda", 3)
    assert M._rank_device("cuda:1") == torch.device("cuda", 1)
    assert M._rank_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert M._rank_device("cuda") == torch.device("cuda")
    assert K.same_device("cuda", "cuda:0") and not K.same_device("cuda", "cuda:3")
    assert K.same_device("cuda:3", "cuda:3") and not K.same_device("cuda:3", "cuda:1")
    assert K.same_device("cpu", torch.device("cpu")) and not K.same_device("cpu", "cuda")


def test_fused_pgd_takes_no_tpu_knob_by_position():
    """``FusedPGD(qqp, 8, 512)`` is ``block_rows=512`` to the reference; the
    port has no such knob and refuses the call rather than read 512 as
    ``momentum``.  Spelled with keywords, the momentum solve is bit-identical
    to the reference's (Pallas in interpret mode)."""
    import jax.numpy as jnp

    from pint_tpu.mpc import condense_double_integrator as j_condense
    from pint_tpu.mpc import quantize as j_quantize
    from pint_tpu.mpc.fused import FusedPGD as JFused
    from pint_tpu_torch.convert import quantized_qp_from_arrays, words_to_numpy

    ref = j_quantize(j_condense(T=16))
    port = quantized_qp_from_arrays(ref)
    with pytest.raises(TypeError):
        FusedPGD(port, 8, 512, device="cpu")
    rng = np.random.default_rng(7)
    x0 = np.stack([rng.uniform(-3, 3, 8), rng.uniform(-1, 1, 8)], -1)
    g = ref.g_lane_fixed(x0)
    u0 = np.zeros((8, ref.padded // 4), np.uint32)
    expect = JFused(ref, 8, block_rows=8, momentum=True, interpret=True).solve_words(
        jnp.asarray(u0), jnp.asarray(g))
    solver = FusedPGD(port, 8, momentum=True, device="cpu")
    got = solver.solve_words(solver.init_words(8), torch.from_numpy(g))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(expect))


def test_cpu_entry_points_run_the_plain_versions():
    """On the CPU the solvers run without launching a kernel."""
    from pint_tpu_torch.ops import kernels as K

    qqp = _qqp()
    before = K.launch_counts()
    x0 = np.array([[1.0, 0.0], [-0.5, 0.2]])
    words, _ = FusedPGD(qqp, iters=3, device="cpu").solve(x0)
    ref, _ = FixedPointPGD(qqp, iters=3, device="cpu").solve(x0)
    assert torch.equal(words, ref)
    ctrl = ENTRY_POINTS["ConstrainedController"](device="cpu")
    states, lanes = ctrl.run(torch.tensor([[65536, 0], [-32768, 1000]], dtype=torch.int32), 3)
    assert states.device.type == "cpu" and lanes.shape == (2, 3, 1)
    assert K.launch_counts() == before


def test_cpu_host_tier_and_planners_run_without_kernels():
    """The slice's entry points run on the CPU when asked, with no kernel
    launch: an SQP solve and two controller ticks, the LTI loops (fused and
    not), an MPPI update and a planner solve."""
    from pint_tpu_torch.ops import kernels as K

    before = K.launch_counts()
    x0 = np.array([[0.0, 0.0, 0.0], [-0.1, 0.05, 0.1]])
    sqp = ENTRY_POINTS["QuantizedSQP"](device="cpu")
    words, costs = sqp.solve(x0)
    assert words.device.type == "cpu" and costs.shape == (2, 2)
    states, lanes = SQPController(sqp).run(x0, 2)
    assert states.shape == (2, 3, 3) and lanes.shape == (2, 2, 2)
    w, lam, _ = ENTRY_POINTS["ConstrainedSQP"](device="cpu").solve(
        np.array([[0.0, 0.0, np.pi / 2]]), track_costs=False)
    assert lam.device.type == "cpu"
    s0 = torch.tensor([[65536, 0], [-32768, 1000]], dtype=torch.int32)
    runs = [ENTRY_POINTS[n](device="cpu").run(s0, 3)
            for n in ("LTIController", "LTIController(use_fused)")]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    ENTRY_POINTS["RecedingHorizonController"](device="cpu").run(s0, 2)
    z = torch.zeros((1, 3), dtype=torch.int32)
    cost = pt.unicycle_goal_cost(pt.Unicycle(), np.array([[[0.5, 0.5]]]))
    ENTRY_POINTS["QuantizedMPPI"](device="cpu").step(torch.Generator().manual_seed(0),
                                                     torch.zeros((1, 4), dtype=torch.int32),
                                                     z, cost)
    from pint_tpu_torch.mpc.costs import goal_cost

    ENTRY_POINTS["QuantizedNonlinearPGD"](device="cpu").solve(
        z, goal_cost(pt.Unicycle(), np.array([[0.5, 0.5]])))
    assert K.launch_counts() == before


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


def test_no_port_file_imports_jax_or_the_reference():
    """No module under pint_tpu_torch/, and not chip_smoke.py, imports jax
    or pint_tpu, at any depth of the file (function bodies included)."""
    files = sorted((REPO / "pint_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        bad = {n for n in _imports(path)
               if n.split(".")[0] in ("jax", "jaxlib", "pint_tpu")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
