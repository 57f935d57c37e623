"""An SQP iteration's serial chain (``pint_tpu_torch/mpc/propagate.py``) on
the CPU: which solvers choose the fused chain (``forms["chain"]``), that on
the CPU the fused form runs the torch phases it ran before, bit for bit,
through the same methods and in the same host ranges, what ``chain_fused``
refuses, and that its launch count stays out of ``launch_counts()``.  The kernel itself runs on the card
(``tests/test_torch_propagate_cuda.py``).  This file imports neither jax
nor pint_tpu."""

import numpy as np
import pytest
import torch

from pint_tpu_torch.models import Pendulum, PlanarQuadrotor
from pint_tpu_torch.models.dynamics import Unicycle
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc import propagate
from pint_tpu_torch.mpc.propagate import chain_fused, chain_plain
from pint_tpu_torch.ops import kernels as K

UNI = dict(horizon=8, sqp_iters=2, pgd_iters=10)
PEND = dict(horizon=16, sqp_iters=2, pgd_iters=10, Q=np.diag([1.0, 0.05]),
            R=np.array([[0.05]]), x_ref=np.zeros(2), model=Pendulum())
QUAD = dict(horizon=16, sqp_iters=2, pgd_iters=10, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
            R=np.diag([0.05, 0.05]), x_ref=np.zeros(6), model=PlanarQuadrotor())
PROPAGATE = ("auto", "scan", "unroll", "allpairs")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _operands(B, T, seed):
    """Lanes over the whole int8 range and states whose heading spans
    several turns of both signs."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(-128, 128, (B, 2 * T), dtype=np.int32)
    x0 = np.stack([rng.uniform(-2, 2, B), rng.uniform(-2, 2, B),
                   rng.uniform(-3, 3, B)], -1).astype(np.float32)
    x0[: 4, 2] = (0.5, -0.25, 0.0, -1.0)[: min(4, B)]
    return torch.as_tensor(lanes), torch.as_tensor(x0)


@pytest.mark.parametrize("propagate", PROPAGATE)
def test_forms_choose_the_fused_chain_for_the_unicycle(propagate):
    """DeviceSQP takes the fused chain wherever its iteration runs the
    recursion, not for "allpairs"; DeviceConstrainedSQP, whose constraint
    rows run the recursion in every form, always."""
    sqp = DeviceSQP(**UNI, propagate=propagate, device="cpu")
    assert sqp.forms["chain"] == ("torch" if propagate == "allpairs" else "fused")
    assert DeviceConstrainedSQP(sqp).forms["chain"] == "fused"


@pytest.mark.parametrize("propagate", PROPAGATE)
def test_forms_choose_the_fused_chain_for_the_quadrotor(propagate):
    """The quadrotor has a form of the chain kernel too, chosen as the
    unicycle's."""
    sqp = DeviceSQP(**QUAD, propagate=propagate, device="cpu")
    assert sqp.forms["chain"] == ("torch" if propagate == "allpairs" else "fused")
    assert DeviceConstrainedSQP(sqp, F=np.eye(6)[4:5]).forms["chain"] == "fused"


class _QuadrotorOwnRollout(PlanarQuadrotor):
    """A quadrotor whose f32 rollout is its own (here the same map)."""

    def rollout_f32(self, state0_f, controls_f):
        return super().rollout_f32(state0_f, controls_f)


# the models with no chain kernel: the pendulum, and a quadrotor that
# overrides the dynamics the kernel computes
OTHER = {"pendulum": PEND, "quadrotor": dict(QUAD, model=_QuadrotorOwnRollout())}


@pytest.mark.parametrize("kw", list(OTHER.values()), ids=list(OTHER))
@pytest.mark.parametrize("propagate", PROPAGATE)
def test_other_models_take_the_torch_chain(kw, propagate):
    sqp = DeviceSQP(**kw, propagate=propagate, device="cpu")
    assert sqp.forms["chain"] == "torch"
    assert DeviceConstrainedSQP(sqp, F=np.eye(kw["Q"].shape[0])[:1]).forms["chain"] == "torch"


@pytest.mark.parametrize("base, method", [
    (Unicycle, "rollout_f32"), (Unicycle, "linearize_f32"),
    (PlanarQuadrotor, "rollout_f32"), (PlanarQuadrotor, "linearize_f32"),
])
def test_a_subclass_that_overrides_the_dynamics_takes_the_torch_chain(base, method):
    """The kernel computes its class's own ``rollout_f32`` and
    ``linearize_f32``; a subclass that overrides either, at any depth,
    keeps the torch chain, which calls the model's own methods, and
    ``chain_fused`` refuses it."""
    mine = type("Mine", (base,), {method: lambda self, *a: getattr(base, method)(self, *a)})
    deeper = type("Deeper", (mine,), {})
    kw = dict(UNI) if base is Unicycle else dict(QUAD)
    for cls in (mine, deeper):
        sqp = DeviceSQP(**dict(kw, model=cls()), device="cpu")
        assert sqp.forms["chain"] == "torch"
        assert DeviceConstrainedSQP(sqp, F=np.eye(sqp.Q.shape[0])[:1]).forms["chain"] == "torch"
        n = sqp.Q.shape[0]
        with pytest.raises(ValueError, match="no chain kernel"):
            chain_fused(sqp, torch.zeros((2, n)), torch.zeros((2, 8), dtype=torch.int32))


def test_a_subclass_that_turns_fused_chain_off_takes_the_torch_chain():
    class Mine(PlanarQuadrotor):
        fused_chain = False

    assert DeviceSQP(**dict(QUAD, model=Mine()), device="cpu").forms["chain"] == "torch"


@pytest.mark.parametrize("B, T", [(5, 1), (7, 5), (3, 32), (2, 33)])
def test_chain_fused_on_the_cpu_is_the_plain_chain(B, T):
    """On the CPU ``chain_fused`` is its plain version, which is the
    solver's ``_linearize_phase`` then ``_propagate_unrolled``, bit for
    bit, and launches nothing."""
    sqp = DeviceSQP(**UNI, device="cpu")         # the lanes' width sets T
    lanes, x0 = _operands(B, T, 10 + T)
    before = propagate.launch_count()
    got = chain_fused(sqp, x0, lanes)
    assert propagate.launch_count() == before
    want = chain_plain(sqp, x0, lanes)
    A, Bl, c = sqp._linearize_phase(x0, lanes)
    old = sqp._propagate_unrolled(A, Bl, c)
    shapes = [(B, T, 3, 3), (B, T, 3, 2 * T), (B, T, 3)]
    for g, w, o, shape in zip(got, want, old, shapes, strict=True):
        assert g.shape == shape and g.dtype == torch.float32
        assert torch.equal(_bits(g), _bits(w)) and torch.equal(_bits(g), _bits(o))


def _quad_operands(B, T, seed):
    rng = np.random.default_rng(seed)
    lanes = rng.integers(-128, 128, (B, 2 * T), dtype=np.int32)
    x0 = rng.uniform(-2, 2, (B, 6)).astype(np.float32)
    x0[:, 2] = rng.uniform(-3, 3, B)
    x0[: 4, 2] = (0.5, -0.25, 0.0, -1.0)[: min(4, B)]
    return torch.as_tensor(lanes), torch.as_tensor(x0)


@pytest.mark.parametrize("B, T", [(5, 1), (7, 5), (4, 16), (2, 33)])
def test_chain_fused_on_the_cpu_is_the_plain_chain_for_the_quadrotor(B, T):
    """As for the unicycle: on the CPU ``chain_fused`` is ``chain_plain``
    bit for bit, at n 6, and launches nothing."""
    sqp = DeviceSQP(**QUAD, device="cpu")
    lanes, x0 = _quad_operands(B, T, 20 + T)
    before = propagate.launch_count()
    got = chain_fused(sqp, x0, lanes)
    assert propagate.launch_count() == before
    want = chain_plain(sqp, x0, lanes)
    shapes = [(B, T, 6, 6), (B, T, 6, 2 * T), (B, T, 6)]
    for g, w, shape in zip(got, want, shapes, strict=True):
        assert g.shape == shape and g.dtype == torch.float32
        assert torch.equal(_bits(g), _bits(w))
    with pytest.raises(ValueError, match="x0_f"):
        chain_fused(sqp, x0[:, :3], lanes)


@pytest.mark.parametrize("kind", ["rti", "crti"])
def test_the_cpu_path_runs_the_torch_phases(kind, monkeypatch):
    """A solver whose chain is "fused" runs, on the CPU, the phases it ran
    before: ``_linearize_phase`` and ``_propagate_unrolled`` once an SQP
    iteration, each in its own host range, and launches no kernel."""
    sqp = DeviceSQP(**UNI, device="cpu")
    solver = sqp if kind == "rti" else DeviceConstrainedSQP(sqp, alm_outer=2)
    assert solver.forms["chain"] == "fused"
    calls = []
    for name in ("_linearize_phase", "_propagate_unrolled"):
        def spy(self, *a, _orig=getattr(DeviceSQP, name), _name=name):
            calls.append(_name)
            return _orig(self, *a)
        monkeypatch.setattr(DeviceSQP, name, spy)

    ranges = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            ranges.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(propagate, "span", Range)
    _, x0 = _operands(3, UNI["horizon"], 4)
    before = propagate.launch_count()
    solver.solve_words(solver.init_words(3), x0)
    assert propagate.launch_count() == before
    assert calls == ["_linearize_phase", "_propagate_unrolled"] * UNI["sqp_iters"]
    assert ranges == ["pint.sqp.linearize", "pint.sqp.propagate"] * UNI["sqp_iters"]


def test_the_cpu_solve_is_unchanged_by_the_chain_form():
    """The fused and the torch chain give one CPU solve the same words."""
    sqp = DeviceSQP(**UNI, device="cpu")
    torch_chain = DeviceSQP(**UNI, device="cpu")
    torch_chain.__dict__["forms"] = dict(sqp.forms, chain="torch")
    _, x0 = _operands(6, UNI["horizon"], 5)
    w = sqp.solve_words(sqp.init_words(6), x0)
    assert torch.equal(w, torch_chain.solve_words(torch_chain.init_words(6), x0))


@pytest.mark.parametrize("bad", [
    dict(model=Pendulum()),
    dict(lanes=torch.zeros((4, 9), dtype=torch.int32)),
    dict(lanes=torch.zeros((4, 8), dtype=torch.int64)),
    dict(x0=torch.zeros((4, 2))),
    dict(x0=torch.zeros((3, 3))),
    dict(x0=torch.zeros((4, 3), dtype=torch.float64)),
], ids=["model", "odd-lanes", "int64-lanes", "x0-width", "x0-batch", "x0-f64"])
def test_chain_fused_refuses_what_the_kernel_does_not_take(bad):
    sqp = DeviceSQP(**dict(UNI, horizon=4), device="cpu")
    if "model" in bad:
        sqp = DeviceSQP(**dict(PEND, horizon=4), device="cpu")
    args = dict(x0=torch.zeros((4, 3)), lanes=torch.zeros((4, 8), dtype=torch.int32))
    args.update({k: v for k, v in bad.items() if k != "model"})
    with pytest.raises(ValueError):
        chain_fused(sqp, args["x0"], args["lanes"])


def test_a_subclass_of_the_unicycle_keeps_the_fused_chain():
    """The choice reads the model's ``fused_chain``, not its exact class."""
    class Mine(Unicycle):
        pass

    sqp = DeviceSQP(**UNI, model=Mine(), device="cpu")
    assert sqp.forms["chain"] == "fused"
    assert DeviceConstrainedSQP(sqp).forms["chain"] == "fused"


def test_the_chain_launch_count_is_kept_apart():
    """``launch_counts()`` keeps the names of ``KERNELS`` alone; the
    chain's count is :func:`propagate.launch_count`, and a reset zeroes
    it too."""
    assert set(K.launch_counts()) == set(K.KERNELS)
    assert "propagate" not in K.KERNELS
    before, counts = propagate.launch_count(), K.launch_counts()
    K.count_launch("propagate")
    assert propagate.launch_count() == before + 1
    assert K.launch_counts() == counts
    K.reset_launch_counts()
    assert propagate.launch_count() == 0
