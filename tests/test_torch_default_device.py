"""The port's entry points run on the card unless the caller asks for the CPU.

Constructed with no ``device``, each entry point resolves ``"cuda"``: on a
machine without a card that raises ``RuntimeError`` (nothing falls back to
the CPU), on a machine with one the result lives on the card.  With
``device="cpu"`` each one builds on the host and runs the plain versions.
"""

import numpy as np
import pytest
import torch

import pint_tpu_torch as pt
from pint_tpu_torch.convert import words_from_numpy
from pint_tpu_torch.mpc import (
    AcceleratedPGD,
    ConstrainedController,
    ConstrainedPGD,
    DeviceSQP,
    FixedPointPGD,
    FusedPGD,
    condense_double_integrator,
    constrain_states,
    quantize,
    quantize_constrained,
)


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
    "PackedArray.zeros": lambda **kw: pt.PackedArray.zeros(
        pt.PackedLayout(8, 8, 8, 8), (3,), **kw),
    "words_from_numpy": lambda **kw: words_from_numpy(
        np.arange(6, dtype=np.uint32), **kw),
}


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
