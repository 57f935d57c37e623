"""An SQP iteration's reduce (``pint_tpu_torch/mpc/reduce.py``) on the CPU:
the plain version against the torch ``_reduce_sym`` it replaces and against
pint_tpu's ``_reduce_sym``, on the same stacks; which solvers choose the
kernel's form (``forms["reduce"]``) and the bounds of its fit; that a
problem with a NaN changes no other problem's bits; that Ht is exactly
symmetric; what ``reduce_fused`` refuses; and that its launch count stays
out of ``launch_counts()``.  The kernel itself runs on the card
(``tests/test_torch_reduce_cuda.py``).

Tolerances: those of ``tests/test_torch_forms.py``'s reduce forms (Ht
within 1e-5 of max|Ht|, g rtol 1e-5, atol 1e-4): the plain version sums in
the kernel's order, the others in their GEMM's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import Pendulum as JPendulum
from pint_tpu.models import PlanarQuadrotor as JQuad
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu_torch.convert import device_sqp_config
from pint_tpu_torch.models import Pendulum
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc import reduce
from pint_tpu_torch.mpc.propagate import chain_plain
from pint_tpu_torch.mpc.reduce import reduce_fits, reduce_fused, reduce_plain
from pint_tpu_torch.ops import kernels as K

UNI = dict(sqp_iters=1, pgd_iters=10, Q=np.diag([1.0, 1.0, 0.02]), R=np.diag([0.02, 0.02]),
           qf_scale=20.0, x_ref=np.array([1.0, 0.0, 0.0]))
PEND = dict(sqp_iters=1, pgd_iters=10, Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
            x_ref=np.zeros(2))
QUAD = dict(sqp_iters=1, pgd_iters=10, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
            R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6))
CASES = {"unicycle-T32": (None, UNI, 32), "unicycle-T128": (None, UNI, 128),
         "pendulum-T16": (JPendulum, PEND, 16), "quadrotor-T16": (JQuad, QUAD, 16)}


def _bits(t):
    return t.contiguous().view(torch.int32)


def _close_to_max(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= rel * (np.abs(b).max() + 1e-12)


@pytest.fixture(scope="module", params=list(CASES))
def jax_stacks(request):
    """JAX's linearization and scan stacks of a warm plan of B = 5 (not a
    multiple of the kernel's group of 8), and both solvers."""
    cls, kw, T = CASES[request.param]
    ref = JDeviceSQP(horizon=T, propagate="scan", **kw, **({} if cls is None else
                                                           dict(model=cls())))
    port = device_sqp_config(ref, device="cpu")
    rng = np.random.default_rng(T)
    n = np.asarray(kw["Q"]).shape[0]
    x0 = (rng.normal(size=(5, n)) * 0.3).astype(np.float32)
    lanes = rng.integers(-60, 60, (5, ref.n_dec), dtype=np.int32)
    lin = jax.jit(ref._linearize_phase)(jnp.asarray(x0), jnp.asarray(lanes))
    stacks = [np.asarray(v) for v in jax.jit(ref._propagate_scan)(*lin)]
    return ref, port, x0, stacks


def _port_stacks(stacks, x0):
    """JAX's batch-last stacks (T, n, ..., B) -> the port's (B, T, n, ...)."""
    return [torch.as_tensor(np.ascontiguousarray(np.moveaxis(s, -1, 0))) for s in stacks] + [
        torch.as_tensor(x0)]


@pytest.mark.parametrize("against", ["torch_sym", "jax_sym"])
def test_reduce_plain_matches_sym(jax_stacks, against):
    """The plain version against the torch ``_reduce_sym`` and JAX's
    ``_reduce_sym`` on the same stacks, in the same order of Ht."""
    ref, port, x0, stacks = jax_stacks
    args = _port_stacks(stacks, x0)
    assert port.forms["reduce"] == "kernel"
    Ht, g = reduce_plain(port, *args)
    if against == "torch_sym":
        Ht_w, g_w = (t.numpy() for t in port._reduce_sym(*args))
    else:
        Ht_w, g_w = (np.asarray(v) for v in jax.jit(ref._reduce_sym)(
            *(jnp.asarray(s) for s in stacks), jnp.asarray(x0)))
    assert Ht.shape == Ht_w.shape
    _close_to_max(Ht.numpy(), Ht_w, 1e-5)
    np.testing.assert_allclose(g.numpy(), g_w, rtol=1e-5, atol=1e-4)


def test_ht_is_exactly_symmetric_and_handed_over(jax_stacks):
    """Ht is its own transpose bit for bit, batch-last to 64 lanes and the
    problem-major view past them, as ``_hand_over`` gives it; on the CPU
    ``reduce_fused`` is the plain version."""
    _, port, x0, stacks = jax_stacks
    args = _port_stacks(stacks, x0)
    Ht, g = reduce_plain(port, *args)
    assert torch.equal(_bits(Ht), _bits(Ht.transpose(0, 1)))
    if port.n_dec > K.LONG_LANES:
        assert K.problem_major(Ht, 0) and not Ht.is_contiguous()
    else:
        assert Ht.is_contiguous()
    Ht_f, g_f = reduce_fused(port, *args)
    assert torch.equal(_bits(Ht_f), _bits(Ht)) and torch.equal(_bits(g_f), _bits(g))


@pytest.mark.parametrize("T", [14, 34])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_every_state_dim_matches_sym(n, T):
    """Every n the kernel takes, on random stacks whose dead columns are
    zero as the recursion's are, with a dense PSD Q: the plain version
    against the torch ``_reduce_sym``, Ht exactly symmetric.  Random stacks
    cancel where physical ones do not, so g too is held within 1e-5 of its
    largest magnitude."""
    rng = np.random.default_rng(10 * n + T)
    M = rng.normal(size=(n, n))
    sqp = DeviceSQP(horizon=T, Q=M @ M.T + 0.1 * np.eye(n), R=np.diag([0.03, 0.02]),
                    x_ref=rng.normal(size=n), device="cpu")
    B, Tm = 5, 2 * T
    live = (np.arange(T)[:, None] >= np.arange(Tm)[None, :] // 2)[None, :, None, :]
    args = [torch.as_tensor(np.ascontiguousarray(x, np.float32)) for x in (
        rng.normal(size=(B, T, n, n)), rng.normal(size=(B, T, n, Tm)) * live,
        rng.normal(size=(B, T, n)), rng.normal(size=(B, n)))]
    Ht, g = reduce_plain(sqp, *args)
    Ht_w, g_w = sqp._reduce_sym(*args)
    _close_to_max(Ht.numpy(), Ht_w.numpy(), 1e-5)
    _close_to_max(g.numpy(), g_w.numpy(), 1e-5)
    assert torch.equal(_bits(Ht), _bits(Ht.transpose(0, 1)))


@pytest.mark.parametrize("T", [16, 128])
def test_nan_changes_no_other_problem(T):
    """NaN in the dead columns of one problem's Bbar changes nothing; a
    NaN state makes that problem's g NaN and leaves every other problem's
    Ht and g bits as they were."""
    sqp = DeviceSQP(horizon=T, **UNI, device="cpu")
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor((rng.normal(size=(6, 3)) * 0.3).astype(np.float32))
    lanes = torch.as_tensor(rng.integers(-60, 60, (6, 2 * T), dtype=np.int32))
    Abar, Bbar, Cbar = chain_plain(sqp, x0, lanes)
    clean = reduce_plain(sqp, Abar, Bbar, Cbar, x0)
    Bbar, x0 = Bbar.clone(), x0.clone()
    Bbar[1, : T - 2, :, -4:] = float("nan")
    x0[4, 2] = float("nan")
    Ht, g = reduce_plain(sqp, Abar, Bbar, Cbar, x0)
    keep = [0, 1, 2, 3, 5]
    assert torch.equal(_bits(Ht), _bits(clean[0]))
    assert torch.equal(_bits(g[keep]), _bits(clean[1][keep]))
    assert torch.isnan(g[4]).all()


PROPAGATE = ("auto", "scan", "unroll", "allpairs")


@pytest.mark.parametrize("form", ["sym", "einsum", "blocked", "btrans"])
@pytest.mark.parametrize("propagate", PROPAGATE)
def test_forms_choose_the_reduce_kernel(propagate, form):
    """DeviceSQP takes the kernel's form for "sym" wherever its iteration
    runs the recursion; DeviceConstrainedSQP, whose constraint rows run the
    recursion in every form, for "sym" always; every other contraction
    keeps its torch form."""
    sqp = DeviceSQP(horizon=16, **UNI, propagate=propagate, reduce=form, device="cpu")
    sym = form == "sym"
    assert sqp.forms["reduce"] == ("kernel" if sym and propagate != "allpairs" else "torch")
    assert DeviceConstrainedSQP(sqp).forms["reduce"] == ("kernel" if sym else "torch")


@pytest.mark.parametrize("n, m, T, fits", [
    (3, 2, 2048, True), (3, 2, 2050, False), (3, 4, 1024, True), (3, 4, 1025, False),
    (6, 2, 16, True), (7, 2, 16, False), (1, 4, 1, True), (0, 2, 16, False),
    (2, 1, 6, False), (2, 1, 68, True), (3, 0, 16, False), (3, 2, 0, False)])
def test_reduce_fits_bounds(n, m, T, fits):
    """n to 6, Tm = T m to 4096 and a multiple of 4."""
    assert reduce_fits(n, m, T) == fits


def test_past_the_fit_takes_the_torch_form():
    """Past Tm 4096 both solvers keep ``_reduce_sym`` (built, not solved)."""
    sqp = DeviceSQP(horizon=2050, **UNI, device="cpu")
    assert sqp.forms["reduce"] == "torch"
    assert DeviceConstrainedSQP(sqp).forms["reduce"] == "torch"
    assert DeviceSQP(horizon=2048, **UNI, device="cpu").forms["reduce"] == "kernel"


def test_other_models_take_the_kernel_form():
    sqp = DeviceSQP(horizon=16, model=Pendulum(), **PEND, device="cpu")
    assert (sqp.forms["chain"], sqp.forms["reduce"]) == ("torch", "kernel")


def test_reduce_fused_refuses():
    """Shapes, dtypes and devices it does not take, and a solver that has
    no L (an indefinite Q needs ``reduce="einsum"``)."""
    sqp = DeviceSQP(horizon=8, **UNI, device="cpu")
    x0 = torch.zeros((3, 3))
    lanes = torch.zeros((3, 16), dtype=torch.int32)
    Abar, Bbar, Cbar = chain_plain(sqp, x0, lanes)
    with pytest.raises(ValueError, match="Bbar must be"):
        reduce_fused(sqp, Abar, Bbar[:, :, :, :-2], Cbar, x0)
    with pytest.raises(ValueError, match="Abar must be"):
        reduce_fused(sqp, Abar.double(), Bbar, Cbar, x0)
    with pytest.raises(ValueError, match="x0_f must be"):
        reduce_fused(sqp, Abar, Bbar, Cbar, x0[:2])
    with pytest.raises(ValueError, match="horizon"):
        reduce_fused(DeviceSQP(horizon=4, **UNI, device="cpu"), Abar, Bbar, Cbar, x0)
    with pytest.raises(ValueError, match="needs reduce='sym'"):
        reduce_fused(dataclasses.replace(sqp, reduce="einsum"), Abar, Bbar, Cbar, x0)


def test_the_reduce_launch_count_is_kept_apart():
    """``launch_counts()`` keeps the names of ``KERNELS`` alone; the
    reduce's count is :func:`reduce.launch_count`, and a reset zeroes it
    too."""
    assert set(K.launch_counts()) == set(K.KERNELS)
    assert "reduce" not in K.KERNELS
    before, counts = reduce.launch_count(), K.launch_counts()
    K.count_launch("reduce")
    assert reduce.launch_count() == before + 1
    assert K.launch_counts() == counts
    K.reset_launch_counts()
    assert reduce.launch_count() == 0
