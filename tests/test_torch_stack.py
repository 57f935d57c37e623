"""An SQP iteration's constraint stacking (``pint_tpu_torch/mpc/stack.py``)
on the CPU: the plain version against the torch form it replaces
(``DeviceConstrainedSQP._stack_einsum``, two einsums) on the same stacks;
the shapes and memory order K6 and ``_pen_lipschitz`` read; which solvers
choose the kernel's form (``forms["stack"]``) and the bounds of its fit;
that a NaN stays in its problem's rows; what ``stack_fused`` refuses; and
that its launch count stays out of ``launch_counts()``.  The kernel itself
runs on the card (``tests/test_torch_stack_cuda.py``).

Tolerances: against the einsums, whose sums run in the GEMM's order,
rtol 1e-5 and atol 1e-5 on entries of order one (sums of at most six
products); on a one-hot F none, the signs of zeros aside (``+ 0.0`` turns
-0.0 into +0.0 on both sides), since each row is then one stack entry.
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.models import PlanarQuadrotor
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc import stack
from pint_tpu_torch.mpc.condense_fused import pen_plain
from pint_tpu_torch.mpc.propagate import chain_plain
from pint_tpu_torch.mpc.stack import stack_fits, stack_fused, stack_plain
from pint_tpu_torch.ops import kernels as K

UNI = dict(sqp_iters=1, pgd_iters=10, Q=np.diag([1.0, 1.0, 0.02]), R=np.diag([0.02, 0.02]),
           qf_scale=20.0, x_ref=np.array([1.0, 0.0, 0.0]))
QUAD = dict(sqp_iters=1, pgd_iters=10, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
            R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6))
CORRIDOR = dict(lo=-0.03, hi=0.03, rho=100.0, alm_outer=2)
ONE_HOT = {3: np.array([[0.0, 1.0, 0.0]]), 6: np.array([[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]])}
"""The benchmark cells' corridors: the unicycle's lateral offset, the
quadrotor's vertical speed."""


def _bits(t):
    return (t + 0.0).contiguous().view(torch.int32)


def _solver(n, T, F, **kw):
    dev = (DeviceSQP(horizon=T, **UNI, device="cpu") if n == 3 else
           DeviceSQP(horizon=T, model=PlanarQuadrotor(), **QUAD, device="cpu"))
    Cs = np.atleast_2d(F).shape[0]
    return DeviceConstrainedSQP(dev, F=F, **dict(CORRIDOR, lo=-0.03 * np.ones(Cs),
                                                 hi=0.03 * np.ones(Cs)), **kw)


def _random_stacks(B, T, n, seed):
    """Random stacks whose dead columns are zero, as the recursion's are."""
    rng = np.random.default_rng(seed)
    Tm = 2 * T
    live = (np.arange(T)[:, None] >= np.arange(Tm)[None, :] // 2)[None, :, None, :]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32))

    return (t(rng.normal(size=(B, T, n, n))), t(rng.normal(size=(B, T, n, Tm)) * live),
            t(rng.normal(size=(B, T, n))))


def _chain_stacks(csqp, B, seed):
    """The torch chain's stacks of a warm plan: what the solver stacks."""
    rng = np.random.default_rng(seed)
    d = csqp.dev
    n = np.asarray(d.Q).shape[0]
    x0 = torch.as_tensor((rng.normal(size=(B, n)) * 0.3).astype(np.float32))
    lanes = torch.as_tensor(rng.integers(-60, 60, (B, d.n_dec), dtype=np.int32))
    return chain_plain(d, x0, lanes)


@pytest.mark.parametrize("Cs", [1, 2, 3])
@pytest.mark.parametrize("n", [3, 6])
def test_plain_matches_the_einsums(n, Cs):
    """Random F with Cs rows, random stacks: the plain version against the
    torch form to f32 roundoff, in the same shapes."""
    T, B = 6, 5
    F = np.random.default_rng(n + 10 * Cs).normal(size=(Cs, n))
    csqp = _solver(n, T, F)
    assert csqp.forms["stack"] == "kernel"
    args = _random_stacks(B, T, n, 7 * n + Cs)
    got = stack_plain(csqp._F, *args)
    want = csqp._stack_einsum(*args)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stacks", ["random", "chain"])
@pytest.mark.parametrize("n, T", [(3, 32), (3, 128), (6, 16), (6, 6)])
def test_one_hot_rows_are_the_einsums_bit_for_bit(n, T, stacks):
    """The cells' one-hot F: every row is one stack entry, in either form,
    so the two agree bit for bit (zeros' signs aside), on random stacks and
    on the chain's; ``_stack_constraints`` takes the plain version here."""
    csqp = _solver(n, T, ONE_HOT[n])
    B = 7
    args = (_random_stacks(B, T, n, T) if stacks == "random" else _chain_stacks(csqp, B, T))
    want = csqp._stack_einsum(*args)
    for got in (stack_plain(csqp._F, *args), stack_fused(csqp._F, *args),
                csqp._stack_constraints(*args)):
        for g, w in zip(got, want, strict=True):
            assert torch.equal(_bits(g), _bits(w))


def test_two_one_hot_rows():
    """Two rows a step (Cs 2), each one-hot: row k Cs + c is constraint c
    at step k + 1, as in the einsums."""
    csqp = _solver(3, 8, np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]))
    args = _random_stacks(5, 8, 3, 2)
    S_t, P_t, r_t = stack_plain(csqp._F, *args)
    Abar, Bbar, Cbar = args
    assert torch.equal(_bits(S_t[2 * 3 + 1]), _bits(Bbar[:, 3, 0].T))
    assert torch.equal(_bits(P_t[2 * 5]), _bits(Abar[:, 5, 1].T))
    assert torch.equal(_bits(r_t[2 * 7 + 1]), _bits(Cbar[:, 7, 0]))
    for g, w in zip((S_t, P_t, r_t), csqp._stack_einsum(*args), strict=True):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n, T", [(3, 32), (3, 128), (6, 16)])
def test_shapes_and_order_as_k6_reads_them(n, T):
    """S_t (C, Tm, B) contiguous, P_t (C, n, B), r_t (C, B), f32; K6's plain
    version and ``_pen_lipschitz`` take S_t, and on the cells' one-hot F
    K6 gives the torch form's bits."""
    csqp = _solver(n, T, ONE_HOT[n])
    B = 9
    args = _chain_stacks(csqp, B, 5)
    S_t, P_t, r_t = stack_plain(csqp._F, *args)
    C, Tm = csqp.n_rows, csqp.dev.n_dec
    assert S_t.shape == (C, Tm, B) and P_t.shape == (C, n, B) and r_t.shape == (C, B)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (S_t, P_t, r_t))
    pen, pen_w = pen_plain(S_t, power_iters=4), pen_plain(
        csqp._stack_einsum(*args)[0], power_iters=4)
    for a, b in zip(pen, pen_w, strict=True):
        assert torch.equal(a, b)
    assert csqp._pen_lipschitz(S_t).shape == (B,)


def test_nan_stays_in_its_problem():
    """A NaN in one problem's dead columns and another's Abar reaches
    their rows, where F is zero too (0 * NaN), and no other problem's."""
    csqp = _solver(3, 8, np.array([[0.0, 1.0, 0.0], [0.5, -0.25, 2.0]]))
    Abar, Bbar, Cbar = _random_stacks(6, 8, 3, 4)
    clean = stack_plain(csqp._F, Abar, Bbar, Cbar)
    Abar, Bbar = Abar.clone(), Bbar.clone()
    Bbar[1, 2, 0, -4:] = float("nan")            # row 0 of F has a zero there
    Abar[4, 6, 2, 1] = float("nan")
    S_t, P_t, r_t = stack_plain(csqp._F, Abar, Bbar, Cbar)
    keep = [0, 2, 3, 5]
    for g, w in zip((S_t, P_t, r_t), clean, strict=True):
        assert torch.equal(_bits(g[..., keep]), _bits(w[..., keep]))
    assert torch.isnan(S_t[2 * 2:2 * 2 + 2, -4:, 1]).all()
    assert torch.isnan(P_t[2 * 6:2 * 6 + 2, 1, 4]).all()


CELLS = [(3, 1, 32, 64), (3, 1, 128, 256), (6, 1, 16, 32)]
"""(n, Cs, T, Tm) of the four constrained cells: crti_t32 (both fleets),
crti_t128 and cquad_t16."""


@pytest.mark.parametrize("n, Cs, T, Tm", CELLS)
def test_the_cells_fit(n, Cs, T, Tm):
    assert stack_fits(n, Cs, T, Tm)


@pytest.mark.parametrize("n, Cs, T, Tm, fits", [
    (6, 1, 16, 32, True), (7, 1, 16, 32, False), (0, 1, 16, 32, False),
    (3, 8, 16, 32, True), (3, 9, 16, 32, False), (3, 0, 16, 32, False),
    (3, 1, 17, 34, False), (2, 1, 6, 6, False), (2, 1, 68, 68, True),
    (3, 1, 65535, 131070 + 2, True), (3, 1, 65536, 131072, False),
    (3, 1, 2, 32 * 65535, True), (3, 1, 2, 32 * 65535 + 4, False), (3, 1, 0, 4, False)])
def test_stack_fits_bounds(n, Cs, T, Tm, fits):
    """n to 6, Cs to 8, Tm a multiple of 4, T and Tm / 32 to 65535."""
    assert stack_fits(n, Cs, T, Tm) == fits


@pytest.mark.parametrize("n, T", [(3, 32), (3, 128), (6, 16), (3, 144), (3, 300)])
def test_forms_choose_the_stack_kernel(n, T):
    """Every constrained solver at one-hot F takes the kernel's form, past
    K3's and K5's fits too (T 144, 300); ``DeviceSQP`` stacks nothing."""
    csqp = _solver(n, T, ONE_HOT[n])
    assert csqp.forms["stack"] == "kernel"
    assert "stack" not in csqp.dev.forms


def test_past_the_fit_takes_the_einsums():
    """Nine rows a step (Cs 9) are past the kernel: the torch form, as
    before, in ``_stack_constraints`` and in a whole solve."""
    F = np.eye(3)[[1, 0, 2, 1, 0, 2, 1, 0, 2]]
    csqp = _solver(3, 4, F)
    assert csqp.forms["stack"] == "torch"
    args = _random_stacks(3, 4, 3, 9)
    for g, w in zip(csqp._stack_constraints(*args), csqp._stack_einsum(*args), strict=True):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="past the kernel's fit"):
        stack_plain(csqp._F, *args)
    x0 = np.array([[0.1, 0.02, 0.3], [-0.2, -0.01, -0.5]], np.float32)
    words, lam = csqp.solve_words(csqp.init_words(2), x0)
    assert words.shape == (2, 2) and lam.shape == (2, csqp.padded_rows)


@pytest.mark.parametrize("n, T", [(3, 32), (6, 16)])
def test_either_form_gives_the_same_solve(n, T):
    """On the cells' one-hot F, warm solves through the plain version and
    through the einsums give the same words and multipliers."""
    kern = _solver(n, T, ONE_HOT[n])
    torch_form = _solver(n, T, ONE_HOT[n])
    torch_form.__dict__["forms"] = dict(kern.forms, stack="torch")
    rng = np.random.default_rng(T)
    x0 = (rng.normal(size=(6, n)) * 0.2).astype(np.float32)
    out = []
    for csqp in (kern, torch_form):
        words, lam = csqp.solve_words(csqp.init_words(6), x0)
        out.append(csqp.solve_words(words, x0, lam))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_stack_fused_refuses():
    """Shapes, dtypes and devices it does not take, and shapes past the
    fit."""
    F = ONE_HOT[3]
    Abar, Bbar, Cbar = _random_stacks(3, 4, 3, 1)
    with pytest.raises(ValueError, match="Bbar must be"):
        stack_fused(F, Abar, Bbar[0], Cbar)
    with pytest.raises(ValueError, match="F must be"):
        stack_fused(ONE_HOT[6], Abar, Bbar, Cbar)
    with pytest.raises(ValueError, match="Abar must be"):
        stack_fused(F, Abar.double(), Bbar, Cbar)
    with pytest.raises(ValueError, match="Cbar must be"):
        stack_fused(F, Abar, Bbar, Cbar[:2])
    with pytest.raises(ValueError, match="past the kernel's fit"):
        stack_fused(F, Abar, Bbar[..., :6].contiguous(), Cbar)


def test_the_stack_launch_count_is_kept_apart():
    """``launch_counts()`` keeps the names of ``KERNELS`` alone; the
    stacking's count is :func:`stack.launch_count`, the CPU's plain version
    adds nothing to it, and a reset zeroes it."""
    assert set(K.launch_counts()) == set(K.KERNELS)
    assert "stack" not in K.KERNELS
    before, counts = stack.launch_count(), K.launch_counts()
    stack_fused(ONE_HOT[3], *_random_stacks(3, 4, 3, 1))
    assert stack.launch_count() == before
    K.count_launch("stack")
    assert stack.launch_count() == before + 1
    assert K.launch_counts() == counts
    K.reset_launch_counts()
    assert stack.launch_count() == 0
