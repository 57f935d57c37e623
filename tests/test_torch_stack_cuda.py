"""An SQP iteration's constraint stacking in one kernel (``csrc/stack.cu``
through :func:`~pint_tpu_torch.mpc.stack.stack_fused`) against its plain
version (:func:`~pint_tpu_torch.mpc.stack.stack_plain`) on the card.

Tolerance: none.  S_t, P_t and r_t are compared as int32 bits, so +0.0 and
-0.0 differ and a NaN must stand where the plain version's stands: on the
chain kernel's stacks at the benchmark cells' shapes (T 32 at B 4096 and
16384, T 128 at B 4096, the quadrotor's T 16 at B 4096) and one-hot F; at
batches that are not a multiple of the kernel's 32 problems, at Tm not a
multiple of its 32 columns, with two and three rows of F a step, random F
and every n from 1 to 6; on the torch chain's stacks of states that are
not finite (NaN in the dead columns too).  A captured and replayed graph
gives the eager call's bits; warm solves launch it once an SQP iteration
and give the einsums' words and multipliers on the cells' one-hot F.

Every test needs an NVIDIA GPU and skips without one.  This file imports
neither jax nor pint_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_stack_cuda.py
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.models import PlanarQuadrotor
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc import stack
from pint_tpu_torch.mpc.propagate import chain_fused, chain_plain
from pint_tpu_torch.mpc.stack import stack_fused, stack_plain

pytestmark = pytest.mark.cuda

UNI = dict(sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
           Q=np.diag([1.0, 1.0, 0.02]), R=np.diag([0.02, 0.02]), qf_scale=20.0,
           x_ref=np.array([1.0, 0.0, 0.0]))
QUAD = dict(sqp_iters=1, pgd_iters=30, power_iters=16, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
            R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6))
ONE_HOT = {3: np.array([[0.0, 1.0, 0.0]]), 6: np.array([[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]])}
"""The benchmark's corridors: crti_t32 and crti_t128 (n 3), cquad_t16 (n 6)."""


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _dev(n, T, cuda, **kw):
    if n == 3:
        return DeviceSQP(horizon=T, **UNI, device=cuda, **kw)
    return DeviceSQP(horizon=T, model=PlanarQuadrotor(), **QUAD, device=cuda, **kw)


def _stacks(sqp, cuda, B, seed, fused=True):
    rng = np.random.default_rng(seed)
    n = np.asarray(sqp.Q).shape[0]
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, sqp.n_dec), dtype=np.int32),
                            device=cuda)
    x0 = torch.as_tensor((rng.normal(size=(B, n)) * 0.3).astype(np.float32), device=cuda)
    return (chain_fused if fused else chain_plain)(sqp, x0, lanes), x0


def _same(F, args):
    """The kernel's rows bit for bit its plain version's, in the same
    shapes and order."""
    got, want = stack_fused(F, *args), stack_plain(F, *args)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.is_contiguous() and w.is_contiguous()
        assert torch.equal(_bits(g), _bits(w))
    return got


CELLS = [(3, 32, 4096), (3, 32, 16384), (3, 128, 4096), (6, 16, 4096)]
"""(n, T, B) of the four constrained cells."""


@pytest.mark.parametrize("n, T, B", CELLS, ids=str)
def test_kernel_equals_plain_at_the_cells(cuda, n, T, B):
    sqp = _dev(n, T, cuda)
    args, _ = _stacks(sqp, cuda, B, 7 * T + B)
    before = stack.launch_count()
    S_t, _, _ = _same(ONE_HOT[n], args)
    assert stack.launch_count() == before + 1
    assert S_t.shape == (T, 2 * T, B)


@pytest.mark.parametrize("n, T, B", [(3, 32, 37), (3, 128, 4097), (6, 16, 1001), (3, 18, 33),
                                     (3, 2, 1), (3, 34, 31), (6, 6, 65)], ids=str)
@pytest.mark.parametrize("Cs", [1, 2, 3])
def test_ragged_batches_and_rows(cuda, n, T, B, Cs):
    """Batches past a multiple of 32, Tm 36, 4 and 68 (a last column tile
    in part past Tm), Cs 1-3 rows of a random F."""
    sqp = _dev(n, T, cuda)
    args, _ = _stacks(sqp, cuda, B, T + Cs)
    F = np.random.default_rng(Cs + n).normal(size=(Cs, n))
    _same(F, args)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("Cs", [1, 5, 8])
def test_every_state_dim_and_row_count(cuda, n, Cs):
    """Every n and up to eight rows on random stacks and a random F with a
    zero and a negative zero in it."""
    rng = np.random.default_rng(10 * n + Cs)
    B, T, Tm = 45, 12, 40
    F = rng.normal(size=(Cs, n))
    F[0, 0], F[-1, -1] = 0.0, -0.0

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=cuda)

    _same(F, (t(B, T, n, n), t(B, T, n, Tm), t(B, T, n)))


@pytest.mark.parametrize("n, T", [(3, 32), (3, 128), (6, 16)])
def test_non_finite_states(cuda, n, T):
    """The torch chain's stacks where a heading is NaN and a position
    infinite: NaN in that problem's columns, dead ones too; the kernel puts
    every NaN where the plain version does and changes no other problem's
    bits."""
    sqp = _dev(n, T, cuda)
    B = 70
    rng = np.random.default_rng(3)
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, sqp.n_dec), dtype=np.int32),
                            device=cuda)
    x0 = torch.as_tensor((rng.normal(size=(B, n)) * 0.3).astype(np.float32), device=cuda)
    keep = [b for b in range(B) if b not in (5, 40)]
    x0[5, 2] = float("nan")
    x0[40, 0] = float("inf")
    Abar, Bbar, Cbar = chain_plain(sqp, x0, lanes)
    assert torch.isnan(Bbar[5]).any()
    for F in (ONE_HOT[n], np.random.default_rng(n).normal(size=(2, n))):
        got = _same(F, (Abar, Bbar, Cbar))
        assert torch.isnan(got[0][..., 5]).any()
        clean = stack_fused(F, *chain_plain(sqp, x0[keep], lanes[keep]))
        for g, w in zip(got, clean, strict=True):
            assert torch.equal(_bits(g[..., keep]), _bits(w))


@pytest.mark.parametrize("T", [32, 128])
def test_graph_replay_equals_eager(cuda, T):
    sqp = _dev(3, T, cuda)
    args, _ = _stacks(sqp, cuda, 1000, 4)
    F = np.array([[0.0, 1.0, 0.0], [0.3, -0.7, 0.1]])
    want = stack_fused(F, *args)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        stack_fused(F, *args)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = stack_fused(F, *args)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, want, strict=True):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("n, T", [(3, 32), (3, 128), (6, 16)])
def test_warm_solves_equal_the_einsums(cuda, n, T):
    """Warm ``solve_words`` (eager, captured, replayed) launch the kernel
    once an SQP iteration and give words and multipliers ``torch.equal`` to
    those of the einsum form and of ``use_kernels=False``, on the cells'
    one-hot F."""
    F = ONE_HOT[n]
    con = dict(F=F, lo=-0.03, hi=0.03, rho=100.0) if n == 3 else dict(
        F=F, lo=-0.15, hi=0.15, rho=50.0)
    kern = DeviceConstrainedSQP(_dev(n, T, cuda), **con)
    einsum = DeviceConstrainedSQP(_dev(n, T, cuda), **con)
    einsum.__dict__["forms"] = dict(kern.forms, stack="torch")
    plain = DeviceConstrainedSQP(_dev(n, T, cuda, use_kernels=False), **con)
    assert kern.forms["stack"] == "kernel"
    B = 512
    rng = np.random.default_rng(T)
    x0 = torch.as_tensor((rng.normal(size=(B, n)) * 0.2).astype(np.float32), device=cuda)
    outs = []
    for csqp in (kern, einsum, plain):
        words, lam = csqp.init_words(B), None
        for _ in range(3):
            before = stack.launch_count()
            words, lam = csqp.solve_words(words, x0, lam)
            torch.cuda.synchronize()
            assert stack.launch_count() - before == (csqp is kern)
        outs.append((words, lam))
    for words, lam in outs[1:]:
        assert torch.equal(words, outs[0][0]) and torch.equal(lam, outs[0][1])
