"""An SQP iteration's reduce in one kernel (``csrc/reduce.cu`` through
:func:`~pint_tpu_torch.mpc.reduce.reduce_fused`) against its plain version
(:func:`~pint_tpu_torch.mpc.reduce.reduce_plain`) on the card.

Tolerance: none.  Ht and g are compared as int32 bits, so +0.0 and -0.0
differ: on the stacks of the benchmark cells' solvers at their shapes (T 32
at B 4096 and 16384, T 128 at B 4096), at a batch that is not a multiple of
the kernel's group of 8 problems, at horizons whose Tm is not a multiple of
the 32-lane tile or of a sub-tile's 8 columns (batch-last and
problem-major), on the quadrotor (n 6) at T 16 and the pendulum (n 2, m 1)
at T 32 and 68, with a dense PSD Q, and on random stacks at every n from 1
to 6; NaN in one problem's dead columns or state changes no other
problem's bits; Ht is exactly symmetric and lies in the order the
quantization reads; a captured and replayed graph of the call gives the
eager call's bits; warm solves of both solvers launch it once an SQP
iteration, replays included, and give ``use_kernels=False``'s words.

Every test needs an NVIDIA GPU and skips without one.  This file imports
neither jax nor pint_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_reduce_cuda.py
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.models import Pendulum, PlanarQuadrotor
from pint_tpu_torch.mpc import DeviceSQP
from pint_tpu_torch.mpc import reduce
from pint_tpu_torch.mpc.propagate import chain_fused, chain_plain
from pint_tpu_torch.mpc.reduce import reduce_fused, reduce_plain
from pint_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

CELLS = {
    "rti": dict(sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
                Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]), qf_scale=60.0,
                x_ref=np.array([0.2, 0.1, 0.0])),
    "crti": dict(sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
                 Q=np.diag([1.0, 1.0, 0.02]), R=np.diag([0.02, 0.02]), qf_scale=20.0,
                 x_ref=np.array([1.0, 0.0, 0.0])),
}
"""The benchmark's solvers (``rti_t32``; ``crti_t32`` and ``crti_t128``)."""

SHAPES = [("rti", 32, 4096), ("rti", 32, 16384), ("crti", 128, 4096), ("crti", 32, 37),
          ("rti", 2, 3), ("crti", 34, 37), ("rti", 40, 1001), ("crti", 18, 9),
          ("rti", 100, 13)]
"""(solver, T, B): the cells' shapes first; then batches past a multiple of
8, Tm 4, 68 (problem-major, a last sub-tile half past Tm), 80, 36 (a
batch-last tile half past Tm) and 200."""


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _stacks(sqp, cuda, B, seed, fused=True):
    rng = np.random.default_rng(seed)
    n = np.asarray(sqp.Q).shape[0]
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, sqp.n_dec), dtype=np.int32),
                            device=cuda)
    x0 = torch.as_tensor((rng.normal(size=(B, n)) * 0.5).astype(np.float32), device=cuda)
    chain = chain_fused if fused else chain_plain
    return (*chain(sqp, x0, lanes), x0)


def _same(sqp, args):
    """The kernel's (Ht, g) bit for bit its plain version's; Ht exactly
    symmetric, in the order the quantization reads."""
    Ht, g = reduce_fused(sqp, *args)
    Ht_p, g_p = reduce_plain(sqp, *args)
    assert Ht.shape == Ht_p.shape and Ht.stride() == Ht_p.stride()
    assert K.problem_major(Ht, 0) == (sqp.n_dec > K.LONG_LANES)
    assert torch.equal(_bits(Ht), _bits(Ht_p))
    assert torch.equal(_bits(g), _bits(g_p))
    assert torch.equal(_bits(Ht), _bits(Ht.transpose(0, 1)))
    return Ht, g


@pytest.mark.parametrize("name, T, B", SHAPES, ids=lambda v: str(v))
def test_kernel_equals_plain_unicycle(cuda, name, T, B):
    sqp = DeviceSQP(horizon=T, **CELLS[name], device=cuda)
    assert sqp.forms["reduce"] == "kernel"
    before = reduce.launch_count()
    _same(sqp, _stacks(sqp, cuda, B, 7 * T + B))
    assert reduce.launch_count() == before + 1


MODELS = [
    ("quadrotor", dict(horizon=16, model=PlanarQuadrotor(),
                       Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]), R=np.diag([0.05, 0.05]),
                       x_ref=np.zeros(6)), 4096),
    ("quadrotor", dict(horizon=16, model=PlanarQuadrotor(),
                       Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]), R=np.diag([0.05, 0.05]),
                       x_ref=np.zeros(6)), 37),
    ("pendulum", dict(horizon=32, model=Pendulum(), Q=np.diag([1.0, 0.05]),
                      R=np.array([[0.05]]), x_ref=np.zeros(2)), 4096),
    ("pendulum", dict(horizon=68, model=Pendulum(), Q=np.diag([1.0, 0.05]),
                      R=np.array([[0.05]]), x_ref=np.zeros(2)), 37),
]


@pytest.mark.parametrize("name, kw, B", MODELS, ids=lambda v: str(v)[:12])
def test_kernel_equals_plain_other_models(cuda, name, kw, B):
    """The other models' stacks from the torch chain (the quadrotor's, which
    has a chain kernel too, from both), whose dead columns are +0.0 as the
    chain kernel's are."""
    sqp = DeviceSQP(**kw, device=cuda)
    assert sqp.forms["reduce"] == "kernel"
    assert sqp.forms["chain"] == ("fused" if name == "quadrotor" else "torch")
    if name == "quadrotor":
        _same(sqp, _stacks(sqp, cuda, B, 12))
    _same(sqp, _stacks(sqp, cuda, B, 11, fused=False))


def test_dense_q(cuda):
    """A dense PSD Q: L = V sqrt(w) has no zero, every term of every dot
    counts."""
    rng = np.random.default_rng(5)
    M = rng.normal(size=(3, 3))
    sqp = DeviceSQP(horizon=24, Q=M @ M.T + 0.1 * np.eye(3), R=np.array([[0.02, 0.004],
                    [0.004, 0.03]]), x_ref=np.array([0.3, -0.2, 0.1]), device=cuda)
    _same(sqp, _stacks(sqp, cuda, 515, 3))


@pytest.mark.parametrize("T", [14, 34, 42])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_every_state_dim(cuda, n, T):
    """Every n the kernel takes, batch-last (Tm 28) and problem-major (Tm 68,
    84: chunk buffers of every size), on random stacks whose dead columns
    are zero as the recursion's are, and a dense PSD Q."""
    rng = np.random.default_rng(10 * n + T)
    M = rng.normal(size=(n, n))
    sqp = DeviceSQP(horizon=T, Q=M @ M.T + 0.1 * np.eye(n), R=np.diag([0.03, 0.02]),
                    x_ref=rng.normal(size=n), device=cuda)
    assert sqp.forms["reduce"] == "kernel"
    B, Tm = 19, 2 * T
    live = (np.arange(T)[:, None] >= np.arange(Tm)[None, :] // 2)[None, :, None, :]
    Bbar = rng.normal(size=(B, T, n, Tm)) * live

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=cuda)

    _same(sqp, (t(rng.normal(size=(B, T, n, n))), t(Bbar), t(rng.normal(size=(B, T, n))),
                t(rng.normal(size=(B, n)))))


@pytest.mark.parametrize("T", [32, 128])
def test_nan_stays_in_its_row(cuda, T):
    """NaN in the dead columns of one problem's Bbar (those no step has
    reached) changes nothing, in either form; a NaN state x0 makes that
    problem's g NaN in both forms and changes no other problem's bits."""
    sqp = DeviceSQP(horizon=T, **CELLS["crti"], device=cuda)
    Abar, Bbar, Cbar, x0 = _stacks(sqp, cuda, 37, 9)
    clean = reduce_fused(sqp, Abar, Bbar, Cbar, x0)
    Bbar, x0 = Bbar.clone(), x0.clone()
    Bbar[5, : T - 2, :, -4:] = float("nan")   # steps T-2 and T-1's controls, before them
    x0[20, 1] = float("nan")
    keep = [b for b in range(37) if b != 20]
    for Ht, g in (reduce_fused(sqp, Abar, Bbar, Cbar, x0),
                  reduce_plain(sqp, Abar, Bbar, Cbar, x0)):
        assert torch.equal(_bits(Ht), _bits(clean[0]))
        assert torch.equal(_bits(g[keep]), _bits(clean[1][keep]))
        assert torch.isnan(g[20]).all()


@pytest.mark.parametrize("T", [32, 128])
def test_graph_replay_equals_eager(cuda, T):
    sqp = DeviceSQP(horizon=T, **CELLS["rti"], device=cuda)
    args = _stacks(sqp, cuda, 1000, 4)
    Ht, g = reduce_fused(sqp, *args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        reduce_fused(sqp, *args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = reduce_fused(sqp, *args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out[0]), _bits(Ht)) and torch.equal(_bits(out[1]), _bits(g))


def test_solver_launches_it_once_an_iteration(cuda):
    """A warm solve of each solver through ``solve_words`` (eager, captured,
    replayed) launches the reduce kernel once an SQP iteration, and gives
    the words of ``use_kernels=False``."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    for T in (32, 128):
        sqp = DeviceSQP(horizon=T, **dict(CELLS["crti"], sqp_iters=2), device=cuda)
        plain = DeviceSQP(horizon=T, **dict(CELLS["crti"], sqp_iters=2), device=cuda,
                          use_kernels=False)
        for make in (lambda s: s, lambda s: DeviceConstrainedSQP(s)):
            solver, ref = make(sqp), make(plain)
            assert solver.forms["reduce"] == "kernel"
            _, _, _, x0 = _stacks(sqp, cuda, 256, T)
            words = solver.init_words(256)
            want = ref.solve_words(words, x0)
            for _ in range(3):
                before = reduce.launch_count()
                got = solver.solve_words(words, x0)
                torch.cuda.synchronize()
                assert reduce.launch_count() - before == 2
                for a, b in zip(got if isinstance(got, tuple) else (got,),
                                want if isinstance(want, tuple) else (want,)):
                    assert torch.equal(a, b)
