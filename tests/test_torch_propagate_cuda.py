"""The unicycle's serial chain in one kernel (``csrc/propagate.cu`` through
:func:`~pint_tpu_torch.mpc.propagate.chain_fused`) against its plain
version (:func:`~pint_tpu_torch.mpc.propagate.chain_plain`, the torch
phases) on the card.

Tolerance: none.  Abar, Bbar and Cbar are compared as int32 bits, so +0.0
and -0.0 differ: at the benchmark cells' shapes (T 32 at B 4096 and 16384,
T 128 at B 4096), at a ragged batch, odd horizons, horizons across the
kernel's 32-step chunks and column tiles, and T 316 (Tm 632, three warps a
problem), with headings over several turns of both signs and on the
quadratic sine's breakpoints; the finite problems beside non-finite ones;
and one warm ``solve_words`` of each of the benchmark's configurations
(``rti_t32``, ``crti_t32``, ``crti_t128``), eager, captured and replayed,
gives the same words and multipliers with the kernel as with the plain
chain, the kernel launched once an SQP iteration.

Every test needs an NVIDIA GPU and skips without one.  This file imports
neither jax nor pint_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_propagate_cuda.py
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc import propagate
from pint_tpu_torch.mpc.propagate import chain_fused, chain_plain

pytestmark = pytest.mark.cuda

SHAPES = [(32, 4096), (32, 16384), (128, 4096), (32, 37), (5, 37), (1, 3), (33, 37),
          (64, 37), (100, 37), (316, 37)]
"""(T, B): the cells' shapes first."""

SQP_CELLS = {
    "rti": dict(horizon=32, sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
                Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]), qf_scale=60.0,
                x_ref=np.array([0.2, 0.1, 0.0])),
    "crti": dict(horizon=32, sqp_iters=1, pgd_iters=30, power_iters=16, g_shift=12,
                 Q=np.diag([1.0, 1.0, 0.02]), R=np.diag([0.02, 0.02]), qf_scale=20.0,
                 x_ref=np.array([1.0, 0.0, 0.0])),
}
SQP_CELLS["crti_t128"] = dict(SQP_CELLS["crti"], horizon=128)
"""The benchmark's ``rti_t32``, ``crti_t32`` and ``crti_t128`` solvers."""
HEADINGS = {"rti": (0.0, 1.0), "crti": (-np.pi, np.pi), "crti_t128": (-np.pi, np.pi)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _operands(cuda, B, T, seed):
    """Lanes over the whole int8 range (so headings turn fast), positions
    within 2, headings over three turns either way, and the first rows on
    the quadratic sine's breakpoints (0, a quarter, a half turn, whole
    turns of both signs)."""
    rng = np.random.default_rng(seed)
    lanes = rng.integers(-128, 128, (B, 2 * T), dtype=np.int32)
    x0 = np.stack([rng.uniform(-2, 2, B), rng.uniform(-2, 2, B),
                   rng.uniform(-3, 3, B)], -1).astype(np.float32)
    marks = np.array([0.0, 0.25, 0.5, 0.75, -0.25, -0.5, 1.0, -1.0, 2.5], np.float32)
    x0[: len(marks), 2] = marks[: B]
    return (torch.as_tensor(lanes, device=cuda), torch.as_tensor(x0, device=cuda))


def _unicycle(cuda):
    """A unicycle solver: the chain reads its model and lane scales, and
    the lanes' width sets T."""
    return DeviceSQP(horizon=2, device=cuda)


@pytest.mark.parametrize("T, B", SHAPES)
def test_the_kernel_writes_the_plain_chains_stacks_bit_for_bit(cuda, T, B):
    lanes, x0 = _operands(cuda, B, T, 1000 + T + B)
    sqp = _unicycle(cuda)
    before = propagate.launch_count()
    got = chain_fused(sqp, x0, lanes)
    assert propagate.launch_count() == before + 1
    want = chain_plain(sqp, x0, lanes)
    torch.cuda.synchronize()
    for name, g, w in zip(("Abar", "Bbar", "Cbar"), got, want, strict=True):
        assert g.shape == w.shape and g.is_contiguous()
        differ = int((_bits(g) != _bits(w)).reshape(B, -1).any(-1).sum())
        assert differ == 0, f"{name}: {differ} of {B} problems differ"


def test_the_finite_problems_stay_bit_identical_beside_non_finite_ones(cuda):
    """A problem whose state is not finite spreads NaN through its own
    stacks in the torch chain (into the columns no step has reached too,
    where the kernel writes +0.0); every other problem is unaffected."""
    B, T = 37, 32
    lanes, x0 = _operands(cuda, B, T, 7)
    bad = [3, 11, 30]
    x0[3, 2] = float("nan")
    x0[11, 0] = float("inf")
    x0[30] = float("nan")
    sqp = _unicycle(cuda)
    got = chain_fused(sqp, x0, lanes)
    want = chain_plain(sqp, x0, lanes)
    good = torch.ones(B, dtype=torch.bool, device=cuda)
    good[bad] = False
    for g, w in zip(got, want, strict=True):
        assert torch.equal(_bits(g[good]), _bits(w[good]))


def _solver(kind, cuda):
    sqp = DeviceSQP(**SQP_CELLS[kind], device=cuda)
    if kind == "rti":
        return sqp
    return DeviceConstrainedSQP(sqp, rho=100.0, alm_outer=3, row_pad=64,
                                F=np.array([[0.0, 1.0, 0.0]]), lo=-0.03, hi=0.03)


def _torch_chain(solver):
    """The same solver with the plain chain: the kernels of the other
    stages still run."""
    solver.__dict__["forms"] = dict(solver.forms, chain="torch")
    return solver


@pytest.mark.parametrize("kind", ["rti", "crti", "crti_t128"])
def test_a_warm_solve_is_the_same_with_the_kernel_as_with_the_plain_chain(cuda, kind):
    """Three warm-started ticks at B 4096 (eager, captured, replayed):
    words and multipliers equal tick by tick, the kernel launched once an
    SQP iteration on the fused solver (replays counted) and never on the
    other."""
    B = 4096
    fused, plain = _solver(kind, cuda), _torch_chain(_solver(kind, cuda))
    assert fused.forms["chain"] == "fused" and plain.forms["chain"] == "torch"
    iters = SQP_CELLS[kind]["sqp_iters"]
    rng = np.random.default_rng(40)
    states = {}
    for name, solver in (("fused", fused), ("plain", plain)):
        state = [solver.init_words(B), None, *(() if kind == "rti" else (solver.init_lam(B),))]
        outs, launched = [], []
        for tick in range(3):
            x0 = np.stack([rng.uniform(-0.02, 0.02, B), rng.uniform(-0.02, 0.02, B),
                           rng.uniform(*HEADINGS[kind], B)], -1).astype(np.float32)
            state[1] = torch.as_tensor(x0, device=cuda)
            before = propagate.launch_count()
            out = solver.solve_words(*state)
            torch.cuda.synchronize()
            launched.append(propagate.launch_count() - before)
            out = (out,) if isinstance(out, torch.Tensor) else out
            outs.append(out)
            state[0] = torch.roll(out[0], -1, dims=1)
            if kind != "rti":
                state[2] = torch.roll(out[1], -1, dims=1)
        rng = np.random.default_rng(40)          # the same states for the other solver
        states[name] = (outs, launched)
    assert states["fused"][1] == [iters] * 3 and states["plain"][1] == [0] * 3
    assert fused._graphed.captures == 1 and fused._graphed.replays == 2
    for tick, (g, w) in enumerate(zip(states["fused"][0], states["plain"][0], strict=True)):
        for a, b in zip(g, w, strict=True):
            assert torch.equal(a, b), f"tick {tick}"
