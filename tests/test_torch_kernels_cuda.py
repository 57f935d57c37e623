"""The port's CUDA kernels (K2, K3, K4) against their plain PyTorch versions,
on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel has
no CPU mode).  This file imports neither jax nor pint_tpu, so it runs on a
machine without JAX; there, skip the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K2 and K4 bit-identical; K3 ``hqt``, ``h_max`` and ``lip``
bit-identical (the plain version adds in the kernel's order; ``lip`` is
also held to the contract's rtol 1e-5 first); a whole DeviceSQP solve,
kernels against plain versions, cost parity rtol 0.01, atol 1e-4.
"""

import numpy as np
import pytest
import torch

from pint_tpu_torch.mpc import (
    DeviceSQP,
    FusedPGD,
    condense_double_integrator,
    fused_pgd,
    fused_pgd_plain,
    lipq_fused,
    lipq_plain,
    pgd_hqt,
    pgd_hqt_plain,
    quantize,
)
from pint_tpu_torch.mpc.condense_fused import true_div
from pint_tpu_torch.mpc.ltv import true_cost
from pint_tpu_torch.models.dynamics import unpack_controls
from pint_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

SQP_KW = dict(
    horizon=32, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(0, 1, B)], -1).astype(np.float32)


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("B", [1, 1000])
@pytest.mark.parametrize("T, pad_to", [(50, 64), (20, 32), (100, 64)])
def test_k2_bit_identical(cuda, momentum, B, T, pad_to):
    qqp = quantize(condense_double_integrator(T=T), pad_to=pad_to)
    rng = np.random.default_rng(12)
    lanes = torch.as_tensor(
        rng.integers(-128, 128, (B, qqp.padded), dtype=np.int32), device=cuda)
    g = torch.as_tensor(qqp.g_lane_fixed(np.stack(
        [rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], -1)), device=cuda)
    hq = torch.as_tensor(qqp.Hq, device=cuda)
    kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift,
              iters=15, momentum=momentum, beta_num=FusedPGD(qqp).beta_num)
    got = fused_pgd(lanes, g, hq, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_pgd_plain(lanes, g, hq, **kw))


@pytest.fixture(scope="module", params=[32, 16, 64], ids=lambda h: f"T{h}")
def condensed(cuda, request):
    sqp = DeviceSQP(sqp_iters=1, device=cuda, **dict(SQP_KW, horizon=request.param))
    B = 37
    rng = np.random.default_rng(13)
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, sqp.n_dec), dtype=np.int32),
                            device=cuda)
    Ht, g = sqp._condense_ht(torch.as_tensor(_x0(B, 14), device=cuda), lanes)
    return sqp, lanes, Ht, g


def test_k3_matches_plain(condensed):
    sqp, _, Ht, _ = condensed
    hqt, lip, hmax = lipq_fused(Ht, power_iters=sqp.power_iters)
    hqt_p, lip_p, hmax_p = lipq_plain(Ht, power_iters=sqp.power_iters)
    torch.cuda.synchronize()
    assert torch.equal(hqt, hqt_p) and torch.equal(hmax, hmax_p)
    np.testing.assert_allclose(lip.cpu().numpy(), lip_p.cpu().numpy(), rtol=1e-5)
    # the plain version reduces in the kernel's order: lip matches bit for bit
    assert torch.equal(lip, lip_p)


def test_k3_rounds_half_to_even(cuda):
    """Exact .5 ties (h_max = 127, scale exactly 1): rintf, not roundf."""
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0], np.float32)
    Ht = np.stack([np.resize(vals, (4, 4)), np.resize(-vals[::-1], (4, 4))], -1)
    ht = torch.as_tensor(Ht, device=cuda)
    hqt, _, _ = lipq_fused(ht, power_iters=2)
    assert torch.equal(hqt, lipq_plain(ht, power_iters=2)[0])
    assert sorted(set(hqt.cpu().numpy().ravel().tolist())) == [
        -127, -126, -2, 0, 2, 126, 127]


def test_k4_bit_identical(condensed):
    sqp, lanes, Ht, g = condensed
    hqt, lip, hmax = lipq_plain(Ht, power_iters=sqp.power_iters)
    alpha = true_div(1.0, lip)
    g_pre = sqp._g_pre_from(g, alpha)
    hs_num, hs_den = sqp._step_rationals(true_div(alpha * hmax, 127.0))
    kw = dict(iters=30, g_shift=sqp.g_shift)
    got = pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw))


def test_launch_counts(cuda):
    qqp = quantize(condense_double_integrator(T=50))
    solver = FusedPGD(qqp, iters=3, device=cuda)
    g = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    before = K.launch_counts()["fused_pgd"]
    solver.solve_words(solver.init_words(4), g)
    assert K.launch_counts()["fused_pgd"] == before + 1


def test_wrappers_refuse_mixed_devices(cuda):
    qqp = quantize(condense_double_integrator(T=50))
    with pytest.raises(ValueError):
        fused_pgd(torch.zeros((4, 64), dtype=torch.int32, device=cuda),
                  torch.zeros((4, 64), dtype=torch.int32),
                  torch.as_tensor(qqp.Hq, device=cuda),
                  hs_num=1, hs_den=0, g_shift=12, iters=1)


def test_device_sqp_kernels_cost_parity(cuda):
    kern = DeviceSQP(sqp_iters=4, device=cuda, **SQP_KW)
    plain = DeviceSQP(sqp_iters=4, device=cuda, use_kernels=False, **SQP_KW)
    x0 = _x0(64, 15)
    costs = []
    for sqp in (kern, plain):
        w = sqp.solve_words(sqp.init_words(64), torch.as_tensor(x0, device=cuda))
        costs.append(true_cost(sqp, x0, unpack_controls(w).cpu().numpy()))
    np.testing.assert_allclose(costs[0], costs[1], rtol=0.01, atol=1e-4)
