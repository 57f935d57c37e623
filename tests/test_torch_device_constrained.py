"""Port parity: DeviceConstrainedSQP (the state-constrained tier's whole
solve) against pint_tpu's, on the CPU.

Tolerances: the constraint stacks (f32) rtol 1e-5, atol 1e-4, the bound of
tests/test_device_sqp.py's cross-path checks; full solves against JAX's
``DeviceConstrainedSQP(lipq=True)`` (its Pallas kernels in interpret mode)
held to cost parity, rtol 0.01, atol 1e-4, and violation parity, atol
5e-3 (tests/test_condense_fused.py::test_constrained_lipq_solution_quality),
since last-ulp f32 differences can move an int8 rounding tie.  Inside the
port every route is bit-identical.  The torch form of the reference's
``lipq=False`` branch: ``pen_lip`` and ``row_amp`` rtol 1e-5 (sums in
another order than XLA's), ``sqc`` and ``s_scale`` bit-identical given
JAX's own ``S_t``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.mpc import DeviceConstrainedSQP as JDeviceConstrainedSQP
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu_torch.convert import (
    device_constrained_config,
    words_from_numpy,
    words_to_numpy,
)
from pint_tpu_torch.models.dynamics import unpack_controls
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP

CON = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0)
SMALL = dict(horizon=8, sqp_iters=2, pgd_iters=6, x_ref=np.array([1.0, 0.0, 0.0]))
X0 = np.array([[0.0, 0.0, np.pi / 2], [0.0, 0.0, -np.pi / 2]], np.float32)
BIG = dict(horizon=32, sqp_iters=6, pgd_iters=40, x_ref=np.array([1.0, 0.0, 0.0]))


def _x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(-np.pi, np.pi, B)], -1).astype(np.float32)


def _lanes(csqp, words):
    return unpack_controls(words)[:, : csqp.dev.n_dec].cpu().numpy()


@pytest.fixture(scope="module")
def small_pair():
    ref = JDeviceConstrainedSQP(JDeviceSQP(propagate="unroll", **SMALL),
                                alm_outer=2, lipq=True, fused=False,
                                lipq_block=8, **CON)
    return ref, device_constrained_config(ref, device="cpu")


@pytest.fixture(scope="module")
def big():
    return DeviceConstrainedSQP(DeviceSQP(**BIG, device="cpu"), alm_outer=4, **CON)


def test_config_carries_over(small_pair):
    ref, port = small_pair
    assert port.n_rows == ref.n_rows == 8 and port.padded_rows == 64
    assert port.dev.horizon == 8 and port.rho == 100.0 and port.alm_outer == 2
    assert port.fused is False and port.lipq is True
    port2 = device_constrained_config(ref, fused=None, use_kernels=False, rho=50.0, device="cpu")
    assert port2.fused is None and port2.rho == 50.0
    assert port2.dev.use_kernels is False


def test_stack_constraints_match(small_pair):
    ref, port = small_pair
    B = 7
    rng = np.random.default_rng(3)
    x0 = _x0(B, 4)
    lanes = rng.integers(-100, 100, (B, port.dev.n_dec), dtype=np.int32)
    d = ref.dev

    def stack(x0_f, lanes):
        A, Bl, c = d._linearize_phase(x0_f, lanes)
        return ref._stack_constraints(*d._propagate_unrolled(A, Bl, c))

    expect = jax.jit(stack)(jnp.asarray(x0), jnp.asarray(lanes))
    pd = port.dev
    A, Bl, c = pd._linearize_phase(torch.as_tensor(x0), torch.as_tensor(lanes))
    got = port._stack_constraints(*pd._propagate_unrolled(A, Bl, c))
    assert got[0].shape == (8, 16, B) and got[0].is_contiguous()
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5, atol=1e-4)


def test_full_solve_cost_and_violation_parity(small_pair):
    ref, port = small_pair
    x0 = np.concatenate([X0, _x0(4, 5)])
    w_j, l_j = ref.solve_words(ref.init_words(6), x0)
    w, lam = port.solve_words(port.init_words(6), x0)
    assert w.shape == (6, 4) and lam.shape == (6, 64)
    lanes_j = _lanes(port, words_from_numpy(np.asarray(w_j), device="cpu"))
    lanes = _lanes(port, w)
    np.testing.assert_allclose(port.dev.true_cost(x0, lanes),
                               port.dev.true_cost(x0, lanes_j),
                               rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(port.violation(x0, lanes),
                               ref.violation(x0, lanes_j), atol=5e-3)
    # the port's violation helper is the reference's on the same plans
    np.testing.assert_allclose(port.violation(x0, lanes_j),
                               ref.violation(x0, lanes_j), rtol=1e-6, atol=1e-7)


def test_routes_bit_identical(small_pair):
    """Kernel route (plain on the CPU), use_kernels=False and the
    word-space fused=False inner give the same words and multipliers."""
    ref, _ = small_pair
    x0 = _x0(5, 6)
    out = []
    for kw in (dict(fused=None), dict(fused=None, use_kernels=False),
               dict(fused=False)):
        port = device_constrained_config(ref, **kw, device="cpu")
        out.append(port.solve_words(port.init_words(5), x0))
    for w, lam in out[1:]:
        assert torch.equal(w, out[0][0]) and torch.equal(lam, out[0][1])


def test_deterministic(big):
    w1, l1 = big.solve_words(big.init_words(2), X0)
    w2, l2 = big.solve_words(big.init_words(2), X0)
    assert torch.equal(w1, w2) and torch.equal(l1, l2)


def test_binding_constraint_binds(big):
    """The corridor binds: the unconstrained plan overshoots it 2x, the
    constrained one stays inside on the true rollout, with nonzero
    multipliers (tests/test_device_constrained.py's bounds)."""
    unc = DeviceSQP(**BIG, device="cpu")
    w_u = unc.solve_words(unc.init_words(2), X0)
    u_phys = torch.as_tensor(
        _lanes(big, w_u).reshape(2, 32, 2) * unc._lane_scales, dtype=torch.float32)
    swing = unc.model.rollout_f32(torch.as_tensor(X0), u_phys)[:, 1:, 1].abs().max()
    assert float(swing) > 2 * 0.03
    w_d, lam = big.solve_words(big.init_words(2), X0)
    assert big.violation(X0, _lanes(big, w_d)).max() < 0.01
    assert int(lam.abs().max()) > 0


def test_inactive_constraint_is_inert():
    wide = DeviceConstrainedSQP(DeviceSQP(**BIG, device="cpu"), F=[[0.0, 1.0, 0.0]],
                                lo=-5.0, hi=5.0, rho=100.0, alm_outer=2)
    w, lam = wide.solve_words(wide.init_words(2), X0)
    assert int(lam.abs().max()) == 0
    assert wide.violation(X0, _lanes(wide, w)).max() == 0.0


def test_warm_start_improves_or_holds(big):
    w1, l1 = big.solve_words(big.init_words(2), X0)
    w2, _ = big.solve_words(w1, X0, l1)
    c1 = big.dev.true_cost(X0, _lanes(big, w1))
    c2 = big.dev.true_cost(X0, _lanes(big, w2))
    assert (c2 <= c1 * 1.02 + 1e-6).all(), (c1, c2)


def test_solve_convenience(small_pair):
    _, port = small_pair
    words, lam, plans = port.solve(X0)
    assert plans.shape == (2, 8, 2) and np.isfinite(plans).all()
    np.testing.assert_array_equal(
        words_to_numpy(words), words_to_numpy(port.solve_words(port.init_words(2), X0)[0]))


def test_validation(small_pair):
    _, port = small_pair
    with pytest.raises(ValueError, match="lo must be < hi"):
        DeviceConstrainedSQP(DeviceSQP(**SMALL, device="cpu"), F=[[0.0, 1.0, 0.0]], lo=1.0, hi=-1.0)
    bad = DeviceConstrainedSQP(DeviceSQP(**SMALL, device="cpu"), F=[[0.0, 1.0]])
    with pytest.raises(ValueError, match="columns"):
        bad.solve_words(bad.init_words(1), X0[:1])
    with pytest.raises(ValueError, match="batch"):
        port.solve_words(port.init_words(3), X0)
    with pytest.raises(ValueError, match="lam shape"):
        port.solve_words(port.init_words(2), X0, torch.zeros((2, 8), dtype=torch.int32))


@pytest.mark.parametrize("make, reduce_fn", [
    (lambda: DeviceConstrainedSQP(DeviceSQP(reduce="einsum", **SMALL, device="cpu")),
     "_reduce_phase"),
    (lambda: DeviceConstrainedSQP(DeviceSQP(propagate="scan", **SMALL, device="cpu")),
     "_reduce_sym"),
], ids=["reduce=einsum", "propagate=scan"])
def test_unported_options_raise(make, reduce_fn, monkeypatch):
    """These options raised NotImplementedError until the port took them;
    now the solver builds, and its condensation runs the recursion and the
    contraction asked for ("scan" is the recursion, "einsum" the
    two-operand contraction), and nothing else."""
    csqp = make()
    calls = []
    for name in ("_propagate_unrolled", "_condense_allpairs", "_reduce_phase",
                 "_reduce_blocked", "_reduce_btrans", "_reduce_sym"):
        def spy(self, *a, _orig=getattr(DeviceSQP, name), _name=name):
            calls.append(_name)
            return _orig(self, *a)
        monkeypatch.setattr(DeviceSQP, name, spy)
    words, _ = csqp.solve_words(csqp.init_words(2), torch.from_numpy(X0))
    assert words.shape == (2, csqp.dev.n_dec // 4)
    assert calls == ["_propagate_unrolled", reduce_fn] * csqp.dev.sqp_iters, calls


@pytest.fixture(scope="module")
def jax_s_t(small_pair):
    """JAX's own constraint stack S_t (C, Tm, B) of one warm plan."""
    ref, _ = small_pair
    d = ref.dev
    rng = np.random.default_rng(81)
    B = 7
    lanes = rng.integers(-100, 100, (B, d.n_dec), dtype=np.int32)

    def stack(x0_f, lanes):
        A, Bl, c = d._linearize_phase(x0_f, lanes)
        return ref._stack_constraints(*d._propagate_unrolled(A, Bl, c))[0]

    return np.array(jax.jit(stack)(jnp.asarray(_x0(B, 82)), jnp.asarray(lanes)))


def test_pen_lipschitz_matches_jax(small_pair, jax_s_t):
    ref, port = small_pair
    expect = np.asarray(jax.jit(ref._pen_lipschitz)(jnp.asarray(jax_s_t)))
    got = port._pen_lipschitz(torch.as_tensor(jax_s_t))
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5)


def test_quantize_rows_bit_identical(small_pair, jax_s_t):
    """The constraint quantization of the reference's lipq=False branch
    (pint_tpu/mpc/device_constrained.py:274-284, jitted as it runs there)
    against the torch form on the same S_t."""
    _, port = small_pair

    @jax.jit
    def reference(S_t):
        s_scale = jnp.max(jnp.abs(S_t), axis=(0, 1)) / 127.0
        Sq_t = jnp.clip(jnp.round(S_t / s_scale[None, None, :]), -127, 127
                        ).astype(jnp.int8)
        row_amp = 127.0 * jnp.max(jnp.sum(jnp.abs(S_t), axis=1), axis=0)
        return Sq_t, s_scale, row_amp

    sq_j, scale_j, amp_j = (np.asarray(v) for v in reference(jnp.asarray(jax_s_t)))
    sqc, s_scale, row_amp = port._quantize_rows(torch.as_tensor(jax_s_t))
    np.testing.assert_array_equal(sqc.numpy(), sq_j)
    np.testing.assert_array_equal(s_scale.numpy(), scale_j)
    np.testing.assert_allclose(row_amp.numpy(), amp_j, rtol=1e-5)


def test_lipq_false_solve_parity(small_pair):
    """JAX's lipq=False form (XLA quantize, XLA inner) against the port's
    torch form into K5's plain version: cost and violation parity; inside
    the port the word-space inner gives the same bits."""
    ref, _ = small_pair
    ref_x = JDeviceConstrainedSQP(ref.dev, alm_outer=2, lipq=False, fused=False, **CON)
    port = device_constrained_config(ref_x, fused=None, device="cpu")
    assert port.forms == dict(chain="fused", condense="torch", constraints="torch", inner="alm")
    x0 = np.concatenate([X0, _x0(4, 83)])
    w_j, _ = ref_x.solve_words(ref_x.init_words(6), x0)
    w, lam = port.solve_words(port.init_words(6), x0)
    lanes_j = _lanes(port, words_from_numpy(np.asarray(w_j), device="cpu"))
    lanes = _lanes(port, w)
    np.testing.assert_allclose(port.dev.true_cost(x0, lanes),
                               port.dev.true_cost(x0, lanes_j), rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(port.violation(x0, lanes),
                               ref_x.violation(x0, lanes_j), atol=5e-3)
    word = device_constrained_config(ref_x, fused=False, device="cpu")
    assert word.forms["inner"] == "alm_batched"
    w2, lam2 = word.solve_words(word.init_words(6), x0)
    assert torch.equal(w2, w) and torch.equal(lam2, lam)


def _long_horizon_parity(horizon, forms, Cp):
    """One SQP iteration at ``horizon`` resolves to ``forms`` and is at cost
    and violation parity with JAX's (scan propagation; on the CPU its
    lipq=False form and XLA inner)."""
    kw = dict(horizon=horizon, sqp_iters=1, pgd_iters=10, x_ref=np.array([1.0, 0.0, 0.0]))
    ref = JDeviceConstrainedSQP(JDeviceSQP(propagate="scan", **kw), alm_outer=2, **CON)
    port = device_constrained_config(ref, device="cpu")
    assert port.forms == forms
    assert port.padded_rows == Cp
    w_j, _ = ref.solve_words(ref.init_words(2), X0)
    w, lam = port.solve_words(port.init_words(2), X0)
    lanes_j = _lanes(port, words_from_numpy(np.asarray(w_j), device="cpu"))
    lanes = _lanes(port, w)
    assert lam.shape == (2, Cp)
    np.testing.assert_allclose(port.dev.true_cost(X0, lanes),
                               port.dev.true_cost(X0, lanes_j), rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(port.violation(X0, lanes),
                               ref.violation(X0, lanes_j), atol=5e-3)


def test_long_horizon_solves_in_the_torch_form():
    """T = 144 (Tm = 288, past K3's fit; C = 144 rows, Cp = 192) takes the
    torch form of both, as the reference's _use_lipq does, and K5 (its plain
    version here)."""
    _long_horizon_parity(144, dict(chain="fused", condense="torch", constraints="torch", inner="alm"),
                         192)


def test_t128_solves_through_k3_k6_and_k5():
    """T = 128 (Tm = 256; C = 128 rows, Cp = 128) takes K3, K6 and K5, as
    the reference does on its chip."""
    _long_horizon_parity(128, dict(chain="fused", condense="lipq", constraints="pen", inner="alm"), 128)


@pytest.mark.parametrize("horizon, kw, forms", [
    (32, {}, ("lipq", "pen", "alm")), (112, {}, ("lipq", "pen", "alm")),
    (114, {}, ("lipq", "pen", "alm")), (128, {}, ("lipq", "pen", "alm")),
    (130, {}, ("lipq", "pen", "alm")), (144, {}, ("torch", "torch", "alm")),
    (300, {}, ("torch", "torch", "alm_batched")),
    (32, dict(lipq=False), ("torch", "torch", "alm")),
    (32, dict(fused=False), ("lipq", "pen", "alm_batched")),
    (8, dict(F=np.eye(3)[:1].repeat(200, 0)), ("lipq", "pen", "alm")),
    (8, dict(F=np.eye(3)[:1].repeat(600, 0)), ("lipq", "torch", "alm_batched")),
    (8, dict(F=np.eye(3)[:1].repeat(1100, 0)), ("lipq", "torch", "alm_batched")),
])
def test_forms_follow_the_gates(horizon, kw, forms):
    """K3 by the reference's lipq_viable, K6 where K3 runs and the
    reference's pen_viable takes (C, Tm) (C Tm <= 68266: 200 x 8 rows over
    Tm 16 is 25600, 600 x 8 rows 76800), K5 by the reference's alm_viable
    (C = 600 x 8 rows, Cp = 4800, and 1100 x 8 are past it)."""
    kw = dict(CON, **kw)
    csqp = DeviceConstrainedSQP(DeviceSQP(**dict(SMALL, horizon=horizon), device="cpu"),
                                **kw)
    assert (csqp.forms["condense"], csqp.forms["constraints"], csqp.forms["inner"]) == forms


@pytest.mark.parametrize("horizon, rows", [(32, 1), (128, 1), (136, 1), (64, 6)])
def test_k6_runs_where_the_reference_runs_its_kernel(horizon, rows):
    """forms["constraints"] is "pen" exactly where the reference's
    _use_lipq() holds (built with lipq=True: its auto is False off the
    TPU): T = 32, 128, 136 at one constraint row a step, and a 6-row
    constraint at T = 64 (C 384, Tm 128).  Solvers only, no solve."""
    F = np.tile(np.array([[0.0, 1.0, 0.0]]), (rows, 1))
    kw = dict(SMALL, horizon=horizon)
    con = dict(CON, F=F, lo=-0.03 * np.ones(rows), hi=0.03 * np.ones(rows))
    ref = JDeviceConstrainedSQP(JDeviceSQP(**kw), lipq=True, **con)
    port = DeviceConstrainedSQP(DeviceSQP(**kw, device="cpu"), **con)
    assert ref._use_lipq()
    assert port.forms["constraints"] == "pen"
    assert port.forms["condense"] == "lipq"


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceConstrainedSQP(DeviceSQP(device="cuda", **SMALL))
