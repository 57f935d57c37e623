"""Port parity: the LTV/SQP host tier (``pint_tpu_torch.mpc.ltv``, the LTV
parts of ``mpc/condensed.py``, ``Unicycle.linearize``) against
``pint_tpu``'s, on the CPU.

Tolerance: bit-identical throughout.  The host tier is the reference's
numpy code (``condense_ltv``, ``condense_ltv_batch`` with its propagators,
``dare_terminal``, ``linearize``, ``quantize_batch``), and the inner
``_pgd_batched_h`` is integer end to end, so ``QuantizedSQP.solve`` gives
the same words and the same float64 cost histories, and ``SQPController``
the same states and applied lanes.  The configurations are
``tests/test_ltv.py``'s (unicycle T = 32, 6 x 40; the pendulum tracker of
``test_dare_terminal_fixed_point_and_short_horizon``, T = 8) and
``examples/swingup.py``'s tracker (T = 16, pad_to 16) at fewer ticks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import Pendulum as JPendulum
from pint_tpu.models import Unicycle as JUnicycle
from pint_tpu.models.quadrotor import PlanarQuadrotor as JQuad
from pint_tpu.mpc import QuantizedSQP as JSQP
from pint_tpu.mpc import SQPController as JController
from pint_tpu.mpc import condense_ltv as j_condense_ltv
from pint_tpu.mpc import dare_terminal as j_dare
from pint_tpu.mpc.condensed import condense_ltv_batch as j_condense_ltv_batch
from pint_tpu.mpc.ltv import quantize_batch as j_quantize_batch
from pint_tpu_torch.convert import quantized_sqp_config, words_from_numpy, words_to_numpy
from pint_tpu_torch.models import Pendulum, Unicycle
from pint_tpu_torch.mpc import (
    QuantizedSQP,
    SQPController,
    condense_ltv,
    condense_ltv_batch,
    dare_terminal,
    quantize_batch,
)

SQP_KW = dict(horizon=32, sqp_iters=6, pgd_iters=40, Q=np.diag([1.0, 1.0, 0.005]),
              R=np.diag([0.005, 0.005]), qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]))
X0 = np.array([[0.0, 0.0, 0.0], [-0.1, 0.05, 0.1], [0.05, -0.1, 0.9]])


def _ltv_problem(seed, B=None, T=10, n=3, m=2):
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    A = np.eye(n) + 0.1 * rng.standard_normal(lead + (T, n, n))
    Bm = 0.4 * rng.standard_normal(lead + (T, n, m))
    c = 0.1 * rng.standard_normal(lead + (T, n))
    Q = np.diag(rng.uniform(0.2, 2.0, n))
    R = np.diag(rng.uniform(0.05, 0.5, m))
    return A, Bm, c, Q, R, 7.0 * Q, rng.standard_normal((T, n))


@pytest.mark.parametrize("drift", [True, False])
@pytest.mark.parametrize("per_step_ref", [True, False])
def test_condense_ltv_bit_identical(drift, per_step_ref):
    A, Bm, c, Q, R, Qf, x_ref = _ltv_problem(0)
    c = c if drift else None
    x_ref = x_ref if per_step_ref else x_ref[0]
    got = condense_ltv(A, Bm, c, Q, R, Qf, x_ref, u_max=2.0)
    want = j_condense_ltv(A, Bm, c, Q, R, Qf, x_ref, u_max=2.0)
    for k in ("H", "G", "g_ref"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.lipschitz == want.lipschitz and got.u_max == want.u_max


def test_condense_ltv_scalar_r_and_shape_check():
    A, Bm, c, Q, _, Qf, x_ref = _ltv_problem(1, n=2, m=1, T=6)
    got = condense_ltv(A, Bm, c, Q, 0.5, Qf, x_ref, u_max=1.0)
    want = j_condense_ltv(A, Bm, c, Q, 0.5, Qf, x_ref, u_max=1.0)
    np.testing.assert_array_equal(got.H, want.H)
    with pytest.raises(ValueError, match="A_seq"):
        condense_ltv(A[:, :1], Bm, c, Q, 0.5, Qf, x_ref, u_max=1.0)


@pytest.mark.parametrize("props", [False, True])
def test_condense_ltv_batch_bit_identical(props):
    A, Bm, c, Q, R, Qf, x_ref = _ltv_problem(2, B=5)
    got = condense_ltv_batch(A, Bm, c, Q, R, Qf, x_ref, return_propagators=props)
    want = j_condense_ltv_batch(A, Bm, c, Q, R, Qf, x_ref, return_propagators=props)
    assert len(got) == len(want) == (7 if props else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_condense_ltv_batch_no_drift_shared_ref():
    A, Bm, _, Q, R, Qf, x_ref = _ltv_problem(3, B=3, T=7)
    for g, w in zip(condense_ltv_batch(A, Bm, None, Q, R, Qf, x_ref[0]),
                    j_condense_ltv_batch(A, Bm, None, Q, R, Qf, x_ref[0])):
        np.testing.assert_array_equal(g, w)


def test_dare_terminal_bit_identical():
    """The pendulum's upright linearization in lane units (the reference
    test's), and a random stabilizable pair; an unstabilizable pair raises
    in both."""
    m = Pendulum(u_shift=10)
    A, B = m.linearize(np.zeros(2), np.zeros(1))
    s = m.lane_scales
    Q, R_lane = np.diag([1.0, 0.05]), s[:, None] * np.array([[0.02]]) * s[None, :]
    np.testing.assert_array_equal(dare_terminal(A, B * s, Q, R_lane),
                                  j_dare(A, B * s, Q, R_lane))
    rng = np.random.default_rng(4)
    A2 = np.eye(3) + 0.05 * rng.standard_normal((3, 3))
    B2 = rng.standard_normal((3, 2))
    np.testing.assert_array_equal(dare_terminal(A2, B2, np.eye(3), 0.3),
                                  j_dare(A2, B2, np.eye(3), 0.3))
    A3, B3 = np.diag([1.5, 0.5]), np.array([[0.0], [1.0]])
    for fn in (dare_terminal, j_dare):
        with pytest.raises(ValueError, match="DARE"):
            fn(A3, B3, np.eye(2), 1.0)


def test_unicycle_linearize_and_conversions_bit_identical():
    rng = np.random.default_rng(5)
    states = rng.uniform(-1, 1, (4, 20, 3))
    controls = rng.uniform(-0.3, 0.3, (4, 20, 2))
    for kw in ({}, dict(v_shift=10, w_shift=8, dt_shift=4)):
        got, want = Unicycle(**kw), JUnicycle(**kw)
        for g, w in zip(got.linearize(states, controls), want.linearize(states, controls)):
            np.testing.assert_array_equal(g, w)
        fp = got.to_fixed(states)
        np.testing.assert_array_equal(fp, want.to_fixed(states))
        assert fp.dtype == np.int32
        np.testing.assert_array_equal(got.to_float(fp), want.to_float(fp))
        np.testing.assert_array_equal(got.to_fixed_xy(states[..., :2]),
                                      want.to_fixed_xy(states[..., :2]))
        np.testing.assert_array_equal(got.to_fixed_theta(states[..., 2]),
                                      want.to_fixed_theta(states[..., 2]))
        np.testing.assert_array_equal(got.to_float_xy(fp[..., :2]),
                                      want.to_float_xy(fp[..., :2]))
        np.testing.assert_array_equal(got.to_float_theta(fp[..., 2]),
                                      want.to_float_theta(fp[..., 2]))


@pytest.mark.parametrize("Tp", [20, 64])
def test_quantize_batch_bit_identical(Tp):
    A, Bm, c, Q, R, Qf, x_ref = _ltv_problem(6, B=6)
    H, G, g_ref, lip = j_condense_ltv_batch(A, Bm, c, Q, R, Qf, x_ref)
    x0 = np.random.default_rng(7).standard_normal((6, 3))
    x0[2] = np.inf                          # saturates that problem's g_pre
    alpha = 1.0 / (lip * np.linspace(1.0, 3.0, 6))
    got = quantize_batch(H, G, g_ref, alpha, x0, Tp, 12)
    want = j_quantize_batch(H, G, g_ref, alpha, x0, Tp, 12)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_quantize_batch_degenerate_raises():
    A, Bm, c, Q, R, Qf, x_ref = _ltv_problem(8, B=2)
    H, G, g_ref, lip = condense_ltv_batch(A, Bm, c, Q, R, Qf, x_ref)
    with pytest.raises(ValueError, match="rational"):
        quantize_batch(H * 1e-30, G, g_ref, np.full(2, 1e-30), np.zeros((2, 3)), 64, 12)


@pytest.fixture(scope="module")
def sqp_pair():
    ref = JSQP(**SQP_KW)
    return ref, quantized_sqp_config(ref, device="cpu")


@pytest.fixture(scope="module")
def sqp_solutions(sqp_pair):
    ref, port = sqp_pair
    return ref.solve(X0), port.solve(X0)


def test_quantized_sqp_solve_bit_identical(sqp_pair, sqp_solutions):
    """tests/test_ltv.py's three starts (the third heading-limited): words
    bit-identical, cost histories equal, the true cost falling."""
    ref, port = sqp_pair
    (jw, jc), (pw, pc) = sqp_solutions
    assert pw.shape == (3, port.padded // 4) and pw.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(pw), np.asarray(jw))
    np.testing.assert_array_equal(pc, jc)
    assert (np.diff(pc, axis=-1) < 1e-6).all()
    np.testing.assert_array_equal(port.lanes(pw), np.asarray(ref.lanes(jw)))
    np.testing.assert_array_equal(port.plan_phys(pw), ref.plan_phys(jw))


def test_quantized_sqp_batch_determinism(sqp_pair, sqp_solutions):
    """Each problem's words are independent of its batch companions, and a
    second solve repeats the first."""
    _, port = sqp_pair
    _, (pw, _) = sqp_solutions
    solo, costs = port.solve(X0[1:2])
    assert torch.equal(solo[0], pw[1])
    again, _ = port.solve(X0, track_costs=False)
    assert torch.equal(again, pw)


def test_quantized_sqp_warm_start_and_condense(sqp_pair):
    """A warm start from seeded words: the host condensation's operands and
    the solve after two iterations, bit-identical."""
    ref, port = sqp_pair
    rng = np.random.default_rng(9)
    lanes = rng.integers(-40, 41, (3, port.n_dec)).astype(np.int32)
    for got, want in zip(port._condense_batch(X0, lanes), ref._condense_batch(X0, lanes)):
        np.testing.assert_array_equal(got, want)
    from pint_tpu.models.dynamics import pack_controls as j_pack

    words = np.asarray(j_pack(jnp.asarray(np.pad(lanes, ((0, 0), (0, port.padded - port.n_dec))))))
    import dataclasses

    r2, p2 = dataclasses.replace(ref, sqp_iters=2), dataclasses.replace(port, sqp_iters=2)
    jw, jc = r2.solve(X0, u_words=jnp.asarray(words))
    pw, pc = p2.solve(X0, u_words=words_from_numpy(words, device="cpu"))
    np.testing.assert_array_equal(words_to_numpy(pw), np.asarray(jw))
    np.testing.assert_array_equal(pc, jc)


def test_quantized_sqp_reference_solve_equal(sqp_pair):
    ref, port = sqp_pair
    import dataclasses

    r2, p2 = dataclasses.replace(ref, sqp_iters=2), dataclasses.replace(port, sqp_iters=2)
    for g, w in zip(p2.reference_solve(X0[:2]), r2.reference_solve(X0[:2])):
        np.testing.assert_array_equal(g, w)


def test_quantized_sqp_validation():
    with pytest.raises(ValueError, match="pad_to"):
        QuantizedSQP(pad_to=6, device="cpu")
    sqp = QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, Q=np.eye(2), device="cpu")
    with pytest.raises(ValueError, match="Q has shape"):
        sqp.solve(X0[:1])
    sqp = QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, x_ref=np.zeros((5, 3)),
                       device="cpu")
    with pytest.raises(ValueError, match="x_ref"):
        sqp.solve(X0[:1])
    sqp = QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, device="cpu")
    with pytest.raises(ValueError, match="u_words"):
        sqp.solve(X0, u_words=sqp.init_words(2))


@pytest.mark.parametrize("model", ["pendulum", "quadrotor"])
def test_quantized_sqp_other_models_bit_identical(model):
    """Other model families through the host tier: the pendulum (m = 1) and
    the quadrotor (n = 6, m = 2) at tests/test_quadrotor_device.py's
    weights, 2 SQP iterations."""
    if model == "pendulum":
        kw = dict(model=JPendulum(), horizon=16, Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
                  x_ref=np.zeros(2), pad_to=16)
        x0 = np.array([[0.1, 0.0], [-0.2, 0.3]])
    else:
        kw = dict(model=JQuad(), horizon=16, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
                  R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6))
        x0 = np.array([[0.3, -0.2, 0.01, 0.0, 0.0, 0.0], [-0.2, 0.1, -0.02, 0.1, -0.1, 0.02]])
    ref = JSQP(sqp_iters=2, pgd_iters=30, **kw)
    port = quantized_sqp_config(ref, device="cpu")
    (jw, jc), (pw, pc) = ref.solve(x0), port.solve(x0)
    np.testing.assert_array_equal(words_to_numpy(pw), np.asarray(jw))
    np.testing.assert_array_equal(pc, jc)


def test_sqp_controller_unicycle_bit_identical(sqp_pair):
    """tests/test_ltv.py's RTI closed loop (one SQP iteration a tick, 48
    ticks): states and applied lanes bit-identical; it reaches the goal."""
    ref, port = sqp_pair
    x0 = X0[:2]
    js, ja = JController(ref, iters_per_tick=1).run(x0, ticks=48)
    ps, pa = SQPController(port, iters_per_tick=1).run(x0, ticks=48)
    assert ps.shape == (2, 49, 3) and pa.shape == (2, 48, 2)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pa, ja)
    xyf = port.model.to_float(ps)[:, -1, :2]
    assert (np.linalg.norm(xyf - np.array([0.2, 0.1]), axis=-1) < 0.06).all()


def _pendulum_dare():
    m = JPendulum(u_shift=10)
    A, B = m.linearize(np.zeros(2), np.zeros(1))
    s = m.lane_scales
    Q = np.diag([1.0, 0.05])
    P = j_dare(A, B * s, Q, s[:, None] * np.array([[0.02]]) * s[None, :])
    return JSQP(model=m, horizon=8, sqp_iters=1, pgd_iters=40, Q=Q, R=np.array([[0.02]]),
                Qf=P, x_ref=np.zeros(2), pad_to=8)


def test_sqp_controller_pendulum_dare_bit_identical():
    """test_dare_terminal_fixed_point_and_short_horizon's T = 8 regulator
    with the DARE terminal weight, 96 ticks: bit-identical, and it settles
    (|theta| < 5e-4 over the last 30 ticks, the reference test's bound)."""
    ref = _pendulum_dare()
    port = quantized_sqp_config(ref, device="cpu")
    x0 = np.array([[0.06, 0.0], [-0.07, 0.15]])
    js, ja = JController(ref, iters_per_tick=1).run(x0, ticks=96)
    ps, pa = SQPController(port, iters_per_tick=1).run(x0, ticks=96)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pa, ja)
    assert np.abs(port.model.to_float(ps)[:, -30:, 0]).max() < 5e-4


def test_sqp_controller_tracker_bit_identical():
    """examples/swingup.py's tracker (T = 16, 1 x 40, pad_to 16) following a
    per-step reference from a warm plan, 24 ticks: bit-identical, and a
    short x_ref_traj raises."""
    m = JPendulum(u_shift=10)
    kw = dict(model=m, horizon=16, sqp_iters=1, pgd_iters=40, Q=np.diag([1.0, 0.3]),
              R=np.array([[0.01]]), qf_scale=20.0, x_ref=np.zeros(2), pad_to=16)
    ref = JSQP(**kw)
    port = quantized_sqp_config(ref, device="cpu")
    ticks = 24
    t = np.arange(ticks + 16)[:, None]
    x_ref_traj = np.concatenate([0.3 * np.exp(-t / 12.0), -0.2 * np.exp(-t / 12.0)], -1)
    x0 = np.array([[0.3, -0.1]])
    warm = np.zeros((1, 16), np.int32)
    warm[0, :6] = [40, 30, 20, 10, 5, 2]
    from pint_tpu.models.dynamics import pack_controls as j_pack

    words = np.asarray(j_pack(jnp.asarray(warm)))
    js, ja = JController(ref).run(x0, ticks, u_words=jnp.asarray(words), x_ref_traj=x_ref_traj)
    ps, pa = SQPController(port).run(x0, ticks, u_words=words_from_numpy(words, device="cpu"),
                                     x_ref_traj=x_ref_traj)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pa, ja)
    with pytest.raises(ValueError, match="x_ref_traj"):
        SQPController(port).run(x0, ticks, x_ref_traj=x_ref_traj[:20])
