"""Port parity: the LTI box-QP PGD solvers (word-space FixedPointPGD and
the K2 FusedPGD) against pint_tpu's, at T = 50, batch 16, and at the card
tests' edges of K2 and K2p (Tp 32, 52 and 128, 0 and 1 iterations, batch 17).

JAX's FusedPGD runs its Pallas kernel in interpret mode, as
tests/test_fused.py runs it.  Tolerance: bit-identical packed words."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.mpc import FixedPointPGD as JFixed
from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import quantize as j_quantize
from pint_tpu.mpc.fused import FusedPGD as JFused
from pint_tpu_torch.convert import (
    quantized_qp_from_arrays,
    words_from_numpy,
    words_to_numpy,
)
from pint_tpu_torch.mpc import (
    FixedPointPGD,
    FusedPGD,
    fused_pgd,
    fused_pgd_packed,
    fused_pgd_packed_plain,
)

BATCH = 16


@pytest.fixture(scope="module")
def qqps():
    ref = j_quantize(j_condense(T=50))
    return ref, quantized_qp_from_arrays(ref)


@pytest.fixture(scope="module")
def problem(qqps):
    ref, _ = qqps
    rng = np.random.default_rng(11)
    x0 = np.stack([rng.uniform(-3, 3, BATCH), rng.uniform(-1, 1, BATCH)], -1)
    g = ref.g_lane_fixed(x0)
    # a warm start that exercises -128 lanes and the saturating update
    warm = rng.integers(-128, 128, (BATCH, ref.padded), dtype=np.int32)
    warm_words = np.asarray(j_pack(jnp.asarray(warm)))
    return x0, g, warm_words


def test_quantized_qp_copied(qqps):
    ref, port = qqps
    np.testing.assert_array_equal(port.Hq, ref.Hq)
    assert (port.hs_num, port.hs_den, port.padded) == (ref.hs_num, ref.hs_den, ref.padded)
    from pint_tpu_torch.mpc import condense_double_integrator, quantize

    own = quantize(condense_double_integrator(T=50))
    np.testing.assert_array_equal(own.Hq, ref.Hq)
    assert (own.hs_num, own.hs_den, own.Gq_scale) == (ref.hs_num, ref.hs_den, ref.Gq_scale)


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_fixed_point_pgd_bit_identical(qqps, problem, error_feedback, start):
    ref, port = qqps
    x0, g, warm_words = problem
    u0 = (np.zeros((BATCH, ref.padded // 4), np.uint32) if start == "cold"
          else warm_words)
    expect = jax.jit(JFixed(ref, iters=30, error_feedback=error_feedback).solve_words)(
        jnp.asarray(u0), jnp.asarray(g)
    )
    got = FixedPointPGD(port, iters=30, error_feedback=error_feedback, device="cpu").solve_words(
        words_from_numpy(u0, device="cpu"), torch.from_numpy(g)
    )
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(expect))


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("iters", [15, 40])
def test_fused_pgd_bit_identical_to_jax(qqps, problem, momentum, iters):
    ref, port = qqps
    x0, g, warm_words = problem
    jf = JFused(ref, iters=iters, momentum=momentum, block_rows=8, interpret=True)
    expect = np.asarray(jf.solve_words(jnp.asarray(warm_words), jnp.asarray(g)))
    tf = FusedPGD(port, iters=iters, momentum=momentum, device="cpu")
    assert tf.beta_num == jf._beta_num
    got = tf.solve_words(words_from_numpy(warm_words, device="cpu"), torch.from_numpy(g))
    np.testing.assert_array_equal(words_to_numpy(got), expect)


@pytest.mark.parametrize("batch", [16, 128])
@pytest.mark.parametrize("start", ["cold", "warm"])
def test_packed_io_bit_identical_to_jax(qqps, batch, start):
    """FusedPGD(packed_io=True) -- K2p's plain version here -- equals JAX's
    packed kernel (interpret mode) and packed_io=False, on words that
    exercise -128 lanes (tests/test_fused.py's batches)."""
    ref, port = qqps
    rng = np.random.default_rng(batch)
    x0 = np.stack([rng.uniform(-3, 3, batch), rng.uniform(-1, 1, batch)], -1)
    g = ref.g_lane_fixed(x0)
    warm = rng.integers(-128, 128, (batch, ref.padded), dtype=np.int32)
    u0 = (np.zeros((batch, ref.padded // 4), np.uint32) if start == "cold"
          else np.asarray(j_pack(jnp.asarray(warm))))
    jf = JFused(ref, iters=20, packed_io=True, block_rows=8, interpret=True)
    expect = np.asarray(jf.solve_words(jnp.asarray(u0), jnp.asarray(g)))
    packed = FusedPGD(port, iters=20, packed_io=True, device="cpu")
    got = packed.solve_words(words_from_numpy(u0, device="cpu"), torch.from_numpy(g))
    np.testing.assert_array_equal(words_to_numpy(got), expect)
    lanes = FusedPGD(port, iters=20, device="cpu").solve_words(
        words_from_numpy(u0, device="cpu"), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), lanes.numpy())


@pytest.mark.parametrize("mode", ["lanes", "momentum", "packed_io"])
@pytest.mark.parametrize("iters", [0, 1])
@pytest.mark.parametrize("T, pad_to", [(20, 32), (50, 4), (100, 64)])
def test_fused_pgd_edges_bit_identical_to_jax(T, pad_to, iters, mode):
    """The card tests' edges against the reference: FusedPGD(device="cpu")
    -- K2's plain version with momentum off and on, K2p's with packed_io --
    equals JAX's FusedPGD in interpret mode at Tp 32, 52 and 128, 0 and 1
    iterations, B = 17 (a tile of 16 problems and one more), on warm words
    with -128 lanes."""
    ref = j_quantize(j_condense(T=T), pad_to=pad_to)
    port = quantized_qp_from_arrays(ref)
    assert port.padded == {20: 32, 50: 52, 100: 128}[T]
    B = 17
    rng = np.random.default_rng(T + iters)
    x0 = np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], -1)
    g = ref.g_lane_fixed(x0)
    warm = rng.integers(-128, 128, (B, ref.padded), dtype=np.int32)
    u0 = np.asarray(j_pack(jnp.asarray(warm)))
    kw = dict(iters=iters, momentum=mode == "momentum", packed_io=mode == "packed_io")
    jf = JFused(ref, block_rows=8, interpret=True, **kw)
    expect = np.asarray(jf.solve_words(jnp.asarray(u0), jnp.asarray(g)))
    got = FusedPGD(port, device="cpu", **kw).solve_words(
        words_from_numpy(u0, device="cpu"), torch.from_numpy(g))
    np.testing.assert_array_equal(words_to_numpy(got), expect)


def test_fused_pgd_packed_plain_is_the_cpu_route(qqps, problem):
    _, port = qqps
    _, g, warm_words = problem
    kw = dict(hs_num=port.hs_num, hs_den=port.hs_den, g_shift=port.g_shift, iters=7)
    args = (words_from_numpy(warm_words, device="cpu"), torch.from_numpy(g),
            torch.as_tensor(port.Hq))
    np.testing.assert_array_equal(fused_pgd_packed(*args, **kw).numpy(),
                                  fused_pgd_packed_plain(*args, **kw).numpy())


def test_packed_io_rejects_momentum_and_bad_shapes(qqps):
    _, port = qqps
    with pytest.raises(ValueError, match="momentum"):
        FusedPGD(port, packed_io=True, momentum=True, device="cpu")
    with pytest.raises(ValueError, match="do not agree"):
        fused_pgd_packed(torch.zeros((4, 15), dtype=torch.int32),
                         torch.zeros((4, 64), dtype=torch.int32),
                         torch.as_tensor(port.Hq), hs_num=1, hs_den=0, g_shift=12,
                         iters=1)


def test_fused_matches_word_solver(qqps, problem):
    _, port = qqps
    x0, g, _ = problem
    fused = FusedPGD(port, iters=25, device="cpu")
    words = FixedPointPGD(port, iters=25, device="cpu")
    gt = torch.from_numpy(g)
    np.testing.assert_array_equal(
        fused.solve_words(fused.init_words(BATCH), gt).numpy(),
        words.solve_words(words.init_words(BATCH), gt).numpy(),
    )


def test_solve_physical_controls_match(qqps, problem):
    ref, port = qqps
    x0, _, _ = problem
    _, u_ref = JFixed(ref, iters=20).solve(x0)
    _, u = FusedPGD(port, iters=20, device="cpu").solve(x0)
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_ref))


def test_fused_pgd_rejects_bad_shapes(qqps):
    _, port = qqps
    hq = torch.as_tensor(port.Hq)
    with pytest.raises(ValueError, match="do not agree"):
        fused_pgd(torch.zeros((4, 60), dtype=torch.int32),
                  torch.zeros((4, 64), dtype=torch.int32), hq,
                  hs_num=1, hs_den=0, g_shift=12, iters=1)


def test_cuda_request_without_cuda_raises(qqps):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is valid here")
    _, port = qqps
    with pytest.raises(RuntimeError, match="cuda"):
        FusedPGD(port, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        FixedPointPGD(port, device="cuda")



def test_fixed_point_pgd_members_match_jax(qqps):
    """``Hq_dev`` and ``lower_words`` hold the reference's values: the int8
    Hessian, and the (1,) box-floor word in the signed container."""
    ref, port = qqps
    j, p = JFixed(ref, iters=3), FixedPointPGD(port, iters=3, device="cpu")
    assert p.Hq_dev.dtype == torch.int8 and p.Hq_dev.device.type == "cpu"
    np.testing.assert_array_equal(p.Hq_dev.numpy(), np.asarray(j.Hq_dev))
    assert p.lower_words.shape == (1,) and p.lower_words.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(p.lower_words), np.asarray(j.lower_words))


def test_cost_bit_equal_to_jax(qqps, problem):
    """``FixedPointPGD.cost`` is the reference's float64 objective, bit for
    bit, on the solver's own plans, on random plans and on one state."""
    ref, port = qqps
    x0, _, _ = problem
    j, p = JFixed(ref, iters=20), FixedPointPGD(port, iters=20, device="cpu")
    _, u = p.solve(x0)
    rng = np.random.default_rng(31)
    for U, x in ((u.numpy(), x0), (rng.normal(size=(BATCH, ref.horizon)), x0),
                 (np.zeros((1, ref.horizon)), x0[0])):
        got = p.cost(U, x)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, j.cost(U, x))


def test_fixed_point_matches_float_reference_by_cost():
    """tests/test_mpc.py:58-80 on the port's solver: within a quantization
    margin of the float64 PGD by ``cost``."""
    from pint_tpu_torch.mpc import condense_double_integrator, quantize

    qp = condense_double_integrator(T=50)
    solver = FixedPointPGD(quantize(qp), iters=60, device="cpu")
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-3, 3, size=16), rng.uniform(-1, 1, size=16)], axis=-1)
    got = solver.solve(x0)[1].numpy()
    u_ref = qp.solve_pgd(x0, iters=60)
    c_got, c_ref = solver.cost(got, x0), solver.cost(u_ref, x0)
    c0 = solver.cost(np.zeros_like(got), x0)
    assert np.all(c_got - c_ref <= 0.02 * (c0 - c_ref + 1e-9))


def test_multi_input_solve_by_cost():
    """tests/test_mpc.py:122-146 on the port: the 2-D double integrator (n
    4, m 2) with error feedback, within the margin of the float64 PGD."""
    from pint_tpu_torch.mpc import condense_lti, quantize

    dt = 1 / 32
    A = np.block([[np.eye(2), dt * np.eye(2)], [np.zeros((2, 2)), np.eye(2)]])
    Bm = np.vstack([0.5 * dt * dt * np.eye(2), dt * np.eye(2)])
    Q = np.diag([1.0, 1.0, 0.1, 0.1])
    lti = condense_lti(A, Bm, Q, 0.01, 10 * Q, 30, np.zeros(4), u_max=1.0)
    solver = FixedPointPGD(quantize(lti), iters=60, error_feedback=True, device="cpu")
    x0 = np.random.default_rng(7).uniform(-2, 2, size=(8, 4))
    u = solver.solve(x0)[1].numpy()
    u_ref = lti.solve_pgd(x0, iters=60)
    c_got, c_ref = solver.cost(u, x0), solver.cost(u_ref, x0)
    c0 = solver.cost(np.zeros_like(u_ref), x0)
    assert np.all(c_got - c_ref <= 0.02 * (c0 - c_ref + 1e-9))
