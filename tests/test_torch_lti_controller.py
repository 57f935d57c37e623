"""Port parity: the LTI closed loops (``pint_tpu_torch.mpc.controller``:
``LTIController``, ``RecedingHorizonController``) against
``pint_tpu.mpc.controller``'s jitted ``run`` on the CPU.

Configurations: ``tests/test_controller.py``'s double integrator
(``u_shift=10``, T = 32, 12 PGD iterations a tick) and
``tests/test_quadrotor.py:56-72``'s hover loop (n = 6, m = 2, T = 40, 25
iterations, error feedback), from seeded states.  Tolerance: bit-identical
(states, applied lanes, words).  The tick's f32 map reproduces XLA's CPU
dot (``constrained._mat_round``).  With ``use_fused=True`` the port runs
K2's plain version here (K2 itself on the card, held to the same bits by
``chip_smoke.py`` and the card tests); the reference's fused tick equals
its word-space tick (``tests/test_controller.py``), so the quadrotor's
fused loop is held to the reference's word-space loop without error
feedback.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import DoubleIntegrator as JDI
from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.models.quadrotor import PlanarQuadrotor as JQuad
from pint_tpu.mpc import condense_lti as j_condense_lti
from pint_tpu.mpc import quantize as j_quantize
from pint_tpu.mpc.controller import LTIController as JLTI
from pint_tpu.mpc.controller import RecedingHorizonController as JRHC
from pint_tpu_torch.convert import lti_controller_config, words_from_numpy, words_to_numpy
from pint_tpu_torch.models import DoubleIntegrator, PlanarQuadrotor
from pint_tpu_torch.mpc import LTIController, RecedingHorizonController, quantize
from pint_tpu_torch.mpc import condense_double_integrator
from pint_tpu_torch.ops import kernels as K


@pytest.fixture(scope="module")
def rhc():
    ref = JRHC.build(JDI(u_shift=10), horizon=32, iters_per_tick=12)
    return ref, lti_controller_config(ref, device="cpu")


def _di_states(model, seed, B):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-3, 3, B), rng.uniform(-1.5, 1.5, B)], -1)
    return model.to_fixed(x)


@pytest.mark.parametrize("fused", [False, True])
def test_receding_horizon_40_ticks_bit_identical(rhc, fused):
    """40 ticks from tests/test_controller.py's start and 31 seeded ones,
    word-space and fused ticks, against JAX's jitted run of the same
    form."""
    ref, port = rhc
    ref = dataclasses.replace(ref, use_fused=fused)
    port = dataclasses.replace(port, use_fused=fused)
    x0 = np.concatenate([ref.model.to_fixed(np.array([[2.5, -0.3]])),
                         _di_states(ref.model, 0, 31)])
    js, jl = jax.jit(lambda s: ref.run(s, 40))(jnp.asarray(x0))
    before = K.launch_counts()
    ps, pl = port.run(torch.as_tensor(x0), 40)
    assert K.launch_counts() == before           # the CPU runs plain versions
    assert ps.shape == (32, 41, 2) and pl.shape == (32, 40)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


def test_receding_horizon_regulates_bit_identical(rhc):
    """tests/test_controller.py's regulation run (220 ticks from three
    starts): bit-identical, ends near the origin, lanes in the box."""
    ref, port = rhc
    x0 = ref.model.to_fixed(np.array([[3.0, 0.0], [-2.0, 1.0], [1.0, -1.5]]))
    js, jl = jax.jit(lambda s: ref.run(s, 220))(jnp.asarray(x0))
    ps, pl = port.run(torch.as_tensor(x0), 220)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    pos = port.model.to_float(ps.numpy()[..., 0])
    vel = port.model.to_float(ps.numpy()[..., 1])
    assert np.abs(pos[:, -1]).max() < 0.15 and np.abs(vel[:, -1]).max() < 0.15
    assert np.abs(pl.numpy()).max() <= 127


@pytest.mark.parametrize("seed", [1, 2])
def test_receding_horizon_tick_bit_identical(rhc, seed):
    """One tick from seeded states and warm words."""
    ref, port = rhc
    rng = np.random.default_rng(seed)
    x0 = _di_states(ref.model, seed, 64)
    lanes = rng.integers(-127, 128, (64, ref.qqp.padded), dtype=np.int32)
    words = np.asarray(j_pack(jnp.asarray(lanes)))
    want = jax.jit(ref.tick)(jnp.asarray(x0), jnp.asarray(words))
    got = port.tick(torch.as_tensor(x0), words_from_numpy(words, device="cpu"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(words_to_numpy(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_receding_horizon_build_and_checks():
    port = RecedingHorizonController.build(DoubleIntegrator(u_shift=10), horizon=32,
                                           iters_per_tick=12, device="cpu")
    ref = JRHC.build(JDI(u_shift=10), horizon=32, iters_per_tick=12)
    np.testing.assert_array_equal(port.qqp.Hq, ref.qqp.Hq)
    assert (port.qqp.hs_num, port.qqp.hs_den) == (ref.qqp.hs_num, ref.qqp.hs_den)
    with pytest.raises(ValueError, match="lane scale"):
        RecedingHorizonController(quantize(condense_double_integrator(T=8)),
                                  DoubleIntegrator(u_shift=10), device="cpu")
    states, lanes = port.run(torch.zeros((2, 2), dtype=torch.int32), 0)
    assert states.shape == (2, 1, 2) and lanes.shape == (2, 0)


def _quad_qqp():
    m = JQuad()
    A, B = m.hover_lti()
    Q = np.diag([4.0, 4.0, 2.0, 0.5, 0.5, 0.5])
    qp = j_condense_lti(A, B, Q, 0.05, 10 * Q, 40, np.zeros(6), 100 * m.f_scale)
    return m, j_quantize(qp)


def _quad_states(m, seed, B):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-0.6, 0.6, B), rng.uniform(-0.6, 0.6, B),
                  rng.uniform(-0.03, 0.03, B), rng.uniform(-0.2, 0.2, B),
                  rng.uniform(-0.2, 0.2, B), rng.uniform(-0.05, 0.05, B)], -1)
    x[0] = [0.6, -0.4, 0.03, 0.0, 0.0, 0.0]      # tests/test_quadrotor.py's start
    return m.to_fixed(x)


@pytest.fixture(scope="module")
def quad():
    m, qqp = _quad_qqp()
    pm = PlanarQuadrotor()

    def make(fused, ef):
        ref = JLTI(qqp, plant_step=lambda s, u: m.step(s, u[..., 0], u[..., 1]),
                   inputs_per_step=2, iters_per_tick=25, error_feedback=ef)
        port = lti_controller_config(
            ref, plant_step=lambda s, u: pm.step(s, u[..., 0], u[..., 1]),
            use_fused=fused, device="cpu")
        return ref, port

    return m, make


def test_quadrotor_hover_160_ticks_bit_identical(quad):
    """The hover loop with error feedback, 160 ticks, from the reference
    test's start and 15 seeded ones: bit-identical, and the first problem
    ends hovering as the reference test asserts."""
    m, make = quad
    ref, port = make(False, True)
    x0 = _quad_states(m, 0, 16)
    js, jl = jax.jit(lambda s: ref.run(s, 160))(jnp.asarray(x0))
    ps, pl = port.run(torch.as_tensor(x0), 160)
    assert pl.shape == (16, 160, 2)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    traj = m.to_float(ps.numpy()[0])
    assert np.abs(traj[-1, :2]).max() < 0.12 and abs(traj[-1, 2]) < 0.02
    assert np.abs(traj[-1, 3:5]).max() < 0.15


def test_quadrotor_fused_without_error_feedback_bit_identical(quad):
    """``use_fused=True, error_feedback=False`` (K2's plain version here),
    60 ticks, against the reference's loop without error feedback."""
    m, make = quad
    ref, _ = make(False, False)
    _, port = make(True, False)
    x0 = _quad_states(m, 1, 16)
    js, jl = jax.jit(lambda s: ref.run(s, 60))(jnp.asarray(x0))
    ps, pl = port.run(torch.as_tensor(x0), 60)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


def test_fused_with_error_feedback_raises(quad):
    """The reference quietly drops error feedback under use_fused (K2 has
    none); the port refuses the pair."""
    m, qqp = _quad_qqp()
    from pint_tpu_torch.convert import quantized_qp_from_arrays

    with pytest.raises(ValueError, match="error feedback"):
        LTIController(quantized_qp_from_arrays(qqp), plant_step=lambda s, u: s,
                      use_fused=True, error_feedback=True, device="cpu")
    ref = JLTI(qqp, plant_step=lambda s, u: s, use_fused=True, error_feedback=True)
    with pytest.raises(ValueError, match="error feedback"):
        lti_controller_config(ref, plant_step=lambda s, u: s, device="cpu")
    with pytest.raises(ValueError, match="plant_step"):
        lti_controller_config(ref, device="cpu")


def test_lti_controller_zero_ticks(quad):
    m, make = quad
    _, port = make(False, True)
    x0 = torch.as_tensor(_quad_states(m, 2, 3))
    states, lanes = port.run(x0, 0)
    assert states.shape == (3, 1, 6) and lanes.shape == (3, 0, 2)
    assert torch.equal(states[:, 0], x0)
