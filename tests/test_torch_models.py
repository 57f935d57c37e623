"""Port parity: the double integrator, the planar quadrotor and the pendulum
(``pint_tpu_torch.models``) against ``pint_tpu.models``.

Tolerances: the fixed-point steps and rollouts bit-identical (int32 wrap
and arithmetic shifts, also at int32's extremes); the float32 twins
(``rollout_f32``, ``linearize_f32``) rtol 1e-6, atol 1e-6 (f32 roundoff:
the frameworks may fuse multiply-adds differently), as the unicycle's
(``tests/test_torch_dynamics.py``); the float64 references and Jacobians to
1e-12 (the same numpy code)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import DoubleIntegrator as JDI
from pint_tpu.models import Pendulum as JPend
from pint_tpu.models import PlanarQuadrotor as JQuad
from pint_tpu.models.dynamics import _dsin_turns_f64 as j_dsin
from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu_torch.models import DoubleIntegrator, Pendulum, PlanarQuadrotor
from pint_tpu_torch.models.dynamics import _dsin_turns_f64, pack_controls


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- the double integrator -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_double_integrator_step_bit_identical(seed):
    rng = np.random.default_rng(seed)
    st = rng.integers(-2**31, 2**31, (257, 2), dtype=np.int64).astype(np.int32)
    u = rng.integers(-128, 128, 257, dtype=np.int32)
    m, jm = DoubleIntegrator(), JDI()
    np.testing.assert_array_equal(m.step(_t(st), _t(u)).numpy(),
                                  _np(jm.step(jnp.asarray(st), jnp.asarray(u))))


def test_double_integrator_rollout_packed_h52_b64():
    """bench.py's rollouts section at B = 64: H = 52 steps from seeded
    words, bit-identical, and equal to the unpacked rollout."""
    rng = np.random.default_rng(5)
    B, H = 64, 52
    words = rng.integers(0, 2**32, (B, H // 4), dtype=np.uint64).astype(np.uint32)
    st0 = np.stack([rng.integers(-2**20, 2**20, B), rng.integers(-2**18, 2**18, B)],
                   -1).astype(np.int32)
    m = DoubleIntegrator()
    got = m.rollout_packed(_t(st0), _t(words.view(np.int32)))
    ref = _np(JDI().rollout_packed(jnp.asarray(st0), jnp.asarray(words)))
    assert got.shape == (B, H + 1, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kw", [dict(), dict(dt_shift=3, u_shift=12)])
def test_double_integrator_rollout_and_reference(kw):
    rng = np.random.default_rng(2)
    lanes = rng.integers(-128, 128, (9, 40), dtype=np.int32)
    st0 = np.stack([rng.integers(-2**16, 2**16, 9), rng.integers(-2**14, 2**14, 9)],
                   -1).astype(np.int32)
    m, jm = DoubleIntegrator(**kw), JDI(**kw)
    np.testing.assert_array_equal(m.rollout(_t(st0), _t(lanes)).numpy(),
                                  _np(jm.rollout(jnp.asarray(st0), jnp.asarray(lanes))))
    x0 = m.to_float(st0)
    np.testing.assert_allclose(m.reference_rollout(x0, lanes * m.u_scale),
                               jm.reference_rollout(x0, lanes * jm.u_scale),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(m.to_fixed(x0), jm.to_fixed(x0))
    assert m.u_scale == jm.u_scale and m.dt == jm.dt


def test_double_integrator_validates():
    with pytest.raises(ValueError, match="u_shift"):
        DoubleIntegrator(u_shift=24)
    with pytest.raises(ValueError, match="dt_shift"):
        DoubleIntegrator(dt_shift=0)


def test_dsin_turns_f64_equal():
    t = np.linspace(-2.0, 2.0, 1001)
    np.testing.assert_array_equal(_dsin_turns_f64(t), j_dsin(t))


# -- the planar quadrotor -----------------------------------------------------------


@pytest.mark.parametrize("f_shift", [9, 11])
def test_quadrotor_step_bit_identical_at_int32_extremes(f_shift):
    """Full-range int32 states (theta and the velocities wrap) and lanes at
    -128 and 127: every product and sum stays int32 and wraps as XLA's."""
    rng = np.random.default_rng(f_shift)
    st = rng.integers(-2**31, 2**31, (512, 6), dtype=np.int64).astype(np.int32)
    st[:4] = [[2**31 - 1] * 6, [-2**31] * 6, [0] * 6, [2**31 - 1, -2**31] * 3]
    u1 = rng.integers(-128, 128, 512, dtype=np.int32)
    u2 = rng.integers(-128, 128, 512, dtype=np.int32)
    u1[:4], u2[:4] = [127, -128, 127, -128], [-128, 127, 127, -128]
    m, jm = PlanarQuadrotor(f_shift=f_shift), JQuad(f_shift=f_shift)
    got = m.step(_t(st), _t(u1), _t(u2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _np(jm.step(jnp.asarray(st), jnp.asarray(u1), jnp.asarray(u2))))


def test_quadrotor_rollout_bit_identical():
    rng = np.random.default_rng(3)
    B, T = 33, 24
    m, jm = PlanarQuadrotor(), JQuad()
    st0 = m.to_fixed(np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B),
                               rng.uniform(-0.1, 0.1, B), rng.uniform(-0.5, 0.5, B),
                               rng.uniform(-0.5, 0.5, B), rng.uniform(-0.2, 0.2, B)], -1))
    lanes = rng.integers(-128, 128, (B, T, 2), dtype=np.int32)
    np.testing.assert_array_equal(m.rollout(_t(st0), _t(lanes)).numpy(),
                                  _np(jm.rollout(jnp.asarray(st0), jnp.asarray(lanes))))


def _quad_states(rng, B):
    return np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B), rng.uniform(-0.6, 0.6, B),
                     rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
                     rng.uniform(-0.3, 0.3, B)], -1)


@pytest.mark.parametrize("seed", [4, 5])
def test_quadrotor_f32_twins(seed):
    rng = np.random.default_rng(seed)
    B, T = 32, 16
    m, jm = PlanarQuadrotor(), JQuad()
    x0 = _quad_states(rng, B).astype(np.float32)
    u = rng.uniform(-0.99, 0.99, (B, T, 2)).astype(np.float32)
    np.testing.assert_allclose(
        m.rollout_f32(_t(x0), _t(u)).numpy(),
        _np(jm.rollout_f32(jnp.asarray(x0), jnp.asarray(u))), rtol=1e-6, atol=1e-6)
    A, Bm = m.linearize_f32(_t(x0), _t(u[:, 0]))
    jA, jB = jm.linearize_f32(jnp.asarray(x0), jnp.asarray(u[:, 0]))
    assert A.dtype == torch.float32 and A.shape == (B, 6, 6) and Bm.shape == (B, 6, 2)
    np.testing.assert_allclose(A.numpy(), _np(jA), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Bm.numpy(), _np(jB), rtol=1e-6, atol=1e-6)


def test_quadrotor_f64_reference_linearize_and_hover():
    rng = np.random.default_rng(6)
    m, jm = PlanarQuadrotor(), JQuad()
    x0 = _quad_states(rng, 8)
    u = rng.uniform(-0.99, 0.99, (8, 12, 2))
    np.testing.assert_allclose(m.reference_rollout(x0, u), jm.reference_rollout(x0, u),
                               rtol=1e-12, atol=1e-12)
    for a, b in zip(m.linearize(x0, u[:, 0]), jm.linearize(x0, u[:, 0])):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    for a, b in zip(m.hover_lti(), jm.hover_lti()):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(m.to_fixed(x0), jm.to_fixed(x0))
    np.testing.assert_array_equal(m.lane_scales, jm.lane_scales)
    assert (m.hover_fp, m.g_fp) == (jm.hover_fp, jm.g_fp)
    with pytest.raises(ValueError, match="f_shift"):
        PlanarQuadrotor(f_shift=12)


# -- the pendulum -------------------------------------------------------------------


@pytest.mark.parametrize("k_g", [2.5, 7.9])
def test_pendulum_step_and_rollout_bit_identical(k_g):
    rng = np.random.default_rng(7)
    st = rng.integers(-2**31, 2**31, (300, 2), dtype=np.int64).astype(np.int32)
    u = rng.integers(-128, 128, 300, dtype=np.int32)
    m, jm = Pendulum(k_g=k_g), JPend(k_g=k_g)
    np.testing.assert_array_equal(m.step(_t(st), _t(u)).numpy(),
                                  _np(jm.step(jnp.asarray(st), jnp.asarray(u))))
    lanes = rng.integers(-128, 128, (16, 52), dtype=np.int32)
    st0 = st[:16] >> 8
    words = j_pack(jnp.asarray(lanes))
    got = m.rollout_packed(_t(st0), pack_controls(_t(lanes)))
    np.testing.assert_array_equal(got.numpy(), _np(jm.rollout_packed(jnp.asarray(st0), words)))


@pytest.mark.parametrize("seed", [8, 9])
def test_pendulum_f32_twins_and_reference(seed):
    rng = np.random.default_rng(seed)
    m, jm = Pendulum(), JPend()
    x0 = np.stack([rng.uniform(-0.5, 0.5, 24), rng.uniform(-1, 1, 24)], -1)
    u = rng.uniform(-m.u_max, m.u_max, (24, 20, 1))
    x32, u32 = x0.astype(np.float32), u.astype(np.float32)
    np.testing.assert_allclose(
        m.rollout_f32(_t(x32), _t(u32)).numpy(),
        _np(jm.rollout_f32(jnp.asarray(x32), jnp.asarray(u32))), rtol=1e-6, atol=1e-6)
    for a, b in zip(m.linearize_f32(_t(x32), _t(u32[:, 0])),
                    jm.linearize_f32(jnp.asarray(x32), jnp.asarray(u32[:, 0]))):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.reference_rollout(x0, u), jm.reference_rollout(x0, u),
                               rtol=1e-12, atol=1e-12)
    for a, b in zip(m.linearize(x0, u[:, 0]), jm.linearize(x0, u[:, 0])):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert m._kg_fp == jm._kg_fp and m.u_max == jm.u_max
    np.testing.assert_array_equal(m.to_fixed(x0), jm.to_fixed(x0))


def test_pendulum_validates():
    with pytest.raises(ValueError, match="k_g"):
        Pendulum(k_g=8.0)
    with pytest.raises(ValueError, match="u_shift"):
        Pendulum(u_shift=21)
