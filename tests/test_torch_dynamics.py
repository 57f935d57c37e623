"""Port parity: pint_tpu_torch.models.dynamics against pint_tpu's.

Tolerances: packing and the fixed-point rollout bit-identical; the float32
twins (``rollout_f32``, ``linearize_f32``) rtol 1e-6, atol 1e-6 (f32
roundoff: the two frameworks may fuse the multiply-adds differently); the
float64 numpy reference exactly equal (same code)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pint_tpu.models.dynamics import Unicycle as JUnicycle
from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.models.dynamics import unpack_controls as j_unpack
from pint_tpu_torch.convert import words_from_numpy
from pint_tpu_torch.models.dynamics import Unicycle, pack_controls, unpack_controls


def _states(rng, B, T):
    x0 = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-0.5, 0.5, B),
                   rng.uniform(-2, 2, B)], -1).astype(np.float32)
    u = np.stack([rng.uniform(-0.4, 0.4, (B, T)),
                  rng.uniform(-0.1, 0.1, (B, T))], -1).astype(np.float32)
    return x0, u


@pytest.mark.parametrize("T", [4, 64])
def test_pack_unpack_controls_bit_identical(T):
    rng = np.random.default_rng(0)
    lanes = rng.integers(-128, 128, (33, T), dtype=np.int32)
    words = pack_controls(torch.from_numpy(lanes))
    ref = np.asarray(j_pack(jnp.asarray(lanes)))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(unpack_controls(words).numpy(),
                                  np.asarray(j_unpack(jnp.asarray(ref))))
    np.testing.assert_array_equal(unpack_controls(words).numpy(), lanes)


def test_pack_controls_rejects_ragged():
    with pytest.raises(ValueError, match="multiple of 4"):
        pack_controls(torch.zeros((2, 6), dtype=torch.int32))


@pytest.mark.parametrize("seed", [1, 2])
def test_rollout_f32_matches(seed):
    rng = np.random.default_rng(seed)
    x0, u = _states(rng, 16, 32)
    ref = np.asarray(JUnicycle().rollout_f32(jnp.asarray(x0), jnp.asarray(u)))
    got = Unicycle().rollout_f32(torch.from_numpy(x0), torch.from_numpy(u))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_linearize_f32_matches(seed):
    rng = np.random.default_rng(seed)
    x0, u = _states(rng, 64, 1)
    A_ref, B_ref = JUnicycle().linearize_f32(jnp.asarray(x0), jnp.asarray(u[:, 0]))
    A, B = Unicycle().linearize_f32(torch.from_numpy(x0), torch.from_numpy(u[:, 0]))
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), rtol=1e-6, atol=1e-6)


def test_fixed_point_rollout_bit_identical():
    rng = np.random.default_rng(5)
    m = JUnicycle()
    x0 = m.to_fixed(np.stack([rng.uniform(-1, 1, 8), rng.uniform(-1, 1, 8),
                              rng.uniform(-1, 1, 8)], -1))
    lanes = rng.integers(-127, 128, (8, 40), dtype=np.int32)
    words = np.asarray(j_pack(jnp.asarray(lanes)))
    ref = np.asarray(m.rollout_packed(jnp.asarray(x0), jnp.asarray(words)))
    got = Unicycle().rollout_packed(
        torch.from_numpy(np.array(x0)), words_from_numpy(words, device="cpu")
    )
    np.testing.assert_array_equal(got.numpy(), ref)


def test_reference_rollout_and_lane_scales_equal():
    rng = np.random.default_rng(6)
    x0, u = _states(rng, 4, 10)
    np.testing.assert_array_equal(
        Unicycle().reference_rollout(x0, u), JUnicycle().reference_rollout(x0, u)
    )
    np.testing.assert_array_equal(Unicycle().lane_scales, JUnicycle().lane_scales)
