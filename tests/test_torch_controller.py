"""Port parity: ``ConstrainedController`` (``pint_tpu_torch.mpc.constrained``)
against ``pint_tpu.mpc.ConstrainedController`` on the CPU.

The configuration is ``tests/test_constrained.py::test_constrained_closed_loop``'s:
the Q16 double integrator at T = 32, a velocity corridor of +-0.15, rho 50,
3 x 15 ALM iterations a tick.  Tolerance: bit-identical, ticks and a
40-tick closed loop (states, applied lanes, words, multipliers).  JAX's
controller runs its word-space (XLA) ALM route on the CPU, as the port's
does; on the card the port's runs K7, held to the same bits by
``chip_smoke.py``.  The tick's f32 maps are summed in index order in the
port (``constrained._mat_round``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import DoubleIntegrator as JDI
from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.mpc import ConstrainedController as JController
from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import constrain_states as j_constrain
from pint_tpu.mpc import quantize_constrained as j_quantize_c
from pint_tpu_torch.convert import (
    quantized_constrained_qp_from_arrays,
    words_from_numpy,
    words_to_numpy,
)
from pint_tpu_torch.models import DoubleIntegrator
from pint_tpu_torch.mpc import ConstrainedController

T, V_MAX, RHO = 32, 0.15, 50.0


@pytest.fixture(scope="module")
def controllers():
    model = JDI()
    dt = model.dt
    qp = j_condense(T=T, dt=dt, q_pos=4.0, u_max=127 * model.u_scale)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    sc = j_constrain(qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)),
                     None, F=[[0.0, 1.0]], lo=-V_MAX, hi=V_MAX)
    jq = j_quantize_c(sc, rho=RHO)
    ref = JController(jq, plant_step=lambda s, u: model.step(s, u[..., 0]),
                      frac_bits=model.frac_bits, outer_per_tick=3, inners_per_outer=15)
    port_model = DoubleIntegrator()
    port = ConstrainedController(quantized_constrained_qp_from_arrays(jq),
                                 plant_step=lambda s, u: port_model.step(s, u[..., 0]),
                                 frac_bits=16, outer_per_tick=3, inners_per_outer=15,
                                 device="cpu")
    return ref, port, jq


def _states(rng, B):
    return np.stack([rng.uniform(-1.5, 1.5, B) * 2**16, rng.uniform(-0.1, 0.1, B) * 2**16],
                    -1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tick_bit_identical(controllers, seed):
    """One tick from seeded states, warm words and warm multipliers."""
    ref, port, jq = controllers
    rng = np.random.default_rng(seed)
    B = 64
    st = _states(rng, B)
    lanes = rng.integers(-127, 128, (B, jq.qqp.padded), dtype=np.int32)
    words = np.asarray(j_pack(jnp.asarray(lanes)))
    lam = rng.integers(0, 400, (B, jq.padded_rows), dtype=np.int32)
    lam[:, jq.n_rows:] = 0
    want = jax.jit(ref.tick)(jnp.asarray(st), jnp.asarray(words), jnp.asarray(lam))
    got = port.tick(torch.as_tensor(st), words_from_numpy(words, device="cpu"),
                    torch.as_tensor(lam))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(words_to_numpy(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_closed_loop_40_ticks_bit_identical(controllers):
    """A 40-tick loop from the reference test's two states and 30 seeded
    ones: states and applied lanes bit-identical, and the velocity limit
    holds (|v| < v_max + 0.01)."""
    ref, port, _ = controllers
    x0 = np.concatenate([np.array([[-1.5 * 2**16, 0.0], [1.0 * 2**16, 0.0]], np.int32),
                         _states(np.random.default_rng(3), 30)])
    want_s, want_u = jax.jit(lambda s: ref.run(s, 40))(jnp.asarray(x0))
    got_s, got_u = port.run(torch.as_tensor(x0), 40)
    assert got_s.shape == (32, 41, 2) and got_u.shape == (32, 40, 1)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    v = got_s.numpy()[..., 1] * 2.0**-16
    assert np.abs(v).max() < V_MAX + 0.01


def test_run_zero_ticks(controllers):
    _, port, _ = controllers
    x0 = torch.as_tensor(_states(np.random.default_rng(4), 3))
    states, lanes = port.run(x0, 0)
    assert states.shape == (3, 1, 2) and lanes.shape == (3, 0, 1)
    assert torch.equal(states[:, 0], x0)
