"""Port parity: ``ConstrainedSQP`` (``pint_tpu_torch.mpc.sqp_constrained``)
against ``pint_tpu.mpc.ConstrainedSQP`` on the CPU.

The configuration is ``tests/test_sqp_constrained.py``'s: the unicycle at
T = 32, 6 SQP x 40 PGD, x_ref (1, 0, 0), a lateral corridor F = [[0, 1, 0]],
from two starts facing +-a quarter turn.  Tolerance: bit-identical.  The
host condensation, stacking and quantization are the reference's numpy,
the multiplier rescale between SQP iterations is numpy, and the inner
``_alm_batched`` is integer end to end, so words, multipliers, cost
histories and violations are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.mpc.ltv import QuantizedSQP as JSQP
from pint_tpu.mpc.sqp_constrained import ConstrainedSQP as JCSQP
from pint_tpu_torch.convert import constrained_sqp_config, words_from_numpy, words_to_numpy
from pint_tpu_torch.mpc import ConstrainedSQP, QuantizedSQP

X0 = np.array([[0.0, 0.0, np.pi / 2], [0.0, 0.0, -np.pi / 2]])
SQP_KW = dict(horizon=32, sqp_iters=6, pgd_iters=40, x_ref=np.array([1.0, 0.0, 0.0]))
BINDING = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=4)
INERT = dict(F=[[0.0, 1.0, 0.0]], lo=-0.5, hi=0.5, rho=50.0, alm_outer=2)


def _pair(**kw):
    ref = JCSQP(JSQP(**SQP_KW), **kw)
    return ref, constrained_sqp_config(ref, device="cpu")


def _solve_both(ref, port, x0=X0, **kw):
    jw, jl, jc = ref.solve(x0, **kw)
    pw, pl, pc = port.solve(x0)
    return (np.asarray(jw), np.asarray(jl), jc), (words_to_numpy(pw), pl.numpy(), pc)


@pytest.fixture(scope="module")
def binding():
    ref, port = _pair(**BINDING)
    return ref, port, _solve_both(ref, port)


def test_binding_corridor_bit_identical(binding):
    """Words, multipliers and cost histories equal; the violation equal and
    small (the reference test's bound/3), multipliers active."""
    ref, port, ((jw, jl, jc), (pw, pl, pc)) = binding
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pc, jc)
    lanes = port.sqp.lanes(words_from_numpy(pw, device="cpu"))
    viol = port.violation(X0, lanes)
    np.testing.assert_array_equal(viol, ref.violation(X0, lanes))
    assert viol.max() < 0.03 / 3
    assert np.abs(pl).max() > 0
    np.testing.assert_array_equal(port.constraint_trajectory(X0, lanes),
                                  ref.constraint_trajectory(X0, lanes))


def test_inert_corridor_bit_identical():
    """A corridor wider than the unconstrained swing: bit-identical, zero
    multipliers and zero violation."""
    ref, port = _pair(**INERT)
    (jw, jl, jc), (pw, pl, pc) = _solve_both(ref, port)
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pc, jc)
    assert np.abs(pl).max() == 0
    assert port.violation(X0, port.sqp.lanes(words_from_numpy(pw, device="cpu"))).max() == 0.0


def test_condense_constrained_operands_bit_identical(binding):
    """One iteration's host operands from a seeded warm plan, field by
    field, and the c-unit."""
    ref, port, _ = binding
    lanes = np.random.default_rng(0).integers(-60, 61, (2, 64)).astype(np.int32)
    (pops, pcu), (jops, jcu) = (port._condense_constrained(X0, lanes),
                                ref._condense_constrained(X0, lanes))
    assert set(pops) == set(jops)
    for k in jops:
        assert pops[k].dtype == jops[k].dtype, k
        np.testing.assert_array_equal(pops[k], jops[k], err_msg=k)
    np.testing.assert_array_equal(pcu, jcu)


def test_warm_words_and_multipliers_bit_identical(binding):
    """Warm-started from the binding solve's words and multipliers (the
    rescale path runs with carried multipliers), two more iterations."""
    ref, port, ((jw, jl, _), _) = binding
    r2 = dataclasses.replace(ref, sqp=dataclasses.replace(ref.sqp, sqp_iters=2))
    p2 = dataclasses.replace(port, sqp=dataclasses.replace(port.sqp, sqp_iters=2))
    jw2, jl2, _ = r2.solve(X0, u_words=jnp.asarray(jw), lam=jnp.asarray(jl),
                           track_costs=False)
    pw2, pl2, costs = p2.solve(X0, u_words=words_from_numpy(jw, device="cpu"),
                               lam=torch.as_tensor(jl.copy()), track_costs=False)
    assert costs is None
    np.testing.assert_array_equal(words_to_numpy(pw2), np.asarray(jw2))
    np.testing.assert_array_equal(pl2.numpy(), np.asarray(jl2))


def test_reference_solve_equal():
    ref, port = _pair(**BINDING)
    r2 = dataclasses.replace(ref, sqp=dataclasses.replace(ref.sqp, sqp_iters=2, pgd_iters=10))
    p2 = dataclasses.replace(port, sqp=dataclasses.replace(port.sqp, sqp_iters=2,
                                                           pgd_iters=10))
    for g, w in zip(p2.reference_solve(X0), r2.reference_solve(X0)):
        np.testing.assert_array_equal(g, w)


def test_geometry_and_init():
    _, port = _pair(**BINDING)
    assert port.n_rows == 32 and port.padded_rows == 64
    assert port.init_lam(3).shape == (3, 64) and port.init_lam(3).dtype == torch.int32
    assert port.init_words(3).shape == (3, 16)
    two = ConstrainedSQP(QuantizedSQP(horizon=20, device="cpu"),
                         F=[[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], row_pad=16)
    assert two.n_rows == 40 and two.padded_rows == 48


def test_deterministic():
    _, port = _pair(**dict(BINDING, alm_outer=2))
    p = dataclasses.replace(port, sqp=dataclasses.replace(port.sqp, sqp_iters=2))
    w1, l1, _ = p.solve(X0, track_costs=False)
    w2, l2, _ = p.solve(X0, track_costs=False)
    assert torch.equal(w1, w2) and torch.equal(l1, l2)


def test_validation():
    sqp = QuantizedSQP(horizon=8, sqp_iters=1, pgd_iters=2, x_ref=np.array([1.0, 0.0, 0.0]),
                       device="cpu")
    with pytest.raises(ValueError, match="columns"):
        ConstrainedSQP(sqp, F=[[0.0, 1.0]], lo=-1, hi=1).solve(X0, track_costs=False)
    with pytest.raises(ValueError, match="lo must be < hi"):
        ConstrainedSQP(sqp, F=[[0.0, 1.0, 0.0]], lo=1.0, hi=-1.0).solve(
            X0, track_costs=False)
    with pytest.raises(ValueError, match="identically zero"):
        ConstrainedSQP(sqp, F=[[0.0, 0.0, 0.0]]).solve(X0, track_costs=False)
