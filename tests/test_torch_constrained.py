"""Port parity: the LTI state-constrained tier (``mpc/constrained.py`` and
its kernel K7, ``alm_shared_fused_words``) against pint_tpu's.

The problem is ``bench_constrained``'s (the double integrator with a
velocity corridor, ``F=[[0,1]]``, ``lo=-0.25``, ``hi=0.25``, rho 50) at a
small horizon.  Tolerances: the host tier (``constrain_states``,
``quantize_constrained``) equal field by field; the integer ALM loops
bit-identical (words and multipliers, cold and warm); JAX's Pallas kernel
runs in interpret mode, as tests/test_fused_alm.py runs it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import constrain_states as j_constrain
from pint_tpu.mpc import quantize_constrained as j_quantize_c
from pint_tpu.mpc.constrained import ConstrainedPGD as JConstrainedPGD
from pint_tpu.mpc.fused_alm import alm_shared_fused_words as j_alm_shared
from pint_tpu_torch.convert import (
    quantized_constrained_qp_from_arrays,
    words_from_numpy,
    words_to_numpy,
)
from pint_tpu_torch.models.dynamics import pack_controls
from pint_tpu_torch.mpc import (
    ConstrainedPGD,
    alm_shared,
    alm_shared_fused_words,
    alm_shared_plain,
    condense_double_integrator,
    constrain_states,
    quantize_constrained,
)

DT = 1.0 / 32.0


def _problem(lib, T):
    condense, constrain, quantize_c = lib
    qp = condense(T=T, dt=DT, q_pos=4.0)
    A = np.array([[1.0, DT], [0.0, 1.0]])
    Bm = np.array([[0.5 * DT * DT], [DT]])
    sc = constrain(qp, np.broadcast_to(A, (T, 2, 2)),
                   np.broadcast_to(Bm, (T, 2, 1)), None,
                   F=[[0.0, 1.0]], lo=-0.25, hi=0.25)
    return quantize_c(sc, rho=50.0)


@pytest.fixture(scope="module", params=[12, 20], ids=lambda t: f"T{t}")
def qcqps(request):
    T = request.param
    ref = _problem((j_condense, j_constrain, j_quantize_c), T)
    port = _problem((condense_double_integrator, constrain_states,
                     quantize_constrained), T)
    return ref, port


def _states(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-1.5, 1.5, B), rng.uniform(-0.2, 0.2, B)], -1)


def _assert_fields_equal(a, b, path=""):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_fields_equal(getattr(a, f.name), getattr(b, f.name),
                                 f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_host_tier_fields_equal(qcqps):
    ref, port = qcqps
    _assert_fields_equal(port, ref)
    _assert_fields_equal(quantized_constrained_qp_from_arrays(ref), port)


def test_host_tier_offsets_and_reference_solver_equal(qcqps):
    ref, port = qcqps
    x0 = _states(7, 1)
    x0[2, 0] = np.inf
    np.testing.assert_array_equal(port.c_off_pre(x0), ref.c_off_pre(x0))
    x0 = _states(3, 2)
    U, lam = port.scqp.solve_alm(x0, rho=50.0, outer=3, inners=10)
    U_j, lam_j = ref.scqp.solve_alm(x0, rho=50.0, outer=3, inners=10)
    np.testing.assert_array_equal(U, U_j)
    np.testing.assert_array_equal(lam, lam_j)
    np.testing.assert_array_equal(port.scqp.kkt_residual(U, lam, x0),
                                  ref.scqp.kkt_residual(U, lam, x0))


def test_constrain_states_validation():
    qp = condense_double_integrator(T=4)
    A, Bm = np.eye(2), np.ones((2, 1))
    with pytest.raises(ValueError, match="lo must be < hi"):
        constrain_states(qp, np.broadcast_to(A, (4, 2, 2)),
                         np.broadcast_to(Bm, (4, 2, 1)), None, F=[[0, 1]],
                         lo=1.0, hi=-1.0)
    with pytest.raises(ValueError, match="columns"):
        constrain_states(qp, np.broadcast_to(A, (4, 2, 2)),
                         np.broadcast_to(Bm, (4, 2, 1)), None, F=[[0, 1, 0]],
                         lo=-1.0, hi=1.0)


def _inputs(q, B, seed):
    x0 = _states(B, seed)
    return x0, q.qqp.g_lane_fixed(x0), q.c_off_pre(x0)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_constrained_pgd_word_space_bit_identical(qcqps, warm):
    """Port ConstrainedPGD(fused=False) against JAX's XLA route and JAX's
    Pallas kernel (interpret), and the port's lane-space entry (K7's
    plain version) against both."""
    ref, port = qcqps
    B = 12
    _, g, co = _inputs(ref, B, 3)
    rng = np.random.default_rng(4)
    lanes0 = rng.integers(-127, 128, (B, ref.qqp.padded), dtype=np.int32) if warm \
        else np.zeros((B, ref.qqp.padded), np.int32)
    lam0 = rng.integers(0, 300, (B, ref.padded_rows), dtype=np.int32) if warm \
        else np.zeros((B, ref.padded_rows), np.int32)
    kw = dict(outer=3, inners=8)
    j_words0 = np.asarray(pack_controls(torch.as_tensor(lanes0))).view(np.uint32)
    jx = JConstrainedPGD(ref, fused=False, **kw)
    jf = JConstrainedPGD(ref, fused=True, block_rows=8, **kw)
    args = (jnp.asarray(j_words0), jnp.asarray(g), jnp.asarray(co), jnp.asarray(lam0))
    w_x, l_x = jax.jit(jx.solve_words)(*args)
    w_f, l_f = jax.jit(jf.solve_words)(*args)
    np.testing.assert_array_equal(np.asarray(w_x), np.asarray(w_f))
    targs = (words_from_numpy(j_words0, device="cpu"), torch.as_tensor(g), torch.as_tensor(co),
             torch.as_tensor(lam0))
    for fused in (False, True, None):
        w, lam = ConstrainedPGD(port, fused=fused, **kw, device="cpu").solve_words(*targs)
        np.testing.assert_array_equal(words_to_numpy(w), np.asarray(w_x))
        np.testing.assert_array_equal(lam.numpy(), np.asarray(l_x))


def test_alm_shared_plain_matches_jax_kernel(qcqps):
    """K7's plain version against JAX's kernel in interpret mode, on warm
    lanes (incl. -128) and multipliers."""
    ref, port = qcqps
    B = 10
    _, g, co = _inputs(ref, B, 5)
    rng = np.random.default_rng(6)
    lanes = rng.integers(-128, 128, (B, ref.qqp.padded), dtype=np.int32)
    lam = rng.integers(-200, 400, (B, ref.padded_rows), dtype=np.int32)
    q, qq = ref, ref.qqp
    rat = dict(hs_num=qq.hs_num, hs_den=qq.hs_den, cs_num=q.cs_num,
               cs_den=q.cs_den, eh_num=q.eh_num, eh_den=q.eh_den,
               el_num=q.el_num, el_den=q.el_den)
    kw = dict(outer=2, inners=7, g_shift=qq.g_shift, y_shift=q.y_shift)
    j_words = np.asarray(pack_controls(torch.as_tensor(lanes))).view(np.uint32)
    w_j, l_j = j_alm_shared(
        jnp.asarray(j_words), jnp.asarray(g), jnp.asarray(co), jnp.asarray(lam),
        Hq=qq.Hq, Sq=q.Sq, lo_pre=q.lo_pre, hi_pre=q.hi_pre, block_rows=4,
        interpret=True, **rat, **kw)
    t = torch.as_tensor
    out, lam_p = alm_shared_plain(
        t(lanes), t(g), t(co), t(lam), t(qq.Hq), t(q.Sq), t(q.lo_pre),
        t(q.hi_pre), **rat, **kw)
    np.testing.assert_array_equal(words_to_numpy(pack_controls(out)), np.asarray(w_j))
    np.testing.assert_array_equal(lam_p.numpy(), np.asarray(l_j))
    w, lam_w = alm_shared_fused_words(
        words_from_numpy(j_words, device="cpu"), t(g), t(co), t(lam), Hq=qq.Hq, Sq=q.Sq,
        lo_pre=q.lo_pre, hi_pre=q.hi_pre, **rat, **kw)
    np.testing.assert_array_equal(words_to_numpy(w), np.asarray(w_j))
    np.testing.assert_array_equal(lam_w.numpy(), np.asarray(l_j))


def test_solve_end_to_end(qcqps):
    ref, port = qcqps
    x0 = _states(6, 7)
    kw = dict(outer=3, inners=10)
    w_j, U_j, l_j = JConstrainedPGD(ref, fused=False, **kw).solve(x0)
    w, U, lam = ConstrainedPGD(port, **kw, device="cpu").solve(x0)
    np.testing.assert_array_equal(words_to_numpy(w), np.asarray(w_j))
    np.testing.assert_array_equal(U.numpy(), np.asarray(U_j))
    np.testing.assert_array_equal(lam.numpy(), np.asarray(l_j))
    assert U.shape == (6, ref.qqp.horizon)
    assert np.abs(U.numpy()).max() <= ref.qqp.qp.u_max + 1e-6


def test_constrained_pgd_binds_and_tracks_reference():
    """At the bench horizon (T=50): the quantized solve stays near the
    float64 ALM reference's constraint values."""
    port = _problem((condense_double_integrator, constrain_states,
                     quantize_constrained), 50)
    x0 = _states(4, 8)
    _, U, _ = ConstrainedPGD(port, outer=12, inners=60, device="cpu").solve(x0)
    c = port.scqp.constraint(U.numpy().astype(np.float64), x0)
    U_ref, _ = port.scqp.solve_alm(x0, rho=50.0, outer=12, inners=60)
    c_ref = port.scqp.constraint(U_ref, x0)
    viol = np.maximum(c - 0.25, 0) + np.maximum(-0.25 - c, 0)
    viol_ref = np.maximum(c_ref - 0.25, 0) + np.maximum(-0.25 - c_ref, 0)
    assert viol.max() <= viol_ref.max() + 0.02


def test_alm_shared_rejects_bad_operands(qcqps):
    _, port = qcqps
    qq = port.qqp
    B, Tp, Cp = 2, qq.padded, port.padded_rows
    z = torch.zeros
    good = [z((B, Tp), dtype=torch.int32), z((B, Tp), dtype=torch.int32),
            z((B, Cp), dtype=torch.int32), z((B, Cp), dtype=torch.int32),
            torch.as_tensor(qq.Hq), torch.as_tensor(port.Sq),
            torch.as_tensor(port.lo_pre), torch.as_tensor(port.hi_pre)]
    kw = dict(hs_num=1, hs_den=0, cs_num=1, cs_den=0, eh_num=1, eh_den=0,
              el_num=1, el_den=0, outer=1, inners=1, g_shift=12, y_shift=12)
    bad_dtype = list(good)
    bad_dtype[4] = bad_dtype[4].to(torch.int32)
    with pytest.raises(ValueError, match="hq must be torch.int8"):
        alm_shared(*bad_dtype, **kw)
    bad_shape = list(good)
    bad_shape[5] = bad_shape[5][:, :-4]
    with pytest.raises(ValueError, match="sq is"):
        alm_shared(*bad_shape, **kw)
