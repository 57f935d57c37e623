"""Port parity: the per-problem ALM inner (K5, ``alm_fused_words_pre``)
and the penalty power iteration (K6, ``pen_fused``) against pint_tpu's, on
real DeviceConstrainedSQP operands.

The operands come from JAX's ``_condense_constrained_dev`` at horizon 8
(Tm = 16, C = 8 rows padded to Cp = 64), B = 12, converted with numpy, as
tests/test_fused_alm.py makes them.  JAX's Pallas kernels run in interpret
mode.  Tolerances: the ALM inners bit-identical (words and multipliers,
cold and warm); K6's ``sqc``, ``sqj`` and ``s_scale`` bit-identical,
``row_amp`` rtol 1e-6 and ``pen_lip`` rtol 1e-4 (the bounds of
tests/test_condense_fused.py: the f32 sums are added in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.mpc import DeviceConstrainedSQP as JDeviceConstrainedSQP
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu.mpc.condense_fused import pen_fused as j_pen
from pint_tpu.mpc.fused_alm import alm_fused_words_pre as j_alm_pre
from pint_tpu.mpc.sqp_constrained import _Y_SHIFT as J_Y_SHIFT
from pint_tpu.mpc.sqp_constrained import _alm_batched as j_alm_batched
from pint_tpu.mpc.sqp_constrained import _rational_vec as j_rational_vec
from pint_tpu_torch.convert import words_from_numpy, words_to_numpy
from pint_tpu_torch.mpc import (
    alm_fused_words,
    alm_fused_words_pre,
    alm_hqt,
    alm_hqt_plain,
    pen_fused,
    pen_plain,
)
from pint_tpu_torch.mpc.constrained import RATIONALS
from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT, _alm_batched, _rational_vec

ORDER = ("g_pre", "Hq", "hs_num", "hs_den", "Sq", "cs_num", "cs_den",
         "c_off", "lo_pre", "hi_pre", "eh_num", "eh_den", "el_num",
         "el_den")


def _mk():
    return JDeviceConstrainedSQP(
        JDeviceSQP(horizon=8, sqp_iters=2, pgd_iters=6,
                   x_ref=np.array([1.0, 0.0, 0.0]), propagate="unroll"),
        F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=2,
        fused=False,
    )


def _x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(-np.pi, np.pi, B)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def real_ops():
    devc = _mk()
    d = devc.dev
    B = 12
    rng = np.random.default_rng(7)
    x0 = jnp.asarray(_x0(B, 8))
    lanes = jnp.asarray(rng.integers(-100, 100, (B, d.n_dec), dtype=np.int32))
    ops, _ = jax.jit(devc._condense_constrained_dev)(x0, lanes)
    ops = {k: np.asarray(v) for k, v in ops.items()}
    ops["hqt"] = np.ascontiguousarray(np.transpose(ops["Hq"], (2, 1, 0)))
    ops["sqj"] = np.ascontiguousarray(np.transpose(ops["Sq"], (2, 1, 0)))
    ops["sqc"] = np.ascontiguousarray(np.transpose(ops["Sq"], (1, 2, 0)))
    return devc, ops


def _warm(devc, B, warm, seed):
    rng = np.random.default_rng(seed)
    if not warm:
        return (np.zeros((B, devc.dev.n_dec // 4), np.uint32),
                np.zeros((B, devc.padded_rows), np.int32))
    lanes = rng.integers(-127, 128, (B, devc.dev.n_dec), dtype=np.int32)
    return (np.asarray(j_pack(jnp.asarray(lanes))),
            rng.integers(0, 500, (B, devc.padded_rows), dtype=np.int32))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_y_shift_matches():
    assert _Y_SHIFT == J_Y_SHIFT


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_alm_inner_bit_identical(real_ops, warm):
    devc, o = real_ops
    d = devc.dev
    B = o["g_pre"].shape[0]
    words, lam0 = _warm(devc, B, warm, 3)
    kw = dict(outer=devc.alm_outer, inners=d.pgd_iters, g_shift=d.g_shift,
              y_shift=_Y_SHIFT)
    jw, jl = j_alm_batched(jnp.asarray(words), *[jnp.asarray(o[k]) for k in ORDER],
                           jnp.asarray(lam0), **kw)
    jw_k, jl_k = j_alm_pre(
        jnp.asarray(words), jnp.asarray(o["g_pre"]), jnp.asarray(o["hqt"]),
        jnp.asarray(o["hs_num"]), jnp.asarray(o["hs_den"]), jnp.asarray(o["sqj"]),
        jnp.asarray(o["sqc"]), *[jnp.asarray(o[k]) for k in ORDER[5:]],
        jnp.asarray(lam0), block=5, interpret=True, **kw)
    np.testing.assert_array_equal(np.asarray(jw), np.asarray(jw_k))
    np.testing.assert_array_equal(np.asarray(jl), np.asarray(jl_k))

    w = words_from_numpy(words, device="cpu")
    rest = [_t(o[k]) for k in ORDER[5:]]
    got = {
        "_alm_batched": _alm_batched(w, *[_t(o[k]) for k in ORDER], _t(lam0), **kw),
        "alm_fused_words": alm_fused_words(
            w, *[_t(o[k]) for k in ORDER], _t(lam0), **kw),
        "alm_fused_words_pre": alm_fused_words_pre(
            w, _t(o["g_pre"]), _t(o["hqt"]), _t(o["hs_num"]), _t(o["hs_den"]),
            _t(o["sqj"]), _t(o["sqc"]), *rest, _t(lam0), **kw),
    }
    for name, (gw, gl) in got.items():
        np.testing.assert_array_equal(words_to_numpy(gw), np.asarray(jw), err_msg=name)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(jl), err_msg=name)


def test_alm_hqt_plain_is_the_cpu_route(real_ops):
    devc, o = real_ops
    d = devc.dev
    B = o["g_pre"].shape[0]
    rng = np.random.default_rng(9)
    lanes = _t(rng.integers(-128, 128, (B, d.n_dec), dtype=np.int32))
    lam = _t(rng.integers(-300, 300, (B, devc.padded_rows), dtype=np.int32))
    sc = _t(np.stack([o[k] for k in RATIONALS]))
    args = (lanes, _t(o["g_pre"]), _t(o["hqt"]), _t(o["sqj"]), _t(o["sqc"]),
            _t(o["c_off"]), _t(o["lo_pre"]), _t(o["hi_pre"]), lam, sc)
    kw = dict(outer=2, inners=5, g_shift=d.g_shift, y_shift=_Y_SHIFT)
    a, b = alm_hqt(*args, **kw), alm_hqt_plain(*args, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0].abs().max()) <= 127


def test_alm_hqt_rejects_bad_operands(real_ops):
    devc, o = real_ops
    B = o["g_pre"].shape[0]
    sc = _t(np.stack([o[k] for k in RATIONALS]))
    good = [_t(np.zeros((B, devc.dev.n_dec), np.int32)), _t(o["g_pre"]),
            _t(o["hqt"]), _t(o["sqj"]), _t(o["sqc"]), _t(o["c_off"]),
            _t(o["lo_pre"]), _t(o["hi_pre"]), _t(o["c_off"]) * 0, sc]
    kw = dict(outer=1, inners=1, g_shift=12, y_shift=_Y_SHIFT)
    bad = list(good)
    bad[4] = bad[4].to(torch.int32)
    with pytest.raises(ValueError, match="sqc must be torch.int8"):
        alm_hqt(*bad, **kw)
    bad = list(good)
    bad[9] = bad[9][:7]
    with pytest.raises(ValueError, match="sc is"):
        alm_hqt(*bad, **kw)


def test_rational_vec_matches():
    val = np.array([3e-4, 0.5, 7.25, 1234.5])
    for args in ((127 * 127 * 64, 2**31 - 1), (64 * 127 * 64, 2**30 - 1)):
        for a, b in zip(_rational_vec(val, *args, "x"), j_rational_vec(val, *args, "x")):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        _rational_vec(np.array([-1.0]), 100, 2**31 - 1, "neg")


@pytest.fixture(scope="module")
def s_stack():
    devc = _mk()
    d = devc.dev
    B = 12
    rng = np.random.default_rng(53)
    lanes = jnp.asarray(rng.integers(-100, 100, (B, d.n_dec), dtype=np.int32))

    def stack(x0_f, lanes):
        A_seq, B_lane, c_seq = d._linearize_phase(x0_f, lanes)
        return devc._stack_constraints(*d._propagate_unrolled(A_seq, B_lane, c_seq))

    S_t, _, _ = jax.jit(stack)(jnp.asarray(_x0(B, 54)), lanes)
    return devc, np.asarray(S_t)


@pytest.mark.parametrize("case", ["condensed", "past_old_fit"])
def test_pen_matches_jax_kernel(request, case):
    """On a real constraint stack, and at C = 260, Tm = 4 (past C 256, where
    the port's gate stopped before it took the reference's pen_viable)."""
    if case == "condensed":
        devc, S_t = request.getfixturevalue("s_stack")
        it = devc.dev.power_iters
    else:
        S_t = np.random.default_rng(59).standard_normal((260, 4, 3)).astype(np.float32)
        it = 16
    sqc_j, sqj_j, lip_j, ss_j, ra_j = j_pen(jnp.asarray(S_t), power_iters=it,
                                            block=5, interpret=True)
    sqc, sqj, lip, ss, ra = pen_fused(_t(S_t), power_iters=it)
    assert sqc.dtype == torch.int8 and sqc.shape == S_t.shape
    assert sqj.shape == (S_t.shape[1], S_t.shape[0], S_t.shape[2])
    np.testing.assert_array_equal(sqc.numpy(), np.asarray(sqc_j))
    np.testing.assert_array_equal(sqj.numpy(), np.asarray(sqj_j))
    np.testing.assert_array_equal(ss.numpy(), np.asarray(ss_j))
    np.testing.assert_allclose(ra.numpy(), np.asarray(ra_j), rtol=1e-6)
    np.testing.assert_allclose(lip.numpy(), np.asarray(lip_j), rtol=1e-4)


def test_pen_plain_is_the_cpu_route_and_rounds_half_to_even(s_stack):
    devc, S_t = s_stack
    for x, y in zip(pen_fused(_t(S_t), power_iters=3),
                    pen_plain(_t(S_t), power_iters=3)):
        assert torch.equal(x, y)
    # max |S| = 127 makes the scale exactly 1: .5 ties round half to even
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0], np.float32)
    S = np.stack([np.resize(vals, (2, 4)), np.resize(-vals[::-1], (2, 4))], -1)
    sqc_j = j_pen(jnp.asarray(S), power_iters=2, block=2, interpret=True)[0]
    sqc = pen_fused(_t(S), power_iters=2)[0]
    np.testing.assert_array_equal(sqc.numpy(), np.asarray(sqc_j))
    assert sorted(set(sqc.numpy().ravel().tolist())) == [
        -127, -126, -2, 0, 2, 126, 127]


def test_pen_rejects_bad_input():
    with pytest.raises(ValueError, match="float32"):
        pen_fused(torch.zeros((2, 4, 3), dtype=torch.float64), power_iters=1)
    with pytest.raises(ValueError, match="C, Tm, B"):
        pen_fused(torch.zeros((4, 3)), power_iters=1)
