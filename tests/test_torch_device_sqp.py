"""Port parity: DeviceSQP and its two kernels' modules (K3 lipq, K4 PGD
inner) against pint_tpu's, at horizon 32 (Tm = 64), small batches.

JAX's Pallas kernels run in interpret mode, as tests/test_fused_alm.py and
tests/test_condense_fused.py run them.  Tolerances:
* K4 inner given identical operands: bit-identical, against both JAX's
  ``pgd_fused_words_pre`` and the word-space ``_pgd_batched_h``;
* K3 on one shared ``Ht``: ``hqt`` and ``h_max`` bit-identical, ``lip``
  rtol 1e-5 (the norms are reduced in another order);
* the f32 condensation ``Ht``, ``g``: rtol 1e-5, atol 1e-4, the bound of
  tests/test_device_sqp.py's cross-path checks;
* full solves: cost parity, rtol 0.01, atol 1e-4 (tests/test_device_sqp.py),
  since last-ulp f32 differences can move an int8 rounding tie;
* the torch form of the reference's ``lipq=False`` phases: ``lip`` rtol 1e-5
  (the power iteration sums in the GEMM's order, not XLA's), the quantized
  operands bit-identical given JAX's own ``Ht``, ``g`` and ``lip``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu.mpc import QuantizedSQP
from pint_tpu.mpc.condense_fused import lipq_fused as j_lipq
from pint_tpu.mpc.condense_fused import pen_viable as j_pen_viable
from pint_tpu.mpc.fused_alm import pgd_fused_words_pre as j_pgd_pre
from pint_tpu.mpc.ltv import _pgd_batched_h as j_pgd_batched_h
from pint_tpu_torch.convert import device_sqp_config, words_from_numpy, words_to_numpy
from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc import (
    DeviceSQP,
    alm_fits,
    lipq_fits,
    lipq_fused,
    lipq_plain,
    pen_fits,
    pgd_fits,
    pgd_fused_words,
    pgd_fused_words_pre,
    pgd_fused_words_pre_plain,
    pgd_hqt,
    pgd_hqt_plain,
)
from pint_tpu_torch.mpc.ltv import _pgd_batched_h

KW = dict(
    horizon=32, sqp_iters=4, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)


def _x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(0, 1, B)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    ref = JDeviceSQP(propagate="unroll", **KW)
    return ref, device_sqp_config(ref, device="cpu")


@pytest.fixture(scope="module")
def operands(pair):
    """One real condensation's quantized operands (JAX, XLA epilogue) and a
    warm plan with -128 lanes."""
    ref, _ = pair
    B = 8
    rng = np.random.default_rng(21)
    x0 = _x0(B, 22)
    lanes = rng.integers(-128, 128, (B, ref.n_dec), dtype=np.int32)
    Hq, g_pre, hs_num, hs_den = jax.jit(ref._condense_dev)(
        jnp.asarray(x0), jnp.asarray(lanes))
    words = np.asarray(j_pack(jnp.asarray(lanes)))
    return dict(
        words=words, Hq=np.asarray(Hq), g_pre=np.asarray(g_pre),
        hs_num=np.asarray(hs_num), hs_den=np.asarray(hs_den),
        hqt=np.ascontiguousarray(np.transpose(np.asarray(Hq), (2, 1, 0))),
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pgd_inner_bit_identical(pair, operands):
    ref, _ = pair
    o = operands
    kw = dict(iters=ref.pgd_iters, g_shift=ref.g_shift)
    expect = np.asarray(j_pgd_pre(
        jnp.asarray(o["words"]), jnp.asarray(o["g_pre"]), jnp.asarray(o["hqt"]),
        jnp.asarray(o["hs_num"]), jnp.asarray(o["hs_den"]), interpret=True, **kw))
    expect_words = np.asarray(j_pgd_batched_h(
        jnp.asarray(o["words"]), jnp.asarray(o["g_pre"]), jnp.asarray(o["Hq"]),
        jnp.asarray(o["hs_num"]), jnp.asarray(o["hs_den"]), **kw))
    np.testing.assert_array_equal(expect, expect_words)
    w = words_from_numpy(o["words"], device="cpu")
    args = (_t(o["g_pre"]), _t(o["hqt"]), _t(o["hs_num"]), _t(o["hs_den"]))
    np.testing.assert_array_equal(
        words_to_numpy(pgd_fused_words_pre(w, *args, **kw)), expect)
    np.testing.assert_array_equal(
        words_to_numpy(pgd_fused_words(w, _t(o["g_pre"]), _t(o["Hq"]),
                                       *args[2:], **kw)), expect)
    np.testing.assert_array_equal(
        words_to_numpy(_pgd_batched_h(w, _t(o["g_pre"]), _t(o["Hq"]),
                                      *args[2:], **kw)), expect)


def test_pgd_hqt_rejects_bad_operands(operands):
    o = operands
    with pytest.raises(ValueError, match="int8"):
        pgd_hqt(torch.zeros((8, 64), dtype=torch.int32), _t(o["g_pre"]),
                _t(o["hqt"]).to(torch.int32), _t(o["hs_num"]), _t(o["hs_den"]),
                iters=1, g_shift=12)


def test_words_plain_is_lanes_plain_with_unpack_and_pack(pair, operands):
    """K4's words entry on the CPU (its plain version) equals the lanes plain
    version with unpack and pack around it, on warm words with -128 lanes."""
    ref, _ = pair
    o = operands
    kw = dict(iters=ref.pgd_iters, g_shift=ref.g_shift)
    w = words_from_numpy(o["words"], device="cpu")
    args = (_t(o["g_pre"]), _t(o["hqt"]), _t(o["hs_num"]), _t(o["hs_den"]))
    via_lanes = pack_controls(pgd_hqt_plain(unpack_controls(w), *args, **kw))
    got = pgd_fused_words_pre_plain(w, *args, **kw)
    assert torch.equal(got, via_lanes)
    assert torch.equal(pgd_fused_words_pre(w, *args, **kw), got)
    with pytest.raises(ValueError, match="do not agree"):
        pgd_fused_words_pre(unpack_controls(w), *args, **kw)


@pytest.fixture(scope="module")
def shared_ht(pair):
    ref, _ = pair
    rng = np.random.default_rng(31)
    B = 6
    lanes = rng.integers(-100, 100, (B, ref.n_dec), dtype=np.int32)
    Ht, g = jax.jit(ref._condense_ht)(jnp.asarray(_x0(B, 32)), jnp.asarray(lanes))
    return np.asarray(Ht)


def test_lipq_matches_jax_kernel(pair, shared_ht):
    ref, _ = pair
    hqt_j, lip_j, hmax_j = j_lipq(
        jnp.asarray(shared_ht), power_iters=ref.power_iters, block=8,
        interpret=True)
    hqt, lip, hmax = lipq_fused(_t(shared_ht), power_iters=ref.power_iters)
    assert hqt.dtype == torch.int8 and hqt.shape == shared_ht.shape
    np.testing.assert_array_equal(hmax.numpy(), np.asarray(hmax_j))
    np.testing.assert_array_equal(hqt.numpy(), np.asarray(hqt_j))
    np.testing.assert_allclose(lip.numpy(), np.asarray(lip_j), rtol=1e-5)


def test_lipq_rounds_half_to_even():
    """Exact .5 ties (h_max = 127, so the scale is exactly 1) round half to
    even, as jnp.round does in the reference kernel."""
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0], np.float32)
    Ht = np.stack([np.resize(vals, (4, 4)), np.resize(-vals[::-1], (4, 4))], -1)
    hqt_j, _, hmax_j = j_lipq(jnp.asarray(Ht), power_iters=2, block=2,
                              interpret=True)
    hqt, _, hmax = lipq_fused(_t(Ht), power_iters=2)
    np.testing.assert_array_equal(hmax.numpy(), np.asarray(hmax_j))
    np.testing.assert_array_equal(hqt.numpy(), np.asarray(hqt_j))
    assert sorted(set(hqt.numpy().ravel().tolist())) == [-127, -126, -2, 0, 2, 126, 127]


def test_lipq_plain_is_the_cpu_route(pair, shared_ht):
    ref, _ = pair
    a = lipq_fused(_t(shared_ht), power_iters=ref.power_iters)
    b = lipq_plain(_t(shared_ht), power_iters=ref.power_iters)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_condensation_matches(pair):
    ref, port = pair
    rng = np.random.default_rng(41)
    B = 8
    x0 = _x0(B, 42)
    lanes = rng.integers(-127, 128, (B, ref.n_dec), dtype=np.int32)
    Ht_j, g_j = jax.jit(ref._condense_ht)(jnp.asarray(x0), jnp.asarray(lanes))
    Ht, g = port._condense_ht(_t(x0), _t(lanes))
    assert Ht.shape == (ref.n_dec, ref.n_dec, B)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Ht_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-4)


def test_full_solve_cost_parity(pair):
    ref, port = pair
    x0 = np.concatenate(
        [np.array([[0.0, 0.0, 0.0], [-0.1, 0.05, 0.1], [0.05, -0.1, 0.9]]),
         _x0(5, 51)])
    host = QuantizedSQP(**KW)
    w_ref, _ = ref.solve(x0)
    w, plans = port.solve(x0)
    assert plans.shape == (8, 32, 2) and np.isfinite(plans).all()
    lanes = host.lanes(jnp.asarray(words_to_numpy(w)))
    cost = host.true_cost(x0, lanes)
    cost_ref = host.true_cost(x0, host.lanes(w_ref))
    np.testing.assert_allclose(cost, cost_ref, rtol=0.01, atol=1e-4)
    # the port's numpy cost helper is the reference's objective
    np.testing.assert_allclose(port.true_cost(x0, lanes), cost, rtol=1e-12)


def test_solve_deterministic_and_plain_route_equal(pair):
    _, port = pair
    x0 = _x0(4, 61)
    w1, _ = port.solve(x0)
    w2, _ = port.solve(x0)
    np.testing.assert_array_equal(w1.numpy(), w2.numpy())
    plain = device_sqp_config(pair[0], use_kernels=False, device="cpu")
    np.testing.assert_array_equal(plain.solve(x0)[0].numpy(), w1.numpy())


@pytest.mark.parametrize("kw, match", [
    (dict(propagate="scan"), "scan"),
    (dict(propagate="allpairs"), "allpairs"),
    (dict(reduce="einsum"), "einsum"),
    (dict(reduce="blocked"), "blocked"),
])
def test_unported_options_raise(kw, match):
    """These options raised NotImplementedError until the port took them;
    now each builds, and only a value that is no option raises (a
    ValueError naming the choices)."""
    (field, value), = kw.items()
    sqp = DeviceSQP(**KW, **kw, device="cpu")
    assert getattr(sqp, field) == value
    with pytest.raises(ValueError, match=match):
        DeviceSQP(**KW, **{field: value + "-x"}, device="cpu")


def test_h_scale_and_step_rationals_bit_identical(pair):
    """Given JAX's own ``alpha`` and ``h_max`` (from its K3 on a real
    condensation), the port's ``h_scale``, ``hs_num`` and ``hs_den`` equal
    the reference's jitted ``alpha * h_max / 127.0`` and step rationals bit
    for bit.  XLA compiles that division as a multiply by f32(1/127); on
    this seed an IEEE division differs from it in one problem."""
    from pint_tpu_torch.mpc.condense_fused import true_div

    ref, port = pair
    rng = np.random.default_rng(2)
    B = 16
    x0 = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                   rng.uniform(0, 1, B)], -1).astype(np.float32)
    lanes = rng.integers(-100, 100, (B, ref.n_dec), dtype=np.int32)
    Ht, _ = jax.jit(ref._condense_ht)(jnp.asarray(x0), jnp.asarray(lanes))
    _, lip, h_max = j_lipq(Ht, power_iters=ref.power_iters, block=8, interpret=True)

    @jax.jit
    def reference(lip, h_max):   # pint_tpu/mpc/device_sqp.py:797-800
        alpha = 1.0 / lip
        h_scale = alpha * h_max / 127.0
        return (alpha, h_scale, *ref._step_rationals(h_scale))

    alpha, *expect = (np.asarray(v) for v in reference(lip, h_max))
    got = port._lipq_rationals(_t(alpha), _t(h_max))
    for g, e in zip(got, expect):
        assert g.numpy().dtype == e.dtype
        np.testing.assert_array_equal(g.numpy(), e)
    ieee = true_div(_t(alpha) * _t(h_max), 127.0).numpy()
    assert (ieee != expect[0]).any()


@pytest.fixture(scope="module")
def jax_ht_g(pair):
    """JAX's own condensation (Ht, g) of one warm plan, and JAX's own
    ``_lipschitz_phase`` on it."""
    ref, _ = pair
    rng = np.random.default_rng(71)
    B = 8
    lanes = rng.integers(-100, 100, (B, ref.n_dec), dtype=np.int32)
    Ht, g = jax.jit(ref._condense_ht)(jnp.asarray(_x0(B, 72)), jnp.asarray(lanes))
    lip = jax.jit(ref._lipschitz_phase)(Ht)
    return np.asarray(Ht), np.asarray(g), np.asarray(lip)


def test_lipschitz_phase_matches_jax(pair, jax_ht_g):
    _, port = pair
    Ht, _, lip_j = jax_ht_g
    lip = port._lipschitz_phase(_t(Ht))
    assert lip.shape == lip_j.shape and lip.dtype == torch.float32
    np.testing.assert_allclose(lip.numpy(), lip_j, rtol=1e-5)


def test_quantize_phase_bit_identical(pair, jax_ht_g):
    """Given JAX's Ht, g and lip, the torch form's int8 Hessian (in the
    kernel orientation), linear term and step rationals equal the
    reference's jitted ``_quantize_phase`` bit for bit."""
    ref, port = pair
    Ht, g, lip = jax_ht_g
    Hq_j, *rest_j = (np.asarray(v) for v in jax.jit(ref._quantize_phase)(
        jnp.asarray(Ht), jnp.asarray(g), jnp.asarray(lip)))
    hqt, *rest = port._quantize_phase(_t(Ht), _t(g), _t(lip))
    assert hqt.dtype == torch.int8 and hqt.is_contiguous()
    np.testing.assert_array_equal(hqt.permute(2, 1, 0).numpy(), Hq_j)
    for a, b in zip(rest, rest_j):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_lipq_false_solve_cost_parity(pair):
    """``lipq=False`` runs the torch form into K4's plain version; JAX's
    default on the CPU is its ``lipq=False`` form into the XLA inner."""
    ref, _ = pair
    port = device_sqp_config(ref, lipq=False, device="cpu")
    assert port.forms == dict(chain="fused", condense="torch", inner="pgd_hqt")
    x0 = _x0(6, 73)
    w_ref, _ = ref.solve(x0)
    w, _ = port.solve(x0)
    lanes = unpack_controls(w)[:, : ref.n_dec].numpy()
    lanes_ref = unpack_controls(words_from_numpy(np.asarray(w_ref), device="cpu"))
    cost = port.true_cost(x0, lanes)
    cost_ref = port.true_cost(x0, lanes_ref[:, : ref.n_dec].numpy())
    np.testing.assert_allclose(cost, cost_ref, rtol=0.01, atol=1e-4)
    # the word-space inner and K4's plain version agree on the torch form
    plain = device_sqp_config(ref, lipq=False, use_kernels=False, device="cpu")
    np.testing.assert_array_equal(plain.solve(x0)[0].numpy(), w.numpy())


def test_converted_lipq_false_takes_the_torch_form():
    """``device_sqp_config`` copies ``lipq`` (and ``fused``): a reference
    ``DeviceSQP(lipq=False)`` converts to the torch form, not K3, and
    solves at cost parity with JAX's."""
    ref = JDeviceSQP(propagate="unroll", lipq=False, **KW)
    port = device_sqp_config(ref, device="cpu")
    assert port.lipq is False and port.fused is None
    assert port.forms == dict(chain="fused", condense="torch", inner="pgd_hqt")
    x0 = _x0(6, 77)
    w_ref, _ = ref.solve(x0)
    w, _ = port.solve(x0)
    lanes = unpack_controls(w)[:, : ref.n_dec].numpy()
    lanes_ref = unpack_controls(words_from_numpy(np.asarray(w_ref), device="cpu"))
    np.testing.assert_allclose(port.true_cost(x0, lanes),
                               port.true_cost(x0, lanes_ref[:, : ref.n_dec].numpy()),
                               rtol=0.01, atol=1e-4)
    for fused in (False, True):
        conv = device_sqp_config(JDeviceSQP(fused=fused, **KW), device="cpu")
        assert conv.fused is fused and conv.lipq is None


@pytest.mark.parametrize("fused", [None, True, False])
@pytest.mark.parametrize("horizon", [32, 316, 318])
def test_fused_selects_the_inner(horizon, fused):
    """``fused`` None or True: K4 where ``pgd_fits`` takes Tm (to 632,
    horizon 316), the word-space inner past it, as the reference's
    ``_use_fused`` returns False past ``pgd_viable``; False: the word-space
    inner at every horizon."""
    sqp = DeviceSQP(**dict(KW, horizon=horizon), fused=fused, device="cpu")
    kernel = fused is not False and horizon <= 316
    assert sqp.forms["inner"] == ("pgd_hqt" if kernel else "pgd_batched_h")
    assert sqp.forms["condense"] == ("lipq" if horizon <= 143 else "torch")


def test_fused_false_bit_identical_to_fused_none(pair):
    """``fused=False`` (the word-space ``_pgd_batched_h``) and the default
    (K4's plain version here) give the same words, in both condense
    forms."""
    ref, port = pair
    x0 = _x0(5, 79)
    for lipq in (None, False):
        base = device_sqp_config(ref, lipq=lipq, device="cpu")
        word = device_sqp_config(ref, lipq=lipq, fused=False, device="cpu")
        assert word.forms["inner"] == "pgd_batched_h"
        np.testing.assert_array_equal(word.solve(x0)[0].numpy(), base.solve(x0)[0].numpy())


def _long_horizon_parity(horizon, forms, seed):
    """One SQP iteration at ``horizon`` resolves to ``forms`` and is at cost
    parity with JAX's (scan propagation; on the CPU its lipq=False form and
    XLA inner)."""
    kw = dict(KW, horizon=horizon, sqp_iters=1)
    ref = JDeviceSQP(propagate="scan", **kw)
    port = device_sqp_config(ref, device="cpu")
    assert port.forms == forms
    x0 = _x0(2, seed)
    w_ref, _ = ref.solve(x0)
    w, plans = port.solve(x0)
    assert plans.shape == (2, horizon, 2) and np.isfinite(plans).all()
    lanes = unpack_controls(w)[:, : port.n_dec].numpy()
    lanes_ref = unpack_controls(words_from_numpy(np.asarray(w_ref), device="cpu"))
    np.testing.assert_allclose(
        port.true_cost(x0, lanes),
        port.true_cost(x0, lanes_ref[:, : port.n_dec].numpy()), rtol=0.01, atol=1e-4)


def test_long_horizon_solves_in_the_torch_form():
    """T = 144 (Tm = 288, past K3's fit, the reference's lipq_viable)
    takes the torch form and K4 (its plain version here)."""
    _long_horizon_parity(144, dict(chain="fused", condense="torch", inner="pgd_hqt"), 74)


def test_t128_solves_through_k3_and_k4():
    """T = 128 (Tm = 256, the reference's longest shipped horizon) takes
    K3 and K4, as the reference does on its chip."""
    _long_horizon_parity(128, dict(chain="fused", condense="lipq", inner="pgd_hqt"), 75)


@pytest.mark.parametrize("horizon, forms", [
    (32, ("lipq", "pgd_hqt")), (112, ("lipq", "pgd_hqt")),
    (114, ("lipq", "pgd_hqt")), (128, ("lipq", "pgd_hqt")),
    (130, ("lipq", "pgd_hqt")), (142, ("lipq", "pgd_hqt")),
    (144, ("torch", "pgd_hqt")), (316, ("torch", "pgd_hqt")),
    (318, ("torch", "pgd_batched_h")),
])
def test_forms_follow_the_gates(horizon, forms):
    """Each stage's form comes from the shapes at construction: K3 to Tm
    286 (horizon 143), K4 to Tp 632 (horizon 316), the reference's
    lipq_viable and pgd_viable."""
    sqp = DeviceSQP(**dict(KW, horizon=horizon), device="cpu")
    assert (sqp.forms["condense"], sqp.forms["inner"]) == forms
    assert DeviceSQP(**dict(KW, horizon=horizon), lipq=False,
                     device="cpu").forms["condense"] == "torch"


def test_fits_gates_at_their_boundaries():
    assert lipq_fits(286) and not lipq_fits(288) and not lipq_fits(0)
    assert pgd_fits(256) and pgd_fits(632) and not pgd_fits(636)
    assert not pgd_fits(254) and not pgd_fits(0)
    # alm_viable: Tp^2 + 2 Tp Cp + 8 (Tp + Cp) <= 409600
    assert alm_fits(256, 256) and alm_fits(260, 64) and alm_fits(64, 260)
    assert alm_fits(632, 4) and not alm_fits(632, 8)
    assert alm_fits(512, 136) and not alm_fits(512, 140)
    assert not alm_fits(64, 62) and alm_fits(4, 4096) and not alm_fits(4, 4100)
    # K6: the reference's pen_viable, C Tm <= 68266
    assert pen_fits(225, 256) and pen_fits(256, 256) and pen_fits(257, 8)
    assert pen_fits(261, 261) and not pen_fits(262, 261)
    assert pen_fits(1, 68266) and not pen_fits(1, 68267) and not pen_fits(0, 8)


@pytest.mark.parametrize("C, Tm", [
    (32, 64), (128, 256), (136, 272), (256, 256), (384, 128), (261, 261), (262, 261),
    (2048, 32), (4, 17066), (4, 17067), (68266, 1), (68267, 1), (130, 260), (1, 1)])
def test_pen_fits_is_the_reference_pen_viable(C, Tm):
    assert pen_fits(C, Tm) == j_pen_viable(C, Tm)


def test_indefinite_q_rejected_at_construction():
    with pytest.raises(ValueError, match="PSD"):
        DeviceSQP(horizon=8, Q=np.diag([1.0, -1.0, 0.1]), device="cpu")


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceSQP(**KW, device="cuda")

