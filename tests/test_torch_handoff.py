"""The problem-major handoff past 64 lanes, against ``pint_tpu`` on the CPU.

Past 64 lanes the port hands its long-form kernels (K3 past Tm 64, K4's and
K5's cluster kernel) their per-problem slabs problem-major: ``Ht`` is the
batch-first condensed Hessian's ``permute(1, 2, 0)`` view, K3 and the torch
phases write ``hqt`` as ``Hq.permute(2, 1, 0)`` of a batch-first ``Hq``, and
K6 hands over its batch-first int8 rows as views.  Only memory changes: each
view carries the same logical values, indices and bits as the contiguous
batch-last tensor it replaces.  These tests hold that at the first horizon
past 64 lanes (the unicycle at T = 34, Tm 68: the reference refuses T = 33,
whose 66 lanes do not pack 4 to a word) and a few past it, against
JAX's own condensation and kernels (Pallas in interpret mode), and hold the
plain versions of K3, K4 and K5 to the same bits on either order.  To 64
lanes everything stays batch-last and contiguous.  Tolerances: the f32
condensation to JAX's rtol 1e-5 (``tests/test_torch_device_sqp.py``'s); int8
and int32 results bit-identical; whole solves at cost parity (rtol 0.01,
atol 1e-4; violation atol 5e-3).
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
from pint_tpu.mpc.fused_alm import pgd_fused_words as j_pgd_fused_words
from pint_tpu_torch.convert import (device_constrained_config, device_sqp_config,
                                    words_from_numpy, words_to_numpy)
from pint_tpu_torch.models.dynamics import unpack_controls
from pint_tpu_torch.mpc import (lipq_fused, lipq_plain, pen_fused, pen_plain,
                                pgd_fused_words, pgd_fused_words_pre_plain, pgd_hqt_plain)
from pint_tpu_torch.mpc.constrained import RATIONALS
from pint_tpu_torch.mpc.device_constrained import _pad_rows
from pint_tpu_torch.mpc.fused_alm import alm_hqt_plain
from pint_tpu_torch.ops import kernels as K

KW = dict(
    sqp_iters=1, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)
CON_SQP = dict(sqp_iters=1, pgd_iters=30, x_ref=np.array([1.0, 0.0, 0.0]))
CON = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=3)


def _x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(0, 1, B)], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pm(x):
    """The batch-last (d0, d1, B) tensor ``x`` problem-major with rows
    along dim 0: the same logical values in another memory order."""
    return x.permute(2, 0, 1).contiguous().permute(1, 2, 0)


def _pm_hqt(x):
    """``hqt`` (Tp, Tp, B) problem-major with rows j (dim 1)."""
    return x.permute(2, 1, 0).contiguous().permute(2, 1, 0)


@pytest.mark.parametrize("horizon", [32, 34, 48])
@pytest.mark.parametrize("reduce", ["sym", "einsum", "blocked", "btrans"])
def test_reduce_hands_over_problem_major_past_64(horizon, reduce):
    """Every reduce form returns Ht as the problem-major view of its
    batch-first Hb past 64 lanes (T = 34, 48: Tm 68, 96) and a contiguous
    batch-last Ht to 64 (T = 32); either way Ht matches JAX's."""
    ref = JDeviceSQP(propagate="unroll", reduce=reduce, horizon=horizon, **KW)
    port = device_sqp_config(ref, device="cpu")
    B = 5
    rng = np.random.default_rng(horizon)
    x0 = _x0(B, horizon + 1)
    lanes = rng.integers(-127, 128, (B, ref.n_dec), dtype=np.int32)
    Ht_j, g_j = jax.jit(ref._condense_ht)(jnp.asarray(x0), jnp.asarray(lanes))
    Ht, g = port._condense_ht(_t(x0), _t(lanes))
    long = port.n_dec > K.LONG_LANES
    assert K.problem_major(Ht, 0) == long and Ht.is_contiguous() != long
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Ht_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-4)
    # the view and the batch-last copy the parent made carry the same bits
    np.testing.assert_array_equal(Ht.numpy(), Ht.contiguous().numpy())


@pytest.mark.parametrize("C, Tm", [(33, 66), (66, 20), (8, 100), (64, 64), (40, 40)])
def test_pen_plain_hands_over_problem_major_rows(C, Tm):
    """K6's plain version hands sqc and sqj over problem-major past 64 rows
    or columns and batch-last to them, with JAX's values either way."""
    S_t = np.random.default_rng(C + Tm).standard_normal((C, Tm, 5)).astype(np.float32)
    sqc_j, sqj_j, lip_j, ss_j, ra_j = j_pen(jnp.asarray(S_t), power_iters=4, block=5,
                                            interpret=True)
    for pen in (pen_fused, pen_plain):
        sqc, sqj, lip, ss, ra = pen(_t(S_t), power_iters=4)
        long = max(C, Tm) > K.LONG_LANES
        assert K.problem_major(sqc, 0) == long and K.problem_major(sqj, 0) == long
        assert sqc.is_contiguous() != long and sqj.is_contiguous() != long
        np.testing.assert_array_equal(sqc.numpy(), np.asarray(sqc_j))
        np.testing.assert_array_equal(sqj.numpy(), np.asarray(sqj_j))
        np.testing.assert_array_equal(ss.numpy(), np.asarray(ss_j))
        np.testing.assert_allclose(ra.numpy(), np.asarray(ra_j), rtol=1e-6)
        np.testing.assert_allclose(lip.numpy(), np.asarray(lip_j), rtol=1e-4)


@pytest.mark.parametrize("Tp", [64, 68, 100])
def test_pgd_fused_words_hands_over_a_view(Tp):
    """pgd_fused_words hands K4 Hq's problem-major view past 64 lanes (no
    transpose copy): words bit-identical to JAX's pgd_fused_words."""
    rng = np.random.default_rng(Tp)
    B = 6
    lanes = rng.integers(-127, 128, (B, Tp), dtype=np.int32)
    g_pre = rng.integers(-2**18, 2**18, (B, Tp), dtype=np.int32)
    Hq = rng.integers(-127, 128, (B, Tp, Tp), dtype=np.int8)
    hs_num = rng.integers(1, 300, (B,), dtype=np.int32)
    hs_den = rng.integers(10, 16, (B,), dtype=np.int32)
    words = np.asarray(j_pack(jnp.asarray(lanes)))
    want = j_pgd_fused_words(jnp.asarray(words), jnp.asarray(g_pre), jnp.asarray(Hq),
                             jnp.asarray(hs_num), jnp.asarray(hs_den), iters=12,
                             g_shift=12, interpret=True)
    got = pgd_fused_words(words_from_numpy(words, device="cpu"), _t(g_pre), _t(Hq),
                          _t(hs_num), _t(hs_den), iters=12, g_shift=12)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("Tm, B", [(66, 3), (100, 5), (256, 2)])
def test_lipq_plain_same_bits_on_either_order(Tm, B):
    """K3's plain version: the same hqt, lip and h_max bits on Ht
    problem-major and on its batch-last copy; past 64 rows hqt comes
    problem-major with rows j, as K3 writes it."""
    Ht = torch.randn((B, Tm, Tm), generator=torch.Generator().manual_seed(Tm)).permute(1, 2, 0)
    a = lipq_plain(Ht, power_iters=6)
    b = lipq_plain(Ht.contiguous(), power_iters=6)
    assert K.problem_major(a[0], 1) and K.problem_major(b[0], 1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(lipq_fused(Ht, power_iters=6), a):
        assert torch.equal(x, y)


def _k5_operands(B, Tp, Cp, seed):
    rng = np.random.default_rng(seed)
    sq = rng.integers(-127, 128, (Cp, Tp, B), dtype=np.int8)
    sc = np.stack([rng.integers(1, 300, B), rng.integers(10, 16, B),
                   rng.integers(1, 300, B), rng.integers(10, 16, B),
                   rng.integers(1, 300, B), rng.integers(8, 14, B),
                   rng.integers(1, 300, B), rng.integers(8, 14, B)]).astype(np.int32)
    return [_t(rng.integers(-128, 128, (B, Tp), dtype=np.int32)),
            _t(rng.integers(-2**16, 2**16, (B, Tp), dtype=np.int32)),
            _t(rng.integers(-127, 128, (Tp, Tp, B), dtype=np.int8)),
            _t(np.ascontiguousarray(sq.transpose(1, 0, 2))), _t(sq),
            _t(rng.integers(-3000, 3000, (B, Cp), dtype=np.int32)),
            _t(rng.integers(-2000, -100, (B, Cp), dtype=np.int32)),
            _t(rng.integers(100, 2000, (B, Cp), dtype=np.int32)),
            _t(rng.integers(0, 500, (B, Cp), dtype=np.int32)), _t(sc)]


@pytest.mark.parametrize("Tp, Cp", [(68, 36), (100, 68), (16, 80)])
def test_k4_k5_plain_same_bits_on_either_order(Tp, Cp):
    """K4's and K5's plain versions give the same lanes, words and
    multipliers on problem-major slabs as on batch-last ones."""
    args = _k5_operands(4, Tp, Cp, Tp + Cp)
    pm = list(args)
    pm[2], pm[3], pm[4] = _pm_hqt(args[2]), _pm(args[3]), _pm(args[4])
    assert K.problem_major(pm[2], 1) and K.problem_major(pm[4], 0)
    kw = dict(outer=2, inners=6, g_shift=12, y_shift=9)
    for x, y in zip(alm_hqt_plain(*args, **kw), alm_hqt_plain(*pm, **kw)):
        assert torch.equal(x, y)
    lanes, g_pre, hqt = args[:3]
    hs_num, hs_den = args[9][0], args[9][1]
    pk = dict(iters=10, g_shift=12)
    assert torch.equal(pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **pk),
                       pgd_hqt_plain(lanes, g_pre, pm[2], hs_num, hs_den, **pk))
    words = torch.as_tensor(lanes.clamp(-127, 127).to(torch.int8).numpy().view(np.int32))
    assert torch.equal(pgd_fused_words_pre_plain(words, g_pre, hqt, hs_num, hs_den, **pk),
                       pgd_fused_words_pre_plain(words, g_pre, pm[2], hs_num, hs_den, **pk))


@pytest.mark.parametrize("dim", [0, 1])
def test_pad_rows_keeps_the_order(dim):
    """The constraint rows' zero padding to Cp keeps each order and pads
    nothing when there is nothing to pad (no copy)."""
    x = torch.randint(-127, 128, (6, 5, 3), dtype=torch.int8)
    for src in (x, _pm(x)):
        same = _pad_rows(src, dim, src.shape[dim])
        assert same is src
        out = _pad_rows(src, dim, 8)
        assert out.shape[dim] == 8
        assert out.is_contiguous() == src.is_contiguous()
        assert K.problem_major(out, 0) == K.problem_major(src, 0)
        n = 8 - x.shape[dim]
        want = torch.nn.functional.pad(x, [0, 0, 0, 0, 0, n] if dim == 0 else [0, 0, 0, n])
        assert torch.equal(out, want)


@pytest.mark.parametrize("horizon", [34, 40])
def test_device_sqp_past_64_lanes_at_parity(horizon):
    """A DeviceSQP solve past 64 lanes goes through K3's and K4's plain
    versions on the problem-major handoff at cost parity with JAX (its CPU
    default: the lipq=False form and XLA inner), and gives the same words
    as the torch form fed the same handoff."""
    ref = JDeviceSQP(propagate="scan", horizon=horizon, **dict(KW, sqp_iters=2))
    port = device_sqp_config(ref, device="cpu")
    assert port.forms == dict(chain="fused", reduce="kernel", condense="lipq", inner="pgd_hqt")
    x0 = _x0(3, horizon)
    w_ref, _ = ref.solve(x0)
    w, _ = port.solve(x0)
    lanes = unpack_controls(w)[:, : port.n_dec].numpy()
    lanes_ref = unpack_controls(words_from_numpy(np.asarray(w_ref), device="cpu"))
    np.testing.assert_allclose(
        port.true_cost(x0, lanes),
        port.true_cost(x0, lanes_ref[:, : port.n_dec].numpy()), rtol=0.01, atol=1e-4)
    hqt, g_pre, _, _ = port._condense(_t(x0), unpack_controls(w)[:, : port.n_dec])
    assert K.problem_major(hqt, 1)


@pytest.mark.parametrize("horizon", [34, 40])
def test_device_constrained_past_64_lanes_at_parity(horizon):
    """A DeviceConstrainedSQP solve past 64 lanes through K3, K6 and K5's
    plain versions on problem-major slabs: cost and violation parity with
    JAX, and the operands K5 gets are problem-major with JAX's values."""
    ref = JDeviceConstrainedSQP(JDeviceSQP(horizon=horizon, **CON_SQP), **CON)
    port = device_constrained_config(ref, device="cpu")
    d = port.dev
    assert port.forms == dict(chain="fused", reduce="kernel", stack="kernel",
                              condense="lipq", constraints="pen", inner="alm")
    x0 = np.stack([np.linspace(-0.1, 0.1, 3), np.linspace(-0.02, 0.02, 3),
                   np.linspace(-1, 1, 3)], -1).astype(np.float32)
    w_ref, lam_ref, _ = ref.solve(x0)
    w, lam, _ = port.solve(x0)
    lanes = unpack_controls(w)[:, : d.n_dec].numpy()
    lanes_ref = unpack_controls(words_from_numpy(np.asarray(w_ref), device="cpu"))
    lanes_ref = lanes_ref[:, : d.n_dec].numpy()
    np.testing.assert_allclose(d.true_cost(x0, lanes), d.true_cost(x0, lanes_ref),
                               rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(port.violation(x0, lanes), port.violation(x0, lanes_ref),
                               atol=5e-3)
    ops, _ = port._condense_constrained_dev(_t(x0), _t(lanes))
    assert K.problem_major(ops["hqt"], 1)
    assert K.problem_major(ops["sqc"], 0) and K.problem_major(ops["sqj"], 0)
    sc = torch.stack([ops[k] for k in RATIONALS])
    kw = dict(outer=port.alm_outer, inners=d.pgd_iters, g_shift=d.g_shift, y_shift=9)
    zero = torch.zeros((3, d.n_dec), dtype=torch.int32)
    lam0 = torch.zeros((3, port.padded_rows), dtype=torch.int32)
    view = alm_hqt_plain(zero, ops["g_pre"], ops["hqt"], ops["sqj"], ops["sqc"],
                         ops["c_off"], ops["lo_pre"], ops["hi_pre"], lam0, sc, **kw)
    flat = alm_hqt_plain(zero, ops["g_pre"], ops["hqt"].contiguous(),
                         ops["sqj"].contiguous(), ops["sqc"].contiguous(), ops["c_off"],
                         ops["lo_pre"], ops["hi_pre"], lam0, sc, **kw)
    for x, y in zip(view, flat):
        assert torch.equal(x, y)
