"""The port's CUDA kernels (K1, K9, K8, K11a-c, K2, K2p, K3, K4, K5, K6, K7,
K10) against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel has
no CPU mode).  This file imports neither jax nor pint_tpu, so it runs on a
machine without JAX; there, skip the JAX-only conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the SWAR kernels bit-identical on full-range random words (not
only canonical ones); K2 and K4 (lanes and words entries) bit-identical; K3
``hqt``, ``h_max`` and ``lip`` bit-identical (the plain version adds in the kernel's order; ``lip`` is
also held to the contract's rtol 1e-5 first); K5 and K7 bit-identical
(words and multipliers) to their plain versions and word-space references;
K6 bit-identical on every output (``pen_lip``, ``row_amp`` also held to
rtol 1e-5 first; NaN where the plain version has NaN); K10 and K2p
bit-identical (K10 with int32-extreme lanes against an int64 product
wrapped modulo 2^32, which the plain version's float64 product does not
reproduce; K2p also to K2 with its unpack and pack); K2, K2p and K7 past
256 lanes (the wide forms) bit-identical, and raising past 4096; whole
DeviceSQP and DeviceConstrainedSQP solves (T = 32; T = 128, and 136,
through K3 and K6; T = 144, past K3's fit; the quadrotor and the pendulum;
every condensation form), kernels against plain versions, cost parity rtol
0.01, atol 1e-4 (violation atol 5e-3); ConstrainedController on the card
bit-identical to the CPU's loop.  Each
shape gate (``lipq_fits``, ``pen_fits``, ``pgd_fits``, ``alm_fits``) is true
exactly where its kernel's C entry accepts the shape.
"""

import functools

import numpy as np
import pytest
import torch

import pint_tpu_torch as pt
from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.mpc import (
    DeviceSQP,
    FusedPGD,
    condense_double_integrator,
    fused_pgd,
    fused_pgd_plain,
    lipq_fused,
    lipq_plain,
    pgd_hqt,
    pgd_hqt_plain,
    quantize,
)
from pint_tpu_torch.mpc.condense_fused import true_div
from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import swar as S
from pint_tpu_torch.ops import word as W
from pint_tpu_torch.ops.split64 import split_u64

pytestmark = pytest.mark.cuda

SQP_KW = dict(
    horizon=32, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(0, 1, B)], -1).astype(np.float32)


# K2 and K2p: B across the tile of 16 problems and the grid; Tp at each
# padded width W = 32, 64, 128, 256 and at Tp = 52 (zero B-fragment rows and
# columns past Tp inside W = 64)
K2_BATCHES = [1, 15, 16, 17, 1000, 8192, 8193]
K2_SHAPES = [(20, 32), (50, 4), (50, 64), (100, 64), (200, 64)]  # (T, pad_to): Tp 32, 52, 64, 128, 256
K2_ITERS = [0, 1, 15, 40]


def _k2_operands(cuda, B, T, pad_to, g_kind, seed):
    """qqp, full-range warm lanes (so -128 lanes occur) and g: the QP's own
    linear terms, or values within 2^20 of int32's extremes, so that
    -(pre + g) + half wraps."""
    qqp = quantize(condense_double_integrator(T=T), pad_to=pad_to)
    rng = np.random.default_rng(seed)
    lanes = rng.integers(-128, 128, (B, qqp.padded), dtype=np.int32)
    if g_kind == "real":
        g = qqp.g_lane_fixed(np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], -1))
    else:
        edge = rng.integers(0, 1 << 20, (B, qqp.padded), dtype=np.int64)
        g = np.where(rng.integers(0, 2, (B, qqp.padded)) == 1, 2**31 - 1 - edge,
                     -2**31 + edge).astype(np.int32)
        g[:, qqp.horizon:] = 0  # padded lanes carry g = 0, as g_lane_fixed's
    return (qqp, torch.as_tensor(lanes, device=cuda), torch.as_tensor(g, device=cuda),
            torch.as_tensor(qqp.Hq, device=cuda))


@pytest.mark.parametrize("g_kind", ["real", "extreme"])
@pytest.mark.parametrize("iters", K2_ITERS)
@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("B", K2_BATCHES)
@pytest.mark.parametrize("T, pad_to", K2_SHAPES)
def test_k2_bit_identical(cuda, momentum, B, T, pad_to, iters, g_kind):
    qqp, lanes, g, hq = _k2_operands(cuda, B, T, pad_to, g_kind, 12 + B)
    kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift,
              iters=iters, momentum=momentum, beta_num=FusedPGD(qqp).beta_num)
    before = K.launch_counts()["fused_pgd"]
    got = fused_pgd(lanes, g, hq, **kw)
    assert K.launch_counts()["fused_pgd"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused_pgd_plain(lanes, g, hq, **kw))


@pytest.fixture(scope="module", params=[32, 16, 40, 64], ids=lambda h: f"T{h}")
def condensed(cuda, request):
    sqp = DeviceSQP(sqp_iters=1, device=cuda, **dict(SQP_KW, horizon=request.param))
    B = 37
    rng = np.random.default_rng(13)
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, sqp.n_dec), dtype=np.int32),
                            device=cuda)
    Ht, g = sqp._condense_ht(torch.as_tensor(_x0(B, 14), device=cuda), lanes)
    return sqp, lanes, Ht, g


def test_k3_matches_plain(condensed):
    sqp, _, Ht, _ = condensed
    hqt, lip, hmax = lipq_fused(Ht, power_iters=sqp.power_iters)
    hqt_p, lip_p, hmax_p = lipq_plain(Ht, power_iters=sqp.power_iters)
    torch.cuda.synchronize()
    assert torch.equal(hqt, hqt_p) and torch.equal(hmax, hmax_p)
    np.testing.assert_allclose(lip.cpu().numpy(), lip_p.cpu().numpy(), rtol=1e-5)
    # the plain version reduces in the kernel's order: lip matches bit for bit
    assert torch.equal(lip, lip_p)


def test_k3_rounds_half_to_even(cuda):
    """Exact .5 ties (h_max = 127, scale exactly 1): rintf, not roundf."""
    vals = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0], np.float32)
    Ht = np.stack([np.resize(vals, (4, 4)), np.resize(-vals[::-1], (4, 4))], -1)
    ht = torch.as_tensor(Ht, device=cuda)
    hqt, _, _ = lipq_fused(ht, power_iters=2)
    assert torch.equal(hqt, lipq_plain(ht, power_iters=2)[0])
    assert sorted(set(hqt.cpu().numpy().ravel().tolist())) == [
        -127, -126, -2, 0, 2, 126, 127]


def test_k4_bit_identical(condensed):
    sqp, lanes, Ht, g = condensed
    hqt, lip, hmax = lipq_plain(Ht, power_iters=sqp.power_iters)
    alpha = true_div(1.0, lip)
    g_pre = sqp._g_pre_from(g, alpha)
    hs_num, hs_den = sqp._step_rationals(true_div(alpha * hmax, 127.0))
    kw = dict(iters=30, g_shift=sqp.g_shift)
    got = pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw))


@pytest.mark.parametrize("Tm", [16, 32, 48, 64, 66, 80, 100, 128, 160, 224, 228, 256,
                                286])
@pytest.mark.parametrize("B", [37, 4096, 4099, 4100])
def test_k3_bit_identical_at_every_path(cuda, B, Tm):
    """K3 against lipq_plain on random slabs.  Tm <= 64, the register
    kernel (16, 32, 48: the ones built for any Tm; 48 takes six boxes):
    B = 4096 takes TMA boxes and 16-byte stores, B = 4100 TMA boxes past the
    batch (zero-filled) and byte stores, B = 37 and 4099 the ragged 4-byte
    copies and byte stores.  Past Tm = 64 the long form on problem-major
    slabs, one problem a group of warps: a ring of 5 slots with 4 groups
    (66, 80), 4 slots (100), 3 (128), 2 (160) and 1 (224); past 224 one
    slot holds the first rows and registers the rest (228, 256, 286: 36 to
    94 rows in registers)."""
    gen = torch.Generator(device=cuda).manual_seed(B + Tm)
    if Tm > K.LONG_LANES:
        Ht = torch.randn((B, Tm, Tm), generator=gen, device=cuda).permute(1, 2, 0)
    else:
        Ht = torch.randn((Tm, Tm, B), generator=gen, device=cuda)
    got = lipq_fused(Ht, power_iters=16)
    ref = lipq_plain(Ht, power_iters=16)
    torch.cuda.synchronize()
    for name, a, b in zip(("hqt", "lip", "h_max"), got, ref):
        assert torch.equal(a, b), name


def _k4_operands(cuda, B, Tp, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=cuda)

    return (t(rng.integers(-128, 128, (B, Tp), dtype=np.int32)),
            t(rng.integers(-2**18, 2**18, (B, Tp), dtype=np.int32)),
            t(rng.integers(-127, 128, (Tp, Tp, B), dtype=np.int8)),
            t(rng.integers(1, 300, (B,), dtype=np.int32)),
            t(rng.integers(10, 16, (B,), dtype=np.int32)))


@pytest.mark.parametrize("Tp", [32, 64, 256])
@pytest.mark.parametrize("B", [37, 4096])
def test_k4_words_and_lanes_bit_identical(cuda, B, Tp):
    """K4's lanes entry and its words entry against their plain versions and
    against each other, full-range warm lanes (so -128 occurs): rows in
    registers (32, 64) and the cluster kernel (256)."""
    from pint_tpu_torch.mpc import pgd_fused_words_pre, pgd_fused_words_pre_plain

    lanes, g_pre, hqt, hs_num, hs_den = _k4_operands(cuda, B, Tp, B + Tp)
    kw = dict(iters=30, g_shift=12)
    got_lanes = pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    words = pack_controls(lanes)
    got_words = pgd_fused_words_pre(words, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_lanes, pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw))
    assert torch.equal(got_words,
                       pgd_fused_words_pre_plain(words, g_pre, hqt, hs_num, hs_den, **kw))
    assert torch.equal(got_words, pack_controls(got_lanes))


@pytest.mark.parametrize("B, Tp", [(37, 100), (4096, 288), (37, 512), (1000, 632)])
def test_k4_cluster_kernel_bit_identical(cuda, B, Tp):
    """Past 64 lanes K4 runs alm.cu's cluster kernel: one block a problem
    to Tp = 464, a cluster of two past it (512, 632: the reference's
    pgd_viable limit); both entries against their plain versions."""
    from pint_tpu_torch.mpc import pgd_fused_words_pre, pgd_fused_words_pre_plain

    lanes, g_pre, hqt, hs_num, hs_den = _k4_operands(cuda, B, Tp, B + Tp)
    kw = dict(iters=20, g_shift=12)
    got_lanes = pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    words = pack_controls(lanes)
    got_words = pgd_fused_words_pre(words, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_lanes, pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw))
    assert torch.equal(got_words,
                       pgd_fused_words_pre_plain(words, g_pre, hqt, hs_num, hs_den, **kw))


def test_k4_words_entry_is_one_launch(cuda):
    """The words entry launches K4 once, counted as pgd_hqt, and the device
    runs nothing else for it: no unpack or pack around the kernel."""
    from pint_tpu_torch.mpc import pgd_fused_words_pre

    lanes, g_pre, hqt, hs_num, hs_den = _k4_operands(cuda, 4096, 64, 7)
    words = pack_controls(lanes)
    kw = dict(iters=30, g_shift=12)
    pgd_fused_words_pre(words, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    before = K.launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pgd_fused_words_pre(words, g_pre, hqt, hs_num, hs_den, **kw)
        torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["pgd_hqt"] == before["pgd_hqt"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    ran = [e.key for e in prof.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0]
    assert len(ran) == 1 and "pgd_hqt" in ran[0], ran

def test_launch_counts(cuda):
    qqp = quantize(condense_double_integrator(T=50))
    solver = FusedPGD(qqp, iters=3, device=cuda)
    g = torch.zeros((4, 64), dtype=torch.int32, device=cuda)
    before = K.launch_counts()["fused_pgd"]
    solver.solve_words(solver.init_words(4), g)
    assert K.launch_counts()["fused_pgd"] == before + 1


def test_wrappers_refuse_mixed_devices(cuda):
    qqp = quantize(condense_double_integrator(T=50))
    with pytest.raises(ValueError):
        fused_pgd(torch.zeros((4, 64), dtype=torch.int32, device=cuda),
                  torch.zeros((4, 64), dtype=torch.int32),
                  torch.as_tensor(qqp.Hq, device=cuda),
                  hs_num=1, hs_den=0, g_shift=12, iters=1)


def test_device_sqp_kernels_cost_parity(cuda):
    kern = DeviceSQP(sqp_iters=4, device=cuda, **SQP_KW)
    plain = DeviceSQP(sqp_iters=4, device=cuda, use_kernels=False, **SQP_KW)
    x0 = _x0(64, 15)
    costs = []
    for sqp in (kern, plain):
        w = sqp.solve_words(sqp.init_words(64), torch.as_tensor(x0, device=cuda))
        costs.append(sqp.true_cost(x0, unpack_controls(w).cpu().numpy()))
    np.testing.assert_allclose(costs[0], costs[1], rtol=0.01, atol=1e-4)


# -- SWAR kernels (csrc/swar.cu) ---------------------------------------------

SWAR_LAYOUTS = [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (5, 6, 5), (3, 3),
                (8,) * 8, (20, 20, 24)]
U64_LAYOUTS = [(8,) * 8, (20, 20, 24), (7, 7, 9, 9, 11, 12), (33,)]


def _words(layout, shape, seed, device):
    """Full-range random words: every bit pattern, canonical or not."""
    g = torch.Generator().manual_seed(seed)
    info = torch.iinfo(W.container_dtype(layout))
    high = info.max + 1 if info.bits < 64 else info.max   # randint's high is int64
    w = torch.randint(info.min, high, shape, generator=g, dtype=torch.int64)
    return w.to(W.container_dtype(layout)).to(device)


@pytest.mark.parametrize("op", S.BINOP_NAMES)
@pytest.mark.parametrize("widths", SWAR_LAYOUTS, ids=str)
def test_swar_binop_bit_identical(cuda, widths, op):
    lay = PackedLayout(*widths)
    a, b = _words(lay, (4099,), 1, cuda), _words(lay, (4099,), 2, cuda)
    got = S.binop(lay, op)(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, S.binop_plain(lay, op, a, b))


@pytest.mark.parametrize("op", S.BINOP_NAMES)
@pytest.mark.parametrize("widths", U64_LAYOUTS, ids=str)
def test_swar_binop_pair_bit_identical(cuda, widths, op):
    lay = PackedLayout(*widths)
    a = split_u64(_words(lay, (3, 1001), 3, cuda))
    b = split_u64(_words(lay, (3, 1001), 4, cuda))
    got = S.binop_pair(lay, op)(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, S.binop_plain(lay, op, a, b, pair=True))


@pytest.mark.parametrize("amount", [0, 1, 3, 7, 12, 33, 100, -1, -8, 2**31, 2**32 + 1])
@pytest.mark.parametrize("op", S.SHIFT_NAMES)
@pytest.mark.parametrize("widths", SWAR_LAYOUTS, ids=str)
def test_swar_shift_bit_identical(cuda, widths, op, amount):
    lay = PackedLayout(*widths)
    v = _words(lay, (2053,), 5, cuda)
    ref = S.shift_plain(lay, op, v, amount)
    fn = S.shift(lay, op)
    for amt in (amount, torch.tensor(amount, device=cuda),
                torch.tensor(amount, dtype=torch.int64)):
        got = fn(v, amt)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    if lay.word_bits == 64:
        pair = split_u64(v)
        got = S.shift_pair(lay, op)(pair, amount)
        torch.cuda.synchronize()
        assert torch.equal(got, S.shift_plain(lay, op, pair, amount, pair=True))


@pytest.mark.parametrize("steps", [0, 1, 4])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("widths", SWAR_LAYOUTS, ids=str)
def test_swar_sat_accum_bit_identical(cuda, widths, signed, steps):
    lay = PackedLayout(*widths)
    acc = _words(lay, (37, 29), 6, cuda)
    deltas = _words(lay, (steps, 37, 29), 7, cuda)
    fn = S.saturating_accumulate(lay, signed=signed, steps=steps)
    got = fn(acc, deltas)
    torch.cuda.synchronize()
    assert torch.equal(got, S.sat_accum_plain(lay, signed, acc, deltas))
    if lay.word_bits == 64:
        pa, pd = split_u64(acc), split_u64(deltas)   # (2, ...), (2, steps, ...)
        got = fn(pa, pd)
        torch.cuda.synchronize()
        assert torch.equal(got, S.sat_accum_plain(lay, signed, pa, pd))


def test_swar_cuda_words_launch_their_kernels(cuda):
    """No fallback: each entry on CUDA words adds one to its kernel's count."""
    lay, lay64 = PackedLayout(8, 8, 8, 8), PackedLayout(20, 20, 24)
    x, x64 = _words(lay, (100,), 8, cuda), _words(lay64, (100,), 9, cuda)
    p = split_u64(x64)
    calls = {
        "swar_binop": lambda: S.binop(lay, "add_wrap")(x, x),
        "swar_shift": lambda: S.shift(lay, "shift_left")(x, 1),
        "swar_sat_accum": lambda: S.saturating_accumulate(lay, steps=2)(
            x, torch.stack([x, x])),
        "swar_binop_pair": lambda: S.binop_pair(lay64, "min_signed")(p, p),
        "swar_shift_pair": lambda: S.shift_pair(lay64, "shift_right_unsigned")(p, 3),
        "swar_sat_accum_pair": lambda: S.saturating_accumulate(lay64, steps=1)(
            p, p[:, None]),
    }
    for name, call in calls.items():
        before = K.launch_counts()
        call()
        after = K.launch_counts()
        assert after[name] == before[name] + 1, name
        assert sum(after.values()) == sum(before.values()) + 1, name
    before = K.launch_counts()
    S.binop(lay, "add_wrap")(x[:0], x[:0])          # empty: nothing to launch
    assert K.launch_counts() == before


def test_swar_shapes_on_card(cuda):
    """0-d, empty and non-contiguous words; an amount on the card."""
    lay = PackedLayout(8, 8, 8, 8)
    x = _words(lay, (64, 48), 10, cuda)
    t = x.t()                                        # non-contiguous
    got = S.binop(lay, "max_signed")(t, t.flip(0))
    assert got.shape == t.shape
    assert torch.equal(got, S.binop_plain(lay, "max_signed", t, t.flip(0)))
    s = x[3, 4]
    assert torch.equal(S.shift(lay, "shift_left")(s, torch.tensor(5, device=cuda)),
                       S.shift_plain(lay, "shift_left", s, 5))
    assert S.binop(lay, "add_wrap")(x[:, :0], x[:, :0]).shape == (64, 0)


def test_packed_array_on_card(cuda):
    """The PackedArray flow on CUDA equals the same flow on the CPU."""
    lay = PackedLayout(5, 6, 5)
    rng = np.random.default_rng(11)
    lanes = rng.integers(-64, 64, (1000, 3))
    out = []
    for dev in ("cpu", cuda):
        a = pt.PackedArray.pack(lay, torch.as_tensor(lanes), device=dev)
        b = pt.shift_left(a, 1)
        c = pt.max_signed(pt.add_signed_saturate(a, b), pt.sub_unsigned_saturate(b, a))
        out.append(pt.slice_lanes(pt.shift_right_unsigned(c, 2), 1, 3).lanes().cpu())
    assert torch.equal(out[0], out[1])


# -- the constrained tier: K5 and K6 (csrc/alm.cu, csrc/pen.cu), K7 ------------

CON = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0)


def _con_x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(-np.pi, np.pi, B)], -1).astype(np.float32)


@pytest.fixture(scope="module", params=[32, 50, 8], ids=lambda h: f"T{h}")
def con_condensed(cuda, request):
    """One real DeviceConstrainedSQP condensation: T=32 (Tm=Cp=64, C=32),
    T=50 (Tm=100, C=50, Cp=64), T=8 (Tm=16, C=8, Cp=64); B=37."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    csqp = DeviceConstrainedSQP(
        DeviceSQP(horizon=request.param, sqp_iters=1, pgd_iters=30,
                  x_ref=np.array([1.0, 0.0, 0.0]), device=cuda), **CON)
    B = 37
    rng = np.random.default_rng(16)
    x0 = torch.as_tensor(_con_x0(B, 17), device=cuda)
    lanes = torch.as_tensor(
        rng.integers(-100, 100, (B, csqp.dev.n_dec), dtype=np.int32), device=cuda)
    d = csqp.dev
    A, Bl, c = d._linearize_phase(x0, lanes)
    S_t, _, _ = csqp._stack_constraints(*d._propagate_unrolled(A, Bl, c))
    ops, _ = csqp._condense_constrained_dev(x0, lanes)
    return csqp, S_t, ops


def test_k6_bit_identical(con_condensed):
    from pint_tpu_torch.mpc import pen_fused, pen_plain

    csqp, S_t, _ = con_condensed
    got = pen_fused(S_t, power_iters=csqp.dev.power_iters)
    ref = pen_plain(S_t, power_iters=csqp.dev.power_iters)
    torch.cuda.synchronize()
    for i in (2, 4):
        np.testing.assert_allclose(got[i].cpu().numpy(), ref[i].cpu().numpy(),
                                   rtol=1e-5)
    for name, a, b in zip(("sqc", "sqj", "pen_lip", "s_scale", "row_amp"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("C, Tm", [(8, 100), (100, 66), (128, 256), (224, 256),
                                   (256, 223)])
@pytest.mark.parametrize("B", [37, 1000])
def test_k6_rows_kernel_bit_identical(cuda, B, C, Tm):
    """Past C 64 or Tm 64 K6 runs its cluster kernel, a problem a block or
    split over 2 blocks (224 x 256, 256 x 223); every output against
    pen_plain."""
    from pint_tpu_torch.mpc import pen_fused, pen_plain

    gen = torch.Generator(device=cuda).manual_seed(B + C + Tm)
    S_t = torch.randn((C, Tm, B), generator=gen, device=cuda)
    got = pen_fused(S_t, power_iters=16)
    ref = pen_plain(S_t, power_iters=16)
    torch.cuda.synchronize()
    for name, a, b in zip(("sqc", "sqj", "pen_lip", "s_scale", "row_amp"), got, ref):
        assert torch.equal(a, b), name


def _same_bits(name, a, b):
    """Bit-identical, NaN where NaN (a NaN's payload aside)."""
    if a.is_floating_point():
        assert torch.equal(a.isnan(), b.isnan()), name
        a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
    assert torch.equal(a, b), name


@pytest.mark.parametrize("power_iters", [0, 16])
@pytest.mark.parametrize("C, Tm, B", [
    (32, 64, 4096), (32, 64, 4095), (32, 64, 1), (128, 256, 1000), (136, 272, 37),
    (256, 256, 37), (384, 128, 37), (2048, 32, 9), (20, 40, 100), (40, 40, 4096),
    (40, 40, 37), (36, 30, 1000), (64, 20, 9), (33, 64, 4095), (48, 48, 1000),
    (56, 56, 100), (64, 64, 100)])
def test_k6_bit_identical_at_every_design(cuda, C, Tm, B, power_iters):
    """The register kernel (32 x 64: TMA boxes and 16-byte stores at B
    4096, 4-byte copies and byte stores at 4095 and 1; any C <= 32, Tm <= 64
    at 20 x 40), the warp kernel (32 < C <= 64: 40 x 40, 36 x 30, 64 x 20,
    33 x 64, 48 x 48, 56 x 56) and the cluster kernel (a problem a block at
    128 x 256, 136 x 272, 384 x 128 and 64 x 64; two blocks, split by rows,
    past 227 KB at 256 x 256 and 2048 x 32), every output against
    pen_plain."""
    from pint_tpu_torch.mpc import pen_fused, pen_plain

    gen = torch.Generator(device=cuda).manual_seed(C + Tm + B + power_iters)
    S_t = torch.randn((C, Tm, B), generator=gen, device=cuda)
    got = pen_fused(S_t, power_iters=power_iters)
    ref = pen_plain(S_t, power_iters=power_iters)
    torch.cuda.synchronize()
    for name, a, b in zip(("sqc", "sqj", "pen_lip", "s_scale", "row_amp"), got, ref):
        _same_bits(name, a, b)


@pytest.mark.parametrize("C, Tm", [(32, 64), (40, 40), (128, 256), (4, 17000)])
def test_k6_nan_stays_in_its_problem(cuda, C, Tm):
    """A NaN in one problem's slab: that problem's outputs are NaN (its int8
    rows 0), every other problem's are as without it; the register kernel,
    the warp kernel (40 x 40), the cluster kernel and its column split (4 x
    17000)."""
    from pint_tpu_torch.mpc import pen_fused, pen_plain

    B = 64
    gen = torch.Generator(device=cuda).manual_seed(C + Tm)
    S_t = torch.randn((C, Tm, B), generator=gen, device=cuda)
    clean = pen_fused(S_t, power_iters=4)
    S_t[C // 2, Tm // 3, 5] = float("nan")
    got = pen_fused(S_t, power_iters=4)
    ref = pen_plain(S_t, power_iters=4)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("sqc", "sqj", "pen_lip", "s_scale", "row_amp"), got, ref,
                             clean):
        _same_bits(name, a, b)
        keep = torch.arange(B, device=cuda) != 5
        assert torch.equal(a[..., keep], c[..., keep]), name
    assert got[2][5].isnan() and not got[0][..., 5].any()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_k5_bit_identical(con_condensed, warm):
    from pint_tpu_torch.mpc import alm_fused_words_pre
    from pint_tpu_torch.mpc.constrained import RATIONALS
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain
    from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT, _alm_batched

    csqp, _, o = con_condensed
    d = csqp.dev
    B = o["g_pre"].shape[0]
    rng = np.random.default_rng(18)
    if warm:
        lanes = torch.as_tensor(rng.integers(-128, 128, (B, d.n_dec), dtype=np.int32),
                                device="cuda")
        lam = torch.as_tensor(rng.integers(0, 500, (B, csqp.padded_rows),
                                           dtype=np.int32), device="cuda")
    else:
        lanes = torch.zeros((B, d.n_dec), dtype=torch.int32, device="cuda")
        lam = torch.zeros((B, csqp.padded_rows), dtype=torch.int32, device="cuda")
    sc = torch.stack([o[k] for k in RATIONALS])
    args = (lanes, o["g_pre"], o["hqt"], o["sqj"], o["sqc"], o["c_off"],
            o["lo_pre"], o["hi_pre"], lam, sc)
    kw = dict(outer=3, inners=30, g_shift=d.g_shift, y_shift=_Y_SHIFT)
    before = K.launch_counts()["alm"]
    got = alm_hqt(*args, **kw)
    assert K.launch_counts()["alm"] == before + 1
    ref = alm_hqt_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    words = pack_controls(lanes.clamp(-127, 127))
    w_k, l_k = alm_fused_words_pre(
        words, o["g_pre"], o["hqt"], o["hs_num"], o["hs_den"], o["sqj"], o["sqc"],
        *[o[k] for k in ("cs_num", "cs_den", "c_off", "lo_pre", "hi_pre",
                         "eh_num", "eh_den", "el_num", "el_den")], lam, **kw)
    w_x, l_x = _alm_batched(
        words, o["g_pre"], o["hqt"].permute(2, 1, 0), o["hs_num"], o["hs_den"],
        o["sqc"].permute(2, 0, 1), *[o[k] for k in (
            "cs_num", "cs_den", "c_off", "lo_pre", "hi_pre", "eh_num",
            "eh_den", "el_num", "el_den")], lam, **kw)
    torch.cuda.synchronize()
    assert torch.equal(w_k, w_x) and torch.equal(l_k, l_x)


def _lti_constrained(T, pad_to=64):
    from pint_tpu_torch.mpc import constrain_states, quantize_constrained

    dt = 1.0 / 32.0
    qp = condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    sc = constrain_states(qp, np.broadcast_to(A, (T, 2, 2)),
                          np.broadcast_to(Bm, (T, 2, 1)), None,
                          F=[[0.0, 1.0]], lo=-0.25, hi=0.25)
    return quantize_constrained(sc, rho=50.0, pad_to=pad_to)


@pytest.mark.parametrize("B", [1, 1000])
@pytest.mark.parametrize("T", [50, 100, 20])
def test_k7_bit_identical(cuda, B, T):
    """K7 against its plain version and the word-space ConstrainedPGD, cold
    and with warm lanes and multipliers; T=100 runs Tp = Cp = 128."""
    from pint_tpu_torch.mpc import ConstrainedPGD

    q = _lti_constrained(T)
    rng = np.random.default_rng(19)
    x0 = np.stack([rng.uniform(-1.5, 1.5, B), rng.uniform(-0.2, 0.2, B)], -1)
    g = torch.as_tensor(q.qqp.g_lane_fixed(x0), device=cuda)
    co = torch.as_tensor(q.c_off_pre(x0), device=cuda)
    kern = ConstrainedPGD(q, outer=4, inners=15, device=cuda)
    word = ConstrainedPGD(q, outer=4, inners=15, fused=False, device=cuda)
    lanes = torch.as_tensor(rng.integers(-127, 128, (B, q.qqp.padded), dtype=np.int32),
                            device=cuda)
    lam = torch.as_tensor(rng.integers(0, 300, (B, q.padded_rows), dtype=np.int32),
                          device=cuda)
    for u0, lam0 in ((kern.init_words(B), None), (pack_controls(lanes), lam)):
        before = K.launch_counts()["alm_shared"]
        w_k, l_k = kern.solve_words(u0, g, co, lam0)
        assert K.launch_counts()["alm_shared"] == before + 1
        w_x, l_x = word.solve_words(u0, g, co, lam0)
        torch.cuda.synchronize()
        assert torch.equal(w_k, w_x) and torch.equal(l_k, l_x)


def test_constrained_kernels_reject_bad_operands(cuda, con_condensed):
    from pint_tpu_torch.mpc import alm_shared, pen_fused
    from pint_tpu_torch.mpc.constrained import RATIONALS
    from pint_tpu_torch.mpc.fused_alm import alm_hqt

    _, S_t, o = con_condensed
    lanes = torch.zeros_like(o["g_pre"])
    lam = torch.zeros_like(o["c_off"])
    sc = torch.stack([o[k] for k in RATIONALS])
    kw = dict(outer=1, inners=1, g_shift=12, y_shift=12)
    with pytest.raises(ValueError, match="contiguous"):
        # the right shape, as a transposed (non-contiguous) view
        sqc_view = o["sqj"].permute(1, 0, 2)
        alm_hqt(lanes, o["g_pre"], o["hqt"], o["sqj"], sqc_view, o["c_off"],
                o["lo_pre"], o["hi_pre"], lam, sc, **kw)
    with pytest.raises(ValueError, match="int32"):
        alm_hqt(lanes, o["g_pre"], o["hqt"], o["sqj"], o["sqc"], o["c_off"],
                o["lo_pre"], o["hi_pre"], lam, sc.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="float32"):
        pen_fused(S_t.double(), power_iters=1)
    with pytest.raises(ValueError, match="pen_viable"):
        pen_fused(torch.zeros((262, 261, 2), device=cuda), power_iters=1)
    z = torch.zeros
    with pytest.raises(ValueError, match="multiples of 4"):
        alm_shared(z((2, 262), dtype=torch.int32, device=cuda),
                   z((2, 262), dtype=torch.int32, device=cuda),
                   z((2, 64), dtype=torch.int32, device=cuda),
                   z((2, 64), dtype=torch.int32, device=cuda),
                   z((262, 262), dtype=torch.int8, device=cuda),
                   z((64, 262), dtype=torch.int8, device=cuda),
                   z((64,), dtype=torch.int32, device=cuda),
                   z((64,), dtype=torch.int32, device=cuda),
                   hs_num=1, hs_den=0, cs_num=1, cs_den=0, eh_num=1, eh_den=0,
                   el_num=1, el_den=0, **kw)


def test_device_constrained_kernels_cost_parity(cuda):
    """A whole constrained solve through K3, K6 and K5 against the plain
    versions: cost and violation parity (and, with the plain versions adding
    in the kernels' order, the same words)."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    sqp_kw = dict(horizon=32, sqp_iters=4, pgd_iters=30, x_ref=np.array([1.0, 0.0, 0.0]))
    kern = DeviceConstrainedSQP(DeviceSQP(device=cuda, **sqp_kw), **CON)
    plain = DeviceConstrainedSQP(DeviceSQP(device=cuda, use_kernels=False, **sqp_kw),
                                 **CON)
    x0 = _con_x0(64, 20)
    out = []
    for csqp in (kern, plain):
        w, lam = csqp.solve_words(csqp.init_words(64), torch.as_tensor(x0, device=cuda))
        lanes = unpack_controls(w)[:, : csqp.dev.n_dec].cpu().numpy()
        out.append((csqp.dev.true_cost(x0, lanes), csqp.violation(x0, lanes)))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=5e-3)


def _k7_operands(cuda, B, Tp, Cp, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=cuda)

    return (t(rng.integers(-128, 128, (B, Tp), dtype=np.int32)),
            t(rng.integers(-2**16, 2**16, (B, Tp), dtype=np.int32)),
            t(rng.integers(-3000, 3000, (B, Cp), dtype=np.int32)),
            t(rng.integers(0, 500, (B, Cp), dtype=np.int32)),
            t(rng.integers(-127, 128, (Tp, Tp), dtype=np.int8)),
            t(rng.integers(-127, 128, (Cp, Tp), dtype=np.int8)),
            t(rng.integers(-2000, -100, (Cp,), dtype=np.int32)),
            t(rng.integers(100, 2000, (Cp,), dtype=np.int32)))


@pytest.mark.parametrize("Tp, Cp", [(20, 20), (64, 64), (52, 100), (256, 256)])
@pytest.mark.parametrize("B", [1, 15, 17, 1000, 4096])
def test_k7_bit_identical_at_every_shape(cuda, B, Tp, Cp):
    """K7 against alm_shared_plain on random operands with warm lanes (so
    -128 occurs) and multipliers: the tensor-core kernel at W = 32 (20 x
    20), 64, 128 (52 x 100) and 256 (256 x 256, B fragments in shared
    memory, four column groups a warp); tiles of 16 problems, ragged at 1,
    15, 17 and 1000."""
    from pint_tpu_torch.mpc import alm_shared, alm_shared_plain

    args = _k7_operands(cuda, B, Tp, Cp, B + Tp + Cp)
    kw = dict(hs_num=37, hs_den=14, cs_num=91, cs_den=12, eh_num=55, eh_den=16,
              el_num=23, el_den=11, outer=3, inners=8, g_shift=12, y_shift=9)
    got = alm_shared(*args, **kw)
    ref = alm_shared_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_k7_one_launch_a_constrained_pgd_solve(cuda):
    from pint_tpu_torch.mpc import ConstrainedPGD

    q = _lti_constrained(50)
    solver = ConstrainedPGD(q, outer=2, inners=10, device=cuda)
    x0 = np.stack([np.linspace(-1.5, 1.5, 33), np.linspace(-0.2, 0.2, 33)], -1)
    before = K.launch_counts()
    solver.solve(x0)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["alm_shared"] == before["alm_shared"] + 1
    assert sum(after.values()) == sum(before.values()) + 1


def _k5_operands(cuda, B, Tp, Cp, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device=cuda)

    sq = rng.integers(-127, 128, (Cp, Tp, B), dtype=np.int8)
    sc = np.stack([rng.integers(1, 300, B), rng.integers(10, 16, B),
                   rng.integers(1, 300, B), rng.integers(8, 14, B),
                   rng.integers(1, 300, B), rng.integers(12, 18, B),
                   rng.integers(1, 300, B), rng.integers(8, 14, B)]).astype(np.int32)
    return (t(rng.integers(-128, 128, (B, Tp), dtype=np.int32)),
            t(rng.integers(-2**16, 2**16, (B, Tp), dtype=np.int32)),
            t(rng.integers(-127, 128, (Tp, Tp, B), dtype=np.int8)),
            t(np.ascontiguousarray(sq.transpose(1, 0, 2))), t(sq),
            t(rng.integers(-3000, 3000, (B, Cp), dtype=np.int32)),
            t(rng.integers(-2000, -100, (B, Cp), dtype=np.int32)),
            t(rng.integers(100, 2000, (B, Cp), dtype=np.int32)),
            t(rng.integers(0, 500, (B, Cp), dtype=np.int32)), t(sc))


@pytest.mark.parametrize("Tp, Cp", [(64, 64), (32, 64), (256, 128)])
@pytest.mark.parametrize("B", [37, 4096, 4099])
def test_k5_bit_identical_at_every_shape(cuda, B, Tp, Cp):
    """K5 against alm_hqt_plain on random operands: rows in registers
    (Tp, Cp <= 64; B = 4096 lands by 8-byte copies, 37 and 4099 by byte
    loads) and the cluster kernel past 64 (256 x 128, one block a
    problem)."""
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain

    args = _k5_operands(cuda, B, Tp, Cp, B + Tp + Cp)
    kw = dict(outer=3, inners=10, g_shift=12, y_shift=9)
    got = alm_hqt(*args, **kw)
    ref = alm_hqt_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("Tp, Cp", [(100, 68), (288, 192), (512, 128), (632, 4),
                                    (16, 1600)])
@pytest.mark.parametrize("B", [37, 1000])
def test_k5_cluster_kernel_to_the_reference_fit(cuda, B, Tp, Cp):
    """K5's cluster kernel against alm_hqt_plain up to the reference's
    alm_viable: one block a problem (100 x 68, 288 x 192), two blocks whose
    rows j and c split (512 x 128, 632 x 4), and four of 400 rows c each
    (16 x 1600)."""
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain

    args = _k5_operands(cuda, B, Tp, Cp, B + Tp + Cp)
    kw = dict(outer=2, inners=6, g_shift=12, y_shift=9)
    got = alm_hqt(*args, **kw)
    ref = alm_hqt_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _entry_accepts(cuda, entry, ptrs, *ints):
    """Whether C entry ``entry`` accepts the shape: 0 from a launch on
    zero operands of a generous size, and the launch runs."""
    bufs = [torch.zeros(1 << 22, dtype=torch.int32, device=cuda) for _ in range(ptrs)]
    err = getattr(K.library(), entry)(*(b.data_ptr() for b in bufs), *ints,
                                      K.stream_of(bufs[0]))
    torch.cuda.synchronize()
    return err == 0


@pytest.mark.parametrize("Tm", [220, 224, 228, 256, 286, 288])
def test_lipq_fits_is_where_k3_accepts(cuda, Tm):
    from pint_tpu_torch.mpc import lipq_fits

    assert _entry_accepts(cuda, "pint_lipq", 4, 1, Tm, 2) == lipq_fits(Tm)


@pytest.mark.parametrize("C, Tm", [(224, 256), (225, 256), (256, 223), (256, 224),
                                   (257, 8), (128, 256), (261, 261), (262, 261),
                                   (2048, 32), (1, 68266), (1, 68267), (68266, 1)])
def test_pen_fits_is_where_k6_accepts(cuda, C, Tm):
    from pint_tpu_torch.mpc import pen_fits

    assert _entry_accepts(cuda, "pint_pen", 7, 1, C, Tm, 2, 0) == pen_fits(C, Tm)


@pytest.mark.parametrize("Tp", [4, 64, 254, 256, 260, 632, 636])
def test_pgd_fits_is_where_k4_accepts(cuda, Tp):
    from pint_tpu_torch.mpc import pgd_fits

    for entry in ("pint_pgd_hqt", "pint_pgd_hqt_words"):
        assert _entry_accepts(cuda, entry, 6, 1, Tp, 2, 12, 0) == pgd_fits(Tp)


@pytest.mark.parametrize("Tp, Cp", [(64, 64), (256, 256), (260, 64), (64, 260),
                                    (62, 64), (20, 100), (632, 4), (632, 8),
                                    (512, 136), (512, 140), (4, 4096), (4, 4100)])
def test_alm_fits_is_where_k5_and_k7_accept(cuda, Tp, Cp):
    """K5 takes what alm_fits takes; K7 takes multiples of 4 up to 4096
    (its wide form past 256, given its scratch)."""
    from pint_tpu_torch.mpc import alm_fits

    fits = alm_fits(Tp, Cp)
    assert _entry_accepts(cuda, "pint_alm", 12, 1, Tp, Cp, 1, 2, 12, 9, 0) == fits
    k7 = Tp % 4 == 0 and Cp % 4 == 0 and max(Tp, Cp) <= 4096
    assert _entry_accepts(cuda, "pint_alm_shared", 11, 1, Tp, Cp, 1, 2, 12, 9,
                          1, 0, 1, 0, 1, 0, 1, 0) == k7


@pytest.mark.parametrize("horizon, forms", [
    (128, dict(chain="fused", reduce="kernel", condense="lipq", inner="pgd_hqt")),
    (144, dict(chain="fused", reduce="kernel", condense="torch", inner="pgd_hqt")),
])
def test_long_horizon_device_sqp_cost_parity(cuda, horizon, forms):
    """At T = 128 (Tm 256: K3 with rows in registers, K4) and past K3's fit
    (Tm 288: the torch form, K4's cluster kernel) the solve runs on the
    card at cost parity with the plain versions."""
    kw = dict(SQP_KW, horizon=horizon)
    kern = DeviceSQP(sqp_iters=2, device=cuda, **kw)
    plain = DeviceSQP(sqp_iters=2, device=cuda, use_kernels=False, **kw)
    assert kern.forms == forms
    x0 = _x0(64, 23)
    costs = []
    for sqp in (kern, plain):
        w = sqp.solve_words(sqp.init_words(64), torch.as_tensor(x0, device=cuda))
        costs.append(sqp.true_cost(x0, unpack_controls(w)[:, : sqp.n_dec].cpu().numpy()))
    assert np.isfinite(costs[0]).all()
    np.testing.assert_allclose(costs[0], costs[1], rtol=0.01, atol=1e-4)


@pytest.mark.parametrize("horizon, forms", [
    (128, dict(chain="fused", reduce="kernel", stack="kernel", condense="lipq",
               constraints="pen", inner="alm")),
    (136, dict(chain="fused", reduce="kernel", stack="kernel", condense="lipq",
               constraints="pen", inner="alm")),
    (144, dict(chain="fused", reduce="kernel", stack="kernel",
               condense="torch", constraints="torch", inner="alm")),
])
def test_long_horizon_device_constrained_cost_parity(cuda, horizon, forms):
    """T = 128 and 136 through K3, K6 and K5's cluster kernel; T = 144 past
    K3's fit (and so, as in the reference, no K6), K5's cluster kernel at
    288 x 192."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    sqp_kw = dict(horizon=horizon, sqp_iters=2, pgd_iters=30,
                  x_ref=np.array([1.0, 0.0, 0.0]))
    kern = DeviceConstrainedSQP(DeviceSQP(device=cuda, **sqp_kw), **CON)
    plain = DeviceConstrainedSQP(DeviceSQP(device=cuda, use_kernels=False, **sqp_kw), **CON)
    assert kern.forms == forms
    fits = forms["condense"] == "lipq"
    x0 = _con_x0(64, 24)
    out = []
    before = K.launch_counts()
    for csqp in (kern, plain):
        w, lam = csqp.solve_words(csqp.init_words(64), torch.as_tensor(x0, device=cuda))
        lanes = unpack_controls(w)[:, : csqp.dev.n_dec].cpu().numpy()
        out.append((csqp.dev.true_cost(x0, lanes), csqp.violation(x0, lanes)))
        if csqp is kern:
            after = K.launch_counts()
            assert after["alm"] == before["alm"] + 2
            assert after["lipq"] == before["lipq"] + 2 * fits
            assert after["pen"] == before["pen"] + 2 * fits
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(out[0][1], out[1][1], atol=5e-3)


# -- the multi-device tier's kernels: K10 and K2p -------------------------------


@pytest.fixture(scope="module")
def rti_slabs(cuda):
    """One real DeviceSQP lipq condensation and one DeviceConstrainedSQP
    condensation at the RTI configurations (Tm = 64, Cp = 64), B = 4096."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    B = 4096
    rng = np.random.default_rng(20)
    sqp = DeviceSQP(sqp_iters=1, device=cuda, **SQP_KW)
    lanes = torch.as_tensor(rng.integers(-60, 61, (B, sqp.n_dec), dtype=np.int32),
                            device=cuda)
    hqt = sqp._condense(torch.as_tensor(_x0(B, 21), device=cuda), lanes)[0]
    csqp = DeviceConstrainedSQP(
        DeviceSQP(horizon=32, sqp_iters=1, pgd_iters=30, x_ref=np.array([1.0, 0.0, 0.0]),
                  device=cuda), **CON)
    ops, _ = csqp._condense_constrained_dev(torch.as_tensor(_con_x0(B, 22), device=cuda),
                                            lanes)
    return hqt, ops, lanes


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("slab", ["sqp", "constrained"])
def test_k10_bit_identical(rti_slabs, tp, slab):
    """K10 on rank 0's slab: K = 64/tp columns, rows = Tm (DeviceSQP) or
    Tm + Cp (the constrained combined slab)."""
    from pint_tpu_torch.mpc import pgd_matvec_cols, pgd_matvec_cols_plain

    hqt, ops, lanes = rti_slabs
    k = 64 // tp
    slab_r = (hqt[:k] if slab == "sqp"
              else torch.cat([ops["hqt"][:k], ops["sqj"][:k]], dim=1))
    lanes_r = lanes[:, :k].contiguous()
    before = K.launch_counts()["pgd_matvec_cols"]
    got = pgd_matvec_cols(lanes_r, slab_r)
    assert K.launch_counts()["pgd_matvec_cols"] == before + 1
    torch.cuda.synchronize()
    assert got.shape == (4096, 64 if slab == "sqp" else 128)
    assert torch.equal(got, pgd_matvec_cols_plain(lanes_r, slab_r))


@pytest.mark.parametrize("B, K_, rows", [(37, 32, 64), (1, 8, 5), (4099, 16, 200),
                                          (37, 130, 64), (4096, 130, 64)])
def test_k10_ragged_shapes(cuda, B, K_, rows):
    """Batches and row counts that fill no tile, and K past one stage of
    lanes (130: three of the first design's, five of the 16-byte
    design's), full-range int8 lanes."""
    from pint_tpu_torch.mpc import pgd_matvec_cols, pgd_matvec_cols_plain

    rng = np.random.default_rng(B + K_)
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, K_), dtype=np.int32), device=cuda)
    slab = torch.as_tensor(rng.integers(-128, 128, (K_, rows, B), dtype=np.int8),
                           device=cuda)
    got = pgd_matvec_cols(lanes, slab)
    torch.cuda.synchronize()
    assert torch.equal(got, pgd_matvec_cols_plain(lanes, slab))


def test_k10_refuses_what_it_cannot_stage(cuda):
    """More rows than the grid's 65535 tiles of 16 cover: the C entry
    refuses them before the launch."""
    from pint_tpu_torch.mpc import pgd_matvec_cols

    rows = 16 * 65535 + 1
    before = K.launch_counts()["pgd_matvec_cols"]
    with pytest.raises(RuntimeError, match="pgd_matvec_cols: CUDA error .*invalid argument"):
        pgd_matvec_cols(torch.zeros((1, 1), dtype=torch.int32, device=cuda),
                        torch.zeros((1, rows, 1), dtype=torch.int8, device=cuda))
    assert K.launch_counts()["pgd_matvec_cols"] == before


def _matvec_wrap(lanes, slab):
    """out[b, j] = sum_k slab[k, j, b] lanes[b, k] in int64, wrapped to int32."""
    acc = torch.einsum("kjb,bk->bj", slab.cpu().to(torch.int64), lanes.cpu().to(torch.int64))
    acc = acc & 0xFFFFFFFF
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


@pytest.mark.parametrize("B", [4096, 4095, 1])
@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("K_", [1, 16, 32, 33])
def test_k10_bit_identical_at_every_shape(cuda, K_, rows, B):
    """16-byte slab loads (B % 16 == 0) and byte loads, one chunk of k or
    two (K 33); int8 lanes against the plain version, then lanes at int32's
    extremes against an int64 product wrapped modulo 2^32."""
    from pint_tpu_torch.mpc import pgd_matvec_cols, pgd_matvec_cols_plain

    rng = np.random.default_rng(K_ * rows + B)
    slab = torch.as_tensor(rng.integers(-128, 128, (K_, rows, B), dtype=np.int8),
                           device=cuda)
    lanes = torch.as_tensor(rng.integers(-128, 128, (B, K_), dtype=np.int32), device=cuda)
    got = pgd_matvec_cols(lanes, slab)
    torch.cuda.synchronize()
    assert torch.equal(got, pgd_matvec_cols_plain(lanes, slab))
    ext = np.array([-2**31, 2**31 - 1, -2**31 + 1, 2**30, -1, 0], np.int64)
    wide = torch.as_tensor(rng.choice(ext, (B, K_)).astype(np.int32), device=cuda)
    got = pgd_matvec_cols(wide, slab)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _matvec_wrap(wide, slab))


@pytest.mark.parametrize("g_kind", ["real", "extreme"])
@pytest.mark.parametrize("iters", K2_ITERS)
@pytest.mark.parametrize("B", K2_BATCHES)
@pytest.mark.parametrize("T, pad_to", K2_SHAPES)
def test_k2p_bit_identical(cuda, B, T, pad_to, iters, g_kind):
    """K2p on words against K2 with its unpack and pack, and against its
    plain version; full-range warm words, so -128 lanes occur."""
    from pint_tpu_torch.mpc import fused_pgd_packed, fused_pgd_packed_plain

    qqp, lanes, g, hq = _k2_operands(cuda, B, T, pad_to, g_kind, 40 + B)
    words = pack_controls(lanes)
    kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift, iters=iters)
    before = K.launch_counts()["fused_pgd_packed"]
    got = fused_pgd_packed(words, g, hq, **kw)
    assert K.launch_counts()["fused_pgd_packed"] == before + 1
    via_k2 = pack_controls(fused_pgd(unpack_controls(words), g, hq, **kw))
    torch.cuda.synchronize()
    assert torch.equal(got, via_k2)
    assert torch.equal(got, fused_pgd_packed_plain(words, g, hq, **kw))
    solver = FusedPGD(qqp, iters=iters, packed_io=True, device=cuda)
    assert torch.equal(solver.solve_words(words, g), got)


# K2 and K2p past Tp 256 (the wide form: an iteration is one product across
# the batch in tiles of 64 problems x 128 lanes, k in chunks of 64 bytes,
# the operands in blocks of 128 rows): Tp 260 and 388 (ragged around the
# lane tile and the k-chunk), 384, 512 from the QP, 2048 on a random
# symmetric Hq (the QP's condensation takes minutes there); B ragged around
# the 64-problem tile (63, 65) and the 128-row block (127, 129) and across
# the grid (4099)
K2_WIDE_TP = [260, 384, 388, 512, 2048]
K2_WIDE_BATCHES = [1, 17, 63, 65, 127, 129, 1000, 4096, 4099]
K2_WIDE_ITERS = [0, 1, 40]


@functools.lru_cache(maxsize=None)
def _wide_qp(Tp):
    """(Hq (Tp, Tp) int8, hs_num, hs_den, g_shift, the QP or None)."""
    if Tp <= 512:
        qqp = quantize(condense_double_integrator(T=Tp), pad_to=4)
        return qqp.Hq, qqp.hs_num, qqp.hs_den, qqp.g_shift, qqp
    rng = np.random.default_rng(Tp)
    a = rng.integers(-60, 61, (Tp, Tp))
    hq = np.clip((a + a.T) // 2 + 127 * np.eye(Tp, dtype=np.int64), -127, 127)
    return hq.astype(np.int8), 33, 9, 12, None


def _k2_wide_operands(cuda, B, Tp, g_kind, seed):
    hq, hs_num, hs_den, g_shift, qqp = _wide_qp(Tp)
    rng = np.random.default_rng(seed)
    lanes = rng.integers(-128, 128, (B, Tp), dtype=np.int32)
    if g_kind == "real" and qqp is not None:
        g = qqp.g_lane_fixed(np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], -1))
    elif g_kind == "real":
        g = rng.integers(-2**20, 2**20, (B, Tp), dtype=np.int32)
    else:
        edge = rng.integers(0, 1 << 20, (B, Tp), dtype=np.int64)
        g = np.where(rng.integers(0, 2, (B, Tp)) == 1, 2**31 - 1 - edge,
                     -2**31 + edge).astype(np.int32)
    kw = dict(hs_num=hs_num, hs_den=hs_den, g_shift=g_shift)
    return (kw, torch.as_tensor(lanes, device=cuda), torch.as_tensor(g, device=cuda),
            torch.as_tensor(hq, device=cuda))


@pytest.mark.parametrize("g_kind", ["real", "extreme"])
@pytest.mark.parametrize("iters", K2_WIDE_ITERS)
@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("B", K2_WIDE_BATCHES)
@pytest.mark.parametrize("Tp", K2_WIDE_TP)
def test_k2_wide_bit_identical(cuda, Tp, B, momentum, iters, g_kind):
    """K2's wide form against its plain version, one launch a call."""
    kw, lanes, g, hq = _k2_wide_operands(cuda, B, Tp, g_kind, Tp + B)
    kw.update(iters=iters, momentum=momentum, beta_num=150 if momentum else 0)
    before = K.launch_counts()["fused_pgd"]
    got = fused_pgd(lanes, g, hq, **kw)
    assert K.launch_counts()["fused_pgd"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused_pgd_plain(lanes, g, hq, **kw))


@pytest.mark.parametrize("g_kind", ["real", "extreme"])
@pytest.mark.parametrize("iters", K2_WIDE_ITERS)
@pytest.mark.parametrize("B", K2_WIDE_BATCHES)
@pytest.mark.parametrize("Tp", K2_WIDE_TP)
def test_k2p_wide_bit_identical(cuda, Tp, B, iters, g_kind):
    """K2p's wide form on the words against its plain version and against
    K2 with its unpack and pack."""
    from pint_tpu_torch.mpc import fused_pgd_packed, fused_pgd_packed_plain

    kw, lanes, g, hq = _k2_wide_operands(cuda, B, Tp, g_kind, 7 * Tp + B)
    kw.update(iters=iters)
    words = pack_controls(lanes)
    before = K.launch_counts()["fused_pgd_packed"]
    got = fused_pgd_packed(words, g, hq, **kw)
    assert K.launch_counts()["fused_pgd_packed"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, fused_pgd_packed_plain(words, g, hq, **kw))
    assert torch.equal(got, pack_controls(fused_pgd(unpack_controls(words), g, hq, **kw)))


@pytest.mark.parametrize("iters", K2_WIDE_ITERS)
@pytest.mark.parametrize("B", [1, 3])
def test_k2_wide_at_the_limit(cuda, B, iters):
    """K2 (momentum off and on) and K2p at Tp 4096, the widest they take,
    against their plain versions."""
    from pint_tpu_torch.mpc import fused_pgd_packed, fused_pgd_packed_plain

    kw, lanes, g, hq = _k2_wide_operands(cuda, B, 4096, "extreme", B + iters)
    kw.update(iters=iters)
    for mom in (False, True):
        mkw = dict(kw, momentum=mom, beta_num=150 if mom else 0)
        got = fused_pgd(lanes, g, hq, **mkw)
        torch.cuda.synchronize()
        assert torch.equal(got, fused_pgd_plain(lanes, g, hq, **mkw))
    words = pack_controls(lanes)
    assert torch.equal(fused_pgd_packed(words, g, hq, **kw),
                       fused_pgd_packed_plain(words, g, hq, **kw))


def test_fused_pgd_solve_at_tp512(cuda):
    """FusedPGD (K2, momentum off and on, and K2p) at Tp = 512 on the card
    equals the word-space FixedPointPGD."""
    from pint_tpu_torch.mpc import FixedPointPGD

    qqp = _wide_qp(512)[4]
    x0 = np.stack([np.linspace(-3, 3, 33), np.linspace(-1, 1, 33)], -1)
    ref, _ = FixedPointPGD(qqp, iters=20, device=cuda).solve(x0)
    for kw in (dict(), dict(packed_io=True)):
        words, _ = FusedPGD(qqp, iters=20, device=cuda, **kw).solve(x0)
        assert torch.equal(words, ref)
    solver = FusedPGD(qqp, iters=20, momentum=True, device=cuda)
    g = torch.as_tensor(qqp.g_lane_fixed(x0), device=cuda)
    lanes = fused_pgd_plain(unpack_controls(solver.init_words(33)), g, solver._hq,
                            hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift,
                            iters=20, momentum=True, beta_num=solver.beta_num)
    assert torch.equal(solver.solve_words(solver.init_words(33), g), pack_controls(lanes))


# K7 past 256: pass 1 in tiles of 64 problems x 128 columns over Tp + Cp,
# pass 2 in tiles of 64 problems (y_hi and y_lo) x 64 lanes over Tp; B
# ragged around the tile and the 128-row block
K7_WIDE_SHAPES = [(260, 64), (384, 384), (512, 256), (512, 512), (64, 300), (2048, 128),
                  (388, 260)]


K7_WIDE_CASES = ([(B, Tp, Cp) for Tp, Cp in K7_WIDE_SHAPES
                  for B in (1, 17, 63, 65, 127, 129, 1000, 4099)]
                 + [(B, Tp, Cp) for Tp, Cp in ((2048, 2048), (260, 1024)) for B in (17, 1000)])


@pytest.mark.parametrize("B, Tp, Cp", K7_WIDE_CASES)
def test_k7_wide_bit_identical(cuda, B, Tp, Cp):
    """K7's wide form (a batch product a pass, state in memory) against
    alm_shared_plain on random operands with warm lanes (so -128 occurs)
    and multipliers, one launch a call; also with no inner iteration (the
    multiplier updates alone) and with no outer one."""
    from pint_tpu_torch.mpc import alm_shared, alm_shared_plain

    args = _k7_operands(cuda, B, Tp, Cp, B + Tp + Cp)
    kw = dict(hs_num=37, hs_den=14, cs_num=91, cs_den=12, eh_num=55, eh_den=16,
              el_num=23, el_den=11, outer=3, inners=8, g_shift=12, y_shift=9)
    before = K.launch_counts()["alm_shared"]
    got = alm_shared(*args, **kw)
    assert K.launch_counts()["alm_shared"] == before + 1
    ref = alm_shared_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for outer, inners in ((0, 5), (2, 0)):
        kw.update(outer=outer, inners=inners)
        got = alm_shared(*args, **kw)
        ref = alm_shared_plain(*args, **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_constrained_pgd_solve_at_tp512(cuda):
    """ConstrainedPGD at T = 512 (Tp = Cp = 512) runs K7's wide form, equal
    to the word-space solver."""
    from pint_tpu_torch.mpc import ConstrainedPGD

    q = _lti_constrained(512)
    x0 = np.stack([np.linspace(-1.5, 1.5, 33), np.linspace(-0.2, 0.2, 33)], -1)
    kern = ConstrainedPGD(q, outer=2, inners=10, device=cuda)
    word = ConstrainedPGD(q, outer=2, inners=10, fused=False, device=cuda)
    g = torch.as_tensor(q.qqp.g_lane_fixed(x0), device=cuda)
    co = torch.as_tensor(q.c_off_pre(x0), device=cuda)
    before = K.launch_counts()["alm_shared"]
    w_k, l_k = kern.solve_words(kern.init_words(33), g, co)
    assert K.launch_counts()["alm_shared"] == before + 1
    w_x, l_x = word.solve_words(kern.init_words(33), g, co)
    assert torch.equal(w_k, w_x) and torch.equal(l_k, l_x)


def _wide_calls(cuda, B=129, Tp=388, Cp=260):
    """One call of each wide form on random operands: name -> function."""
    from pint_tpu_torch.mpc import alm_shared, fused_pgd_packed

    kw, lanes, g, hq = _k2_wide_operands(cuda, B, Tp, "real", 5)
    words = pack_controls(lanes)
    args = _k7_operands(cuda, B, Tp, Cp, 6)
    akw = dict(hs_num=37, hs_den=14, cs_num=91, cs_den=12, eh_num=55, eh_den=16,
               el_num=23, el_den=11, outer=2, inners=3, g_shift=12, y_shift=9)
    return {
        "fused_pgd": lambda: (fused_pgd(lanes, g, hq, iters=7, **kw),),
        "fused_pgd momentum": lambda: (fused_pgd(lanes, g, hq, iters=7, momentum=True,
                                                 beta_num=150, **kw),),
        "fused_pgd_packed": lambda: (fused_pgd_packed(words, g, hq, iters=7, **kw),),
        "alm_shared": lambda: alm_shared(*args, **akw),
    }


def test_wide_refused_cooperative_launch_raises(cuda):
    """A cooperative grid the card cannot hold at once is refused by the
    runtime (cudaErrorCooperativeLaunchTooLarge, 720): the wide launch
    returns the refusal, the wrappers' check raises on it, nothing runs in
    its place, and the card stays usable.  The grid is enlarged through the
    C entry that exists for this check alone."""
    import ctypes

    from pint_tpu_torch.mpc.fused import _scratch

    B, Tp = 129, 388
    kw, lanes, g, hq = _k2_wide_operands(cuda, B, Tp, "real", 5)
    lib = K.library()
    f = lib.pint_fused_pgd_wide_oversized
    f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = torch.full_like(lanes, 7)
    scratch = _scratch(lib, B, Tp, False, lanes.device)
    err = f(lanes.data_ptr(), g.data_ptr(), hq.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, Tp, 7, 1, K.stream_of(lanes))
    assert err == 720
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        K.check(err, "fused_pgd")
    torch.cuda.synchronize()
    assert bool((out == 7).all())  # nothing ran
    for call in _wide_calls(cuda).values():  # the card is still usable
        call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [1, 129, 4099])
@pytest.mark.parametrize("Tp, Cp", [(256, 256), (260, 64), (64, 300), (388, 260),
                                    (4096, 4096)])
def test_wide_scratch_sizes(cuda, B, Tp, Cp):
    """The scratch the wide forms ask for is their plan's: padded Hq
    (Tp to 128 rows x 64 bytes) and two y buffers (the batch to 128 rows),
    and x (momentum) for K2; [Hq; Sq] and Sq^T padded, u, y_hi, y_lo and
    the int32 error feedback for K7; nothing to 256."""
    def up(x, m):
        return -(-x // m) * m

    lib = K.library()
    bp = up(B, 128)
    for mom in (0, 1):
        want = 0 if Tp <= 256 else (up(Tp, 128) * up(Tp, 64) + 2 * bp * up(Tp, 64)
                                    + (up(B * Tp, 16) if mom else 0))
        assert lib.pint_fused_pgd_scratch(B, Tp, mom) == want
    want = 0 if max(Tp, Cp) <= 256 else (
        (up(Tp, 128) + up(Cp, 128)) * up(Tp, 64) + up(Tp, 128) * up(Cp, 64)
        + bp * up(Tp, 64) + 2 * bp * up(Cp, 64) + 4 * B * Cp)
    assert lib.pint_alm_shared_scratch(B, Tp, Cp) == want


def test_wide_forms_raise_past_their_limit(cuda):
    """Past Tp (or Cp) 4096 K2, K2p and K7 raise; nothing falls back."""
    from pint_tpu_torch.mpc import alm_shared, fused_pgd_packed

    z = torch.zeros
    T = 4100
    lanes = z((2, T), dtype=torch.int32, device=cuda)
    hq = z((T, T), dtype=torch.int8, device=cuda)
    kw = dict(hs_num=1, hs_den=0, g_shift=12, iters=1)
    with pytest.raises(ValueError, match="4096"):
        fused_pgd(lanes, lanes, hq, **kw)
    with pytest.raises(ValueError, match="4096"):
        fused_pgd_packed(z((2, T // 4), dtype=torch.int32, device=cuda), lanes, hq, **kw)
    with pytest.raises(ValueError, match="4096"):
        alm_shared(lanes, lanes, z((2, 8), dtype=torch.int32, device=cuda),
                   z((2, 8), dtype=torch.int32, device=cuda), hq,
                   z((8, T), dtype=torch.int8, device=cuda),
                   z((8,), dtype=torch.int32, device=cuda),
                   z((8,), dtype=torch.int32, device=cuda),
                   hs_num=1, hs_den=0, cs_num=1, cs_den=0, eh_num=1, eh_den=0,
                   el_num=1, el_den=0, outer=1, inners=1, g_shift=12, y_shift=9)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("T, pad_to", [(50, 4), (50, 64)])
def test_k2_unaligned_operands(cuda, packed, T, pad_to):
    """Contiguous views whose data pointers lie 4 bytes past a 16-byte
    boundary (lanes or words, and g) take the kernel's 4-byte path:
    bit-identical, one launch."""
    from pint_tpu_torch.mpc import fused_pgd_packed, fused_pgd_packed_plain

    B = 1000
    qqp, lanes, g, hq = _k2_operands(cuda, B, T, pad_to, "real", 7)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift, iters=15)
    name = "fused_pgd_packed" if packed else "fused_pgd"
    before = K.launch_counts()[name]
    if packed:
        words = pack_controls(lanes)
        got = fused_pgd_packed(shifted(words), shifted(g), hq, **kw)
        ref = fused_pgd_packed_plain(words, g, hq, **kw)
    else:
        got = fused_pgd(shifted(lanes), shifted(g), hq, **kw)
        ref = fused_pgd_plain(lanes, g, hq, **kw)
    assert K.launch_counts()[name] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# -- the other model families and forms on the card -----------------------------

QUAD_KW = dict(horizon=16, pgd_iters=30, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
               R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6))
QUAD_CON = dict(F=[[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]], lo=-0.15, hi=0.15, rho=50.0,
                alm_outer=3)


def _quad_x0(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
                     rng.uniform(-0.03, 0.03, B), rng.uniform(-0.1, 0.1, B),
                     rng.uniform(-0.1, 0.1, B), rng.uniform(-0.03, 0.03, B)],
                    -1).astype(np.float32)


@pytest.fixture(scope="module", params=[37, 4096], ids=lambda b: f"B{b}")
def quad_condensed(cuda, request):
    """One real DeviceConstrainedSQP condensation of the planar quadrotor
    (n = 6, m = 2, T = 16: Tm = 32; C = 16 rows padded to Cp = 64)."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    csqp = DeviceConstrainedSQP(DeviceSQP(model=pt.PlanarQuadrotor(), sqp_iters=1,
                                          device=cuda, **QUAD_KW), **QUAD_CON)
    assert csqp.forms == dict(chain="fused", reduce="kernel", stack="kernel",
                              condense="lipq", constraints="pen", inner="alm")
    B = request.param
    rng = np.random.default_rng(90)
    x0 = torch.as_tensor(_quad_x0(B, 91), device=cuda)
    lanes = torch.as_tensor(rng.integers(-100, 100, (B, 32), dtype=np.int32), device=cuda)
    d = csqp.dev
    Ht, g = d._condense_ht(x0, lanes)
    A, Bl, c = d._linearize_phase(x0, lanes)
    S_t, _, _ = csqp._stack_constraints(*d._propagate_unrolled(A, Bl, c))
    ops, _ = csqp._condense_constrained_dev(x0, lanes)
    return csqp, lanes, Ht, g, S_t, ops


def test_quadrotor_k3_k4_k6_k5_bit_identical(quad_condensed):
    """K3, K4, K6 and K5 at the quadrotor's shapes (Tm 32, C 16 in Cp 64)
    against their plain versions on real operands."""
    from pint_tpu_torch.mpc import pen_fused, pen_plain
    from pint_tpu_torch.mpc.constrained import RATIONALS
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain
    from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT

    csqp, lanes, Ht, g, S_t, o = quad_condensed
    d = csqp.dev
    got, ref = lipq_fused(Ht, power_iters=d.power_iters), lipq_plain(Ht, power_iters=d.power_iters)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    hqt, lip, hmax = ref
    alpha = true_div(1.0, lip)
    g_pre = d._g_pre_from(g, alpha)
    hs_num, hs_den = d._step_rationals(alpha * hmax * (1.0 / 127.0))
    kw = dict(iters=30, g_shift=d.g_shift)
    assert torch.equal(pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw),
                       pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw))
    for a, b in zip(pen_fused(S_t, power_iters=d.power_iters),
                    pen_plain(S_t, power_iters=d.power_iters)):
        assert torch.equal(a, b)
    sc = torch.stack([o[k] for k in RATIONALS])
    lam = torch.zeros_like(o["c_off"])
    args = (lanes.clamp(-127, 127), o["g_pre"], o["hqt"], o["sqj"], o["sqc"], o["c_off"],
            o["lo_pre"], o["hi_pre"], lam, sc)
    akw = dict(outer=3, inners=30, g_shift=d.g_shift, y_shift=_Y_SHIFT)
    a, b = alm_hqt(*args, **akw), alm_hqt_plain(*args, **akw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("model", ["quadrotor", "pendulum"])
def test_other_models_solve_at_cost_parity(cuda, model):
    """DeviceSQP and DeviceConstrainedSQP on the quadrotor (T = 16) and the
    pendulum (T = 32) through the kernels against use_kernels=False: the
    same words (the plain versions add in the kernels' order), cost and
    violation parity."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    if model == "quadrotor":
        kw, con, x0 = dict(QUAD_KW, model=pt.PlanarQuadrotor()), QUAD_CON, _quad_x0(64, 92)
    else:
        kw = dict(horizon=32, pgd_iters=30, Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
                  x_ref=np.zeros(2), model=pt.Pendulum())
        con = dict(F=[[0.0, 1.0]], lo=-0.4, hi=0.4, rho=50.0, alm_outer=3)
        rng = np.random.default_rng(93)
        x0 = np.stack([rng.uniform(-0.1, 0.1, 64), rng.uniform(-0.3, 0.3, 64)],
                      -1).astype(np.float32)
    x = torch.as_tensor(x0, device=cuda)
    out = []
    for use in (True, False):
        sqp = DeviceSQP(sqp_iters=3, device=cuda, use_kernels=use, **kw)
        csqp = DeviceConstrainedSQP(sqp, **con)
        w = sqp.solve_words(sqp.init_words(64), x)
        wc, lam = csqp.solve_words(csqp.init_words(64), x)
        lanes = unpack_controls(w)[:, : sqp.n_dec].cpu().numpy()
        lc = unpack_controls(wc)[:, : sqp.n_dec].cpu().numpy()
        out.append((w, wc, lam, sqp.true_cost(x0, lanes), sqp.true_cost(x0, lc),
                    csqp.violation(x0, lc)))
    torch.cuda.synchronize()
    (k, p) = out
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    for i in (3, 4):
        np.testing.assert_allclose(k[i], p[i], rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(k[5], p[5], atol=5e-3)


@pytest.mark.parametrize("form", [dict(propagate="scan"), dict(propagate="allpairs"),
                                  dict(reduce="einsum"), dict(reduce="blocked"),
                                  dict(reduce="btrans")],
                         ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()))
def test_forms_on_the_card_at_cost_parity(cuda, form):
    """Each condensation form through the kernels on the card at cost
    parity with the default (unroll + sym) form, both solvers."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    x0 = _x0(64, 94)
    x = torch.as_tensor(x0, device=cuda)
    costs = []
    for f in (dict(), form):
        sqp = DeviceSQP(sqp_iters=2, device=cuda, **dict(SQP_KW, **f))
        csqp = DeviceConstrainedSQP(DeviceSQP(sqp_iters=2, device=cuda, **dict(
            SQP_KW, x_ref=np.array([1.0, 0.0, 0.0]), **f)), **CON)
        lanes = unpack_controls(sqp.solve_words(sqp.init_words(64), x))[:, :64].cpu().numpy()
        lc = unpack_controls(csqp.solve_words(csqp.init_words(64), x)[0])[:, :64].cpu().numpy()
        costs.append((sqp.true_cost(x0, lanes), csqp.dev.true_cost(x0, lc),
                      csqp.violation(x0, lc)))
    for i in (0, 1):
        np.testing.assert_allclose(costs[1][i], costs[0][i], rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(costs[1][2], costs[0][2], atol=5e-3)


def test_constrained_controller_on_the_card(cuda):
    """ConstrainedController through K7 every tick, bit-identical to the
    same loop on the CPU (word-space ALM), the velocity limit held."""
    from pint_tpu_torch.mpc import ConstrainedController, constrain_states, quantize_constrained

    model = pt.DoubleIntegrator()
    dt, T = model.dt, 32
    qp = condense_double_integrator(T=T, dt=dt, q_pos=4.0, u_max=127 * model.u_scale)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    q = quantize_constrained(constrain_states(
        qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-0.15, hi=0.15), rho=50.0)
    rng = np.random.default_rng(95)
    x0 = np.stack([rng.uniform(-1.5, 1.5, 300) * 2**16, rng.uniform(-0.1, 0.1, 300) * 2**16],
                  -1).astype(np.int32)
    runs = []
    for dev in (cuda, "cpu"):
        ctrl = ConstrainedController(q, plant_step=lambda s, u: model.step(s, u[..., 0]),
                                     device=dev)
        before = K.launch_counts()["alm_shared"]
        runs.append(ctrl.run(torch.as_tensor(x0), 30))
        if dev == cuda:
            assert K.launch_counts()["alm_shared"] == before + 30
    assert torch.equal(runs[0][0].cpu(), runs[1][0]) and torch.equal(runs[0][1].cpu(), runs[1][1])
    assert np.abs(runs[1][0].numpy()[..., 1] * 2.0**-16).max() < 0.15 + 0.01


# -- the host SQP tier, the LTI controllers on K2, the planners (chip_smoke.py
# phases 23-26 at small batches, the card against the CPU) ------------------------


def test_quantized_sqp_on_the_card(cuda):
    """QuantizedSQP (tests/test_ltv.py's unicycle, T = 32, 6 x 40) and its
    SQPController (10 ticks): words, cost histories, states and applied
    lanes bit-identical to the CPU's; no kernel launches (the reference's
    inner here is its XLA loop, whose torch form runs)."""
    import dataclasses

    sqp = pt.QuantizedSQP(device=cuda, **dict(SQP_KW, sqp_iters=6, pgd_iters=40))
    cpu = dataclasses.replace(sqp, device="cpu")
    x0 = _x0(24, 200).astype(np.float64)
    before = K.launch_counts()
    w, costs = sqp.solve(x0)
    assert w.device.type == torch.device(cuda).type and K.launch_counts() == before
    wc, cc = cpu.solve(x0)
    assert torch.equal(w.cpu(), wc) and np.array_equal(costs, cc)
    s, a = pt.SQPController(sqp).run(x0[:8], 10)
    sc, ac = pt.SQPController(cpu).run(x0[:8], 10)
    assert np.array_equal(s, sc) and np.array_equal(a, ac)


def test_constrained_sqp_on_the_card(cuda):
    """ConstrainedSQP (tests/test_sqp_constrained.py's binding corridor, two
    SQP iterations): words and multipliers bit-identical to the CPU's."""
    import dataclasses

    sqp = pt.QuantizedSQP(horizon=32, sqp_iters=2, pgd_iters=40,
                          x_ref=np.array([1.0, 0.0, 0.0]), device=cuda)
    csqp = pt.ConstrainedSQP(sqp, F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0,
                             alm_outer=4)
    ccpu = dataclasses.replace(csqp, sqp=dataclasses.replace(sqp, device="cpu"))
    rng = np.random.default_rng(201)
    x0 = np.stack([rng.uniform(-0.2, 0.2, 16), rng.uniform(-0.2, 0.2, 16),
                   rng.uniform(-np.pi, np.pi, 16)], -1)
    w, lam, costs = csqp.solve(x0)
    wc, lc, cc = ccpu.solve(x0)
    assert torch.equal(w.cpu(), wc) and torch.equal(lam.cpu(), lc)
    assert np.array_equal(costs, cc)


@pytest.mark.parametrize("B", [1, 17, 1000])
def test_receding_horizon_k2_every_tick(cuda, B):
    """RecedingHorizonController (double integrator, u_shift 10, T = 32, 12
    iterations) for 20 ticks: fused (K2 once a tick) = word-space on the
    card = the CPU's loop."""
    import dataclasses

    model = pt.DoubleIntegrator(u_shift=10)
    rhc = pt.RecedingHorizonController.build(model, horizon=32, iters_per_tick=12, device=cuda)
    fused = dataclasses.replace(rhc, use_fused=True)
    rng = np.random.default_rng(202 + B)
    x0 = model.to_fixed(np.stack([rng.uniform(-3, 3, B), rng.uniform(-1.5, 1.5, B)], -1))
    x_d = torch.as_tensor(x0, device=cuda)
    before = K.launch_counts()["fused_pgd"]
    sf, lf = fused.run(x_d, 20)
    assert K.launch_counts()["fused_pgd"] == before + 20
    su, lu = rhc.run(x_d, 20)
    sc, lc = dataclasses.replace(rhc, device="cpu").run(torch.as_tensor(x0), 20)
    assert torch.equal(sf, su) and torch.equal(lf, lu)
    assert torch.equal(sf.cpu(), sc) and torch.equal(lf.cpu(), lc)


@pytest.mark.parametrize("fused, ef", [(False, True), (True, False)])
def test_hover_lti_controller_on_the_card(cuda, fused, ef):
    """The quadrotor hover LTIController (T = 40, n 6, m 2, 25 iterations)
    for 40 ticks on 64 problems: with error feedback against the CPU's
    loop, fused (K2 once a tick) against the CPU's word-space loop without
    error feedback."""
    quad = pt.PlanarQuadrotor()
    A, Bm = quad.hover_lti()
    Q = np.diag([4.0, 4.0, 2.0, 0.5, 0.5, 0.5])
    qqp = quantize(pt.condense_lti(A, Bm, Q, 0.05, 10 * Q, 40, np.zeros(6), 100 * quad.f_scale))

    def make(device, use_fused):
        return pt.LTIController(qqp, plant_step=lambda s, u: quad.step(s, u[..., 0], u[..., 1]),
                                inputs_per_step=2, iters_per_tick=25, use_fused=use_fused,
                                error_feedback=ef, device=device)

    rng = np.random.default_rng(203)
    x0 = quad.to_fixed(rng.uniform(-0.3, 0.3, (64, 6)) * [1, 1, 0.1, 0.5, 0.5, 0.2])
    before = K.launch_counts()["fused_pgd"]
    s, lanes = make(cuda, fused).run(torch.as_tensor(x0, device=cuda), 40)
    assert K.launch_counts()["fused_pgd"] == before + (40 if fused else 0)
    sc, lc = make("cpu", False).run(torch.as_tensor(x0), 40)
    assert torch.equal(s.cpu(), sc) and torch.equal(lanes.cpu(), lc)


def test_mppi_on_the_card_at_cost_parity(cuda):
    """QuantizedMPPI (H 50, K 512, B 4): a 4-update plan on the card and on
    the CPU from the same seeded CPU generator (the same noise), at cost
    parity (rtol 0.01, atol 1e-4); candidates and rollouts of one update
    bit-identical."""
    import dataclasses

    model = pt.Unicycle(v_shift=10, w_shift=8)
    goals = np.array([[1.5, 0.8], [-1.0, 1.2], [0.3, -0.4], [1.2, -1.0]], np.float32)
    cost = pt.unicycle_goal_cost(model, goals[:, None, :])
    mppi = pt.QuantizedMPPI(model, horizon=50, samples=512, noise_lanes=30, device=cuda)
    cpu = dataclasses.replace(mppi, device="cpu")
    s0 = torch.zeros((4, 3), dtype=torch.int32)
    noise = mppi._sample_noise(torch.Generator().manual_seed(3), 4)
    w0 = torch.zeros((4, 25), dtype=torch.int32)
    got = mppi._rollouts(w0.to(cuda), noise, s0.to(cuda))
    want = cpu._rollouts(w0, noise.cpu(), s0)
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)
    w, _ = mppi.plan(torch.Generator().manual_seed(4), s0, cost, updates=4)
    wc, _ = cpu.plan(torch.Generator().manual_seed(4), s0, cost, updates=4)

    def plan_cost(words):
        ctrl = unpack_controls(words.cpu()).reshape(4, 50, 2)
        return cost(model.rollout(s0, ctrl), ctrl).numpy()

    np.testing.assert_allclose(plan_cost(w), plan_cost(wc), rtol=0.01, atol=1e-4)


def test_nonlinear_planner_on_the_card_at_cost_parity(cuda):
    """QuantizedNonlinearPGD (H 48, 60 iterations, goal + obstacle) on 64
    problems: the card's autograd gradient within rtol 1e-5 of the CPU's,
    the solves at cost parity (rtol 0.01, atol 1e-4)."""
    import dataclasses

    from pint_tpu_torch.mpc import costs as C

    model = pt.Unicycle(v_shift=10, w_shift=8)
    rng = np.random.default_rng(204)
    goals = np.stack([rng.uniform(1.2, 1.8, 64), rng.uniform(-0.4, 0.4, 64)], -1).astype(
        np.float32)
    cost = C.combine(C.goal_cost(model, goals),
                     C.obstacle_cost(model, [(0.8, 0.06)], radius=0.3))
    nl = pt.QuantizedNonlinearPGD(model, horizon=48, iters=60, device=cuda)
    cpu = dataclasses.replace(nl, device="cpu")
    u = (rng.uniform(-1, 1, (64, 48, 2)) * 127 * np.array([model.v_scale, model.w_scale])
         ).astype(np.float32)
    x0 = np.zeros((64, 3), np.float32)
    g = nl.grad(torch.as_tensor(u, device=cuda), torch.as_tensor(x0, device=cuda), cost)
    gc = cpu.grad(torch.as_tensor(u), torch.as_tensor(x0), cost)
    np.testing.assert_allclose(g.cpu().numpy(), gc.numpy(), rtol=1e-5,
                               atol=1e-5 * float(gc.abs().max()))
    s0 = torch.zeros((64, 3), dtype=torch.int32)
    w, st = nl.solve(s0, cost)
    wc, stc = cpu.solve(s0, cost)

    def traj_cost(words, states):
        ctrl = unpack_controls(words.cpu()).reshape(64, 48, 2).to(torch.float32)
        return cost(states.cpu(), ctrl).numpy()

    np.testing.assert_allclose(traj_cost(w, st), traj_cost(wc, stc), rtol=0.01, atol=1e-4)


# -- the native host tier against the SWAR kernels; checkpoint resume on K2;
# DeviceSQP's fused flag ------------------------------------------------------

@pytest.mark.parametrize("widths", SWAR_LAYOUTS, ids=str)
def test_native_ops_match_the_swar_kernels(cuda, widths):
    """``NativeOps`` (host C++) bit-identical to K1 and K9 on the card on
    the same full-range words, and for u64 layouts to K11a and K11b; its
    pack and unpacks to ``ops/word`` on the card."""
    from pint_tpu_torch.convert import words_to_numpy
    from pint_tpu_torch.native import NativeOps
    from pint_tpu_torch.ops.split64 import merge_u64

    lay = PackedLayout(*widths)
    nat = NativeOps(lay)
    a, b = _words(lay, (4099,), 41, cuda), _words(lay, (4099,), 42, cuda)
    na, nb = words_to_numpy(a), words_to_numpy(b)
    for op in S.BINOP_NAMES:
        want = getattr(nat, op)(na, nb)
        np.testing.assert_array_equal(words_to_numpy(S.binop(lay, op)(a, b)), want)
        if lay.word_bits == 64:
            got = merge_u64(S.binop_pair(lay, op)(split_u64(a), split_u64(b)))
            np.testing.assert_array_equal(words_to_numpy(got), want)
    for op in S.SHIFT_NAMES:
        for amount in (0, 1, 3, 7, 12, 100, -1):
            want = getattr(nat, op)(na, amount)
            np.testing.assert_array_equal(words_to_numpy(S.shift(lay, op)(a, amount)), want)
            if lay.word_bits == 64:
                got = merge_u64(S.shift_pair(lay, op)(split_u64(a), amount))
                np.testing.assert_array_equal(words_to_numpy(got), want)
    lanes = nat.unpack(na, signed=True)
    np.testing.assert_array_equal(
        words_to_numpy(W.pack(lay, torch.as_tensor(lanes, device=cuda))), nat.pack(lanes))
    np.testing.assert_array_equal(W.unpack(lay, a).to(torch.int64).cpu().numpy(),
                                  nat.unpack(na))
    np.testing.assert_array_equal(W.unpack_signed(lay, a).to(torch.int64).cpu().numpy(), lanes)


def test_k2_resume_from_solver_state(cuda, tmp_path):
    """FusedPGD: 15 iterations against 7, ``save_solver_state``,
    ``load_solver_state`` and 8 more, bit-identical, K2 launched in each
    solve."""
    from pint_tpu_torch.convert import words_from_numpy
    from pint_tpu_torch.utils.checkpoint import load_solver_state, save_solver_state

    qqp = quantize(condense_double_integrator(T=50))
    rng = np.random.default_rng(43)
    x0 = np.stack([rng.uniform(-3, 3, 1000), rng.uniform(-1, 1, 1000)], -1)
    g = torch.as_tensor(qqp.g_lane_fixed(x0), device=cuda)

    def solve(iters, words):
        before = K.launch_counts()["fused_pgd"]
        out = FusedPGD(qqp, iters=iters, device=cuda).solve_words(words, g)
        torch.cuda.synchronize()
        assert K.launch_counts()["fused_pgd"] == before + 1
        return out

    zero = torch.zeros((1000, qqp.padded // 4), dtype=torch.int32, device=cuda)
    want = solve(15, zero)
    part = solve(7, zero)
    save_solver_state(tmp_path / "s.npz", part, g, iters_done=7)
    u, g2, done, _ = load_solver_state(tmp_path / "s.npz")
    assert done == 7 and torch.equal(torch.as_tensor(g2, device=cuda), g)
    got = solve(15 - done, words_from_numpy(u, device=cuda))
    assert not torch.equal(part, want) and torch.equal(got, want)


def test_device_sqp_fused_false_equals_fused_none(cuda):
    """``fused=False`` (K3, then the word-space inner) bit-identical to the
    default (K3, then K4), K4 launched only by the default."""
    x0 = torch.as_tensor(_x0(512, 44), device=cuda)
    words, k4 = [], []
    for fused in (None, False):
        sqp = DeviceSQP(sqp_iters=4, fused=fused, device=cuda, **SQP_KW)
        before = K.launch_counts()
        words.append(sqp.solve_words(sqp.init_words(512), x0))
        torch.cuda.synchronize()
        after = K.launch_counts()
        assert after["lipq"] - before["lipq"] == 4
        k4.append(after["pgd_hqt"] - before["pgd_hqt"])
    assert k4 == [4, 0]
    assert torch.equal(words[0], words[1])


# -- the long forms on problem-major slabs: K3 past Tm 64, K4 and K5's cluster
# kernel -----------------------------------------------------------------------

LONG_BATCHES = [1, 7, 33, 1000, 4096, 4097]
SLAB_ORDERS = ["batch_last", "problem_major", "mixed"]


def _pm_rows0(x):
    """The (d0, d1, B) tensor ``x`` problem-major with rows along dim 0."""
    return x.permute(2, 0, 1).contiguous().permute(1, 2, 0)


def _pm_hqt(hqt):
    """``hqt`` (Tp, Tp, B) problem-major with rows j (dim 1)."""
    return hqt.permute(2, 1, 0).contiguous().permute(2, 1, 0)


@pytest.mark.parametrize("Tm", [67, 68, 192, 224, 228, 256, 272, 286])
@pytest.mark.parametrize("B", LONG_BATCHES)
def test_k3_long_form_bit_identical(cuda, B, Tm):
    """K3 past Tm 64 reads Ht problem-major (whole-slab bulk copies; 4-byte
    copies at the odd Tm 67) and writes hqt problem-major with rows j
    (16-byte stores where Tm % 16 == 0: 192, 224, 256, 272; words at 68 and
    228; bytes at 67 and 286): hqt, lip and h_max bit-identical to
    lipq_plain on the same view and on its batch-last copy."""
    gen = torch.Generator(device=cuda).manual_seed(7 * B + Tm)
    Ht = torch.randn((B, Tm, Tm), generator=gen, device=cuda).permute(1, 2, 0)
    got = lipq_fused(Ht, power_iters=16)
    torch.cuda.synchronize()
    assert K.problem_major(got[0], 1)
    for ref in (lipq_plain(Ht, power_iters=16), lipq_plain(Ht.contiguous(), power_iters=16)):
        for name, a, b in zip(("hqt", "lip", "h_max"), got, ref):
            assert torch.equal(a, b), name


def _orders(k5_args, order):
    """K5's operands with hqt, sqj, sqc in ``order``: all batch-last, all
    problem-major, or hqt problem-major and the rows batch-last (what the
    torch forms hand over at T = 144)."""
    a = list(k5_args)
    if order != "batch_last":
        a[2] = _pm_hqt(a[2])
    if order == "problem_major":
        a[3], a[4] = _pm_rows0(a[3]), _pm_rows0(a[4])
    return a


@pytest.mark.parametrize("order", ["batch_last", "problem_major"])
@pytest.mark.parametrize("Tp", [68, 256, 288, 632])
@pytest.mark.parametrize("B", LONG_BATCHES)
def test_k4_cluster_kernel_both_orders(cuda, B, Tp, order):
    """K4 past 64 lanes on hqt batch-last (byte gathers) and problem-major
    (16-byte copies at 256 and 288, 4-byte at 68 and 632; a second buffer
    at 68, 256 and 288, an L2 prefetch at 632, a cluster of 2), both
    entries against their plain versions."""
    from pint_tpu_torch.mpc import pgd_fused_words_pre, pgd_fused_words_pre_plain

    lanes, g_pre, hqt, hs_num, hs_den = _k4_operands(cuda, B, Tp, 3 * B + Tp)
    if order == "problem_major":
        hqt = _pm_hqt(hqt)
    kw = dict(iters=20, g_shift=12)
    got_lanes = pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    words = pack_controls(lanes)
    got_words = pgd_fused_words_pre(words, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_lanes, pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw))
    assert torch.equal(got_words,
                       pgd_fused_words_pre_plain(words, g_pre, hqt, hs_num, hs_den, **kw))


@pytest.mark.parametrize("order", SLAB_ORDERS)
@pytest.mark.parametrize("Tp, Cp", [(256, 128), (288, 192), (632, 4), (16, 1600)])
@pytest.mark.parametrize("B", LONG_BATCHES)
def test_k5_cluster_kernel_both_orders(cuda, B, Tp, Cp, order):
    """K5's cluster kernel on slabs batch-last, problem-major and mixed:
    one block a problem with two threads a row (256 x 128), one thread a
    row (288 x 192), clusters of two (632 x 4) and four (16 x 1600, 4-byte
    copies of the 16-byte rows of hqt); lanes and multipliers against
    alm_hqt_plain."""
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain

    args = _orders(_k5_operands(cuda, B, Tp, Cp, 5 * B + Tp + Cp), order)
    kw = dict(outer=2, inners=8, g_shift=12, y_shift=9)
    got = alm_hqt(*args, **kw)
    ref = alm_hqt_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_long_forms_refuse_other_orders(cuda):
    """Each wrapper raises on a memory order its kernel was not built for,
    and copies nothing: K3 past 64 on batch-last Ht and at 64 on
    problem-major Ht; K4 and K5 on a transposed view past 64 and on a
    problem-major slab at 64."""
    from pint_tpu_torch.mpc.fused_alm import alm_hqt

    B = 33
    with pytest.raises(ValueError, match="problem-major"):
        lipq_fused(torch.zeros((96, 96, B), device=cuda), power_iters=1)
    with pytest.raises(ValueError, match="contiguous"):
        lipq_fused(_pm_rows0(torch.zeros((64, 64, B), device=cuda)), power_iters=1)
    for Tp in (64, 256):
        lanes, g_pre, hqt, hs_num, hs_den = _k4_operands(cuda, B, Tp, Tp)
        bad = hqt.transpose(0, 1) if Tp > 64 else _pm_hqt(hqt)
        with pytest.raises(ValueError, match="hqt"):
            pgd_hqt(lanes, g_pre, bad, hs_num, hs_den, iters=1, g_shift=12)
    for Tp, Cp in ((64, 64), (256, 128)):
        args = list(_k5_operands(cuda, B, Tp, Cp, Tp + Cp))
        args[4] = args[4].transpose(0, 1).contiguous().transpose(0, 1) if Tp > 64 \
            else _pm_rows0(args[4])
        with pytest.raises(ValueError, match="sqc"):
            alm_hqt(*args, outer=1, inners=1, g_shift=12, y_shift=9)


def test_long_solves_hand_over_problem_major(cuda):
    """At T = 128 the condensation hands K3 the problem-major view of Hb
    (no batch-last copy), K3 and K6 hand K4 and K5 problem-major slabs, and
    K6's cluster kernel runs no transpose kernel; at T = 32 everything stays
    batch-last (K6's register kernel writes it so)."""
    from pint_tpu_torch.mpc import DeviceConstrainedSQP

    for T, pm in ((128, True), (32, False)):
        csqp = DeviceConstrainedSQP(DeviceSQP(
            horizon=T, sqp_iters=1, pgd_iters=30, x_ref=np.array([1.0, 0.0, 0.0]),
            device=cuda), **CON)
        d, B = csqp.dev, 33
        x0 = torch.as_tensor(_con_x0(B, 31), device=cuda)
        lanes = torch.zeros((B, d.n_dec), dtype=torch.int32, device=cuda)
        Ht, _ = d._condense_ht(x0, lanes)
        assert K.problem_major(Ht, 0) == pm and Ht.is_contiguous() != pm
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            ops, _ = csqp._condense_constrained_dev(x0, lanes)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        assert not any("pen_transpose" in n for n in names)
        assert K.problem_major(ops["hqt"], 1) == pm
        for k in ("sqc", "sqj"):
            assert K.problem_major(ops[k], 0) == pm
