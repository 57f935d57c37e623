#!/usr/bin/env python3
"""Drive the PyTorch port's SWAR substrate and serving path once on one H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. device check: a CUDA card of compute capability 9.0, its name and power
   limit from nvidia-smi; TF32 off;
2. build: the kernels under pint_tpu_torch/csrc/ with nvcc, one process a
   source;
3. substrate: the SWAR kernels K1 (binop), K9 (shift), K8 (saturating
   accumulate) and their u64 pair forms K11a-c, each against its plain
   PyTorch version on 1Mi full-range random words and against the per-lane
   Oracle on 2048 canonical words, on the layouts <8,8,8,8>,
   <1,2,3,4,5,6,11>, <5,6,5> (u16), <3,3> (u8), <8 x 8> (u64) and
   <20,20,24> (u64); bit-identical.  Then a user's PackedArray flow on the
   card (pack, add/sub saturate, min/max, shifts, get_signed, slice_lanes,
   lanes, the fused accumulate and the pair entries), equal to the same
   flow on the CPU;
4. headline (bench.py:_run_headline): raw int32 add, K1
   add_unsigned_saturate on <8,8,8,8> at 16Mi words, raw add again, by CUDA
   events, K1 at no less than 0.9 of the raw add's word rate; the u64
   family at 8Mi <8 x 8> words; K9 and K8 (steps = 4).  Each kernel timed
   here is first held bit-identical to its plain version on the inputs it
   is timed on;
5. kernel checks at the serving shapes, each kernel against its plain
   PyTorch version on the card, with CUDA-event times of both:
   K2 fused PGD (B = 8192, Tp = 64, 15 and 40 iterations, momentum off and
   on; bit-identical), K3 lipq and K4 PGD inner on one real DeviceSQP
   condensation (B = 4096, Tm = 64; K3's hqt and h_max bit-identical, lip
   rtol 1e-5; K4 bit-identical);
6. MPCService: LTI double integrator, T = 50 (Tp = 64), batch 8192, 15 PGD
   iterations a tick, 10 ticks;
7. RTIService: unicycle DeviceSQP, T = 32, batch 4096, 1 SQP x 30 PGD a
   tick, 10 ticks;
8. the flagship DeviceSQP solve, 4 SQP x 30 PGD, batch 4096, once through
   the kernels and once through the plain versions, held to cost parity
   (rtol 0.01, atol 1e-4).

Launch counts are set to 0 before each main path and read after it: the
PackedArray flow must launch every SWAR kernel, phases 6-7 every serving
kernel.  The line before the last is the kernels' JSON record; the last
line is ``{"ok": true, "device": {...}}``.  Inputs are made from fixed seeds.
"""

import json
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

import numpy as np

ROOT = Path(__file__).resolve().parent

LTI_BATCH, RTI_BATCH, TICKS = 8192, 4096, 10
DEVICE = "cuda"
SWAR_LAYOUTS = [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (5, 6, 5), (3, 3),
                (8,) * 8, (20, 20, 24)]
SHIFT_AMOUNTS = (0, 1, 3, 7, 12, 100, -1)
N_CHECK, N_ORACLE = 1 << 20, 2048
N_HEADLINE, N_U64, ACCUM_STEPS = 1 << 24, 1 << 23, 4
SPEED_OF_LIGHT_MIN = 0.9      # K1's word rate over the raw int32 add's
SQP_KW = dict(
    horizon=32, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)


def say(*parts):
    print(*parts, flush=True)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), card has {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build(K):
    t0 = time.perf_counter()
    so = K.build()
    K.library()
    sec = time.perf_counter() - t0
    say(f"build: {so.name} in {sec:.2f} s")


def rand_words(torch, W, lay, shape, seed):
    """Full-range random words in the layout's container, on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    info = torch.iinfo(W.container_dtype(lay))
    high = info.max + 1 if info.bits < 64 else info.max   # randint's high is int64
    w = torch.randint(info.min, high, shape, generator=g, dtype=torch.int64,
                      device=DEVICE)
    return w.to(W.container_dtype(lay))


def same(torch, what, got, ref):
    """Raises unless ``got`` equals ``ref`` bit for bit."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.equal(got, ref):
        bad = int((got != ref).sum()) if got.shape == ref.shape else "shape"
        raise AssertionError(f"{what}: kernel differs from its reference ({bad})")


def phase_substrate(torch, P):
    """Every SWAR kernel against its plain version (1Mi full-range words)
    and against the Oracle (canonical words), on every listed layout."""
    from pint_tpu_torch.convert import words_to_numpy
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops import word as W
    from pint_tpu_torch.ops.split64 import merge_u64, split_u64
    from pint_tpu_torch.utils import Oracle

    checked = dict.fromkeys(P.ops.kernels.SWAR_KERNELS, 0)

    def held(name, what, got, ref):
        same(torch, f"{name} {what}", got, ref)
        checked[name] += 1

    def u64(t):
        return words_to_numpy(t).astype(np.uint64)

    for seed, widths in enumerate(SWAR_LAYOUTS):
        lay = P.PackedLayout(*widths)
        ora = Oracle(lay)
        wide = lay.word_bits == 64
        a = rand_words(torch, W, lay, (N_CHECK,), 10 * seed)
        b = rand_words(torch, W, lay, (N_CHECK,), 10 * seed + 1)
        d = rand_words(torch, W, lay, (ACCUM_STEPS, N_CHECK), 10 * seed + 2)
        used = W._k(lay, lay.used_mask)
        ca, cb, cd = a[:N_ORACLE] & used, b[:N_ORACLE] & used, d[:, :N_ORACLE] & used
        na, nb = u64(ca), u64(cb)
        for op in S.BINOP_NAMES:
            got = S.binop(lay, op)(a, b)
            held("swar_binop", f"{op} {widths}", got, S.binop_plain(lay, op, a, b))
            exp = getattr(ora, op)(na, nb)
            if not np.array_equal(u64(S.binop(lay, op)(ca, cb)), exp):
                raise AssertionError(f"swar_binop {op} {widths}: differs from Oracle")
            if wide:
                pa, pb = split_u64(a), split_u64(b)
                held("swar_binop_pair", f"{op} {widths}", S.binop_pair(lay, op)(pa, pb),
                     S.binop_plain(lay, op, pa, pb, pair=True))
                held("swar_binop_pair", f"{op} {widths} vs native",
                     merge_u64(S.binop_pair(lay, op)(pa, pb)), got)
        for op in S.SHIFT_NAMES:
            for amt in SHIFT_AMOUNTS:
                got = S.shift(lay, op)(a, amt)
                held("swar_shift", f"{op}({amt}) {widths}", got,
                     S.shift_plain(lay, op, a, amt))
                held("swar_shift", f"{op}(card amount {amt}) {widths}",
                     S.shift(lay, op)(a, torch.tensor(amt, device=DEVICE)), got)
                exp = getattr(ora, op)(na, amt & 0xFFFFFFFF)
                if not np.array_equal(u64(S.shift(lay, op)(ca, amt)), exp):
                    raise AssertionError(f"swar_shift {op}({amt}) {widths}: "
                                         "differs from Oracle")
                if wide:
                    pa = split_u64(a)
                    held("swar_shift_pair", f"{op}({amt}) {widths}",
                         S.shift_pair(lay, op)(pa, amt),
                         S.shift_plain(lay, op, pa, amt, pair=True))
        for signed in (False, True):
            fn = S.saturating_accumulate(lay, signed=signed, steps=ACCUM_STEPS)
            got = fn(a, d)
            held("swar_sat_accum", f"signed={signed} {widths}", got,
                 S.sat_accum_plain(lay, signed, a, d))
            f = ora.add_signed_saturate if signed else ora.add_unsigned_saturate
            exp = na
            for s in range(ACCUM_STEPS):
                exp = f(exp, u64(cd[s]))
            if not np.array_equal(u64(fn(ca, cd)), exp):
                raise AssertionError(f"swar_sat_accum signed={signed} {widths}: "
                                     "differs from Oracle")
            if wide:
                pa, pd = split_u64(a), split_u64(d)
                held("swar_sat_accum_pair", f"signed={signed} {widths}", fn(pa, pd),
                     S.sat_accum_plain(lay, signed, pa, pd))
                held("swar_sat_accum_pair", f"signed={signed} {widths} vs native",
                     merge_u64(fn(pa, pd)), got)
        say(f"substrate {widths} u{lay.word_bits}: 10 binops, 2 shifts x "
            f"{len(SHIFT_AMOUNTS)} amounts, accumulate x2"
            f"{', and their pair forms' if wide else ''}: bit-identical to the "
            f"plain versions ({N_CHECK} words) and the Oracle ({N_ORACLE})")
    say("substrate checks: " + ", ".join(f"{k} {v}" for k, v in checked.items()))


def packed_flow(torch, P, device):
    """What a user of the library does (examples/quickstart.py:18-35), on
    ``device``; returns every result on the host."""
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops.split64 import merge_u64, split_u64

    out = {}
    lay = P.PackedLayout(5, 6, 5)
    a = P.PackedArray.pack(lay, 1, 20, 10, device=device)
    b = P.PackedArray.pack(lay, 30, 60, 20, device=device)
    out["wrap"] = P.add_wrap(a, b).lanes()
    out["sat_u"] = P.add_unsigned_saturate(a, b).lanes()
    out["min_u"] = P.min_unsigned(a, b).lanes()
    out["shl2"] = P.shift_left(a, 2).lanes()
    words = torch.arange(1 << 16, dtype=torch.int32, device=device) * 40503
    x = P.PackedArray.from_words(P.PackedLayout(8, 8, 8, 8), words)
    y = P.add_signed_saturate(x, x)
    z = P.max_signed(P.sub_signed_saturate(y, x), P.min_unsigned(x, y))
    z = P.shift_right_unsigned(z, torch.tensor(3, device=device))
    z = P.sub_unsigned_saturate(P.add_wrap(z, x), P.sub_wrap(x, y))
    out["get_signed"] = P.get_signed(z, 3)
    out["slice"] = P.slice_lanes(z, 1, 3).lanes()
    deltas = torch.stack([y.word, z.word, x.word, y.word])
    acc = S.saturating_accumulate(x.layout, signed=True, steps=4)(z.word, deltas)
    out["accumulate"] = P.PackedArray(acc, x.layout).lanes_signed()
    lay64 = P.PackedLayout(20, 20, 24)
    w64 = P.PackedArray.from_words(lay64, words.to(torch.int64) * 0x9E3779B97F4A7C15)
    v64 = P.shift_left(P.add_signed_saturate(w64, w64), 5)
    p = split_u64(v64.word)
    q = S.binop_pair(lay64, "min_signed")(p, split_u64(w64.word))
    q = S.shift_pair(lay64, "shift_right_unsigned")(q, 7)
    q = S.saturating_accumulate(lay64, signed=False, steps=2)(q, torch.stack([p, q], 1))
    out["u64"] = P.PackedArray(merge_u64(q), lay64).lanes()
    return {k: v.cpu() for k, v in out.items()}


def phase_packed_flow(torch, P, K):
    K.reset_launch_counts()                     # main path starts here
    got = packed_flow(torch, P, DEVICE)
    torch.cuda.synchronize()
    counts = K.launch_counts()                  # main path ends here
    for name in K.SWAR_KERNELS:
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the PackedArray flow")
    ref = packed_flow(torch, P, "cpu")
    for k in ref:
        if not torch.equal(got[k], ref[k]):
            raise AssertionError(f"PackedArray flow: {k} on the card differs from the CPU")
    quick = {"wrap": [31, 16, 30], "sat_u": [31, 63, 30], "min_u": [1, 20, 10],
             "shl2": [4, 16, 8]}                # examples/quickstart.py's values
    for k, v in quick.items():
        if got[k].tolist() != v:
            raise AssertionError(f"PackedArray flow: {k} = {got[k].tolist()}, not {v}")
    say("PackedArray flow on the card equals the CPU flow and quickstart's values; "
        "launches: " + ", ".join(f"{k} {counts[k]}" for k in K.SWAR_KERNELS))
    return {k: counts[k] for k in K.SWAR_KERNELS}


def chain_ms(torch, fn, x, *rest, inner=20, reps=7):
    """Median CUDA-event ms of one call in a chain ``x = fn(x, *rest)``."""
    for _ in range(2):
        x = fn(x, *rest)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            x = fn(x, *rest)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return median(out)


def phase_headline(torch, P):
    """bench.py:_run_headline on the card, and the other SWAR kernels' times.
    Each timed kernel is first held bit-identical to its plain version on the
    inputs it is timed on."""
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops import word as W
    from pint_tpu_torch.ops.split64 import split_u64
    from pint_tpu_torch.utils.profiling import roofline_report

    def timed(name, kernel, plain, *args, plain_inner=3):
        """(kernel ms, plain ms) of a chain on ``args``, after one call of
        each on them is held bit-identical."""
        same(torch, f"{name} at {tuple(args[0].shape)}", kernel(*args), plain(*args))
        return (chain_ms(torch, kernel, *args),
                chain_ms(torch, plain, *args, inner=plain_inner, reps=5))

    lay = P.PackedLayout(8, 8, 8, 8)
    n = N_HEADLINE
    a = rand_words(torch, W, lay, (n,), 100)
    b = rand_words(torch, W, lay, (n,), 101)
    add = S.binop(lay, "add_unsigned_saturate")
    add_plain = lambda x, y: S.binop_plain(lay, "add_unsigned_saturate", x, y)
    same(torch, f"swar_binop add_unsigned_saturate at ({n},)", add(a, b), add_plain(a, b))
    raw_pre = chain_ms(torch, torch.add, a, b)
    k1 = chain_ms(torch, add, a, b)
    raw_post = chain_ms(torch, torch.add, a, b)
    k1_plain = chain_ms(torch, add_plain, a, b, inner=5, reps=5)
    raw_wps = n / (0.5 * (raw_pre + raw_post) / 1e3)
    wps = n / (k1 / 1e3)
    res = {
        "baseline_raw_u32_add_Gwords_per_s": raw_wps / 1e9,
        "addsat_u8x4_Gwords_per_s": wps / 1e9,
        "addsat_u8x4_Glanes_per_s": wps * lay.num_lanes / 1e9,
        "addsat_u8x4_vs_speed_of_light": wps / raw_wps,
        "addsat_u8x4_plain_Gwords_per_s": n / (k1_plain / 1e3) / 1e9,
        "addsat_u8x4_GB_per_s": wps * 12 / 1e9,
        "baseline_raw_u32_add_GB_per_s": raw_wps * 12 / 1e9,
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alu = sms * 64 * float(smi) * 1e6         # 64 int32 lanes an SM a clock
    roof = roofline_report(lay, {"add_unsigned_saturate": wps}, raw_wps * 12, alu)
    for k, v in res.items():
        say(f"headline {k} = {v}")
    say(f"headline roofline (memory bound = the raw add's {raw_wps * 12 / 1e9:.1f} GB/s, "
        f"ALU bound = {sms} SMs x 64 x {smi} MHz): {json.dumps(roof)}")
    if not res["addsat_u8x4_vs_speed_of_light"] >= SPEED_OF_LIGHT_MIN:
        raise AssertionError(
            f"K1 at {res['addsat_u8x4_vs_speed_of_light']:.3f} of the raw add, below "
            f"the limit {SPEED_OF_LIGHT_MIN}")

    times = {"swar_binop": (k1, k1_plain)}
    times["swar_shift"] = timed(
        "swar_shift shift_left(3)", S.shift(lay, "shift_left"),
        lambda x, k: S.shift_plain(lay, "shift_left", x, k), a, 3, plain_inner=5)
    d = rand_words(torch, W, lay, (ACCUM_STEPS, n), 102)
    times["swar_sat_accum"] = timed(
        f"swar_sat_accum steps={ACCUM_STEPS}",
        S.saturating_accumulate(lay, signed=False, steps=ACCUM_STEPS),
        lambda x, y: S.sat_accum_plain(lay, False, x, y), a, d)
    say(f"K9 shift_left(3) <8,8,8,8> {n} words: kernel {times['swar_shift'][0]:.4f} ms, "
        f"plain {times['swar_shift'][1]:.4f} ms; K8 unsigned steps={ACCUM_STEPS}: "
        f"kernel {times['swar_sat_accum'][0]:.4f} ms, plain "
        f"{times['swar_sat_accum'][1]:.4f} ms")

    lay64 = P.PackedLayout(*([8] * 8))
    a64 = rand_words(torch, W, lay64, (N_U64,), 103)
    b64 = rand_words(torch, W, lay64, (N_U64,), 104)
    pa, pb = split_u64(a64), split_u64(b64)
    add64 = S.binop(lay64, "add_unsigned_saturate")
    same(torch, f"swar_binop u64 add_unsigned_saturate at ({N_U64},)", add64(a64, b64),
         S.binop_plain(lay64, "add_unsigned_saturate", a64, b64))
    native = chain_ms(torch, add64, a64, b64)
    pair, pair_plain = timed(
        "swar_binop_pair add_unsigned_saturate", S.binop_pair(lay64, "add_unsigned_saturate"),
        lambda x, y: S.binop_plain(lay64, "add_unsigned_saturate", x, y, pair=True), pa, pb)
    lanes = N_U64 * 8
    res["addsat_u8x8_u64_native_Glanes_per_s"] = lanes / (native / 1e3) / 1e9
    res["addsat_u8x8_u64_pair_Glanes_per_s"] = lanes / (pair / 1e3) / 1e9
    res["addsat_u8x8_u64_pair_plain_Glanes_per_s"] = lanes / (pair_plain / 1e3) / 1e9
    times["swar_binop_pair"] = (pair, pair_plain)
    times["swar_shift_pair"] = timed(
        "swar_shift_pair shift_left(3)", S.shift_pair(lay64, "shift_left"),
        lambda x, k: S.shift_plain(lay64, "shift_left", x, k, pair=True), pa, 3)
    pd = split_u64(rand_words(torch, W, lay64, (ACCUM_STEPS, N_U64), 105))
    times["swar_sat_accum_pair"] = timed(
        f"swar_sat_accum_pair steps={ACCUM_STEPS}",
        S.saturating_accumulate(lay64, signed=False, steps=ACCUM_STEPS),
        lambda x, y: S.sat_accum_plain(lay64, False, x, y), pa, pd)
    for k in ("addsat_u8x8_u64_native_Glanes_per_s", "addsat_u8x8_u64_pair_Glanes_per_s",
              "addsat_u8x8_u64_pair_plain_Glanes_per_s"):
        say(f"u64 family <8 x 8> {N_U64} words: {k} = {res[k]}")
    say(f"K11b shift_pair(3): kernel {times['swar_shift_pair'][0]:.4f} ms, plain "
        f"{times['swar_shift_pair'][1]:.4f} ms; K11c pair steps={ACCUM_STEPS}: kernel "
        f"{times['swar_sat_accum_pair'][0]:.4f} ms, plain "
        f"{times['swar_sat_accum_pair'][1]:.4f} ms")
    return res, times


def lti_states(rng, b):
    return np.stack([rng.uniform(-3, 3, b), rng.uniform(-1, 1, b)], axis=-1)


def rti_states(rng, b):
    return np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                     rng.uniform(0, 1, b)], axis=-1)


def phase_k2(torch, P, timing):
    from pint_tpu_torch.mpc import FusedPGD, fused_pgd, fused_pgd_plain

    qqp = P.quantize(P.condense_double_integrator(T=50))
    rng = np.random.default_rng(1)
    dev = torch.device(DEVICE)
    g = torch.as_tensor(qqp.g_lane_fixed(lti_states(rng, LTI_BATCH)), device=dev)
    lanes = torch.as_tensor(
        rng.integers(-128, 128, (LTI_BATCH, qqp.padded), dtype=np.int32),
        device=dev)
    hq = torch.as_tensor(qqp.Hq, device=dev)
    beta = FusedPGD(qqp).beta_num
    rec = {}
    for iters in (15, 40):
        for momentum in (False, True):
            kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift,
                      iters=iters, momentum=momentum, beta_num=beta)
            out = fused_pgd(lanes, g, hq, **kw)
            ref = fused_pgd_plain(lanes, g, hq, **kw)
            torch.cuda.synchronize()
            err = int((out - ref).abs().max())
            if err:
                raise AssertionError(f"K2 iters={iters} momentum={momentum}: "
                                     f"max |kernel - plain| = {err}")
            ms = median(timing.cuda_ms(lambda: fused_pgd(lanes, g, hq, **kw)))
            pms = median(timing.cuda_ms(
                lambda: fused_pgd_plain(lanes, g, hq, **kw), reps=5))
            key = f"iters{iters}_momentum{int(momentum)}"
            rec[key] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
            say(f"K2 fused_pgd B={LTI_BATCH} Tp={qqp.padded} {key}: bit-identical; "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return rec


def phase_k3_k4(torch, P, timing):
    from pint_tpu_torch.mpc import lipq_fused, lipq_plain, pgd_hqt, pgd_hqt_plain
    from pint_tpu_torch.mpc.condense_fused import true_div

    sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **SQP_KW)
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor(rti_states(rng, RTI_BATCH), dtype=torch.float32,
                         device=DEVICE)
    lanes = torch.as_tensor(
        rng.integers(-60, 61, (RTI_BATCH, sqp.n_dec), dtype=np.int32),
        device=DEVICE)
    Ht, g = sqp._condense_ht(x0, lanes)
    it = sqp.power_iters
    hqt, lip, hmax = lipq_fused(Ht, power_iters=it)
    hqt_p, lip_p, hmax_p = lipq_plain(Ht, power_iters=it)
    torch.cuda.synchronize()
    if not torch.equal(hqt, hqt_p) or not torch.equal(hmax, hmax_p):
        raise AssertionError(
            f"K3: {int((hqt != hqt_p).sum())} hqt entries and "
            f"{int((hmax != hmax_p).sum())} h_max entries differ from the "
            "plain version")
    lip_rel = float(((lip - lip_p).abs() / lip_p.abs()).max())
    if not lip_rel <= 1e-5:
        raise AssertionError(f"K3: lip max relative error {lip_rel} > 1e-5")
    k3_err = float((lip - lip_p).abs().max())
    lip_differ = int((lip != lip_p).sum())
    k3_ms = median(timing.cuda_ms(lambda: lipq_fused(Ht, power_iters=it)))
    k3_pms = median(timing.cuda_ms(
        lambda: lipq_plain(Ht, power_iters=it), reps=5))
    say(f"K3 lipq Tm={sqp.n_dec} B={RTI_BATCH}: hqt, h_max bit-identical, lip "
        f"max rel err {lip_rel:.3e} ({lip_differ} of {RTI_BATCH} differ in bits); "
        f"kernel {k3_ms:.4f} ms, plain {k3_pms:.4f} ms")

    alpha = true_div(1.0, lip)
    g_pre = sqp._g_pre_from(g, alpha)
    hs_num, hs_den = sqp._step_rationals(true_div(alpha * hmax, 127.0))
    kw = dict(iters=sqp.pgd_iters, g_shift=sqp.g_shift)
    out = pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    ref = pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw)
    torch.cuda.synchronize()
    k4_err = int((out - ref).abs().max())
    if k4_err:
        raise AssertionError(f"K4: max |kernel - plain| = {k4_err}")
    k4_ms = median(timing.cuda_ms(
        lambda: pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, **kw)))
    k4_pms = median(timing.cuda_ms(
        lambda: pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, **kw), reps=5))
    say(f"K4 pgd_hqt Tp={sqp.n_dec} B={RTI_BATCH} iters={sqp.pgd_iters}: "
        f"bit-identical; kernel {k4_ms:.4f} ms, plain {k4_pms:.4f} ms")
    return (dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_pms,
                 lip_differ=lip_differ),
            dict(max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_pms))


def phase_mpc(torch, P, K):
    qqp = P.quantize(P.condense_double_integrator(T=50))
    x0 = lti_states(np.random.default_rng(0), LTI_BATCH)
    # reference: the same first tick through the word-space solver (no kernel)
    ref = P.MPCService(qqp, batch=LTI_BATCH, iters_per_tick=15, use_fused=False,
                       device=DEVICE).solve(x0)
    K.reset_launch_counts()                     # serving path starts here
    svc = P.MPCService(qqp, batch=LTI_BATCH, iters_per_tick=15, device=DEVICE)
    if not (svc.g_on_device and type(svc._solver).__name__ == "FusedPGD"):
        raise AssertionError("MPCService on cuda did not select the K2 route")
    lat, first = [], None
    for _ in range(TICKS):
        u = svc.solve(x0)
        lat.append(svc.stats.last_latency_s * 1e3)
        first = u if first is None else first
        if u.shape != (LTI_BATCH, 50) or not np.isfinite(u).all():
            raise AssertionError("MPCService: controls not finite / bad shape")
        if np.abs(u).max() > qqp.qp.u_max + 1e-12:
            raise AssertionError("MPCService: controls outside the box")
    if not np.array_equal(first, ref):
        raise AssertionError("MPCService: first tick differs from word solver")
    n = K.launch_counts()["fused_pgd"]
    if n != TICKS:
        raise AssertionError(f"MPCService: K2 launched {n} times in {TICKS} ticks")
    rec = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), ticks=TICKS,
               deadline_misses=svc.stats.deadline_misses)
    say(f"MPCService B={LTI_BATCH} T=50 15 it/tick: {TICKS} ticks, first tick "
        f"equals the word solver; K2 +{n}; tick p50 {rec['p50_ms']:.3f} ms, "
        f"p99 {rec['p99_ms']:.3f} ms")
    return rec


def phase_rti(torch, P, K):
    sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **SQP_KW)
    rti = P.RTIService(sqp, batch=RTI_BATCH)
    x0 = rti_states(np.random.default_rng(0), RTI_BATCH)
    before = K.launch_counts()
    lat = []
    box = 127 * np.asarray(sqp.model.lane_scales) + 1e-12
    for _ in range(TICKS):
        u = rti.solve(x0)
        lat.append(rti.stats.last_latency_s * 1e3)
        if u.shape != (RTI_BATCH, 2) or not np.isfinite(u).all():
            raise AssertionError("RTIService: controls not finite / bad shape")
        if (np.abs(u) > box).any():
            raise AssertionError("RTIService: controls outside the box")
    after = K.launch_counts()
    for k in ("lipq", "pgd_hqt"):
        if after[k] - before[k] != TICKS:
            raise AssertionError(f"RTIService: {k} +{after[k] - before[k]}")
    rec = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), ticks=TICKS,
               deadline_misses=rti.stats.deadline_misses)
    say(f"RTIService B={RTI_BATCH} T=32 1x30/tick: {TICKS} ticks; K3 +{TICKS}, "
        f"K4 +{TICKS}; tick p50 {rec['p50_ms']:.3f} ms, p99 {rec['p99_ms']:.3f} ms")
    return rec


def phase_flagship(torch, P, timing):
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.mpc.ltv import true_cost

    kern = P.DeviceSQP(sqp_iters=4, device=DEVICE, **SQP_KW)
    plain = P.DeviceSQP(sqp_iters=4, device=DEVICE, use_kernels=False, **SQP_KW)
    x0 = rti_states(np.random.default_rng(0), RTI_BATCH).astype(np.float32)
    x0_t = torch.as_tensor(x0, device=DEVICE)
    u0 = kern.init_words(RTI_BATCH)
    out = {}
    for name, sqp in (("kernels", kern), ("plain", plain)):
        words = sqp.solve_words(u0, x0_t)
        lanes = unpack_controls(words)[:, : sqp.n_dec].cpu().numpy()
        out[name] = (words, true_cost(sqp, x0, lanes))
        ms = median(timing.host_ms(lambda: sqp.solve_words(u0, x0_t), reps=5))
        out[name + "_solves_per_s"] = RTI_BATCH / (ms / 1e3)
        out[name + "_ms"] = ms
    ck, cp = out["kernels"][1], out["plain"][1]
    cold = true_cost(kern, x0, np.zeros((RTI_BATCH, kern.n_dec), np.int32))
    if not (np.isfinite(ck).all() and ck.mean() < cold.mean()):
        raise AssertionError("flagship: costs not finite or no better than cold")
    np.testing.assert_allclose(ck, cp, rtol=0.01, atol=1e-4)
    differ = int((out["kernels"][0] != out["plain"][0]).any(-1).sum().item())
    rec = dict(
        solves_per_s=out["kernels_solves_per_s"], ms=out["kernels_ms"],
        plain_solves_per_s=out["plain_solves_per_s"], plain_ms=out["plain_ms"],
        max_rel_cost_diff=float(np.max(np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-12))),
        problems_differing=differ, mean_cost=float(ck.mean()),
        mean_cold_cost=float(cold.mean()),
    )
    say(f"flagship DeviceSQP B={RTI_BATCH} T=32 4x30: cost parity with the plain "
        f"path (max rel diff {rec['max_rel_cost_diff']:.3e}, {differ} problems "
        f"differ in bits); kernels {rec['solves_per_s']:.1f} solves/s "
        f"({rec['ms']:.3f} ms), plain {rec['plain_solves_per_s']:.1f} solves/s")
    return rec


def main():
    if not (ROOT / "pint_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: pint_tpu_torch/ is not beside this script")
    sys.path.insert(0, str(ROOT))
    import torch

    phase_device(torch)
    import pint_tpu_torch as P
    from pint_tpu_torch.ops import kernels as K
    from pint_tpu_torch.utils import timing

    if ROOT not in Path(P.__file__).resolve().parents:
        raise SystemExit(f"chip_smoke.py: imported {P.__file__}, not this checkout")
    phase_build(K)
    phase_substrate(torch, P)
    swar_launches = phase_packed_flow(torch, P, K)
    headline, swar_times = phase_headline(torch, P)
    k2 = phase_k2(torch, P, timing)
    k3, k4 = phase_k3_k4(torch, P, timing)
    mpc = phase_mpc(torch, P, K)
    rti = phase_rti(torch, P, K)
    counts = K.launch_counts()                  # serving path ends here
    for name in ("fused_pgd", "pgd_hqt", "lipq"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the serving path")
    flagship = phase_flagship(torch, P, timing)

    replaces = {
        "swar_binop": ("K1", "pint_tpu/ops/pallas.py:148"),
        "swar_shift": ("K9", "pint_tpu/ops/pallas.py:306"),
        "swar_sat_accum": ("K8", "pint_tpu/ops/pallas.py:407"),
        "swar_binop_pair": ("K11a", "pint_tpu/ops/pallas.py:222"),
        "swar_shift_pair": ("K11b", "pint_tpu/ops/pallas.py:341"),
        "swar_sat_accum_pair": ("K11c", "pint_tpu/ops/pallas.py:469"),
    }
    kernels = [   # every check above is bit-identity, so the error is 0
        dict(name=f"{name} ({kid})", route="cuda", source="pint_tpu_torch/csrc/swar.cu",
             replaces=line, launches=swar_launches[name], max_abs_err=0.0,
             ms=swar_times[name][0], plain_ms=swar_times[name][1])
        for name, (kid, line) in replaces.items()
    ]
    k2_main = k2["iters15_momentum0"]
    kernels += [
        dict(name="fused_pgd (K2)", route="cuda",
             source="pint_tpu_torch/csrc/fused_pgd.cu",
             replaces="pint_tpu/mpc/fused.py:119", launches=counts["fused_pgd"],
             max_abs_err=max(r["max_abs_err"] for r in k2.values()),
             ms=k2_main["ms"], plain_ms=k2_main["plain_ms"]),
        dict(name="lipq (K3)", route="cuda", source="pint_tpu_torch/csrc/lipq.cu",
             replaces="pint_tpu/mpc/condense_fused.py:77",
             launches=counts["lipq"], max_abs_err=k3["max_abs_err"],
             ms=k3["ms"], plain_ms=k3["plain_ms"]),
        dict(name="pgd_hqt (K4)", route="cuda",
             source="pint_tpu_torch/csrc/pgd_hqt.cu",
             replaces="pint_tpu/mpc/fused_alm.py:402",
             launches=counts["pgd_hqt"], **k4),
    ]
    name = torch.cuda.get_device_name(0)
    say(json.dumps({"headline": headline}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
