#!/usr/bin/env python3
"""The MPC kernels K2 and K2p (fused_pgd, fused_pgd_packed), K3 (lipq), K4's
words entry (pgd_fused_words_pre), K5 (alm_hqt), K6 (pen_fused), K7
(alm_shared) and K10 (pgd_matvec_cols) of one pint_tpu_torch checkout on one
card:
their device time against their iteration counts, and the device time of
the solves they serve.

    python3 exp_torch_kernels.py [--root DIR] [--out FILE]

``--root`` names the checkout whose package is measured (default: this
one).  Two designs are compared by running the script for each in turns on
one card, an earlier one unpacked with
``git archive <commit> pint_tpu_torch | tar -x -C .chipwork/old``.  The
script calls only functions that the port has had since K2p, K5 and K7
were first ported, and helpers of this checkout's ``chip_smoke.py``.

At chip_smoke.py's LTI serving configuration (double integrator T = 50, Tp
= 64): K2 at 0, 1, 15 and 40 PGD iterations with momentum off and on, and
K2p at the same counts, at B = 8192 and at the ragged B = 8200 (not a
multiple of the 16-problem tile), device ms of calls queued behind a device
sleep (0 iterations: staging and write-back alone) and one call between
CUDA events at 15 iterations; each held bit-identical to its plain version
first.  Then 20 MPCService ticks (B = 8192, 15 iterations a tick; host
clock p50, p99) and the device time of one tick and K2's share of it
(torch.profiler).

At chip_smoke.py's RTI configuration (B = 4096, Tm = Tp = 64): K3 at 0, 1, 4
and 16 power steps and K4's words entry at 0, 1, 10 and 30 PGD iterations,
device ms of calls queued behind a device sleep (what is left at 0 is
staging and write-back), and one call between CUDA events at the main-path
counts; each held bit-identical to its plain version first.  Then 20
RTIService ticks (host clock p50, p99) and 5 flagship 4 x 30 solves
(solves/s), and the device time of one tick and one solve (sum over their
device operations, torch.profiler).

At chip_smoke.py's constrained configurations: K7 (B = 4096, Tp = Cp = 64,
the LTI constrained problem) at 1 x 1, 12 x 1, 12 x 10 and 12 x 60 ALM
iterations and K5 (B = 4096, Tp = Cp = 64, one real DeviceConstrainedSQP
condensation) at 1 x 0, 1 x 1, 3 x 10 and 3 x 30, queued device ms, each
held bit-identical to its plain version first; then the LTI constrained
solve (ConstrainedPGD 12 x 60, solves/s over 5 solves and the device time
of one) and the constrained flagship (4 SQP x (3 x 30), the same).  K6 on
one real DeviceConstrainedSQP constraint stack (B = 4096, C = 32, Tm = 64)
at 0, 1, 4 and 16 power steps, and K10 on rank 0's slab of one real
DeviceSQP and one DeviceConstrainedSQP condensation at tp = 2 and 4 (K = 32
and 16; rows 64 and 128), each held bit-identical to its plain version
first.  Prints one JSON line.

    python3 exp_torch_kernels.py --long [--root DIR] [--out FILE]

instead times the long-horizon shapes on random operands at B = 4096
(device ms queued and of one call between CUDA events), in the order the
package's kernels take past 64 lanes (problem-major where the package has
``ops.kernels.problem_major``, else batch-last): K4 at Tp = 256, 288 and 632
(30 iterations, and 0: staging and write-back alone), K3 at Tm = 192, 256
and 272 (16 power steps, and 0), K6 at C = 128, Tm = 256 at 0, 1, 4 and 16
power steps (and the device time of its transpose kernel, where it has
one) and at the card tests' other shapes (B = 1000) and at C, Tm <= 64
past C 32 (B = 4096: a 2-row constraint at T = 20 is 40 x 40), K10 at the
card tests' shapes (random int8 operands), and K5 at Tp x Cp = 256 x 128
and 288 x 192 at 3 x 30 and 1 x 0 (staging and write-back only).  Then the
device time of one SQP iteration of DeviceSQP and DeviceConstrainedSQP at T
= 128, B = 4096 (torch.profiler, with the kernels that take most of it),
and the queued device ms of the copies the problem-major handoff removes,
as plain torch operations at the long path's shapes.

    python3 exp_torch_kernels.py --wide [--root DIR] [--out FILE]

instead times the wide forms (past 256 lanes) at chip_smoke.py's WIDE_TP
and WIDE_K7 shapes on its random operands (``wide_operands``, B =
WIDE_BATCH): K2 with momentum off and on and K2p at WIDE_ITERS and at 0
iterations (staging and write-back alone), K7 at WIDE_K7_OUTER x
WIDE_K7_INNERS and at 0 x 0, device ms queued and of one call between CUDA
events, each held bit-identical to its plain version first; and phase 18's
solves at T = 260 (FusedPGD with momentum off and on and with packed_io,
ConstrainedPGD 3 x 10, B = WIDE_BATCH): device ms of one solve, the sum
of its kernel events (``chip_smoke.profile_call``).

    python3 exp_torch_kernels.py --rehearsal [--root DIR] [--out FILE]

instead runs chip_smoke.py's two-rank rehearsal (dp = 1 x tp = 2 over gloo,
both ranks on the one card) for a DeviceSQP and a DeviceConstrainedSQP
sharded solve at B = 4096 and profiles one of each (torch.profiler) on
both ranks: K10's launches and their summed device time a solve, and the
solve's device time.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path
from statistics import median

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

TICKS, SOLVES = 20, 5
K2_ITERS, K2_RAGGED = (0, 1, 15, 40), 8200
K6_SHAPES = ((8, 100), (100, 66), (224, 256), (256, 223), (20, 40), (64, 64), (40, 40))
K6_MID = ((40, 40), (36, 30), (48, 48), (56, 56), (64, 64))
K10_SHAPES = ((32, 64, 4096), (16, 64, 4096), (32, 128, 4096), (16, 128, 4096),
              (33, 64, 4095), (130, 64, 4096))


def solve_record(timing, fn, B, reps):
    """Host ms and solves/s of ``fn`` (a solve of B problems) and the
    device time of one call."""
    ms = median(timing.host_ms(fn, reps=reps))
    dev_ms, kern, _ = CS.profile_call(torch, fn)
    return dict(ms=ms, solves_per_s=B / (ms / 1e3), device_ms=dev_ms, operations=len(kern))


def lti(P, timing):
    """K2 and K2p against their iteration counts at the LTI serving shape
    and a ragged batch, and the device time of an MPCService tick."""
    from pint_tpu_torch.models.dynamics import pack_controls
    from pint_tpu_torch.mpc import (fused_pgd, fused_pgd_packed, fused_pgd_packed_plain,
                                    fused_pgd_plain)

    rec, dev = {}, "cuda"
    qqp = P.quantize(P.condense_double_integrator(T=50))
    hq = torch.as_tensor(qqp.Hq, device=dev)
    beta = P.FusedPGD(qqp, device=dev).beta_num
    for B in (CS.LTI_BATCH, K2_RAGGED):
        rng = np.random.default_rng(B)
        g = torch.as_tensor(qqp.g_lane_fixed(CS.lti_states(rng, B)), device=dev)
        lanes = torch.as_tensor(rng.integers(-128, 128, (B, qqp.padded), dtype=np.int32),
                                device=dev)
        words = pack_controls(lanes)
        for iters in K2_ITERS:
            base = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift,
                        iters=iters)
            for momentum in (False, True):
                kw = dict(base, momentum=momentum, beta_num=beta)
                CS.same(torch, f"K2 B={B} iters={iters} momentum={momentum}",
                        fused_pgd(lanes, g, hq, **kw), fused_pgd_plain(lanes, g, hq, **kw))
                rec[f"k2_B{B}_iters{iters}_momentum{int(momentum)}_queued_ms"] = median(
                    timing.queued_ms(lambda: fused_pgd(lanes, g, hq, **kw)))
            CS.same(torch, f"K2p B={B} iters={iters}", fused_pgd_packed(words, g, hq, **base),
                    fused_pgd_packed_plain(words, g, hq, **base))
            rec[f"k2p_B{B}_iters{iters}_queued_ms"] = median(
                timing.queued_ms(lambda: fused_pgd_packed(words, g, hq, **base)))
        main = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift, iters=15)
        rec[f"k2_B{B}_call_ms"] = median(timing.cuda_ms(lambda: fused_pgd(lanes, g, hq, **main)))
        rec[f"k2p_B{B}_call_ms"] = median(
            timing.cuda_ms(lambda: fused_pgd_packed(words, g, hq, **main)))

    svc = P.MPCService(qqp, batch=CS.LTI_BATCH, iters_per_tick=15, device=dev)
    x0 = CS.lti_states(np.random.default_rng(0), CS.LTI_BATCH)
    lat = []
    for _ in range(TICKS):
        svc.solve(x0)
        lat.append(svc.stats.last_latency_s * 1e3)
    dev_ms, kern, _ = CS.profile_call(torch, lambda: svc.solve(x0))
    rec["mpc_tick"] = dict(p50_ms=CS.pct(lat, 50), p99_ms=CS.pct(lat, 99), readings_ms=lat,
                           device_ms=dev_ms, operations=len(kern),
                           k2_device_ms=sum(ms for k, ms in kern if "fused_pgd" in k))
    return rec


def constrained(P, timing):
    """K7 and K5 against their iteration counts, the LTI constrained solve
    and the constrained flagship."""
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.mpc.constrained import RATIONALS
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain, alm_shared, alm_shared_plain
    from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT

    rec, dev, B = {}, "cuda", CS.CON_BATCH
    T, dt = CS.LTI_CON_T, 1.0 / 32.0
    qp = P.condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    q = P.quantize_constrained(P.constrain_states(
        qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0)
    kern = P.ConstrainedPGD(q, outer=CS.LTI_CON_OUTER, inners=CS.LTI_CON_INNERS, device=dev)
    rng = np.random.default_rng(4)
    x0 = np.stack([rng.uniform(-1.5, 1.5, B), rng.uniform(-0.2, 0.2, B)], -1)
    g = torch.as_tensor(q.qqp.g_lane_fixed(x0), device=dev)
    co = torch.as_tensor(q.c_off_pre(x0), device=dev)
    u0 = kern.init_words(B)
    o = kern._ops
    args = (unpack_controls(u0), g, co, torch.zeros_like(co), o["Hq"], o["Sq"], o["lo"], o["hi"])
    for outer, inners in ((1, 1), (12, 1), (12, 10), (CS.LTI_CON_OUTER, CS.LTI_CON_INNERS)):
        kw = dict(outer=outer, inners=inners, g_shift=q.qqp.g_shift, y_shift=q.y_shift,
                  **kern._rationals)
        got, ref = alm_shared(*args, **kw), alm_shared_plain(*args, **kw)
        CS.same(torch, f"K7 lanes at {outer}x{inners}", got[0], ref[0])
        CS.same(torch, f"K7 lam at {outer}x{inners}", got[1], ref[1])
        rec[f"k7_{outer}x{inners}_queued_ms"] = median(timing.queued_ms(
            lambda: alm_shared(*args, **kw), calls=3))
    rec["k7_call_ms"] = median(timing.cuda_ms(lambda: alm_shared(*args, **kw)))
    rec["lti_constrained"] = solve_record(timing, lambda: kern.solve_words(u0, g, co), B, 5)

    csqp = CS.make_csqp(P, 1)
    d = csqp.dev
    rng = np.random.default_rng(3)
    xc = torch.as_tensor(CS.con_states(rng, B), dtype=torch.float32, device=dev)
    lanes = torch.as_tensor(rng.integers(-60, 61, (B, d.n_dec), dtype=np.int32), device=dev)
    ops, _ = csqp._condense_constrained_dev(xc, lanes)
    lam = torch.as_tensor(rng.integers(0, 500, (B, csqp.padded_rows), dtype=np.int32),
                          device=dev)
    sc = torch.stack([ops[k] for k in RATIONALS])
    k5_args = (lanes, ops["g_pre"], ops["hqt"], ops["sqj"], ops["sqc"], ops["c_off"],
               ops["lo_pre"], ops["hi_pre"], lam, sc)
    for outer, inners in ((1, 0), (1, 1), (3, 10), (csqp.alm_outer, d.pgd_iters)):
        kw = dict(outer=outer, inners=inners, g_shift=d.g_shift, y_shift=_Y_SHIFT)
        got, ref = alm_hqt(*k5_args, **kw), alm_hqt_plain(*k5_args, **kw)
        CS.same(torch, f"K5 lanes at {outer}x{inners}", got[0], ref[0])
        CS.same(torch, f"K5 lam at {outer}x{inners}", got[1], ref[1])
        rec[f"k5_{outer}x{inners}_queued_ms"] = median(timing.queued_ms(
            lambda: alm_hqt(*k5_args, **kw), calls=5))
    rec["k5_call_ms"] = median(timing.cuda_ms(lambda: alm_hqt(*k5_args, **kw)))

    flag = CS.make_csqp(P, 4)
    xf = torch.as_tensor(CS.con_states(np.random.default_rng(0), B).astype(np.float32),
                         device=dev)
    w0 = flag.init_words(B)
    rec["constrained_flagship"] = solve_record(timing, lambda: flag.solve_words(w0, xf), B, 3)
    return rec


def k6_k10(P, timing):
    """K6 against its power steps and K10 at tp = 2 and 4, on real
    operands."""
    from pint_tpu_torch.mpc import (pen_fused, pen_plain, pgd_matvec_cols,
                                    pgd_matvec_cols_plain)

    rec, dev, B = {}, "cuda", CS.CON_BATCH
    csqp = CS.make_csqp(P, 1)
    d = csqp.dev
    rng = np.random.default_rng(3)
    xc = torch.as_tensor(CS.con_states(rng, B), dtype=torch.float32, device=dev)
    lanes = torch.as_tensor(rng.integers(-60, 61, (B, d.n_dec), dtype=np.int32), device=dev)
    A, Bl, c = d._linearize_phase(xc, lanes)
    S_t = csqp._stack_constraints(*d._propagate_unrolled(A, Bl, c))[0]
    for p in (0, 1, 4, d.power_iters):
        for name, a, b in zip(("sqc", "sqj", "pen_lip", "s_scale", "row_amp"),
                              pen_fused(S_t, power_iters=p), pen_plain(S_t, power_iters=p)):
            CS.same(torch, f"K6 {name} at {p} power steps", a, b)
        rec[f"k6_power_iters_{p}_queued_ms"] = median(timing.queued_ms(
            lambda: pen_fused(S_t, power_iters=p)))
    rec["k6_call_ms"] = median(timing.cuda_ms(lambda: pen_fused(S_t, power_iters=d.power_iters)))

    sqp = P.DeviceSQP(sqp_iters=1, device=dev, **CS.SQP_KW)
    x0 = torch.as_tensor(CS.rti_states(rng, B), dtype=torch.float32, device=dev)
    hqt = sqp._condense(x0, lanes)[0]
    ops, _ = csqp._condense_constrained_dev(xc, lanes)
    for tp in (2, 4):
        k = sqp.n_dec // tp
        lanes_r = lanes[:, :k].contiguous()
        for name, slab in (("sqp", hqt[:k]),
                           ("constrained", torch.cat([ops["hqt"][:k], ops["sqj"][:k]], 1))):
            CS.same(torch, f"K10 tp={tp} {name}", pgd_matvec_cols(lanes_r, slab),
                    pgd_matvec_cols_plain(lanes_r, slab))
            rec[f"k10_tp{tp}_{name}_queued_ms"] = median(timing.queued_ms(
                lambda: pgd_matvec_cols(lanes_r, slab)))
    return rec


LONG_K3 = (192, 256, 272)                  # Tm; 16 and 0 power steps
LONG_K4 = (256, 288, 632)                  # Tp; 30 and 0 iterations
LONG_K5 = ((256, 128), (288, 192))         # (Tp, Cp); 3 x 30 and 1 x 0


def long_operands(P, B, seed):
    """Random long-form operands in the order the measured package's
    kernels take past 64 lanes: problem-major (each problem's slab one
    contiguous run) where the package has ``ops.kernels.problem_major``,
    else batch-last."""
    from pint_tpu_torch.ops import kernels as K

    pm = hasattr(K, "problem_major")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ht(Tm):            # (Tm, Tm, B) f32 with rows k along dim 0
        if pm:
            return torch.randn((B, Tm, Tm), generator=gen, device="cuda").permute(1, 2, 0)
        return torch.randn((Tm, Tm, B), generator=gen, device="cuda")

    def i8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def hqt(Tp):           # hqt[k, j, b] = Hq_b[j, k]
        return i8((B, Tp, Tp)).permute(2, 1, 0) if pm else i8((Tp, Tp, B))

    def sq(Tp, Cp):        # (sqj (Tp, Cp, B), sqc (Cp, Tp, B)), both Sq_b[c, j]
        if pm:
            bf = i8((B, Cp, Tp))
            return bf.transpose(1, 2).contiguous().permute(1, 2, 0), bf.permute(1, 2, 0)
        sqc = i8((Cp, Tp, B))
        return sqc.transpose(0, 1).contiguous(), sqc

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    return pm, ht, hqt, sq, ints


def long_solves(P, timing):
    """Device time (torch.profiler) of one SQP iteration of DeviceSQP and
    DeviceConstrainedSQP at T = 128, B = 4096, and the kernels that take
    the most of it."""
    rec = {}
    B, T = CS.LONG_BATCH, CS.LONG_T
    makers = (
        ("device_sqp", lambda: P.DeviceSQP(sqp_iters=1, device="cuda",
                                           **dict(CS.SQP_KW, horizon=T)), CS.rti_states),
        ("device_constrained", lambda: P.DeviceConstrainedSQP(P.DeviceSQP(
            sqp_iters=1, device="cuda", **dict(CS.CON_SQP_KW, horizon=T)), **CS.CON_KW),
         CS.con_states))
    for name, make, states in makers:
        solver = make()
        x0 = torch.as_tensor(states(np.random.default_rng(11), B), dtype=torch.float32,
                             device="cuda")
        u0 = solver.init_words(B)
        dev_ms, kern, copies = CS.profile_call(torch, lambda: solver.solve_words(u0, x0))
        by = {}
        for key, ms in kern:
            by[key] = by.get(key, 0.0) + ms
        top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        Tm = solver.n_dec if hasattr(solver, "n_dec") else solver.dev.n_dec
        rec[f"{name}_T{T}_iteration"] = dict(
            device_ms=dev_ms, kernels=len(kern), top_ms={k[:90]: ms for k, ms in top},
            transpose_kernels=sum("pen_transpose" in n for n, _ in kern),
            ht_copies=sum(1 for sh in copies if [Tm, Tm, B] in sh))
        del solver, x0, u0
    return rec


def long_copies(timing):
    """Device ms (queued) of the copies that the problem-major handoff
    removes past 64 lanes, as plain torch operations at the long path's
    shapes: the reduce's batch-last copy of Ht, the constraint rows' sqj
    copy, the torch forms' batch-first copy of Ht and transposed copy of
    hqt (T = 144, B = 1024) and pgd_fused_words' copy of Hq."""
    def queued(fn):
        return median(timing.queued_ms(fn, calls=3, reps=3))

    rec = {}
    Hb = torch.randn((4096, 256, 256), device="cuda")
    rec["ht_batch_last_copy_Tm256_B4096_queued_ms"] = queued(
        lambda: Hb.permute(1, 2, 0).contiguous())
    del Hb
    sqc = torch.randint(-127, 128, (128, 256, 4096), device="cuda", dtype=torch.int8)
    rec["sqj_copy_C128_Tm256_B4096_queued_ms"] = queued(
        lambda: sqc.transpose(0, 1).contiguous())
    del sqc
    Ht = torch.randn((288, 288, 1024), device="cuda")
    rec["ht_batch_first_copy_Tm288_B1024_queued_ms"] = queued(
        lambda: Ht.permute(2, 0, 1).contiguous())
    hq = torch.randint(-127, 128, (288, 288, 1024), device="cuda", dtype=torch.int8)
    rec["hqt_transpose_copy_Tm288_B1024_queued_ms"] = queued(
        lambda: hq.transpose(0, 1).contiguous())
    del Ht, hq
    Hq = torch.randint(-127, 128, (4096, 256, 256), device="cuda", dtype=torch.int8)
    rec["hq_kernel_orientation_copy_Tp256_B4096_queued_ms"] = queued(
        lambda: Hq.permute(2, 1, 0).contiguous())
    return rec


def long_horizon(P, timing):
    """The long-horizon shapes of K3, K4, K5 and K6 on random operands."""
    from pint_tpu_torch.mpc import (lipq_fused, pen_fused, pen_plain, pgd_hqt,
                                    pgd_matvec_cols, pgd_matvec_cols_plain)
    from pint_tpu_torch.mpc.fused_alm import alm_hqt

    dev, B, rec = "cuda", 4096, {}
    rng = np.random.default_rng(0)
    pm, ht, hqt, sq, ints = long_operands(P, B, 0)
    rec["problem_major"] = pm

    def t(a):
        return torch.as_tensor(a, device=dev)

    def queued(fn):
        return median(timing.queued_ms(fn, calls=3, reps=3))

    def both(key, fn):  # queued, and one call between CUDA events
        rec[f"{key}_queued_ms"] = queued(fn)
        rec[f"{key}_call_ms"] = median(timing.cuda_ms(fn, reps=5))

    for Tp in LONG_K4:
        args = (ints(-128, 128, (B, Tp)), ints(-2**18, 2**18, (B, Tp)), hqt(Tp),
                ints(1, 300, (B,)), ints(10, 16, (B,)))
        for n in (30, 0):
            both(f"k4_Tp{Tp}_iters{n}", lambda: pgd_hqt(*args, iters=n, g_shift=12))
        del args
    for Tm in LONG_K3:
        H = ht(Tm)
        for p in (16, 0):
            both(f"k3_Tm{Tm}_power_iters{p}", lambda: lipq_fused(H, power_iters=p))
        del H
    S_t = torch.randn((128, 256, B), device=dev)
    for p in (0, 1, 4, 16):
        rec[f"k6_C128_Tm256_power_iters_{p}_queued_ms"] = queued(
            lambda: pen_fused(S_t, power_iters=p))
    kern = CS.profile_call(torch, lambda: pen_fused(S_t, power_iters=16))[1]
    rec["k6_C128_Tm256_transpose_device_ms"] = sum(ms for k, ms in kern if "transpose" in k)
    del S_t
    for C, Tm in K6_SHAPES:  # the card tests' other K6 shapes, B = 1000
        S_t = torch.randn((C, Tm, 1000), device=dev)
        rec[f"k6_C{C}_Tm{Tm}_B1000_queued_ms"] = queued(lambda: pen_fused(S_t, power_iters=16))
    for C, Tm in K6_MID:  # past C 32, B = 4096, held to the plain version first
        S_t = torch.randn((C, Tm, B), device=dev)
        for a, b in zip(pen_fused(S_t, power_iters=16), pen_plain(S_t, power_iters=16)):
            CS.same(torch, f"K6 at {C} x {Tm}", a, b)
        rec[f"k6_C{C}_Tm{Tm}_B{B}_queued_ms"] = queued(lambda: pen_fused(S_t, power_iters=16))
    del S_t
    for k, rows, b in K10_SHAPES:  # int8 lanes, held to the plain version first
        slab = t(rng.integers(-128, 128, (k, rows, b), dtype=np.int8))
        lanes = t(rng.integers(-128, 128, (b, k), dtype=np.int32))
        CS.same(torch, f"K10 at K {k} x rows {rows}, B = {b}", pgd_matvec_cols(lanes, slab),
                pgd_matvec_cols_plain(lanes, slab))
        rec[f"k10_K{k}_rows{rows}_B{b}_queued_ms"] = queued(lambda: pgd_matvec_cols(lanes, slab))
    del slab
    for Tp, Cp in LONG_K5:
        sqj, sqc = sq(Tp, Cp)
        sc = torch.stack([ints(1, 300, (B,)), ints(10, 16, (B,))] * 4)
        args = (ints(-128, 128, (B, Tp)), ints(-2**16, 2**16, (B, Tp)), hqt(Tp), sqj, sqc,
                ints(-3000, 3000, (B, Cp)), ints(-2000, -100, (B, Cp)),
                ints(100, 2000, (B, Cp)), ints(0, 500, (B, Cp)), sc)
        for outer, inners in ((3, 30), (1, 0)):
            both(f"k5_{Tp}x{Cp}_{outer}x{inners}", lambda: alm_hqt(
                *args, outer=outer, inners=inners, g_shift=12, y_shift=9))
        del args, sqj, sqc
    rec.update(long_solves(P, timing))
    rec.update(long_copies(timing))
    return rec


def wide(P, timing):
    """The wide forms of K2, K2p and K7 at chip_smoke.py's shapes, old or
    new package alike (entry points the port has had since its first wide
    forms)."""
    from pint_tpu_torch.mpc import (alm_shared, alm_shared_plain, fused_pgd,
                                    fused_pgd_packed, fused_pgd_packed_plain,
                                    fused_pgd_plain)
    B, dev, rec = CS.WIDE_BATCH, "cuda", {}
    T, dt = CS.WIDE_TP[0], 1.0 / 32.0
    qp = P.condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    qqp = P.quantize(qp, pad_to=4)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    qc = P.quantize_constrained(P.constrain_states(
        qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0, pad_to=4)
    x0 = CS.lti_states(np.random.default_rng(60), B)
    solvers = dict(
        fused=P.FusedPGD(qqp, iters=CS.WIDE_ITERS, device=dev),
        fused_momentum=P.FusedPGD(qqp, iters=CS.WIDE_ITERS, momentum=True, device=dev),
        fused_packed_io=P.FusedPGD(qqp, iters=CS.WIDE_ITERS, packed_io=True, device=dev),
        constrained=P.ConstrainedPGD(qc, outer=CS.WIDE_K7_OUTER, inners=CS.WIDE_K7_INNERS,
                                     device=dev))
    for name, solver in solvers.items():
        ms = [CS.profile_call(torch, lambda: solver.solve(x0))[0] for _ in range(3)]
        rec[f"solve_{name}_T{T}_device_ms"] = median(ms)

    def both(key, fn, ref, n):  # bit-identical first; queued, and one call
        if n:
            for a, b in zip(fn(), ref()):
                CS.same(torch, key, a, b)
        rec[f"{key}_queued_ms"] = median(timing.queued_ms(fn, calls=3, reps=3))
        if n:
            rec[f"{key}_call_ms"] = median(timing.cuda_ms(fn, reps=3))

    for Tp in CS.WIDE_TP:
        lanes, g, hq = CS.wide_operands(torch, B, Tp, Tp)
        words = P.pack_controls(lanes)
        for n in (CS.WIDE_ITERS, 0):
            kw = dict(hs_num=33, hs_den=9, g_shift=12, iters=n)
            for mom in (0, 1):
                mkw = dict(kw, momentum=bool(mom), beta_num=150 * mom)
                both(f"k2_Tp{Tp}_momentum{mom}_iters{n}",
                     lambda: (fused_pgd(lanes, g, hq, **mkw),),
                     lambda: (fused_pgd_plain(lanes, g, hq, **mkw),), n)
            both(f"k2p_Tp{Tp}_iters{n}", lambda: (fused_pgd_packed(words, g, hq, **kw),),
                 lambda: (fused_pgd_packed_plain(words, g, hq, **kw),), n)
        del lanes, g, hq, words
    for Tp, Cp in CS.WIDE_K7:
        lanes, g, hq = CS.wide_operands(torch, B, Tp, Tp + Cp)
        r = np.random.default_rng(Cp)

        def t(a):
            return torch.as_tensor(a, device=dev)

        args = (lanes, g, t(r.integers(-3000, 3000, (B, Cp), dtype=np.int32)),
                t(r.integers(0, 500, (B, Cp), dtype=np.int32)), hq,
                t(r.integers(-127, 128, (Cp, Tp), dtype=np.int8)),
                t(r.integers(-2000, -100, (Cp,), dtype=np.int32)),
                t(r.integers(100, 2000, (Cp,), dtype=np.int32)))
        for outer, inners in ((CS.WIDE_K7_OUTER, CS.WIDE_K7_INNERS), (0, 0)):
            akw = dict(hs_num=37, hs_den=14, cs_num=91, cs_den=12, eh_num=55, eh_den=16,
                       el_num=23, el_den=11, outer=outer, inners=inners, g_shift=12,
                       y_shift=9)
            both(f"k7_{Tp}x{Cp}_{outer}x{inners}", lambda: alm_shared(*args, **akw),
                 lambda: alm_shared_plain(*args, **akw), outer * inners)
        del args, lanes, g, hq
    return rec


def rehearsal_rank(rank, port, out, P):
    """One rank of the rehearsal: gloo, mesh dp = 1 x tp = 2 on the one
    card; K10's device time in one profiled solve of each sharded solver."""
    from pint_tpu_torch.parallel import distributed as D
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.parallel.mesh import shard

    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    rec = {}
    try:
        mesh = make_mesh(dp=1, tp=2, device="cuda")
        rng = np.random.default_rng(9)
        x_rti = torch.as_tensor(CS.rti_states(rng, CS.RTI_BATCH), dtype=torch.float32,
                                device="cuda")
        x_con = torch.as_tensor(CS.con_states(rng, CS.CON_BATCH), dtype=torch.float32,
                                device="cuda")
        for name, solver, x, B in (
                ("device_sqp", P.DeviceSQP(sqp_iters=4, device="cuda", **CS.SQP_KW), x_rti,
                 CS.RTI_BATCH),
                ("device_constrained", CS.make_csqp(P, 4), x_con, CS.CON_BATCH)):
            solve = solver.sharded_solve_words(mesh)
            w0 = shard(solver.init_words(B), mesh, ("dp", "tp"))
            xs = shard(x, mesh, ("dp", None))
            dev_ms, kern, _ = CS.profile_call(torch, lambda: solve(w0, xs))
            k10 = [ms for key, ms in kern if "matvec" in key]
            rec[name] = dict(k10_launches=len(k10), k10_device_ms=sum(k10),
                             device_ms=dev_ms, operations=len(kern))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    Path(out).write_text(json.dumps(rec))


def rehearsal(root):
    """Both ranks of the rehearsal, started as processes of this script."""
    import subprocess
    import tempfile

    from pint_tpu_torch.ops import kernels as K

    K.library()  # built here, once, for both ranks
    with tempfile.TemporaryDirectory() as tmp:
        port = CS.free_port()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--root",
                                   str(root), "--rehearsal-rank", str(r), str(port),
                                   f"{tmp}/rank{r}.json"]) for r in range(2)]
        try:
            for r, p in enumerate(procs):
                if p.wait(timeout=CS.REHEARSAL_TIMEOUT_S):
                    raise SystemExit(f"rehearsal rank {r} failed ({p.returncode})")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(2)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose pint_tpu_torch is measured")
    ap.add_argument("--out", type=Path, help="also write the JSON record here")
    ap.add_argument("--long", action="store_true",
                    help="time the long-horizon shapes of K3-K6 instead")
    ap.add_argument("--wide", action="store_true",
                    help="time the wide forms of K2, K2p and K7 (past 256 lanes) instead")
    ap.add_argument("--rehearsal", action="store_true",
                    help="profile K10 in the two-rank rehearsal's sharded solves instead")
    ap.add_argument("--rehearsal-rank", nargs=3, metavar=("RANK", "PORT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    CS.phase_device(torch)
    import pint_tpu_torch as P

    if args.rehearsal_rank:
        rank, port, out = args.rehearsal_rank
        rehearsal_rank(int(rank), int(port), out, P)
        return
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
    from pint_tpu_torch.mpc.condense_fused import lipq_fused, lipq_plain, true_div
    from pint_tpu_torch.mpc.fused_alm import pgd_fused_words_pre, pgd_hqt_plain
    from pint_tpu_torch.utils import timing

    if root not in Path(P.__file__).resolve().parents:
        raise SystemExit(f"imported {P.__file__}, not the package under {root}")
    if args.long or args.wide or args.rehearsal:
        rec = {"root": str(root), "card": torch.cuda.get_device_name(0)}
        if args.long:
            rec.update(long_horizon(P, timing))
        elif args.wide:
            rec.update(wide(P, timing))
        else:
            rec["rehearsal_ranks"] = rehearsal(root)
        print(json.dumps(rec), flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(rec) + "\n")
        return
    B, dev = CS.RTI_BATCH, "cuda"
    sqp = P.DeviceSQP(sqp_iters=1, device=dev, **CS.SQP_KW)
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor(CS.rti_states(rng, B), dtype=torch.float32, device=dev)
    lanes = torch.as_tensor(rng.integers(-60, 61, (B, sqp.n_dec), dtype=np.int32), device=dev)
    Ht, g = sqp._condense_ht(x0, lanes)
    hqt, lip, hmax = lipq_plain(Ht, power_iters=sqp.power_iters)
    alpha = true_div(1.0, lip)
    g_pre = sqp._g_pre_from(g, alpha)
    _, hs_num, hs_den = sqp._lipq_rationals(alpha, hmax)
    words = pack_controls(lanes)
    rec = {"root": str(root), "card": torch.cuda.get_device_name(0)}

    def k3(p):
        return lipq_fused(Ht, power_iters=p)

    def k4(n):
        return pgd_fused_words_pre(words, g_pre, hqt, hs_num, hs_den, iters=n,
                                   g_shift=sqp.g_shift)

    for p in (0, 1, 4, sqp.power_iters):
        for name, a, b in zip(("hqt", "lip", "h_max"), k3(p), lipq_plain(Ht, power_iters=p)):
            CS.same(torch, f"K3 {name} at {p} power steps", a, b)
        rec[f"k3_power_iters_{p}_queued_ms"] = median(timing.queued_ms(lambda: k3(p)))
    for n in (0, 1, 10, sqp.pgd_iters):
        ref = pack_controls(pgd_hqt_plain(unpack_controls(words), g_pre, hqt, hs_num, hs_den,
                                          iters=n, g_shift=sqp.g_shift))
        CS.same(torch, f"K4 words entry at {n} iterations", k4(n), ref)
        rec[f"k4_words_iters_{n}_queued_ms"] = median(timing.queued_ms(lambda: k4(n)))
    rec["k3_call_ms"] = median(timing.cuda_ms(lambda: k3(sqp.power_iters)))
    rec["k4_words_call_ms"] = median(timing.cuda_ms(lambda: k4(sqp.pgd_iters)))

    rti = P.RTIService(P.DeviceSQP(sqp_iters=1, device=dev, **CS.SQP_KW), batch=B)
    xr = CS.rti_states(np.random.default_rng(0), B)
    lat = []
    for _ in range(TICKS):
        rti.solve(xr)
        lat.append(rti.stats.last_latency_s * 1e3)
    dev_ms, kern, _ = CS.profile_call(torch, lambda: rti.solve(xr))
    rec["rti_tick"] = dict(p50_ms=CS.pct(lat, 50), p99_ms=CS.pct(lat, 99), readings_ms=lat,
                           device_ms=dev_ms, operations=len(kern))
    flag = P.DeviceSQP(sqp_iters=4, device=dev, **CS.SQP_KW)
    xf = torch.as_tensor(CS.rti_states(np.random.default_rng(0), B).astype(np.float32),
                         device=dev)
    u0 = flag.init_words(B)
    rec["flagship"] = solve_record(timing, lambda: flag.solve_words(u0, xf), B, SOLVES)
    rec.update(lti(P, timing))
    rec.update(constrained(P, timing))
    rec.update(k6_k10(P, timing))
    line = json.dumps(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
