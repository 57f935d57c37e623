#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. device check: a CUDA card of compute capability 9.0, its name and power
   limit from nvidia-smi; TF32 off;
2. build: the kernels under pint_tpu_torch/csrc/ with nvcc;
3. kernel checks at the serving shapes, each kernel against its plain
   PyTorch version on the card, with CUDA-event times of both:
   K2 fused PGD (B = 8192, Tp = 64, 15 and 40 iterations, momentum off and
   on; bit-identical), K3 lipq and K4 PGD inner on one real DeviceSQP
   condensation (B = 4096, Tm = 64; K3's hqt and h_max bit-identical, lip
   rtol 1e-5; K4 bit-identical);
4. MPCService: LTI double integrator, T = 50 (Tp = 64), batch 8192, 15 PGD
   iterations a tick, 10 ticks;
5. RTIService: unicycle DeviceSQP, T = 32, batch 4096, 1 SQP x 30 PGD a
   tick, 10 ticks;
6. the flagship DeviceSQP solve, 4 SQP x 30 PGD, batch 4096, once through
   the kernels and once through the plain versions, held to cost parity
   (rtol 0.01, atol 1e-4).

The kernels' launch counts are set to 0 before phase 4 and read after
phase 5: every kernel must have run on that main path.  The line before
the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Inputs are made from fixed seeds.
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
    K.reset_launch_counts()                     # main path starts here
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
    k2 = phase_k2(torch, P, timing)
    k3, k4 = phase_k3_k4(torch, P, timing)
    mpc = phase_mpc(torch, P, K)
    rti = phase_rti(torch, P, K)
    counts = K.launch_counts()                  # main path ends here
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
    flagship = phase_flagship(torch, P, timing)

    k2_main = k2["iters15_momentum0"]
    kernels = [
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
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
