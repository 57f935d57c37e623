#!/usr/bin/env python3
"""K3 (lipq) and K4's words entry (pgd_fused_words_pre) of one pint_tpu_torch
checkout on one card: their device time against their iteration counts, and
the device time of an RTI tick and of a flagship DeviceSQP solve.

    python3 exp_torch_k3_k4.py [--root DIR] [--out FILE]

``--root`` names the checkout whose package is measured (default: this
one).  Two designs are compared by running the script for each in turns on
one card, an earlier one unpacked with
``git archive <commit> pint_tpu_torch | tar -x -C .chipwork/old``.  The
script calls only functions that the port has had since K3 and K4 were
first ported, and helpers of this checkout's ``chip_smoke.py``.

At chip_smoke.py's RTI configuration (B = 4096, Tm = Tp = 64): K3 at 0, 1, 4
and 16 power steps and K4's words entry at 0, 1, 10 and 30 PGD iterations,
device ms of calls queued behind a device sleep (what is left at 0 is
staging and write-back), and one call between CUDA events at the main-path
counts; each held bit-identical to its plain version first.  Then 20
RTIService ticks (host clock p50, p99) and 5 flagship 4 x 30 solves
(solves/s), and the device time of one tick and one solve (sum over their
device operations, torch.profiler).  Prints one JSON line.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose pint_tpu_torch is measured")
    ap.add_argument("--out", type=Path, help="also write the JSON record here")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    CS.phase_device(torch)
    import pint_tpu_torch as P
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
    from pint_tpu_torch.mpc.condense_fused import lipq_fused, lipq_plain, true_div
    from pint_tpu_torch.mpc.fused_alm import pgd_fused_words_pre, pgd_hqt_plain
    from pint_tpu_torch.utils import timing

    if root not in Path(P.__file__).resolve().parents:
        raise SystemExit(f"imported {P.__file__}, not the package under {root}")
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
    ops = CS.device_kernels(torch, lambda: rti.solve(xr))
    rec["rti_tick"] = dict(p50_ms=CS.pct(lat, 50), p99_ms=CS.pct(lat, 99), readings_ms=lat,
                           device_ms=sum(us for _, us in ops) / 1e3, operations=len(ops))
    flag = P.DeviceSQP(sqp_iters=4, device=dev, **CS.SQP_KW)
    xf = torch.as_tensor(CS.rti_states(np.random.default_rng(0), B).astype(np.float32),
                         device=dev)
    u0 = flag.init_words(B)
    ms = median(timing.host_ms(lambda: flag.solve_words(u0, xf), reps=SOLVES))
    ops = CS.device_kernels(torch, lambda: flag.solve_words(u0, xf))
    rec["flagship"] = dict(ms=ms, solves_per_s=B / (ms / 1e3),
                           device_ms=sum(us for _, us in ops) / 1e3, operations=len(ops))
    line = json.dumps(rec)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
