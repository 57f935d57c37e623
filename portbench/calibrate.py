"""Readings that the limits of the check are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --seed0 <n> \\
        --seconds <run_seconds> --control 3 --out <file>.json

For each of ``--seeds`` seeds one run of the cell as ``run.py`` makes it
(without the trace) gives the program's readings of every compared number;
for the first ``--control`` seeds the control, the plain reference in TF32
(the nearest precision below the configuration's float32 with TF32 off)
put in the program's place on the same sampled inputs, gives its readings.
All in one process, so that set-up is paid once.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seed0", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.say("calibration needs a CUDA card")
        return 2
    cell = run.load_cell(ROOT, args.workload)
    rows = []
    for i in range(args.seeds):
        seed = args.seed0 + 7919 * i
        keep = {}
        t = time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, "cuda", keep=keep)
        row = {"seed": seed, "program": keep["nums"], "correct": res["correct"],
               "sampled_ticks": len(keep["steps"]), "metrics": res["metrics"]}
        if i < args.control:
            row["control"] = compare.control_readings(keep["ref"], keep["start"], keep["steps"])
        row["seconds"] = time.perf_counter() - t
        run.say(json.dumps(row))
        rows.append(row)
        del keep
        torch.cuda.empty_cache()
    names = sorted(rows[0]["program"])
    summary = {k: {"program_max": max(r["program"][k] for r in rows),
                   "control_min": min((r["control"][k] for r in rows
                                       if "control" in r and k in r["control"]), default=None)}
               for k in names}
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "power": run.nvidia_smi(), "rows": rows, "summary": summary}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
