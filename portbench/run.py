"""Run one cell of the benchmark of ``pint_tpu_torch`` on the card it is
started on, and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``portbench/configs/<config>.json``, whose ``kind`` names the module under
``portbench/kinds/`` that builds the port's service from it) under a
traffic mix (``portbench/traffic/<mix>.json``, read by
:mod:`portbench.fleet`, whose ``loop`` names the module under
``portbench/loops/`` that times the ticks; the configuration's
``model.name`` names the plant under ``portbench/plants/``).  Each
per-layer metric is read from the traced slice by
``portbench/layers/<metric>.py``.  Nothing here names a cell, a kind, a
plant or a loop.

A run: build the service and the fleet from the seed, warm up with a few
ticks (set-up ends at the first timed tick), run the loop for
``--seconds`` (each tick is one public ``solve`` call on the whole fleet,
then the plant step), then with ``--trace 1`` profile a bounded slice of
further ticks.  Once the window has closed and the peak memory is read,
the service is freed and the plain reference re-solves the ticks sampled
from the seed (:mod:`portbench.compare`).  The last line of standard
output is the result; the last lines of standard error are the compared
numbers beside their limits.  Without a CUDA card (or with fewer than the
cell asks for) the run prints no result and exits 2; with JAX or the JAX
package loaded, 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, fleet, trace  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "pint_tpu")
WARMUP_TICKS = 3
SAMPLE_ROWS = 32        # problems a sampled tick
SAMPLE_PERIOD = 8       # one pair of consecutive ticks sampled in this many
MAX_PAIRS = 128
START_ROWS = 1024       # problems of the first tick checked from zero warm state
TRACE_WARM_TICKS = 2
TRACE_TICKS = 24


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: object
    loop: object
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    kind = importlib.import_module(f"portbench.kinds.{config['kind']}")
    loop = importlib.import_module(f"portbench.loops.{traffic['loop']}")
    return Cell(workload, int(w["chips"]), config, traffic, kind, loop,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def reader(root: Path, metric: str):
    """The ``read(summary, cell)`` of ``portbench/layers/<metric>.py``."""
    path = root / "portbench" / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.layers._" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Probe:
    """Wraps the solver's ``solve_words`` on the instance: a range around
    the call when tracing, and for the ticks given rows a copy of those rows
    of the warm state handed in and of the answer, for the check."""

    def __init__(self, kind, service, spans: bool):
        self.kind = kind
        self.sol = kind.solver(service)
        self.orig = self.sol.solve_words
        self.sig = inspect.signature(self.orig)
        self.spans = spans
        self.calls = 0
        self.rows = {}
        self.records = {}
        object.__setattr__(self.sol, "solve_words", self._call)

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def _call(self, *a, **k):
        t = self.calls
        self.calls += 1
        idx = self.rows.pop(t, None)
        if idx is not None:
            args = self.sig.bind(*a, **k).arguments
            with self.span("portbench.record"):
                ins = {key: args[p].index_select(0, idx)
                       for key, p in self.kind.RECORD_IN.items()}
        with self.span("portbench.solver"):
            out = self.orig(*a, **k)
        if idx is not None:
            with self.span("portbench.record"):
                self.records[t] = {"in": ins, "out": {
                    key: v.index_select(0, idx)
                    for key, v in self.kind.record_out(out).items()}}
        return out

    def restore(self) -> None:
        object.__delattr__(self.sol, "solve_words")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _build_files() -> set:
    import pint_tpu_torch

    return set(Path(pint_tpu_torch.__file__).parent.joinpath("_build").glob("*.so"))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float = None, root: Path = ROOT, keep: dict = None) -> dict:
    """One run of ``cell``; returns the result object (the last key,
    ``checks``, holds each compared number and its limit).  ``keep``, when
    given, receives the sampled records, the reference and every compared
    number (for :mod:`portbench.calibrate`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda and (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the run needs PyTorch's default full-f32 matmuls")
    from pint_tpu_torch.ops import kernels as K

    built_before = _build_files()
    fl = fleet.Fleet(cell.traffic, cell.config, seed)
    B = fl.batch
    pick = fleet.rng_of(seed, 1)
    S = min(SAMPLE_ROWS, B)
    pair_rows = np.stack([np.sort(pick.choice(B, S, replace=False)) for _ in range(MAX_PAIRS)])
    start_rows = np.sort(pick.choice(B, min(START_ROWS, B), replace=False))
    phase = int(pick.integers(SAMPLE_PERIOD - 1))
    t_build = time.perf_counter()
    service = cell.kind.build(cell.config, B, device)
    probe = Probe(cell.kind, service, spans=traced)
    table = torch.as_tensor(pair_rows, device=device)
    probe.rows[0] = torch.as_tensor(start_rows, device=device)
    t_built = time.perf_counter()
    box = fl.plant.box + 1e-12
    state = dict(x=fl.x.copy(), failed=0, raised=0, errors=[], plant_s=0.0)

    def tick(rows=None, due=None):
        """One public call on the whole fleet, then the plant step; returns
        the call's latency, counted from ``due`` where given."""
        x = state["x"]
        t0 = time.perf_counter() if due is None else due
        try:
            with probe.span("portbench.tick"):
                u = service.solve(x)
        except Exception as e:      # a tick that raised: every plant of it failed
            state["raised"] += 1
            state["failed"] += B
            state["errors"].append(repr(e))
            u = np.full((B, np.size(box)), np.nan)
        t1 = time.perf_counter()
        ok = (np.abs(u) <= box).all(axis=1)          # False where not finite
        state["failed"] += int(B - ok.sum())
        if rows is not None:
            rec = probe.records.get(probe.calls - 1)
            if rec is not None:
                rec["x0"], rec["u"] = x[rows], u[rows]
        with probe.span("portbench.plant"):
            state["x"] = fl.step(u)
        state["plant_s"] += time.perf_counter() - t1
        return t1 - t0

    warm = [tick(start_rows if i == 0 else None) for i in range(WARMUP_TICKS)]
    start = probe.records.pop(0, None)
    built_after = _build_files()
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.3f} s: imports and fleet {t_build - t_start:.3f} s, service "
        f"{t_built - t_build:.3f} s, warm-up ticks {', '.join(f'{w:.3f}' for w in warm)} s "
        f"(the first builds or loads the kernels); nvcc ran: "
        f"{bool(built_after - built_before)} ({len(built_after)} libraries in the cache)")

    # -- the window -------------------------------------------------------------
    counts0 = K.launch_counts()
    lat, starts, pairs, steps = [], [], [], []
    state["failed"] = state["raised"] = 0
    state["plant_s"] = 0.0
    attempted, j, pending = 0, 0, None
    w0 = time.perf_counter()
    deadline, now = w0 + seconds, w0
    while True:
        due = cell.loop.due(cell.traffic, j, w0, now)
        if due >= deadline:
            break
        while (now := time.perf_counter()) < due:
            time.sleep(min(due - now, 1e-3))
        rows = None
        p, r = divmod(j, SAMPLE_PERIOD)
        if p < MAX_PAIRS and r in (phase, phase + 1):
            rows = pair_rows[p]
            probe.rows[probe.calls] = table[p]
        attempted += B
        starts.append(due - w0)
        lat.append(tick(rows, due))
        rec = probe.records.pop(probe.calls - 1, None) if rows is not None else None
        if rec is not None:
            steps.append(rec)
            if r == phase + 1 and pending is not None:
                pairs.append((pending, rec))
            pending = rec if r == phase else None
        j += 1
        now = time.perf_counter()
    w1 = now
    ticks = len(lat)
    window_s = w1 - w0
    counts1 = K.launch_counts()
    lat_ms = np.asarray(lat) * 1e3
    deadline_ms = float(cell.config["deadline_ms"])
    plants_per_s = B * ticks / window_s
    end_to_end = {"tick_p95_ms": float(np.percentile(lat_ms, 95)),
                  "plants_per_s": plants_per_s, "setup_s": setup_s}
    say(f"window: {ticks} ticks of {B} plants in {window_s:.3f} s, {plants_per_s:.1f} "
        f"plants/s; tick p50 "
        f"{np.percentile(lat_ms, 50):.3f} ms, p95 {end_to_end['tick_p95_ms']:.3f} ms, "
        f"max {lat_ms.max():.3f} ms; {100.0 * float((lat_ms > deadline_ms).mean()):.2f}% "
        f"of ticks over the {deadline_ms:g} ms period; plant step {state['plant_s'] * 1e3:.1f} ms "
        f"in all; {state['raised']} ticks raised")
    per_s = np.bincount(np.asarray(starts, int), minlength=int(np.ceil(window_s)))
    say(f"ticks started in each second of the window: {per_s.tolist()}")
    per_tick = {k: (counts1[k] - counts0[k]) / ticks for k in counts1 if counts1[k] != counts0[k]}
    say(f"port kernel launches a tick: {per_tick} (a tick of this kind: {cell.kind.LAUNCHES})")
    if state["errors"]:
        say(f"first error: {state['errors'][0]}")

    result = {"correct": False, "attempted": attempted, "failed": state["failed"]}
    raised = state["raised"]
    summary = None
    if traced:
        probe.rows.clear()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            for _ in range(TRACE_WARM_TICKS):
                tick()
        c0 = K.launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(TRACE_TICKS):
                tick()
            if on_cuda:
                torch.cuda.synchronize()
        c1 = K.launch_counts()
        t_red = time.perf_counter()
        import pint_tpu_torch
        kernels = trace.port_kernels(Path(pint_tpu_torch.__file__).parent / "csrc")
        summary = trace.summarize(prof.profiler.kineto_results.events(), kernels)
        summary.calls = {k: (c1[k] - c0.get(k, 0)) / summary.ticks
                         for k in c1 if c1[k] != c0.get(k, 0)}
        say(f"traced slice: {summary.ticks} ticks, {len(summary.ops)} device operations "
            f"({summary.unplaced} outside every tick or with no runtime call), "
            f"{B * summary.ticks / (summary.wall_ns / 1e9):.1f} plants/s traced against "
            f"{plants_per_s:.1f} untraced; reduced in {time.perf_counter() - t_red:.1f} s; "
            f"{len(kernels)} port kernel names; port kernel calls a tick {summary.calls}")
        say(f"traced slice's wall time: {summary.wall_ns / 1e6:.3f} ms, of it "
            f"{summary.tick_ns / 1e6:.3f} ms in the public calls and "
            f"{summary.plant_ns / 1e6:.3f} ms ({100.0 * summary.plant_ns / summary.wall_ns:.2f}%) "
            f"in the benchmark's plant step; device busy {summary.busy_ns() / 1e6:.3f} ms, "
            f"{summary.busy_in_ticks_ns() / 1e6:.3f} ms of it inside the calls")
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    say(f"memory: max_memory_allocated {peak} bytes; nvidia-smi (name, power limit, "
        f"draw, SM clock, max SM clock, temperature): {nvidia_smi() if on_cuda else 'no card'}")

    metrics = {}
    result["device"] = _device(device, peak)
    if traced:
        for m in cell.per_layer:
            v = reader(root, m["name"])(summary, cell)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["device"]["busy_s"] = summary.busy_ns() / 1e9
        result["device"]["window_s"] = summary.wall_ns / 1e9
        result["breakdown"] = summary.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] in end_to_end:
                metrics[m["name"]] = {"value": end_to_end[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics

    # -- the check, once the window has closed and the service is freed ----------
    probe.restore()
    del service, probe, summary
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = cell.kind.Reference(cell.config, device)
    nums = compare.compare(ref, start, steps, pairs) if steps and start else {}
    say(f"check: {len(steps)} sampled ticks of {S} problems, {len(pairs)} carried pairs, "
        f"{len(start_rows) if start else 0} problems of the first tick; reference "
        f"{time.perf_counter() - t_ref:.1f} s")
    if keep is not None:
        keep.update(start=start, steps=steps, pairs=pairs, ref=ref, nums=nums)
    say("numbers read but not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in nums.items() if k not in cell.config["limits"]))
    checks = {}
    for k, limit in cell.config["limits"].items():
        checks[k] = {"value": nums.get(k), "limit": limit}
    checks["ticks_raised"] = {"value": raised, "limit": 0}
    result["correct"] = bool(nums) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def _device(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA card(s); torch.cuda.is_available() "
            f"is {torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = banned_modules()
    if found:
        say(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    for k, c in result["checks"].items():
        say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
