"""The check that decides ``correct``: the port's answers against the plain
reference, each compared number beside its limit.

The service is a closed loop: every tick's warm state is the plan (and,
constrained, the multipliers) the previous tick left, so the tick depends
on every tick since the service was built.  Replaying that chain would
cost the reference as much as the window.  So the reference follows the
program step by step from the program's own warm state, and the start and
the carry that this skips are checked by themselves:

- **start**: the service's first tick begins from zero warm state; the
  reference solves it from its own zeros (sampled rows, ``start``).
- **steps**: at ticks drawn from the seed in the window, the reference
  takes the states the benchmark sent and the warm state the solver was
  handed, and solves the tick again (``steps``).  Its plans and
  multipliers are compared with those the solver returned, and its first
  controls with the controls the public call returned.
- **carry**: the warm state handed to the tick after a sampled one must be
  the reference's shift of what the sampled tick returned, exactly.

A state sent as not a number (a fault of the traffic) owes no solve: the
service must return a zero control for it and start its warm state over.
So in such a row the reference's control is zero and its carried warm
state is its zeros, and its plan and multipliers are not compared.

Numbers (over the sampled problems):

- ``start_diff_pct``, ``plan_diff_pct``: percent of problems whose plan
  differs from the reference's in any lane;
- ``control_diff_pct``: percent whose returned controls differ;
- ``<key>_diff_pct`` for each further part of the answer (``lam``, the
  multipliers): percent whose rows differ anywhere;
- ``carry_mismatch``: problems whose carried warm state is not what the
  reference carries from the previous answer (an exact comparison, limit
  0).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

CHUNK = 4096


def _cat(records: List[dict], key: str):
    return torch.cat([r[key] for r in records]) if records else None


def solve_reference(ref, x0: np.ndarray, ins: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's answers for states x0 (N, 3) float64 and inputs
    ``ins``, in blocks of rows so that it fits beside anything."""
    outs: Dict[str, List[torch.Tensor]] = {}
    for a in range(0, x0.shape[0], CHUNK):
        xs = torch.as_tensor(x0[a:a + CHUNK].astype(np.float32), device=ref.device)
        part = ref.step(xs, {k: v[a:a + CHUNK].to(ref.device) for k, v in ins.items()})
        for k, v in part.items():
            outs.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in outs.items()}


def set_precision(tf32: bool) -> None:
    """Full float32 products (``tf32=False``), or the TF32 control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _diff_pct(a: torch.Tensor, b: torch.Tensor) -> float:
    return 100.0 * float((a != b).any(dim=1).double().mean()) if a.shape[0] else 0.0


def _inputs(steps: List[dict]):
    """The sampled ticks' states (a fault's row as zeros), which rows were
    sent finite, and the warm state handed in."""
    x0 = np.concatenate([r["x0"] for r in steps])
    sent = np.isfinite(x0).all(axis=1)
    ins = {k: _cat([r["in"] for r in steps], k) for k in steps[0]["in"]}
    return np.where(sent[:, None], x0, 0.0), sent, ins


def compare(ref, start: dict, steps: List[dict], pairs: List[tuple]) -> Dict[str, float]:
    """The compared numbers.  ``start``: the first tick's record (``x0``,
    ``out``); ``steps``: records with ``x0`` (N, n) float64 as sent,
    ``in`` and ``out`` (dicts of tensors) and ``u`` (N, m) returned
    controls; ``pairs``: (record, next record) of consecutive ticks on the
    same rows."""
    set_precision(False)
    nums: Dict[str, float] = {}
    z = ref.zeros(start["x0"].shape[0])
    got = solve_reference(ref, start["x0"], z)
    nums["start_diff_pct"] = _diff_pct(ref.lanes(start["out"]["words"].to(ref.device)),
                                       ref.lanes(got["words"]))
    x0, sent, ins = _inputs(steps)
    ok = torch.as_tensor(sent, device=ref.device)
    outs = {k: _cat([r["out"] for r in steps], k).to(ref.device) for k in steps[0]["out"]}
    want = solve_reference(ref, x0, ins)
    port_l, ref_l = ref.lanes(outs["words"]), ref.lanes(want["words"])
    nums["plan_diff_pct"] = _diff_pct(port_l[ok], ref_l[ok])
    u = np.concatenate([r["u"] for r in steps])
    u_lanes = torch.as_tensor(np.rint(u / ref.lane_scales).astype(np.int32), device=ref.device)
    owed = torch.where(ok[:, None], ref_l[:, :u.shape[1]], 0)
    nums["control_diff_pct"] = _diff_pct(u_lanes, owed)
    for k in outs:
        if k != "words":
            nums[f"{k}_diff_pct"] = _diff_pct(outs[k][ok], want[k][ok])
    bad = 0
    for r, nxt in pairs:
        carried = ref.shift({k: v.to(ref.device) for k, v in r["out"].items()})
        fresh = ref.zeros(r["x0"].shape[0])
        sent_r = torch.as_tensor(np.isfinite(r["x0"]).all(axis=1), device=ref.device)
        same = torch.ones(r["x0"].shape[0], dtype=torch.bool, device=ref.device)
        for k, v in carried.items():
            owed = torch.where(sent_r[:, None], v, fresh[k])
            same &= (nxt["in"][k].to(ref.device) == owed).all(dim=1)
        bad += int((~same).sum())
    nums["carry_mismatch"] = float(bad)
    return nums


def control_readings(ref, start: dict, steps: List[dict]) -> Dict[str, float]:
    """The control: the reference in TF32, the nearest precision below the
    configuration's float32 with TF32 off, put in the program's place on
    the same sampled inputs; the numbers :func:`compare` reads for the
    program, but the carry, which no precision touches."""
    x0, sent, ins = _inputs(steps)
    ok = torch.as_tensor(sent, device=ref.device)
    z = ref.zeros(start["x0"].shape[0])
    set_precision(True)
    try:
        ctl, ctl0 = solve_reference(ref, x0, ins), solve_reference(ref, start["x0"], z)
    finally:
        set_precision(False)
    want, want0 = solve_reference(ref, x0, ins), solve_reference(ref, start["x0"], z)
    c_l, r_l = ref.lanes(ctl["words"])[ok], ref.lanes(want["words"])[ok]
    nums = {"start_diff_pct": _diff_pct(ref.lanes(ctl0["words"]), ref.lanes(want0["words"])),
            "plan_diff_pct": _diff_pct(c_l, r_l),
            "control_diff_pct": _diff_pct(c_l[:, :ref.m], r_l[:, :ref.m])}
    for k in want:
        if k != "words":
            nums[f"{k}_diff_pct"] = _diff_pct(ctl[k][ok], want[k][ok])
    return nums
