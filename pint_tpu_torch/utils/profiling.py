"""Profiling and roofline reporting (port of ``pint_tpu/utils/profiling.py``).

* :func:`trace` -- context manager around ``torch.profiler``, writing a
  Chrome trace of the enclosed block (kernel names, device time, launches).
* :func:`op_word_costs` -- whole-word integer op counts of each packed op.
* :func:`roofline_report` -- measured op rates against the memory and
  integer-ALU bounds.  Callers pass the card's own calibration (a raw-add
  rate, its SM count and clock); nothing here holds a device constant.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator

import torch

from pint_tpu_torch.layout import PackedLayout

__all__ = ["trace", "roofline_report", "op_word_costs"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU, and CUDA when there is a card) and
    write ``logdir/trace.json`` for chrome://tracing or Perfetto."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Whole-word integer op counts per packed op (AND/OR/XOR/ADD/SUB/SHIFT all
# count 1), derived from the branch-free formulas in ops/word.py.  ``d`` is
# the number of saturation-dispatch terms of the layout.
def op_word_costs(layout: PackedLayout) -> Dict[str, int]:
    d = len(layout.sat_terms) * 2 + (
        1 if layout.sat_final_mask is not None else 0
    )
    smear = 2 + d            # shift, sub, dispatch
    carry = 5                # (a&b)|((a|b)&~(a+b))
    return {
        "add_wrap": 6,
        "sub_wrap": 10,
        "add_unsigned_saturate": 6 + carry + 1 + smear + 1,
        "sub_unsigned_saturate": 7 + carry + 1 + smear + 1 + 6,
        "add_signed_saturate": 6 + 4 + 2 * (1 + d) + 4,
        "sub_signed_saturate": 10 + 5 + 2 * (1 + d) + 4,
        "min_unsigned": carry + 1 + smear + 3,
        "max_unsigned": carry + 1 + smear + 3,
        "min_signed": carry + 3 + smear + 3,
        "max_signed": carry + 3 + smear + 3,
        # per-word work after the (scalar) mask build: and, shift, guard-and
        "shift_left": 3,
        "shift_right_unsigned": 3,
    }


# words of memory traffic per op application (binops stream 2 in + 1 out;
# shifts stream 1 in + 1 out -- the amount is a scalar)
_TRAFFIC_WORDS = {"shift_left": 2, "shift_right_unsigned": 2}


def roofline_report(
    layout: PackedLayout,
    measured_words_per_s: Dict[str, float],
    mem_bytes_per_s: float,
    alu_ops_per_s: float,
) -> Dict[str, Dict[str, float]]:
    """Efficiency of each measured op against its memory/ALU roofline.

    An elementwise binop streams 3 words (2 in, 1 out; shifts 2); the
    bound is min(memory words/s, ALU words/s given the op's whole-word op
    count).  ``mem_bytes_per_s`` must come from the same harness as the
    measurements (the raw int32 add of the headline, the analog of the
    reference's ``Baseline`` fixture, pint_bench.cpp:77-83);
    ``alu_ops_per_s`` is the card's integer-op rate.
    """
    costs = op_word_costs(layout)
    out = {}
    for op, wps in measured_words_per_s.items():
        c = costs.get(op)
        words = _TRAFFIC_WORDS.get(op, 3)
        mem_bound = mem_bytes_per_s / (words * layout.word_dtype.itemsize)
        bounds = [mem_bound]
        if c:
            bounds.append(alu_ops_per_s / c)
        sol = min(bounds)
        out[op] = {
            "measured_Gwords_per_s": wps / 1e9,
            "speed_of_light_Gwords_per_s": sol / 1e9,
            "efficiency": wps / sol,
            "bound": "mem" if sol == mem_bound else "alu",
        }
    return out
