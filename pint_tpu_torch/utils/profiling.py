"""Profiling and roofline reporting (port of ``pint_tpu/utils/profiling.py``).

* :func:`trace` -- context manager around ``torch.profiler``, writing a
  Chrome trace of the enclosed block (kernel names, device time, launches).
* :func:`span` -- a named host range of the program's own (``pint.*``),
  recorded whenever a ``torch.profiler`` session records.
* :func:`op_word_costs` -- whole-word integer op counts of each packed op.
* :func:`roofline_report` -- measured op rates against the memory and
  integer-ALU bounds.  Callers pass the card's own calibration (a raw-add
  rate, its SM count and clock).
* :func:`kernel_cost` -- the bytes a kernel must move (each input read once,
  each output written once) and the operations it must do, from its shapes;
  :func:`bound_ms` -- the least time a card could take for them, against
  published peaks (:data:`H100_SXM`).  Pure arithmetic: nothing is measured.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterator, Tuple

import torch

from pint_tpu_torch.layout import PackedLayout

__all__ = ["H100_SXM", "KernelCost", "bound_ms", "kernel_cost", "op_word_costs",
           "roofline_report", "span", "trace"]

_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_NULL = contextlib.nullcontext()


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


def span(name: str):
    """A context manager that marks the enclosed host work as ``name`` in
    a ``torch.profiler`` trace: a host-only range on the profiler's clock,
    the clock of the runtime calls that launch each device operation, so
    operations and idle gaps can be placed inside it.  With no profiler
    recording it costs well under a microsecond and records nothing.

    It is ``_RecordFunctionFast``, a range of function scope that the
    profiler does not draw again on the device; never ``record_function``,
    whose user-scope range the device trace repeats as an annotation over
    the whole span, which a reader of the device's busy time would count
    as work.  Where torch lacks it, a shared null context."""
    return _NULL if _RecordFunctionFast is None else _RecordFunctionFast(name)


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


# -- kernel bounds ---------------------------------------------------------------

H100_SXM = {
    "bytes_per_s": 3.35e12,
    "int8": 1979e12,     # tensor cores, dense (an int8 MAC counts 2 operations)
    "f32": 67e12,        # outside the tensor cores (a multiply and an add, 2)
    "int32": 16.7e12,    # 132 SMs x 64 INT32 lanes x 1.98 GHz
}
"""Published peaks of one H100 SXM at its 700 W limit: NVIDIA's data sheet
(memory, int8, f32) and the Hopper white paper's SM (int32 lanes, boost
clock).  A card set to a lower power limit runs below them."""


@dataclasses.dataclass(frozen=True)
class KernelCost:
    bytes: int       # each input read once, each output written once
    ops: int         # operations these inputs need
    op_type: str     # key of the peak rate the operations run at


def _swar_cost(layout: PackedLayout, kind: str, n: int, op: str = "",
               steps: int = 1, pair: bool = False) -> KernelCost:
    """K1/K11a (binop), K9/K11b (shift), K8/K11c (accumulate) on ``n``
    words.  A u64 word, native or as a pair, costs two int32 operations."""
    w = layout.word_dtype.itemsize
    per = 2 if (pair or w == 8) else 1
    costs = op_word_costs(layout)
    if kind == "binop":
        return KernelCost(3 * n * w, n * costs[op] * per, "int32")
    if kind == "shift":
        return KernelCost(2 * n * w, n * costs[op] * per, "int32")
    if kind == "sat_accum":
        c = costs["add_signed_saturate" if op == "signed" else "add_unsigned_saturate"]
        return KernelCost((steps + 2) * n * w, n * steps * c * per, "int32")
    raise ValueError(f"unknown SWAR kernel kind {kind!r}")


def _alm_macs(Tp: int, Cp: int, outer: int, inners: int) -> int:
    """int8 MACs of one problem's ALM solve: each inner step runs Hq u,
    Sq u and two Sq^T y; each outer step one more Sq u."""
    return outer * (inners * (Tp * Tp + 3 * Cp * Tp) + Cp * Tp)


def kernel_cost(kernel: str, **shape) -> KernelCost:
    """Bytes and operations of one call of an MPC kernel (or, with
    ``layout`` and ``kind``, a SWAR kernel) at the given shape.

    ``fused_pgd`` (K2; ``packed=True`` for K2p): B, Tp, iters.
    ``lipq`` (K3): B, Tm, power_iters.  ``pgd_hqt`` (K4; ``words=True``
    for the words entry): B, Tp, iters.  ``alm`` (K5) and ``alm_shared``
    (K7): B, Tp, Cp, outer, inners.  ``pen`` (K6): B, C, Tm, power_iters.
    ``pgd_matvec_cols`` (K10): B, K, rows.  ``propagate`` (an SQP
    iteration's chain, ``mpc/propagate.py``): B, T, n (3), m (2).  ``reduce`` (an SQP
    iteration's reduce, ``mpc/reduce.py``): B, T, n, m.  ``stack`` (an SQP
    iteration's constraint stacking, ``mpc/stack.py``): B, T, n, Tm, Cs.
    ``swar``: layout, kind ("binop", "shift", "sat_accum"), n, op, steps,
    pair."""
    s = shape
    if kernel == "swar":
        return _swar_cost(**s)
    if kernel == "fused_pgd":
        B, Tp = s["B"], s["Tp"]
        lane = 1 if s.get("packed") else 4
        return KernelCost(2 * B * Tp * lane + 4 * B * Tp + Tp * Tp,
                          2 * s["iters"] * Tp * Tp * B, "int8")
    if kernel == "lipq":
        B, Tm = s["B"], s["Tm"]
        return KernelCost(5 * Tm * Tm * B + 8 * B,
                          2 * (s["power_iters"] + 1) * Tm * Tm * B, "f32")
    if kernel == "pgd_hqt":
        B, Tp = s["B"], s["Tp"]
        lane = 1 if s.get("words") else 4
        return KernelCost(Tp * Tp * B + 2 * B * Tp * lane + 4 * B * Tp + 8 * B,
                          2 * s["iters"] * Tp * Tp * B, "int8")
    if kernel in ("alm", "alm_shared"):
        B, Tp, Cp = s["B"], s["Tp"], s["Cp"]
        lanes = 4 * B * (2 * Tp + 4 * Cp)          # lanes, g, c_off, lam in; out
        if kernel == "alm":                        # hqt, one of sqj/sqc, lo, hi, sc
            mats = B * (Tp * Tp + Cp * Tp) + 4 * B * (2 * Cp + 8)
        else:                                      # one hq, sq, lo, hi
            mats = Tp * Tp + Cp * Tp + 8 * Cp
        return KernelCost(lanes + mats,
                          2 * B * _alm_macs(Tp, Cp, s["outer"], s["inners"]), "int8")
    if kernel == "pen":
        B, C, Tm = s["B"], s["C"], s["Tm"]
        return KernelCost(4 * C * Tm * B + 2 * C * Tm * B + 12 * B,
                          (4 * (s["power_iters"] + 1) + 2) * C * Tm * B, "f32")
    if kernel == "pgd_matvec_cols":
        B, Kc, rows = s["B"], s["K"], s["rows"]
        return KernelCost(Kc * rows * B + 4 * B * Kc + 4 * B * rows,
                          2 * Kc * rows * B, "int8")
    if kernel == "propagate":
        # Abar, Bbar, Cbar written (4 (n^2 T + n T Tm + n T) bytes a
        # problem), the int32 lanes and x0 read (4 Tm + 4 n); the
        # recursion's products and sums (2 n^2 a column a step: n rows of n,
        # summed from +0.0) over the live columns of S_k (m (k + 1) at step
        # k) and the n + 1 of P_k and c_k, the scalar rollout left out
        B, T = s["B"], s["T"]
        n, m = s.get("n", 3), s.get("m", 2)
        Tm = m * T
        return KernelCost(B * (4 * (n * n * T + n * T * Tm + n * T) + 4 * Tm + 4 * n),
                          2 * n * n * (m * T * (T + 1) // 2 + (n + 1) * T) * B, "f32")
    if kernel == "reduce":
        # the live columns of Bbar (t >= j // m), Abar and Cbar and x0 read,
        # Ht and g written; each product and sum one rounding, one f32
        # instruction and no FMA, so two of the "f32" peak's operations:
        # the upper triangle's dots over n (2n a live step), W = L^T Bbar a
        # live column and step (n dots of n), g's n + 1 dots a live column
        # and step, and the terminal term a pair (2n + 1)
        B, T, n, m = s["B"], s["T"], s["n"], s["m"]
        Tm = T * m
        live = n * m * T * (T + 1) // 2                 # live Bbar entries
        pairs = sum((j + 1) * (T - j // m) for j in range(Tm))
        rounds = (2 * n * pairs + (2 * n - 1) * live + 2 * (n + 1) * live
                  + (2 * n + 1) * Tm * (Tm + 1) // 2)
        return KernelCost(4 * B * (live + T * n * (n + 1) + n + Tm * Tm + Tm),
                          2 * rounds * B, "f32")
    if kernel == "stack":
        # Bbar, Abar and Cbar read, S_t, P_t and r_t written, every column,
        # the dead ones too; each of the T Cs (Tm + n + 1) outputs a dot over
        # n, 2n - 1 roundings, one f32 instruction and no FMA each, so two of
        # the "f32" peak's operations
        B, T, n, Tm, Cs = s["B"], s["T"], s["n"], s["Tm"], s["Cs"]
        outputs = T * Cs * (Tm + n + 1)
        return KernelCost(4 * B * (T * n * (Tm + n + 1) + outputs),
                          2 * (2 * n - 1) * outputs * B, "f32")
    raise ValueError(f"unknown kernel {kernel!r}")


def bound_ms(cost: KernelCost) -> Tuple[float, str]:
    """The least milliseconds an H100 (``H100_SXM``) could take for
    ``cost``, the larger of its bytes over the memory rate and its
    operations over the peak of their type, and which of the two ("bytes",
    "operations") sets it."""
    t_bytes = cost.bytes / H100_SXM["bytes_per_s"] * 1e3
    t_ops = cost.ops / H100_SXM[cost.op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
