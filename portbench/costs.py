"""The least time an H100 could take for a kernel's work, from its shapes.

A frozen copy of the port's roofline arithmetic for its MPC kernels, so
that the yardstick does not move when the program does: the bytes a
kernel must move (each input read once, each output written once) and
the operations its inputs need, and their bound against NVIDIA's published
peaks of one H100 SXM (data sheet, dense rates): 3.35 TB/s of HBM, 1,979
int8 tensor-core TOP/s, 67 float32 TFLOP/s outside the tensor cores.  A
card set below its 700 W limit runs below them.  Pure arithmetic; nothing
here is measured.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

H100_SXM = {
    "bytes_per_s": 3.35e12,
    "int8": 1979e12,     # an int8 multiply-accumulate counts 2 operations
    "f32": 67e12,        # a multiply and an add, 2
}


@dataclasses.dataclass(frozen=True)
class KernelCost:
    bytes: int       # each input read once, each output written once
    ops: int         # operations these inputs need
    op_type: str     # key of the peak rate the operations run at


def _alm_macs(Tp: int, Cp: int, outer: int, inners: int) -> int:
    """int8 MACs of one problem's ALM solve: each inner step runs H u, S u
    and two S^T y; each outer step one more S u."""
    return outer * (inners * (Tp * Tp + 3 * Cp * Tp) + Cp * Tp)


def kernel_cost(kernel: str, **s) -> KernelCost:
    """Bytes and operations of one call at the given shape.

    ``fused_pgd`` (box-QP PGD on a shared Hessian; ``packed=True`` for int8
    words in and out): B, Tp, iters.  ``lipq`` (power iteration and int8
    quantization of a per-problem f32 Hessian): B, Tm, power_iters.
    ``pgd_hqt`` (PGD on per-problem int8 Hessians; ``words=True`` for
    packed words): B, Tp, iters.  ``alm`` (per-problem ALM) and
    ``alm_shared`` (ALM on shared matrices): B, Tp, Cp, outer, inners.
    ``pen`` (power iteration and int8 quantization of constraint rows): B,
    C, Tm, power_iters.  ``pgd_matvec_cols`` (a column block's int8
    matvec): B, K, rows."""
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
        if kernel == "alm":                        # H, one orientation of S, lo, hi, rationals
            mats = B * (Tp * Tp + Cp * Tp) + 4 * B * (2 * Cp + 8)
        else:                                      # one H, S, lo, hi
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
    raise ValueError(f"unknown kernel {kernel!r}")


def bound_ms(cost: KernelCost) -> Tuple[float, str]:
    """The least milliseconds for ``cost``: the larger of its bytes over
    the memory rate and its operations over the peak of their type, and
    which of the two ("bytes", "operations") sets it."""
    t_bytes = cost.bytes / H100_SXM["bytes_per_s"] * 1e3
    t_ops = cost.ops / H100_SXM[cost.op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
