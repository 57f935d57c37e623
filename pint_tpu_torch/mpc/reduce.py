"""An SQP iteration's reduce: the condensed Hessian and linear term from the
propagator stacks, for ``reduce="sym"`` (``Q = L L^T``).

From ``Abar (B, T, n, n)``, ``Bbar (B, T, n, Tm)`` and ``Cbar (B, T, n)``
(the recursion's stacks, batch-first and contiguous, as
:func:`~pint_tpu_torch.mpc.propagate.chain_fused` and
:func:`~pint_tpu_torch.mpc.propagate.chain_plain` return them), for each
problem:

* ``Ht = sum_t W_t^T W_t + BQT^T B_{T-1} + R_kron`` with ``W_t = L^T
  Bbar_t`` and ``BQT = (Qf - Q)^T B_{T-1}``;
* ``g = G x0 + g_ref`` with ``G = sum_t W_t^T L^T Abar_t + BQT^T
  Abar_{T-1}`` and ``g_ref = sum_t W_t^T L^T (Cbar_t - x_ref_t) + BQT^T
  (Cbar_{T-1} - x_ref_{T-1})``,

the terms of ``DeviceSQP._reduce_sym``.  Column j of ``Bbar_t`` is zero for
``t < j // m`` (control j moves no earlier state), so each sum over t runs
over the live steps alone: ``t >= max(j1, j2) // m`` for ``Ht[j1, j2]``,
``t >= j // m`` for ``g[j]``.

:func:`reduce_fused` computes both in one CUDA kernel
(``csrc/reduce.cu``), which writes ``Ht`` in the order the quantization
reads it (batch-last to :data:`~pint_tpu_torch.ops.kernels.LONG_LANES`,
problem-major past them, as ``DeviceSQP._hand_over`` gives it) and never
stores ``W``; for CPU tensors it runs :func:`reduce_plain`.  The plain
version repeats the kernel's order of roundings, one elementwise operation
a rounding, so the two are bit-identical on the card for every problem:

1. ``W_t[l, j] = sum_i L[i, l] Bbar_t[i, j]``, ``LA_t[l, q] = sum_i L[i, l]
   Abar_t[i, q]``, ``Cx_t = Cbar_t - x_ref_t``, ``LCx_t[l] = sum_i L[i, l]
   Cx_t[i]``, ``BQT[k, j] = sum_i dQ[i, k] B_{T-1}[i, j]``;
2. each sum over i, l or q (a dot) rounds every product and adds them from
   the first, in index order;
3. each accumulator starts at +0.0 and adds step t's dot, t ascending over
   the live steps: ``acc[j1, j2] += W_t[:, j1] . W_t[:, j2]``,
   ``accG[j, q] += W_t[:, j] . LA_t[:, q]``, ``accR[j] += W_t[:, j] .
   LCx_t``;
4. ``Ht[j1, j2] = (acc + BQT[:, a] . B_{T-1}[:, b]) + R_kron[a, b]`` with
   ``a, b = min, max(j1, j2)``, so ``Ht`` is exactly symmetric;
5. ``G[j, q] = accG + BQT[:, j] . Abar_{T-1}[:, q]``, ``g_ref[j] = accR +
   BQT[:, j] . Cx_{T-1}``, ``g[j] = G[j, :] . x0 + g_ref[j]``.

Against ``_reduce_sym``, whose sums run in cuBLAS's (or the CPU GEMM's)
order, both agree to f32 roundoff.

The solvers choose it at construction (``forms["reduce"]``, from
:func:`reduce_form`).  The kernel's launches are counted under "reduce"
(:func:`launch_count`), beside and not among
:func:`~pint_tpu_torch.ops.kernels.launch_counts`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.ops import kernels as K

__all__ = ["MAX_LANES", "MAX_STATES", "launch_count", "reduce_fits", "reduce_form",
           "reduce_fused", "reduce_plain"]

MAX_STATES = 6
"""The kernel's largest state dimension n: a thread holds 12 n operands of
its 4 x 8 sub-tile a step, beside 32 accumulators."""

MAX_LANES = 4096
"""The kernel's largest Tm = T m."""


def launch_count() -> int:
    """Launches of the reduce kernel since the last
    :func:`~pint_tpu_torch.ops.kernels.reset_launch_counts`, graph replays
    included."""
    return K._counts.get("reduce", 0)


def reduce_fits(n: int, m: int, T: int) -> bool:
    """Whether the kernel takes n states, m controls and horizon T: n to
    :data:`MAX_STATES`, Tm = T m to :data:`MAX_LANES` and a multiple of 4
    (the solvers' int8 lanes pack four to a word)."""
    Tm = T * m
    return 1 <= n <= MAX_STATES and m >= 1 and 1 <= T and 0 < Tm <= MAX_LANES and Tm % 4 == 0


def reduce_form(sqp, recursion: bool) -> str:
    """The form of the solver ``sqp``'s reduce: "kernel" (:func:`reduce_fused`,
    or its plain version) where ``sqp.reduce`` is "sym", the iteration runs
    the propagator recursion and :func:`reduce_fits` takes the shape, else
    "torch" (the solver's own contraction for ``reduce``)."""
    n = np.asarray(sqp.Q).shape[0]
    fits = reduce_fits(n, sqp.n_ctrl, sqp.horizon)
    return "kernel" if recursion and sqp.reduce == "sym" and fits else "torch"


def _dot(terms):
    """Sum of products in index order: each product rounded, then added to
    the sum of those before it, from the first."""
    out = None
    for a, b in terms:
        p = a * b
        out = p if out is None else out + p
    return out


def _check(sqp, Abar, Bbar, Cbar, x0_f):
    """(B, T, n, m) of the stacks; raises on any shape, dtype or device the
    reduce does not take."""
    if Bbar.dim() != 4:
        raise ValueError(f"Bbar must be (B, T, n, Tm), got {tuple(Bbar.shape)}")
    B, T, n, Tm = Bbar.shape
    m = sqp.n_ctrl
    want = {"Abar": (Abar, (B, T, n, n)), "Bbar": (Bbar, (B, T, n, T * m)),
            "Cbar": (Cbar, (B, T, n)), "x0_f": (x0_f, (B, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != Bbar.device:
            raise ValueError(f"reduce: tensors on {t.device} and {Bbar.device}")
    if T != sqp.horizon or np.asarray(sqp.Q).shape != (n, n):
        raise ValueError(f"stacks of horizon {T} and {n} states; the solver has "
                         f"{sqp.horizon} and Q {np.asarray(sqp.Q).shape}")
    if sqp._consts["L"] is None:
        raise ValueError("reduce: the kernel's form needs reduce='sym' (Q = L L^T)")
    if not reduce_fits(n, m, T):
        raise ValueError(f"reduce: n {n}, m {m}, T {T} past the kernel's fit "
                         f"(n <= {MAX_STATES}, T m <= {MAX_LANES}, a multiple of 4)")
    return B, T, n, m


def reduce_plain(sqp, Abar: torch.Tensor, Bbar: torch.Tensor, Cbar: torch.Tensor,
                 x0_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`reduce_fused`, on any device: the
    module's order of roundings, each step restricted to its live block.
    Returns (Ht (Tm, Tm, B) in ``DeviceSQP._hand_over``'s order, g (B,
    Tm))."""
    B, T, n, m = _check(sqp, Abar, Bbar, Cbar, x0_f)
    c = sqp._consts
    L, dQ = c["L"], c["dQ"]
    Tm = T * m
    rn = range(n)
    W = [_dot((L[i, l], Bbar[:, :, i]) for i in rn) for l in rn]        # (B, T, Tm)
    LA = [_dot((L[i, l], Abar[:, :, i]) for i in rn) for l in rn]       # (B, T, n)
    Cx = Cbar - c["x_ref"]                                              # (B, T, n)
    LCx = [_dot((L[i, l], Cx[:, :, i]) for i in rn) for l in rn]        # (B, T)
    H = Bbar.new_zeros((B, Tm, Tm))
    G = Bbar.new_zeros((B, Tm, n))
    r = Bbar.new_zeros((B, Tm))
    for t in range(T):
        e = (t + 1) * m                                 # the live columns
        w = [W[l][:, t, :e] for l in rn]
        H[:, :e, :e] += _dot((w[l][:, :, None], w[l][:, None, :]) for l in rn)
        G[:, :e] += _dot((w[l][:, :, None], LA[l][:, t, None, :]) for l in rn)
        r[:, :e] += _dot((w[l], LCx[l][:, t, None]) for l in rn)
    BT = Bbar[:, T - 1]                                                 # (B, n, Tm)
    BQT = [_dot((dQ[i, k], BT[:, i]) for i in rn) for k in rn]         # (B, Tm)
    term = _dot((BQT[i][:, :, None], BT[:, i, None, :]) for i in rn)   # (B, Tm, Tm)
    upper = torch.ones((Tm, Tm), dtype=torch.bool, device=H.device).triu()
    term = torch.where(upper, term, term.transpose(1, 2))
    Rk = c["R_kron"]
    H = (H + term) + torch.where(upper, Rk, Rk.T)
    AT = Abar[:, T - 1]                                                 # (B, n, n)
    G = G + _dot((BQT[i][:, :, None], AT[:, i, None, :]) for i in rn)
    r = r + _dot((BQT[i], Cx[:, T - 1, i, None]) for i in rn)
    g = _dot((G[:, :, q], x0_f[:, q, None]) for q in rn) + r
    return sqp._hand_over(H), g


def reduce_fused(sqp, Abar: torch.Tensor, Bbar: torch.Tensor, Cbar: torch.Tensor,
                 x0_f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The solver ``sqp``'s reduce in one kernel launch: (Ht (Tm, Tm, B),
    g (B, Tm)) f32 from the stacks and ``x0_f`` (B, n), ``Ht`` batch-last
    and contiguous to 64 lanes and the ``permute(1, 2, 0)`` view of a
    problem-major (B, Tm, Tm) buffer past them.  Kernel for CUDA tensors,
    :func:`reduce_plain` for CPU tensors."""
    B, T, n, m = _check(sqp, Abar, Bbar, Cbar, x0_f)
    if Bbar.device.type == "cpu":
        return reduce_plain(sqp, Abar, Bbar, Cbar, x0_f)
    c = sqp._consts
    consts = (c["L"], c["dQ"], c["R_kron"], c["x_ref"])
    dev = K.require_cuda("reduce_fused", Abar, Bbar, Cbar, x0_f, *consts)
    Tm = T * m
    long = Tm > K.LONG_LANES
    Hb = torch.empty((B, Tm, Tm) if long else (Tm, Tm, B), dtype=torch.float32, device=dev)
    g = torch.empty((B, Tm), dtype=torch.float32, device=dev)
    if B:
        with torch.cuda.device(dev):
            err = K.library().pint_reduce(
                Abar.data_ptr(), Bbar.data_ptr(), Cbar.data_ptr(), x0_f.data_ptr(),
                *(t.data_ptr() for t in consts), Hb.data_ptr(), g.data_ptr(),
                B, T, n, m, int(long), K.stream_of(Bbar))
        K.check(err, "reduce_fused")
        K.count_launch("reduce")
    return (Hb.permute(1, 2, 0) if long else Hb), g
