"""An SQP iteration's constraint stacking: the rows of the state constraints
``lo <= F x_k <= hi`` from the propagator stacks, batch-last.

From ``Abar (B, T, n, n)``, ``Bbar (B, T, n, Tm)`` and ``Cbar (B, T, n)``
(the recursion's stacks, batch-first and contiguous, as
:func:`~pint_tpu_torch.mpc.propagate.chain_fused` and
:func:`~pint_tpu_torch.mpc.propagate.chain_plain` return them) and ``F``
(Cs, n), with C = T Cs:

* ``S_t (C, Tm, B)``, ``S_t[k Cs + c, j, b] = sum_i F[c, i] Bbar[b, k, i, j]``,
  contiguous, as K6 (``pen_fused``) and ``_pen_lipschitz`` read it;
* ``P_t (C, n, B)``, ``P_t[k Cs + c, q, b] = sum_i F[c, i] Abar[b, k, i, q]``;
* ``r_t (C, B)``, ``r_t[k Cs + c, b] = sum_i F[c, i] Cbar[b, k, i]``,

what ``DeviceConstrainedSQP._stack_constraints``'s torch form (two einsums)
returns, in the same shapes and order.

:func:`stack_fused` writes all three in one CUDA kernel
(``csrc/stack.cu``); for CPU tensors it runs :func:`stack_plain`.  The
plain version repeats the kernel's order of roundings, one elementwise
operation a rounding, so the two are bit-identical on the card for every
input: each product ``F[c, i] x_i`` is rounded alone, and each sum starts
from the first product and adds the others in index order over i.  Every
row is read and multiplied, where ``F`` is zero too, so a NaN anywhere in a
problem's stacks reaches its rows.  Against the einsums, whose sums run in
the GEMM's order, both agree to f32 roundoff; on a one-hot ``F`` (the
benchmark's corridors) each row is the selected stack's entry itself, so
the two forms agree bit for bit, the signs of zeros aside.

The solvers choose it at construction (``forms["stack"]``, from
:func:`stack_fits`).  ``F`` is a constant of the solver and arrives on the
host, so the kernel takes it as arguments.  The kernel's launches are
counted under "stack" (:func:`launch_count`), beside and not among
:func:`~pint_tpu_torch.ops.kernels.launch_counts`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.ops import kernels as K

__all__ = ["MAX_ROWS", "MAX_STATES", "launch_count", "stack_fits", "stack_fused",
           "stack_plain"]

MAX_STATES = 6
"""The kernel's largest state dimension n: warps 0 .. n of a block form P's
columns and r."""

MAX_ROWS = 8
"""The kernel's largest Cs, the rows of ``F``: a block stages 32 x 32
values of each."""

_MAX_GRID = 65535
"""The largest T and Tm / 32: the kernel's grid dimensions past the first."""


def launch_count() -> int:
    """Launches of the stacking kernel since the last
    :func:`~pint_tpu_torch.ops.kernels.reset_launch_counts`, graph replays
    included."""
    return K._counts.get("stack", 0)


def stack_fits(n: int, Cs: int, T: int, Tm: int) -> bool:
    """Whether the kernel takes n states, Cs rows of ``F``, horizon T and
    Tm decision lanes: n to :data:`MAX_STATES`, Cs to :data:`MAX_ROWS`, Tm
    a multiple of 4 (a lane's 16-byte loads; the solvers' int8 lanes pack
    four to a word), T and Tm / 32 within the grid."""
    return (1 <= n <= MAX_STATES and 1 <= Cs <= MAX_ROWS and 1 <= T <= _MAX_GRID
            and 0 < Tm <= 32 * _MAX_GRID and Tm % 4 == 0)


def _check(F, Abar, Bbar, Cbar):
    """(F as f32 numpy (Cs, n), B, T, n, Tm); raises on any shape, dtype or
    device the stacking does not take."""
    F = np.atleast_2d(np.asarray(F, np.float32))
    if Bbar.dim() != 4:
        raise ValueError(f"Bbar must be (B, T, n, Tm), got {tuple(Bbar.shape)}")
    B, T, n, Tm = Bbar.shape
    if F.shape[1:] != (n,):
        raise ValueError(f"F must be (Cs, {n}), got {F.shape}")
    want = {"Abar": (Abar, (B, T, n, n)), "Bbar": (Bbar, (B, T, n, Tm)),
            "Cbar": (Cbar, (B, T, n))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
        if t.device != Bbar.device:
            raise ValueError(f"stack: tensors on {t.device} and {Bbar.device}")
    if not stack_fits(n, F.shape[0], T, Tm):
        raise ValueError(f"stack: n {n}, Cs {F.shape[0]}, T {T}, Tm {Tm} past the kernel's "
                         f"fit (n <= {MAX_STATES}, Cs <= {MAX_ROWS}, Tm a multiple of 4)")
    return F, B, T, n, Tm


def _rows(F, x):
    """``(T, Cs, ...)`` from ``x`` (T, n, ..., B): row c is sum_i F[c, i]
    x[:, i], each product rounded, then added to the sum of those before it,
    from the first."""
    out = []
    for f in F:
        s = None
        for i, fi in enumerate(f):
            p = x[:, i] * float(fi)
            s = p if s is None else s + p
        out.append(s)
    return torch.stack(out, dim=1)


def stack_plain(F, Abar: torch.Tensor, Bbar: torch.Tensor,
                Cbar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`stack_fused`, on any device: the
    module's order of roundings, elementwise on batch-last views of the
    stacks.  ``F`` (Cs, n) on the host.  Returns (S_t (C, Tm, B), P_t (C, n,
    B), r_t (C, B)), contiguous."""
    F, B, T, n, Tm = _check(F, Abar, Bbar, Cbar)
    C = T * F.shape[0]
    S_t = _rows(F, Bbar.permute(1, 2, 3, 0)).reshape(C, Tm, B)
    P_t = _rows(F, Abar.permute(1, 2, 3, 0)).reshape(C, n, B)
    r_t = _rows(F, Cbar.permute(1, 2, 0)).reshape(C, B)
    return S_t.contiguous(), P_t.contiguous(), r_t.contiguous()


def stack_fused(F, Abar: torch.Tensor, Bbar: torch.Tensor,
                Cbar: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The constraint rows in one kernel launch: (S_t (C, Tm, B), P_t (C,
    n, B), r_t (C, B)) f32, contiguous and batch-last, from the stacks and
    ``F`` (Cs, n) on the host.  Kernel for CUDA tensors, :func:`stack_plain`
    for CPU tensors."""
    F, B, T, n, Tm = _check(F, Abar, Bbar, Cbar)
    if Bbar.device.type == "cpu":
        return stack_plain(F, Abar, Bbar, Cbar)
    Abar, Bbar, Cbar = Abar.contiguous(), Bbar.contiguous(), Cbar.contiguous()
    dev = K.require_cuda("stack_fused", Abar, Bbar, Cbar)
    Cs = F.shape[0]
    C = T * Cs
    S_t = torch.empty((C, Tm, B), dtype=torch.float32, device=dev)
    P_t = torch.empty((C, n, B), dtype=torch.float32, device=dev)
    r_t = torch.empty((C, B), dtype=torch.float32, device=dev)
    if B:
        f = (ctypes.c_float * F.size)(*F.ravel().tolist())
        with torch.cuda.device(dev):
            err = K.library().pint_stack(
                Abar.data_ptr(), Bbar.data_ptr(), Cbar.data_ptr(), ctypes.addressof(f),
                S_t.data_ptr(), P_t.data_ptr(), r_t.data_ptr(), B, T, n, Tm, Cs,
                K.stream_of(Bbar))
        K.check(err, "stack_fused")
        K.count_launch("stack")
    return S_t, P_t, r_t
