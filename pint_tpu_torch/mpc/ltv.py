"""Word-space SQP inner and cost helpers (port of parts of
``pint_tpu/mpc/ltv.py``).

Ported: :func:`_lower_words`, :func:`_pgd_batched_h` (the word-space PGD
with a per-problem Hessian and error feedback, the plain reference that the
K4 kernel is held to), its column-sharded forms for a tp mesh
(:func:`_pgd_cols_loop`, :func:`_pgd_batched_h_cols` with the plain column
dot, :func:`_pgd_batched_h_cols_hqt` with K10) and a numpy
:func:`true_cost` for cost parity.  ``QuantizedSQP`` and ``SQPController``
are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.ops import word as W

__all__ = ["true_cost"]


def _lower_words() -> int:
    """The packed word of four -127 lanes (the box floor), as the int32
    two's-complement value of its bits."""
    w = 0
    for off in CONTROL_LAYOUT.offsets:
        w |= (-127 & 0xFF) << off
    return w - (1 << 32) if w >> 31 else w


def _pgd_cols_loop(u_words, g_r, hs_num, hs_den, acc_of, *, iters, g_shift):
    """The error-feedback PGD iteration on packed words, shared by the
    single-device inner and its column-sharded forms (one body, so they
    cannot drift apart).  ``acc_of(lanes)`` supplies the raw int32 gradient
    accumulator of the iterate's columns; everything else -- step scaling,
    error feedback, the saturating packed update and the -127 box floor --
    is here.  u_words (B, K/4) int32 words; g_r (B, K) int32; hs_num,
    hs_den (B,) int32."""
    lower = torch.full_like(u_words, _lower_words())
    num, den = hs_num[:, None], hs_den[:, None]
    half = 1 << (g_shift - 1)
    carry = torch.zeros_like(g_r)
    words = u_words
    for _ in range(iters):
        pre = (acc_of(unpack_controls(words)) * num) >> den
        step = -(pre + g_r) + carry
        delta = torch.clamp((step + half) >> g_shift, -128, 127)
        carry = step - (delta << g_shift)
        words = W.add_signed_saturate(CONTROL_LAYOUT, words, pack_controls(delta))
        words = W.max_signed(CONTROL_LAYOUT, words, lower)
    return words


def _bmv(m, lanes):
    """Batched int8 matvec (B, N, K) @ (B, K) -> (B, N) int32 as an exact
    float64 product; ``m`` is already float64."""
    return torch.bmm(m, lanes.to(torch.float64)[:, :, None])[..., 0].to(torch.int32)


def _pgd_batched_h(u_words, g_pre, Hq, hs_num, hs_den, *, iters, g_shift):
    """Fixed-point PGD with a per-problem Hessian, on packed words.

    u_words (B, Tp/4) int32 words; g_pre (B, Tp) int32; Hq (B, Tp, Tp) int8;
    hs_num, hs_den (B,) int32.  The same iteration as ``pint_tpu``'s
    ``_pgd_batched_h``: saturating packed update, then the -127 box floor.
    The int8 matvec runs as an exact float64 batched product."""
    Hd = Hq.to(torch.float64)
    return _pgd_cols_loop(u_words, g_pre, hs_num, hs_den, lambda u: _bmv(Hd, u),
                          iters=iters, g_shift=g_shift)


def _pgd_batched_h_cols(u_words, g_r, Hq, hs_num, hs_den, *, iters, g_shift,
                        group, rank, block):
    """Column-sharded :func:`_pgd_batched_h` on tp rank ``rank`` of the
    process group ``group``: the horizon splits into ``block``-wide column
    blocks.  u_words (B, block/4) and g_r (B, block) are this rank's
    columns; Hq (B, Tp, Tp) int8 is tp-replicated.

    Each iteration this rank's columns contribute ``U_r @ Hq[:, :, cols_r]^T``
    to an exact int32 all-reduce of the full gradient, and the rank updates
    only its own columns: bit-identical to :func:`_pgd_batched_h`
    restricted to these columns."""
    from pint_tpu_torch.parallel.mesh import psum

    cols = slice(rank * block, (rank + 1) * block)
    Hc = Hq[:, :, cols].to(torch.float64)

    def acc_of(lanes):
        return psum(_bmv(Hc, lanes), group)[:, cols]

    return _pgd_cols_loop(u_words, g_r, hs_num, hs_den, acc_of,
                          iters=iters, g_shift=g_shift)


def _pgd_batched_h_cols_hqt(u_words, g_r, hqt, hs_num, hs_den, *, iters, g_shift,
                            group, rank, block):
    """:func:`_pgd_batched_h_cols` with the rank's matvec as K10
    (:func:`~pint_tpu_torch.mpc.fused_alm.pgd_matvec_cols`), launched once
    an iteration with the int32 all-reduce between launches.  hqt
    (Tm, Tm, B) int8 is the full batch-last slab that K3 emits
    (``Hq = hqt.permute(2, 1, 0)``); this rank reads its k-slice.
    Bit-identical to :func:`_pgd_batched_h_cols` (int32 sums are exact)."""
    from pint_tpu_torch.mpc.fused_alm import pgd_matvec_cols
    from pint_tpu_torch.parallel.mesh import psum

    cols = slice(rank * block, (rank + 1) * block)
    hqt_r = hqt[cols]                       # (block, Tm, B), contiguous

    def acc_of(lanes):
        return psum(pgd_matvec_cols(lanes, hqt_r), group)[:, cols]

    return _pgd_cols_loop(u_words, g_r, hs_num, hs_den, acc_of,
                          iters=iters, g_shift=g_shift)


def true_cost(sqp, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
    """The nonlinear objective of lane plans (B, T*m) under ``sqp``'s
    model, weights and target, by a float64 numpy rollout -- the quantity
    ``pint_tpu``'s ``QuantizedSQP.true_cost`` computes."""
    T, m = sqp.horizon, sqp.n_ctrl
    s = np.asarray(sqp.model.lane_scales, np.float64)
    u_phys = np.asarray(lanes, np.float64).reshape(-1, T, m) * s
    traj = sqp.model.reference_rollout(np.atleast_2d(x0_f), u_phys)
    n = traj.shape[-1]
    x_ref = np.broadcast_to(np.asarray(sqp.x_ref, float), (T, n))
    dx = traj[:, 1:] - x_ref
    Q = np.asarray(sqp.Q, float)
    Qs = np.stack([Q] * (T - 1) + [sqp.Qf_matrix])
    state_cost = np.einsum("bki,kij,bkj->b", dx, Qs, dx)
    R = np.asarray(sqp.R, float)
    ctrl_cost = np.einsum("bki,ij,bkj->b", u_phys, R, u_phys)
    return state_cost + ctrl_cost
