"""State-constrained SQP helpers: the word-space per-problem ALM inner.

PyTorch port of parts of ``pint_tpu/mpc/sqp_constrained.py``: the static
y-split shift (``_T_AMP``, ``_Y_SHIFT``), the vectorized rational
``_rational_vec`` and ``_alm_batched``, the batched integer ALM with
per-problem int8 Hessians and constraint rows -- the word-space reference
the K5 kernel (:func:`pint_tpu_torch.mpc.fused_alm.alm_hqt`) is held to, bit
for bit -- and its column-sharded forms for a tp mesh,
:func:`_alm_batched_cols` (plain column dots) and
:func:`_alm_batched_cols_hqt` (K10).  The reference's shared column body
``_alm_cols_loop`` is :func:`pint_tpu_torch.mpc.constrained._alm_loop`
here, the one body of every ALM form.  ``ConstrainedSQP`` waits for the LTV
modules it is built on (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.mpc.constrained import (
    _C_BITS,
    _CX0_CAP,
    _LAM_CAP,
    _Y_BITS,
    RATIONALS,
    _alm_loop,
    _word_space,
)
from pint_tpu_torch.mpc.ltv import _bmv

__all__ = []

# static y-split shift: the worst-case |t| bound is layout-independent
# (2**(_C_BITS-1) reachable c-pre + offset cap + multiplier cap), so the
# 14-bit split point is one constant for every problem
_T_AMP = float(1 << (_C_BITS - 1)) + float(_CX0_CAP) + float(_LAM_CAP)
_Y_SHIFT = max(0, int(np.ceil(np.log2(_T_AMP * 2.0))) - _Y_BITS)


def _rational_vec(
    val: np.ndarray, acc_max: int, budget: int, what: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized int32 rational num/2**den ~ val with overflow budget
    (the batched form of mpc.constrained._rational)."""
    num_max = budget // acc_max
    if num_max < 1 or (val <= 0).any():
        raise ValueError(f"{what}: unrepresentable scale in batch")
    den = np.clip(np.floor(np.log2(num_max / val)), 0, 31).astype(np.int32)
    num = np.round(val * 2.0**den).astype(np.int64)
    if (num < 1).any() or (num > num_max).any():
        raise ValueError(
            f"{what}: scale out of the int32 rational budget; rescale the "
            "problem or rho"
        )
    return num.astype(np.int32), den


def _rat_cols(*vals):
    """The eight (B,) int32 rationals, in RATIONALS order, as the (B, 1)
    columns :func:`_alm_loop` takes by name."""
    return {k: v[:, None] for k, v in zip(RATIONALS, vals)}


def _alm_batched(
    u_words, g_pre, Hq, hs_num, hs_den, Sq, cs_num, cs_den, c_off, lo_pre,
    hi_pre, eh_num, eh_den, el_num, el_den, lam0, *, outer, inners, g_shift,
    y_shift,
):
    """Batched ALM with per-problem Hessians AND constraint rows, on packed
    words: the state-constrained SQP inner solve.

    u_words (B, Tp/4) int32 words; g_pre (B, Tp) int32; Hq (B, Tp, Tp)
    int8; Sq (B, Cp, Tp) int8; c_off, lo_pre, hi_pre, lam0 (B, Cp) int32;
    the rationals (B,) int32.  Same iteration as ``pint_tpu``'s
    ``_alm_batched``; the int8 matvecs run as exact float64 batched
    products (the two halves of the split penalty gradient as two
    products, where the reference stacks them into one -- integer dots are
    exact either way).  Returns (words, lam)."""
    Hd = Hq.to(torch.float64)
    Sd = Sq.to(torch.float64)
    SdT = Sd.transpose(1, 2)
    rat = _rat_cols(hs_num, hs_den, cs_num, cs_den, eh_num, eh_den, el_num, el_den)
    return _alm_loop(
        u_words, g_pre, c_off, lam0,
        hmv=lambda u: _bmv(Hd, u), smv=lambda u: _bmv(Sd, u),
        stmv=lambda y: _bmv(SdT, y), rat=rat,
        lo=lo_pre, hi=hi_pre, outer=outer, inners=inners, g_shift=g_shift,
        y_shift=y_shift, space=_word_space(),
    )


def _alm_batched_cols(
    u_words, g_r, Hq, hs_num, hs_den, Sq, cs_num, cs_den, c_off, lo_pre,
    hi_pre, eh_num, eh_den, el_num, el_den, lam0, *, outer, inners, g_shift,
    y_shift, group, rank, block,
):
    """Column-sharded :func:`_alm_batched` on tp rank ``rank`` of the
    process group ``group``: u_words (B, block/4) and g_r (B, block) are
    this rank's columns; Hq, Sq, c_off, the bounds and lam0 are
    tp-replicated.

    Per inner iteration two exact int32 all-reduces (objective gradient and
    constraint value); the constraint-row plane (violations, error
    feedback, multipliers) stays tp-replicated, each rank computing it from
    the reduced values with the same integer ops; the penalty gradient
    ``y @ Sq[:, :, cols_r]`` needs no collective.  Returns (words, lam),
    lam the same on every tp rank."""
    from pint_tpu_torch.parallel.mesh import psum

    cols = slice(rank * block, (rank + 1) * block)
    Hc = Hq[:, :, cols].to(torch.float64)             # (B, Tp, block)
    Sc = Sq[:, :, cols].to(torch.float64)             # (B, Cp, block)
    ScT = Sc.transpose(1, 2)
    rat = _rat_cols(hs_num, hs_den, cs_num, cs_den, eh_num, eh_den, el_num, el_den)
    return _alm_loop(
        u_words, g_r, c_off, lam0,
        hmv=lambda u: psum(_bmv(Hc, u), group)[:, cols],
        smv=lambda u: psum(_bmv(Sc, u), group),
        stmv=lambda y: _bmv(ScT, y), rat=rat,
        lo=lo_pre, hi=hi_pre, outer=outer, inners=inners, g_shift=g_shift,
        y_shift=y_shift, space=_word_space(),
    )


def _alm_batched_cols_hqt(
    u_words, g_r, hqt, hs_num, hs_den, sqj, cs_num, cs_den, c_off, lo_pre,
    hi_pre, eh_num, eh_den, el_num, el_den, lam0, *, outer, inners, g_shift,
    y_shift, group, rank, block,
):
    """:func:`_alm_batched_cols` with the two big matvecs of an inner
    iteration (objective gradient and constraint value) as ONE K10 launch
    over the rank's concatenated column slab, then one int32 all-reduce.
    hqt (Tp, Tp, B) and sqj (Tp, Cp, B) are the full kernel-orientation
    slabs of K3 and K6.  Bit-identical to :func:`_alm_batched_cols`."""
    from pint_tpu_torch.mpc.fused_alm import pgd_matvec_cols
    from pint_tpu_torch.parallel.mesh import psum

    Tp = hqt.shape[0]
    cols = slice(rank * block, (rank + 1) * block)
    sqj_r = sqj[cols]                                 # (block, Cp, B)
    comb = torch.cat([hqt[cols], sqj_r], dim=1)       # (block, Tp + Cp, B)
    ScT = sqj_r.permute(2, 0, 1).to(torch.float64)    # (B, block, Cp)

    def hsmv(u):
        acc = psum(pgd_matvec_cols(u, comb), group)
        return acc[:, :Tp][:, cols], acc[:, Tp:]

    rat = _rat_cols(hs_num, hs_den, cs_num, cs_den, eh_num, eh_den, el_num, el_den)
    return _alm_loop(
        u_words, g_r, c_off, lam0, hmv=None, hsmv=hsmv,
        smv=lambda u: psum(pgd_matvec_cols(u, sqj_r), group),
        stmv=lambda y: _bmv(ScT, y), rat=rat,
        lo=lo_pre, hi=hi_pre, outer=outer, inners=inners, g_shift=g_shift,
        y_shift=y_shift, space=_word_space(),
    )
