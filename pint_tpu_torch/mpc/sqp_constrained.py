"""State-constrained SQP helpers: the word-space per-problem ALM inner.

PyTorch port of parts of ``pint_tpu/mpc/sqp_constrained.py``: the static
y-split shift (``_T_AMP``, ``_Y_SHIFT``), the vectorized rational
``_rational_vec`` and ``_alm_batched``, the batched integer ALM with
per-problem int8 Hessians and constraint rows -- the word-space reference
the K5 kernel (:func:`pint_tpu_torch.mpc.fused_alm.alm_hqt`) is held to, bit
for bit.  ``ConstrainedSQP`` waits for the LTV modules it is built on, and
the column forms (``_alm_cols_loop``, ``_alm_batched_cols``,
``_alm_batched_cols_hqt``) for ``parallel/`` and K10 (ROADMAP queue 1).
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
    _alm_loop,
    _word_space,
)

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

    def bmv(m, v):
        return torch.bmm(m, v.to(torch.float64)[:, :, None])[..., 0].to(torch.int32)

    rat = dict(hs_num=hs_num, hs_den=hs_den, cs_num=cs_num, cs_den=cs_den,
               eh_num=eh_num, eh_den=eh_den, el_num=el_num, el_den=el_den)
    return _alm_loop(
        u_words, g_pre, c_off, lam0,
        hmv=lambda u: bmv(Hd, u), smv=lambda u: bmv(Sd, u),
        stmv=lambda y: bmv(SdT, y), rat={k: v[:, None] for k, v in rat.items()},
        lo=lo_pre, hi=hi_pre, outer=outer, inners=inners, g_shift=g_shift,
        y_shift=y_shift, space=_word_space(),
    )
