"""Word-space SQP inner and cost helpers (port of parts of
``pint_tpu/mpc/ltv.py``).

Ported: :func:`_lower_words`, :func:`_pgd_batched_h` (the word-space PGD
with a per-problem Hessian and error feedback, the plain reference that the
K4 kernel is held to) and a numpy :func:`true_cost` for cost parity.
``QuantizedSQP``, ``SQPController`` and the column-sharded inners are not
ported yet (ROADMAP queue 1).
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


def _pgd_batched_h(u_words, g_pre, Hq, hs_num, hs_den, *, iters, g_shift):
    """Fixed-point PGD with a per-problem Hessian, on packed words.

    u_words (B, Tp/4) int32 words; g_pre (B, Tp) int32; Hq (B, Tp, Tp) int8;
    hs_num, hs_den (B,) int32.  The same iteration as ``pint_tpu``'s
    ``_pgd_batched_h``: saturating packed update, then the -127 box floor.
    The int8 matvec runs as an exact float64 batched product."""
    lower = torch.full_like(u_words, _lower_words())
    Hd = Hq.to(torch.float64)
    num, den = hs_num[:, None], hs_den[:, None]
    half = 1 << (g_shift - 1)
    carry = torch.zeros_like(g_pre)
    words = u_words
    for _ in range(iters):
        lanes = unpack_controls(words)
        acc = torch.bmm(Hd, lanes.to(torch.float64)[:, :, None])[..., 0]
        pre = (acc.to(torch.int32) * num) >> den
        step = -(pre + g_pre) + carry
        delta = torch.clamp((step + half) >> g_shift, -128, 127)
        carry = step - (delta << g_shift)
        words = W.add_signed_saturate(CONTROL_LAYOUT, words, pack_controls(delta))
        words = W.max_signed(CONTROL_LAYOUT, words, lower)
    return words


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
