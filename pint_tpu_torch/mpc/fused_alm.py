"""Per-problem-Hessian PGD inner of DeviceSQP (K4).

PyTorch port of ``pint_tpu/mpc/fused_alm.py:494-606``
(``pgd_fused_words_pre`` and ``pgd_fused_words``).  :func:`pgd_hqt` runs the
CUDA kernel ``csrc/pgd_hqt.cu`` for CUDA tensors and :func:`pgd_hqt_plain`,
the plain PyTorch version of the same lane-space loop, for CPU tensors.  The
ALM kernels (K5, K7) and the tp column matvec (K10) are not ported yet.

Exactness: for in-range int8 lanes ``max_signed(add_signed_saturate(u, d),
-127)`` equals ``clip(u + d, -127, 127)`` in lane space, so both routes are
bit-identical to the word-space :func:`pint_tpu_torch.mpc.ltv._pgd_batched_h`
given the same operands.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.ops import kernels as K

__all__ = ["pgd_fused_words", "pgd_fused_words_pre", "pgd_hqt", "pgd_hqt_plain"]


def pgd_hqt_plain(lanes, g_pre, hqt, hs_num, hs_den, *, iters, g_shift):
    """Plain PyTorch version of :func:`pgd_hqt` (any device).

    The int8 matvec runs as a float64 batched product, which is exact here
    (|acc| <= 128 * 127 * Tp, far below 2**53) and free of TF32."""
    Hd = hqt.permute(2, 1, 0).to(torch.float64)        # (B, j, k)
    num = hs_num[:, None]
    den = hs_den[:, None]
    half = 1 << (g_shift - 1)
    carry = torch.zeros_like(g_pre)
    for _ in range(iters):
        acc = torch.bmm(Hd, lanes.to(torch.float64)[:, :, None])[..., 0]
        pre = (acc.to(torch.int32) * num) >> den
        step = -(pre + g_pre) + carry
        delta = torch.clamp((step + half) >> g_shift, -128, 127)
        carry = step - (delta << g_shift)
        lanes = torch.clamp(lanes + delta, -127, 127)
    return lanes


def pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, *, iters, g_shift):
    """``iters`` error-feedback PGD steps with per-problem Hessians.

    lanes, g_pre (B, Tp) int32 (lanes in [-128, 127]); hqt (Tp, Tp, B) int8
    with ``hqt[k, j, b] = Hq_b[j, k]``; hs_num, hs_den (B,) int32.  Returns
    the final lanes (B, Tp) int32.  Kernel for CUDA tensors, plain version
    for CPU tensors."""
    B, Tp = g_pre.shape
    if lanes.shape != (B, Tp) or hqt.shape != (Tp, Tp, B):
        raise ValueError(
            f"pgd_hqt: lanes {tuple(lanes.shape)}, g_pre {(B, Tp)}, "
            f"hqt {tuple(hqt.shape)} do not agree"
        )
    if hs_num.shape != (B,) or hs_den.shape != (B,):
        raise ValueError("pgd_hqt: hs_num and hs_den must be (B,)")
    for name, t, dt in (("lanes", lanes, torch.int32), ("g_pre", g_pre, torch.int32),
                        ("hqt", hqt, torch.int8), ("hs_num", hs_num, torch.int32),
                        ("hs_den", hs_den, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"pgd_hqt: {name} must be {dt}, got {t.dtype}")
    if lanes.device.type == "cpu":
        return pgd_hqt_plain(
            lanes, g_pre, hqt, hs_num, hs_den, iters=iters, g_shift=g_shift
        )
    K.require_cuda("pgd_hqt", lanes, g_pre, hqt, hs_num, hs_den)
    if Tp % 4 or Tp > 256:
        raise ValueError(f"pgd_hqt: Tp={Tp} must be a multiple of 4, <= 256")
    out = torch.empty_like(lanes)
    with torch.cuda.device(lanes.device):
        err = K.library().pint_pgd_hqt(
            lanes.data_ptr(), g_pre.data_ptr(), hqt.data_ptr(),
            hs_num.data_ptr(), hs_den.data_ptr(), out.data_ptr(),
            B, Tp, iters, g_shift, K.stream_of(lanes),
        )
    K.check(err, "pgd_hqt")
    K.count_launch("pgd_hqt")
    return out


def pgd_fused_words_pre(u_words, g_pre, hqt, hs_num, hs_den, *, iters, g_shift):
    """Packed words in, packed words out: u_words (B, Tp/4) int32 words,
    hqt already batch-last in the kernel orientation (what
    :func:`pint_tpu_torch.mpc.condense_fused.lipq_fused` emits)."""
    lanes = unpack_controls(u_words)
    return pack_controls(
        pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, iters=iters, g_shift=g_shift)
    )


def pgd_fused_words(u_words, g_pre, Hq, hs_num, hs_den, *, iters, g_shift):
    """:func:`pgd_fused_words_pre` from a batch-first Hessian Hq (B, Tp, Tp)
    (one int8 transpose to the kernel orientation)."""
    hqt = Hq.permute(2, 1, 0).contiguous()
    return pgd_fused_words_pre(
        u_words, g_pre, hqt, hs_num, hs_den, iters=iters, g_shift=g_shift
    )
