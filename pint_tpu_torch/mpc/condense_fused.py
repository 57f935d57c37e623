"""Lipschitz estimate + int8 quantization of the condensed Hessian (K3).

PyTorch port of ``pint_tpu/mpc/condense_fused.py:132`` (``lipq_fused``).
:func:`lipq_fused` runs the CUDA kernel ``csrc/lipq.cu`` for a CUDA tensor
and :func:`lipq_plain`, the plain PyTorch version of the same function, for
a CPU tensor.  The penalty kernel ``pen_fused`` (K6) is not ported yet.

Contract (the kernel against :func:`lipq_plain` on the same ``Ht``):
``hqt`` and ``h_max`` bit-identical, ``lip`` to f32 roundoff at least.  Both
accumulate ``w = H^T v`` over k in order, rounding each product and each
sum, and the plain version reduces the norms in the kernel's order
(:func:`_warp_order_sum`), so on the card ``lip`` comes out bit-identical
too.  Against JAX (whose reductions XLA orders) ``lip`` agrees to roundoff.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.ops import kernels as K

__all__ = ["lipq_fused", "lipq_plain", "quantize_hqt", "true_div"]


def true_div(a, b):
    """IEEE division ``a / b`` of f32 values, either of which may be a
    Python float, on the device of the tensor operand."""
    ref = b if isinstance(b, torch.Tensor) else a
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=ref.dtype, device=ref.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=ref.dtype, device=ref.device)
    return torch.div(a, b)


def quantize_hqt(Ht: torch.Tensor, h_max: torch.Tensor) -> torch.Tensor:
    """``clip(round(Ht * 127 / max(h_max, 1e-30)), +-127)`` as int8, with
    ``h_max`` broadcast over the trailing batch axis.

    The scale is a true f32 division, as in the kernel and in JAX: both
    operands are tensors on the device (``python_scalar / tensor`` would
    run as ``reciprocal * scalar``, and on CUDA ``tensor / python_scalar``
    as a multiply by the reciprocal -- each one rounding more)."""
    scale = true_div(127.0, torch.clamp_min(h_max, 1e-30))
    return torch.clamp(torch.round(Ht * scale), -127, 127).to(torch.int8)


def _warp_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of ``x`` (Tm, B) -> (1, B), added in the order of the
    kernel's warp reduction: row j goes to lane j % 32, each lane adds its
    rows in order, then an xor butterfly over the 32 lanes."""
    Tm, B = x.shape
    nj = -(-Tm // 32)
    if nj * 32 != Tm:
        x = torch.cat([x, x.new_zeros((nj * 32 - Tm, B))])
    x = x.reshape(nj, 32, B)
    part = x[0] + 0.0  # the kernel's lanes start from +0.0
    for q in range(1, nj):
        part = part + x[q]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[lanes ^ o]
    return part[:1]


def lipq_plain(
    Ht: torch.Tensor, *, power_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lipq_fused` (any device)."""
    Tm = Ht.shape[0]
    v = torch.full(
        (Tm, Ht.shape[2]), float(np.float32(1.0 / np.sqrt(Tm))),
        dtype=torch.float32, device=Ht.device,
    )

    def matvec(v):
        w = Ht[0] * v[0:1]
        for k in range(1, Tm):
            w = w + Ht[k] * v[k : k + 1]
        return w

    for _ in range(power_iters):
        w = matvec(v)
        v = w / (torch.sqrt(_warp_order_sum(w * w)) + 1e-30)
    lip = _warp_order_sum(v * matvec(v))[0] * 1.05
    h_max = torch.amax(torch.abs(Ht), dim=(0, 1))
    return quantize_hqt(Ht, h_max), lip, h_max


def lipq_fused(
    Ht: torch.Tensor, *, power_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power-iteration Lipschitz + int8 quantization of the batch-last
    condensed Hessian ``Ht`` (Tm, Tm, B) f32.

    Returns ``(hqt (Tm, Tm, B) int8, lip (B,) f32 with the 1.05 safety
    factor, h_max (B,) f32)``; ``hqt[k, j, b] = q(Ht[k, j, b])`` is the
    orientation :func:`pint_tpu_torch.mpc.fused_alm.pgd_fused_words_pre`
    consumes.  Kernel for a CUDA tensor, plain version for a CPU tensor.
    """
    if Ht.dim() != 3 or Ht.shape[0] != Ht.shape[1]:
        raise ValueError(f"Ht must be (Tm, Tm, B), got {tuple(Ht.shape)}")
    if Ht.dtype != torch.float32:
        raise ValueError(f"Ht must be float32, got {Ht.dtype}")
    if Ht.device.type == "cpu":
        return lipq_plain(Ht, power_iters=power_iters)
    K.require_cuda("lipq_fused", Ht)
    Tm, _, B = Ht.shape
    if Tm > 224:
        raise ValueError(
            f"lipq_fused: Tm={Tm} > 224 does not fit one f32 slab in shared "
            "memory (a streaming kernel is later work)"
        )
    hqt = torch.empty(Ht.shape, dtype=torch.int8, device=Ht.device)
    lip = torch.empty((B,), dtype=torch.float32, device=Ht.device)
    h_max = torch.empty((B,), dtype=torch.float32, device=Ht.device)
    with torch.cuda.device(Ht.device):
        err = K.library().pint_lipq(
            Ht.data_ptr(), hqt.data_ptr(), lip.data_ptr(), h_max.data_ptr(),
            B, Tm, power_iters, K.stream_of(Ht),
        )
    K.check(err, "lipq_fused")
    K.count_launch("lipq")
    return hqt, lip, h_max
