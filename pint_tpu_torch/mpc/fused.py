"""Fused PGD solver: the whole iteration loop in one kernel (K2, K2p).

PyTorch port of ``pint_tpu/mpc/fused.py``.  :func:`fused_pgd` runs the CUDA
kernel ``csrc/fused_pgd.cu`` (to Tp 256 with Hq's B fragments on chip,
past it to :data:`FUSED_MAX_TP` as one product across the batch an
iteration, in one cooperative launch) for CUDA tensors and
:func:`fused_pgd_plain`,
the plain PyTorch version of the same lane-space loop, for CPU tensors;
words are unpacked once before the loop and packed once after it.
:func:`fused_pgd_packed` (K2p, ``FusedPGD(packed_io=True)``) takes and
returns the packed words themselves: the (B, Tp/4) int32 words are the
(B, Tp) int8 lanes in memory, so the kernel reads and writes them as bytes.
Its plain version is :func:`fused_pgd_packed_plain`.  The reference's
grouped lane order and permuted Hessian (a Mosaic workaround) are not
ported: K2p's words equal ``packed_io=False``'s.

Exactness: for in-range int8 lanes ``max_signed(add_signed_saturate(u, d),
-127)`` equals ``clip(u + d, -127, 127)``, so the lane-space loop is
bit-identical to the word-space
:class:`pint_tpu_torch.mpc.solver.FixedPointPGD`; with ``momentum`` it is
the Nesterov-style extrapolation of ``pint_tpu``'s ``FusedPGD(momentum=True)``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.accelerated import beta_num
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.ops import kernels as K

__all__ = ["FusedPGD", "fused_pgd", "fused_pgd_packed", "fused_pgd_packed_plain",
           "fused_pgd_plain"]


FUSED_MAX_TP = 4096
"""The widest Tp K2 and K2p take (``csrc/fused_pgd.cu``: to 256 Hq's B
fragments stay on chip; past it each iteration is one product across the
batch, ``csrc/wide_gemm.cuh``, with Hq 16 MB at 4096)."""


def _scratch(lib, B, Tp, momentum, device):
    """The wide form's scratch past Tp 256 (padded Hq, two y buffers and,
    with momentum, x: ``pint_fused_pgd_scratch`` bytes); None to 256, where
    the kernel takes none."""
    if Tp <= 256:
        return None
    return torch.empty((lib.pint_fused_pgd_scratch(B, Tp, int(momentum)),),
                       dtype=torch.int8, device=device)


def fused_pgd_plain(lanes, g, hq, *, hs_num, hs_den, g_shift, iters,
                    momentum=False, beta_num=0, beta_den=8):
    """Plain PyTorch version of :func:`fused_pgd` (any device).  The int8
    matvec runs as an exact float64 product, free of TF32."""
    hqT = hq.to(torch.float64).T
    half = 1 << (g_shift - 1)
    x, xp = lanes, lanes
    for _ in range(iters):
        y = x
        if momentum:
            y = torch.clamp(x + ((beta_num * (x - xp)) >> beta_den), -127, 127)
        acc = (y.to(torch.float64) @ hqT).to(torch.int32)
        pre = (acc * hs_num) >> hs_den
        delta = torch.clamp((-(pre + g) + half) >> g_shift, -128, 127)
        x, xp = torch.clamp(y + delta, -127, 127), x
    return x


def fused_pgd(lanes, g, hq, *, hs_num, hs_den, g_shift, iters,
              momentum=False, beta_num=0, beta_den=8):
    """``iters`` lane-space PGD steps with one shared int8 Hessian.

    lanes, g (B, Tp) int32 (lanes in [-128, 127]); hq (Tp, Tp) int8.
    Returns the final lanes (B, Tp) int32.  Kernel for CUDA tensors, plain
    version for CPU tensors.  The kernel takes contiguous operands (checked)
    and reads and writes 16 bytes at a time where every data pointer is
    16-byte aligned, 4 bytes at a time otherwise."""
    B, Tp = g.shape
    if lanes.shape != (B, Tp) or hq.shape != (Tp, Tp):
        raise ValueError(
            f"fused_pgd: lanes {tuple(lanes.shape)}, g {(B, Tp)}, "
            f"hq {tuple(hq.shape)} do not agree"
        )
    if lanes.dtype != torch.int32 or g.dtype != torch.int32 or hq.dtype != torch.int8:
        raise ValueError("fused_pgd: lanes and g must be int32, hq int8")
    kw = dict(hs_num=hs_num, hs_den=hs_den, g_shift=g_shift, iters=iters,
              momentum=momentum, beta_num=beta_num, beta_den=beta_den)
    if lanes.device.type == "cpu":
        return fused_pgd_plain(lanes, g, hq, **kw)
    K.require_cuda("fused_pgd", lanes, g, hq)
    if Tp % 4 or Tp > FUSED_MAX_TP:
        raise ValueError(f"fused_pgd: Tp={Tp} must be a multiple of 4, <= "
                         f"{FUSED_MAX_TP} (K2's limit)")
    out = torch.empty_like(lanes)
    lib = K.library()
    scratch = _scratch(lib, B, Tp, momentum, lanes.device)
    with torch.cuda.device(lanes.device):
        err = lib.pint_fused_pgd(
            lanes.data_ptr(), g.data_ptr(), hq.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, Tp, iters, hs_num, hs_den, g_shift, int(momentum), beta_num,
            beta_den, K.stream_of(lanes),
        )
    K.check(err, "fused_pgd")
    K.count_launch("fused_pgd")
    return out


def fused_pgd_packed_plain(words, g, hq, *, hs_num, hs_den, g_shift, iters):
    """Plain PyTorch version of :func:`fused_pgd_packed` (any device):
    unpack, :func:`fused_pgd_plain`, pack."""
    lanes = fused_pgd_plain(unpack_controls(words), g, hq, hs_num=hs_num,
                            hs_den=hs_den, g_shift=g_shift, iters=iters)
    return pack_controls(lanes)


def fused_pgd_packed(words, g, hq, *, hs_num, hs_den, g_shift, iters):
    """:func:`fused_pgd` with packed-word I/O (no momentum, as the
    reference's packed kernel).

    words (B, Tp/4) int32 packed control words; g (B, Tp) int32; hq (Tp, Tp)
    int8.  Returns the final words (B, Tp/4) int32, equal to
    ``pack_controls(fused_pgd(unpack_controls(words), ...))``.  Kernel for
    CUDA tensors, plain version for CPU tensors; contiguous operands, 16-byte
    copies where the data pointers are 16-byte aligned, as
    :func:`fused_pgd`."""
    B, Tp = g.shape
    if words.shape != (B, Tp // 4) or Tp % 4 or hq.shape != (Tp, Tp):
        raise ValueError(
            f"fused_pgd_packed: words {tuple(words.shape)}, g {(B, Tp)}, "
            f"hq {tuple(hq.shape)} do not agree"
        )
    if words.dtype != torch.int32 or g.dtype != torch.int32 or hq.dtype != torch.int8:
        raise ValueError("fused_pgd_packed: words and g must be int32, hq int8")
    kw = dict(hs_num=hs_num, hs_den=hs_den, g_shift=g_shift, iters=iters)
    if words.device.type == "cpu":
        return fused_pgd_packed_plain(words, g, hq, **kw)
    K.require_cuda("fused_pgd_packed", words, g, hq)
    if Tp > FUSED_MAX_TP:
        raise ValueError(f"fused_pgd_packed: Tp={Tp} must be <= {FUSED_MAX_TP} "
                         "(K2p's limit)")
    out = torch.empty_like(words)
    lib = K.library()
    scratch = _scratch(lib, B, Tp, False, words.device)
    with torch.cuda.device(words.device):
        err = lib.pint_fused_pgd_packed(
            words.data_ptr(), g.data_ptr(), hq.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, Tp, iters, hs_num, hs_den, g_shift, K.stream_of(words),
        )
    K.check(err, "fused_pgd_packed")
    K.count_launch("fused_pgd_packed")
    return out


class FusedPGD:
    """Whole-loop PGD solver over K2, bit-identical to
    :class:`~pint_tpu_torch.mpc.solver.FixedPointPGD` (``momentum=False``).

    ``momentum`` runs the Nesterov-style extrapolation with
    ``beta = beta_num / 2**beta_den`` from the QP's condition number, as
    ``pint_tpu``'s ``FusedPGD`` does.  ``packed_io`` runs K2p on the words
    themselves; it has no momentum branch, and where the reference quietly
    drops ``momentum`` with ``packed_io`` the port raises.  Past ``iters``
    the parameters are keyword-only: the reference's third position is
    ``block_rows``, a TPU knob the port does not take."""

    def __init__(self, qqp: QuantizedQP, iters: int = 40, *,
                 momentum: bool = False, beta_den: int = 8, device="cuda",
                 packed_io: bool = False):
        if packed_io and momentum:
            raise ValueError("packed_io has no momentum branch: use one or the other")
        self.qqp = qqp
        self.iters = iters
        self.momentum = momentum
        self.beta_den = beta_den
        self.packed_io = packed_io
        self.device = K.resolve_device(device)
        self._hq = torch.as_tensor(np.asarray(qqp.Hq, np.int8), device=self.device)

    @functools.cached_property
    def beta_num(self) -> int:
        return beta_num(self.qqp, self.beta_den)

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self.qqp.padded // 4), dtype=torch.int32, device=self.device
        )

    def solve_words(self, u_words: torch.Tensor, g_pre: torch.Tensor):
        q = self.qqp
        kw = dict(hs_num=q.hs_num, hs_den=q.hs_den, g_shift=q.g_shift,
                  iters=self.iters)
        if self.packed_io:
            return fused_pgd_packed(u_words, g_pre, self._hq, **kw)
        lanes = fused_pgd(
            unpack_controls(u_words), g_pre, self._hq, momentum=self.momentum,
            beta_num=self.beta_num if self.momentum else 0,
            beta_den=self.beta_den, **kw,
        )
        return pack_controls(lanes)

    # -- multi-device --------------------------------------------------------

    def dp_sharded(self, mesh):
        """The dp-sharded solve over ``mesh``: each rank runs its batch
        shard (u_words (B_loc, Tp/4), g_pre (B_loc, Tp), rows cut by dp)
        through :meth:`solve_words`; no communication, bit-identical.  For
        tp sharding use :class:`pint_tpu_torch.parallel.ShardedPGD`."""
        if not K.same_device(mesh.device, self.device):
            raise ValueError(f"mesh on {mesh.device}, solver on {self.device}")
        return self.solve_words

    def solve(self, x0_phys: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        g_pre = torch.as_tensor(
            self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)), device=self.device
        )
        words = self.solve_words(self.init_words(g_pre.shape[0]), g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.to(torch.float32) * float(np.float32(self.qqp.u_scale))
