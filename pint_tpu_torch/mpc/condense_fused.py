"""The condensation epilogues: power iteration + int8 quantization (K3, K6).

PyTorch port of ``pint_tpu/mpc/condense_fused.py``: ``lipq_fused`` (K3, the
condensed Hessian; CUDA kernel ``csrc/lipq.cu``, plain version
:func:`lipq_plain`) and ``pen_fused`` (K6, the state-constraint rows; CUDA
kernel ``csrc/pen.cu``, plain version :func:`pen_plain`).  Each runs its
kernel for a CUDA tensor and its plain version for a CPU tensor.

Memory order: to :data:`~pint_tpu_torch.ops.kernels.LONG_LANES` (64) rows
the slabs are batch-last and contiguous, as the reference lays them out.
Past it the kernels take and give them problem-major
(:func:`~pint_tpu_torch.ops.kernels.problem_major`): K3 reads ``Ht`` as
``Hb.permute(1, 2, 0)`` of the batch-first (B, Tm, Tm) condensed Hessian
and writes ``hqt`` as ``Hq.permute(2, 1, 0)`` of a batch-first (B, Tm, Tm)
``Hq``; K6 (where ``C`` or ``Tm`` is past 64) hands over ``sqc`` and
``sqj`` as ``permute(1, 2, 0)`` views of its batch-first rows.  The plain
versions give the same orders, so values, indices and bits are the same
either way; only the memory a kernel reads differs.

Contract (each kernel against its plain version on the same input): the
int8 outputs, ``h_max`` and ``s_scale`` bit-identical, ``lip``, ``pen_lip``
and ``row_amp`` to f32 roundoff at least.  The kernels round every product
and sum (no FMA) and add in a fixed order, and the plain versions add in
that same order (:func:`_warp_order_sum`, :func:`_seq_sum`, :func:`_sum4`),
so on the card they come out bit-identical too.  Against JAX (whose reductions XLA orders)
the f32 reductions agree to roundoff.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.ops import kernels as K

__all__ = ["lipq_fits", "lipq_fused", "lipq_plain", "pen_fits", "pen_fused",
           "pen_long", "pen_plain", "quantize_hqt", "true_div"]

_SMEM_BYTES = 232448
"""Shared memory a block may use on the H100 (``kPintMaxSmem``)."""


def lipq_fits(Tm: int) -> bool:
    """True when K3 (``csrc/lipq.cu``) takes a Hessian of ``Tm`` rows:
    Tm <= 286, the reference's ``lipq_viable``.  Past Tm = 224 one
    problem's f32 slab outgrows a block's shared memory and the kernel
    holds its last rows in registers.  Past the gate the solvers take the
    torch form of the Lipschitz and quantize phases, as the reference
    takes its XLA form."""
    return 0 < Tm <= 286


def pen_fits(C: int, Tm: int) -> bool:
    """True when K6 (``csrc/pen.cu``) takes ``C`` constraint rows over
    ``Tm`` columns: C Tm <= 68266, the reference's ``pen_viable``.  Past
    one block's 227 KB of shared memory (C Tm about 56K) the kernel splits
    a problem over a cluster of blocks.  The constrained solver runs K6
    where this and :func:`lipq_fits` both hold, as the reference's
    ``_use_lipq`` does, and the torch form of the constraint rows' phases
    elsewhere."""
    return C > 0 and Tm > 0 and C * Tm * 1536 <= 100 * 2**20


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


def _hqt_order(hqt: torch.Tensor) -> torch.Tensor:
    """``hqt`` (Tm, Tm, B) in the order K3 writes it: problem-major with
    rows j past 64 rows (a copy only where it is not), else as it is."""
    if hqt.shape[0] <= K.LONG_LANES or K.problem_major(hqt, 1):
        return hqt
    return hqt.permute(2, 1, 0).contiguous().permute(2, 1, 0)


def lipq_plain(
    Ht: torch.Tensor, *, power_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`lipq_fused` (any device, either
    memory order of ``Ht``; ``hqt`` in K3's order)."""
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
    return _hqt_order(quantize_hqt(Ht, h_max)), lip, h_max


def lipq_fused(
    Ht: torch.Tensor, *, power_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power-iteration Lipschitz + int8 quantization of the condensed
    Hessian ``Ht`` (Tm, Tm, B) f32.

    Returns ``(hqt (Tm, Tm, B) int8, lip (B,) f32 with the 1.05 safety
    factor, h_max (B,) f32)``; ``hqt[k, j, b] = q(Ht[k, j, b])`` is the
    orientation :func:`pint_tpu_torch.mpc.fused_alm.pgd_fused_words_pre`
    consumes.  To Tm = 64 ``Ht`` and ``hqt`` are batch-last and
    contiguous; past it ``Ht`` must be problem-major with rows k
    (``Hb.permute(1, 2, 0)``) and ``hqt`` comes problem-major with rows j
    (module docstring).  The kernel raises on any other order.  Kernel for
    a CUDA tensor, plain version for a CPU tensor.
    """
    if Ht.dim() != 3 or Ht.shape[0] != Ht.shape[1]:
        raise ValueError(f"Ht must be (Tm, Tm, B), got {tuple(Ht.shape)}")
    if Ht.dtype != torch.float32:
        raise ValueError(f"Ht must be float32, got {Ht.dtype}")
    if Ht.device.type == "cpu":
        return lipq_plain(Ht, power_iters=power_iters)
    K.require_cuda("lipq_fused", slabs=(Ht,))
    Tm, _, B = Ht.shape
    if not lipq_fits(Tm):
        raise ValueError(
            f"lipq_fused: Tm={Tm} is past 286, the reference's lipq_viable "
            "(lipq_fits; the solvers take the torch form past it)"
        )
    long = Tm > K.LONG_LANES
    K.require_order("lipq_fused", "Ht", Ht, 0,
                    ("problem_major",) if long else ("batch_last",))
    if long:
        hqt = torch.empty((B, Tm, Tm), dtype=torch.int8, device=Ht.device).permute(2, 1, 0)
    else:
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


INV_127 = float(np.float32(1.0 / 127.0))
"""The f32 reciprocal of 127.  XLA compiles ``x / 127.0`` as ``x *
INV_127`` (a division by a constant becomes a multiply by its reciprocal),
so the reference's ``max|S| / 127`` is this product."""


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` along ``dim`` added in index order, one rounding a term
    (the order of one kernel thread's loop)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _sum4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of ``x`` along ``dim`` as K6 adds it: four partial sums from
    +0.0, term k to partial k % 4 in index order, then (p0 + p1) + (p2 +
    p3).  Four independent chains a sum keep the kernels' power steps off
    one long chain of dependent additions."""
    parts = x.unbind(dim)
    p = [torch.zeros_like(parts[0]) for _ in range(4)]
    for k, t in enumerate(parts):
        p[k % 4] = p[k % 4] + t
    return (p[0] + p[1]) + (p[2] + p[3])


def pen_plain(
    S_t: torch.Tensor, *, power_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pen_fused` (any device), adding in
    the kernel's order: ``S v`` over j and ``S^T w`` over c as four partial
    sums (:func:`_sum4`), the norms in the warp's order
    (:func:`_warp_order_sum`), the row sums of ``row_amp`` over j in index
    order; a power step scales ``u`` by the reciprocal of its norm."""
    C, Tm, B = S_t.shape
    v = torch.full(
        (Tm, B), float(np.float32(1.0 / np.sqrt(Tm))),
        dtype=torch.float32, device=S_t.device,
    )

    def ssv(v):                                        # (Tm, B) -> (C, B)
        return _sum4(S_t * v[None], 1)

    def stw(w):                                        # (C, B) -> (Tm, B)
        return _sum4(S_t * w[:, None], 0)

    for _ in range(power_iters):
        u = stw(ssv(v))
        v = u * torch.reciprocal(torch.sqrt(_warp_order_sum(u * u)) + 1e-30)
    lip = _warp_order_sum(v * stw(ssv(v)))[0] * 1.05
    a = torch.abs(S_t)
    sm = torch.amax(a, dim=(0, 1))
    ra = torch.amax(_seq_sum(a, 1), dim=0)
    # quantize_hqt's rounding, and NaN to 0 as XLA (and the kernel) convert it
    scale = true_div(127.0, torch.clamp_min(sm, 1e-30))
    q = torch.clamp(torch.round(S_t * scale), -127, 127)
    sqc = torch.where(q.isnan(), 0.0, q).to(torch.int8)
    return (*_rows_order(sqc), lip, sm * INV_127, 127.0 * ra)


def pen_long(C: int, Tm: int) -> bool:
    """True when K6 hands ``sqc`` and ``sqj`` over problem-major: past 64
    rows or columns, where K5 runs its cluster kernel (which takes either
    order) and K6 its cluster kernel (which writes them batch-first)."""
    return max(C, Tm) > K.LONG_LANES


def _rows_order(sqc: torch.Tensor):
    """(sqc, sqj) from the int8 rows ``sqc`` (C, Tm, B) in the order K6
    gives them: problem-major views of batch-first copies past 64 rows or
    columns (:func:`pen_long`), else batch-last and contiguous."""
    if not pen_long(sqc.shape[0], sqc.shape[1]):
        return sqc, sqc.transpose(0, 1).contiguous()
    bf = sqc.permute(2, 0, 1).contiguous()                     # (B, C, Tm)
    return bf.permute(1, 2, 0), bf.transpose(1, 2).contiguous().permute(1, 2, 0)


def pen_fused(
    S_t: torch.Tensor, *, power_iters: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Penalty power iteration + int8 constraint-row quantization of the
    batch-last constraint stack ``S_t`` (C, Tm, B) f32.

    Returns ``(sqc (C, Tm, B) int8, sqj (Tm, C, B) int8, pen_lip (B,) f32,
    s_scale (B,) f32, row_amp (B,) f32)``, both row stacks batch-last, or
    problem-major past 64 rows or columns (:func:`pen_long`): ``sqc[c, j, b] =
    clip(round(S_t[c, j, b] * 127 / max|S_t[..., b]|))`` in both
    orientations :func:`~pint_tpu_torch.mpc.fused_alm.alm_hqt` consumes,
    ``pen_lip ~ 1.05 * lambda_max(S S^T)``, ``s_scale = max|S| * INV_127``
    (the reference's ``max|S| / 127`` as XLA compiles it) and
    ``row_amp = 127 * max_c sum_j |S|``.  Kernel for a CUDA tensor, plain
    version for a CPU tensor."""
    if S_t.dim() != 3:
        raise ValueError(f"S_t must be (C, Tm, B), got {tuple(S_t.shape)}")
    if S_t.dtype != torch.float32:
        raise ValueError(f"S_t must be float32, got {S_t.dtype}")
    if S_t.device.type == "cpu":
        return pen_plain(S_t, power_iters=power_iters)
    K.require_cuda("pen_fused", S_t)
    C, Tm, B = S_t.shape
    if not pen_fits(C, Tm):
        raise ValueError(
            f"pen_fused: C={C}, Tm={Tm}: C Tm is past 68266, the reference's "
            "pen_viable (pen_fits; the solvers take the torch form past it)"
        )
    dev = S_t.device
    lip, s_scale, row_amp = (
        torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(3))
    lib = K.library()
    # past the register and warp kernels the int8 rows go out batch-first
    # into scratch; past 64 rows or columns they stay there, handed over
    # problem-major, else a transpose kernel writes them batch-last
    scratch = torch.empty((lib.pint_pen_scratch(B, C, Tm),), dtype=torch.int8,
                          device=dev)
    long = pen_long(C, Tm)
    if long:
        sqc = scratch[: B * C * Tm].view(B, C, Tm).permute(1, 2, 0)
        sqj = scratch[B * C * Tm:].view(B, Tm, C).permute(1, 2, 0)
    else:
        sqc = torch.empty((C, Tm, B), dtype=torch.int8, device=dev)
        sqj = torch.empty((Tm, C, B), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = lib.pint_pen(
            S_t.data_ptr(), sqc.data_ptr(), sqj.data_ptr(), lip.data_ptr(),
            s_scale.data_ptr(), row_amp.data_ptr(),
            scratch.data_ptr(), B, C, Tm, power_iters, int(long), K.stream_of(S_t),
        )
    K.check(err, "pen_fused")
    K.count_launch("pen")
    return sqc, sqj, lip, s_scale, row_amp
