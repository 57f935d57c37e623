"""The whole-loop integer kernels of the MPC inners (K4, K5, K7).

PyTorch port of ``pint_tpu/mpc/fused_alm.py``:

* K4, the per-problem-Hessian PGD inner of DeviceSQP: :func:`pgd_hqt` on
  int32 lanes and :func:`pgd_fused_words_pre` on the packed words (one
  launch, no unpack or pack), CUDA kernel ``csrc/pgd_hqt.cu``, plain
  versions :func:`pgd_hqt_plain` and :func:`pgd_fused_words_pre_plain`;
* K5, the per-problem ALM inner of DeviceConstrainedSQP
  (``alm_fused_words_pre``, ``alm_fused_words``): :func:`alm_hqt`, CUDA
  kernel ``csrc/alm.cu`` (``alm_reg_kernel`` to 64 lanes and rows,
  ``alm_wide_kernel`` past them; the latter also runs K4 past 64 lanes),
  plain version :func:`alm_hqt_plain`;
* K7, the shared-operand ALM of the LTI ConstrainedPGD
  (``alm_shared_fused_words``): :func:`alm_shared`, CUDA kernel
  ``csrc/alm.cu`` (``alm_mma_kernel`` on the tensor cores to 256 lanes and
  rows, ``alm_mma_wide_kernel`` past them, a batch product a pass), plain
  version :func:`alm_shared_plain`;
* K10, one tp rank's column matvec, launched once an iteration by the
  column-sharded inners with the int32 all-reduce between launches
  (``pgd_matvec_cols``): :func:`pgd_matvec_cols`, CUDA kernel
  ``csrc/matvec_cols.cu``, plain version :func:`pgd_matvec_cols_plain`.

Each wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors.  :func:`pgd_fits` and :func:`alm_fits` state the shapes K4 and
K5 take (the reference's ``pgd_viable`` and ``alm_viable``); the wrappers
refuse by them and the solvers choose their inners by them.  K7 takes Tp
and Cp to :data:`ALM_SHARED_MAX` (4096); the reference's kernel has no
limit, and past it the port raises.  The reference's TPU crossover for the column matvec
(``matvec_viable``, ``matvec_wins``, ``_MATVEC_MIN_COLS``,
``resolve_tp_fused``) is not ported: K10 checks its own shared-memory fit.

Exactness: for in-range int8 lanes ``max_signed(add_signed_saturate(u, d),
-127)`` equals ``clip(u + d, -127, 127)`` in lane space, so every route is
bit-identical to its word-space reference given the same operands
(:func:`pint_tpu_torch.mpc.ltv._pgd_batched_h`,
:func:`pint_tpu_torch.mpc.sqp_constrained._alm_batched`,
``ConstrainedPGD(fused=False)``).  The plain versions run the int8 matvecs
as float64 products, exact here (|acc| <= 128 * 128 * 4096) and free of
TF32.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.constrained import RATIONALS, _alm_loop, _f64_mv, _lane_space
from pint_tpu_torch.mpc.ltv import _bmv
from pint_tpu_torch.ops import kernels as K

__all__ = ["alm_fits", "alm_fused_words", "alm_fused_words_pre", "alm_hqt",
           "alm_hqt_plain", "alm_shared", "alm_shared_fused_words", "alm_shared_plain",
           "pgd_fits", "pgd_fused_words", "pgd_fused_words_pre",
           "pgd_fused_words_pre_plain", "pgd_hqt", "pgd_hqt_plain",
           "pgd_matvec_cols", "pgd_matvec_cols_plain"]


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


def _check_pgd_hqt(name, x, lanes_per, g_pre, hqt, hs_num, hs_den):
    """Shapes and dtypes of K4's operands: ``x`` (B, Tp / lanes_per)."""
    B, Tp = g_pre.shape
    if x.shape != (B, Tp // lanes_per) or Tp % lanes_per or hqt.shape != (Tp, Tp, B):
        raise ValueError(
            f"{name}: {tuple(x.shape)}, g_pre {(B, Tp)}, hqt {tuple(hqt.shape)} "
            "do not agree"
        )
    if hs_num.shape != (B,) or hs_den.shape != (B,):
        raise ValueError(f"{name}: hs_num and hs_den must be (B,)")
    for what, t, dt in (("lanes", x, torch.int32), ("g_pre", g_pre, torch.int32),
                        ("hqt", hqt, torch.int8), ("hs_num", hs_num, torch.int32),
                        ("hs_den", hs_den, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name}: {what} must be {dt}, got {t.dtype}")


_VMEM_WORDS = 409600
"""The reference's fits in int8 bytes a problem: its 100 MiB VMEM ceiling
over two buffers of 128 problems."""


def pgd_fits(Tp: int) -> bool:
    """True when K4 (``csrc/pgd_hqt.cu``) takes a horizon of ``Tp`` lanes:
    a multiple of 4 (dp4a words) within the reference's ``pgd_viable``
    (``Tp^2 + 16 Tp <= 409600``, Tp <= 632).  Past 256 lanes K4 runs
    ``csrc/alm.cu``'s cluster kernel.  Past the gate ``DeviceSQP`` runs
    the word-space ``_pgd_batched_h``, as the reference runs its XLA
    inner."""
    return Tp > 0 and Tp % 4 == 0 and Tp * Tp + 16 * Tp <= _VMEM_WORDS


def alm_fits(Tp: int, Cp: int) -> bool:
    """True when K5 (``csrc/alm.cu``) takes ``Tp`` lanes and ``Cp``
    constraint rows: multiples of 4 within the reference's ``alm_viable``
    (``Tp^2 + 2 Tp Cp + 8 (Tp + Cp) <= 409600``), each at most 4096 (a
    cluster of 8 blocks of 512 threads, a row a thread; every such shape
    fits their shared memory).  Past the gate ``DeviceConstrainedSQP``
    runs the word-space ``_alm_batched``, as the reference runs its XLA
    inner."""
    return (0 < Tp <= 4096 and 0 < Cp <= 4096 and Tp % 4 == 0 and Cp % 4 == 0
            and Tp * Tp + 2 * Tp * Cp + 8 * (Tp + Cp) <= _VMEM_WORDS)


def _slab_orders(lanes):
    """The memory orders a kernel takes its int8 slabs in at ``lanes``
    (K4's Tp, K5's larger of Tp and Cp): batch-last to
    :data:`~pint_tpu_torch.ops.kernels.LONG_LANES`; past it the cluster
    kernel, which takes each slab batch-last or problem-major."""
    return (("batch_last", "problem_major") if lanes > K.LONG_LANES
            else ("batch_last",))


def _launch_pgd_hqt(entry, x, g_pre, hqt, hs_num, hs_den, iters, g_shift):
    """One K4 launch through C entry ``entry``; counts as ``pgd_hqt``."""
    B, Tp = g_pre.shape
    K.require_cuda("pgd_hqt", x, g_pre, hs_num, hs_den, slabs=(hqt,))
    if not pgd_fits(Tp):
        raise ValueError(f"pgd_hqt: Tp={Tp} must be a multiple of 4 within the "
                         "reference's pgd_viable, Tp <= 632 (pgd_fits)")
    pm = K.require_order("pgd_hqt", "hqt", hqt, 1, _slab_orders(Tp))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = getattr(K.library(), entry)(
            x.data_ptr(), g_pre.data_ptr(), hqt.data_ptr(),
            hs_num.data_ptr(), hs_den.data_ptr(), out.data_ptr(),
            B, Tp, iters, g_shift, int(pm), K.stream_of(x),
        )
    K.check(err, "pgd_hqt")
    K.count_launch("pgd_hqt")
    return out


def pgd_hqt(lanes, g_pre, hqt, hs_num, hs_den, *, iters, g_shift):
    """``iters`` error-feedback PGD steps with per-problem Hessians.

    lanes, g_pre (B, Tp) int32 (lanes in [-128, 127]); hqt (Tp, Tp, B) int8
    with ``hqt[k, j, b] = Hq_b[j, k]``, batch-last and contiguous, or past
    64 lanes also problem-major (``Hq.permute(2, 1, 0)`` of a contiguous
    batch-first ``Hq``; the kernel raises on any other order); hs_num,
    hs_den (B,) int32.  Returns the final lanes (B, Tp) int32.  Kernel for
    CUDA tensors, plain version for CPU tensors."""
    _check_pgd_hqt("pgd_hqt", lanes, 1, g_pre, hqt, hs_num, hs_den)
    if lanes.device.type == "cpu":
        return pgd_hqt_plain(
            lanes, g_pre, hqt, hs_num, hs_den, iters=iters, g_shift=g_shift
        )
    return _launch_pgd_hqt("pint_pgd_hqt", lanes, g_pre, hqt, hs_num, hs_den,
                           iters, g_shift)


def pgd_fused_words_pre_plain(u_words, g_pre, hqt, hs_num, hs_den, *, iters,
                              g_shift):
    """Plain PyTorch version of :func:`pgd_fused_words_pre` (any device):
    unpack, :func:`pgd_hqt_plain`, pack."""
    lanes = pgd_hqt_plain(unpack_controls(u_words), g_pre, hqt, hs_num, hs_den,
                          iters=iters, g_shift=g_shift)
    return pack_controls(lanes)


def pgd_fused_words_pre(u_words, g_pre, hqt, hs_num, hs_den, *, iters, g_shift):
    """Packed words in, packed words out: u_words (B, Tp/4) int32 words,
    hqt already in the kernel orientation, in an order :func:`pgd_hqt`
    takes (what :func:`pint_tpu_torch.mpc.condense_fused.lipq_fused`
    emits).

    For CUDA tensors one K4 launch on the words themselves: the (B, Tp/4)
    int32 words are the (B, Tp) int8 lanes in memory, so there is no unpack
    or pack around it.  Equal to ``pack_controls(pgd_hqt(unpack_controls(
    u_words), ...))``; plain version :func:`pgd_fused_words_pre_plain` for
    CPU tensors."""
    _check_pgd_hqt("pgd_fused_words_pre", u_words, 4, g_pre, hqt, hs_num, hs_den)
    if u_words.device.type == "cpu":
        return pgd_fused_words_pre_plain(u_words, g_pre, hqt, hs_num, hs_den,
                                         iters=iters, g_shift=g_shift)
    return _launch_pgd_hqt("pint_pgd_hqt_words", u_words, g_pre, hqt, hs_num,
                           hs_den, iters, g_shift)


def pgd_fused_words(u_words, g_pre, Hq, hs_num, hs_den, *, iters, g_shift):
    """:func:`pgd_fused_words_pre` from a batch-first Hessian Hq (B, Tp, Tp):
    past 64 lanes its problem-major view, else one int8 transpose to the
    batch-last kernel orientation."""
    hqt = Hq.permute(2, 1, 0)
    if Hq.shape[-1] <= K.LONG_LANES:
        hqt = hqt.contiguous()
    return pgd_fused_words_pre(
        u_words, g_pre, hqt, hs_num, hs_den, iters=iters, g_shift=g_shift
    )


# -- the tp column matvec (K10) ------------------------------------------------


def pgd_matvec_cols_plain(lanes_r, hqt_r):
    """Plain PyTorch version of :func:`pgd_matvec_cols` (any device): an
    exact float64 product for the int8-valued lanes the solvers pass
    (|acc| <= 128 * 127 * K).  The kernel wraps modulo 2^32 for any int32
    lanes; this conversion does not."""
    acc = torch.einsum("kjb,bk->bj", hqt_r.to(torch.float64), lanes_r.to(torch.float64))
    return acc.to(torch.int32)


def pgd_matvec_cols(lanes_r, hqt_r):
    """This rank's columns' contribution to the full int32 gradient:
    ``partial[b, j] = sum_k hqt_r[k, j, b] * lanes_r[b, k]``.

    lanes_r (B, K) int32, this rank's iterate columns (int8 values);
    hqt_r (K, rows, B) int8, this rank's k-slice of the batch-last slab
    (``hqt[k, j, b] = Hq_b[j, k]``).  Returns (B, rows) int32.  Kernel for
    CUDA tensors, plain version for CPU tensors.  The kernel
    (``csrc/matvec_cols.cu``) takes any K, a chunk of columns at a time,
    and refuses (``RuntimeError``) more rows than its grid covers (16 x
    65535; 8 x 65535 for a batch not a multiple of 16)."""
    B, Kc = lanes_r.shape
    if hqt_r.dim() != 3 or hqt_r.shape[0] != Kc or hqt_r.shape[2] != B:
        raise ValueError(
            f"pgd_matvec_cols: lanes_r {tuple(lanes_r.shape)} and hqt_r "
            f"{tuple(hqt_r.shape)} do not agree"
        )
    if lanes_r.dtype != torch.int32 or hqt_r.dtype != torch.int8:
        raise ValueError("pgd_matvec_cols: lanes_r must be int32, hqt_r int8")
    if lanes_r.device.type == "cpu":
        return pgd_matvec_cols_plain(lanes_r, hqt_r)
    K.require_cuda("pgd_matvec_cols", lanes_r, hqt_r)
    rows = hqt_r.shape[1]
    out = torch.empty((B, rows), dtype=torch.int32, device=lanes_r.device)
    with torch.cuda.device(lanes_r.device):
        err = K.library().pint_matvec_cols(
            lanes_r.data_ptr(), hqt_r.data_ptr(), out.data_ptr(), B, Kc, rows,
            K.stream_of(lanes_r),
        )
    K.check(err, "pgd_matvec_cols")
    K.count_launch("pgd_matvec_cols")
    return out


# -- the ALM kernels (K5, K7) --------------------------------------------------


def _check(name, specs):
    """Raise unless each (what, tensor, shape, dtype) matches."""
    for what, t, shape, dt in specs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} is {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name}: {what} must be {dt}, got {t.dtype}")


ALM_SHARED_MAX = 4096
"""The widest Tp and Cp K7 takes (``csrc/alm.cu``: to 256 the B fragments
stay on chip; past it each pass is one product across the batch,
``csrc/wide_gemm.cuh``, in one cooperative launch a call)."""


def alm_shared_plain(lanes, g_pre, c_off, lam, hq, sq, lo_pre, hi_pre, *,
                     hs_num, hs_den, cs_num, cs_den, eh_num, eh_den, el_num,
                     el_den, outer, inners, g_shift, y_shift):
    """Plain PyTorch version of :func:`alm_shared` (any device): the
    lane-space loop of ``pint_tpu``'s ``_shared_kernel_factory``."""
    hqT, sd = hq.to(torch.float64).T, sq.to(torch.float64)
    rat = dict(hs_num=hs_num, hs_den=hs_den, cs_num=cs_num, cs_den=cs_den,
               eh_num=eh_num, eh_den=eh_den, el_num=el_num, el_den=el_den)
    return _alm_loop(
        lanes, g_pre, c_off, lam,
        hmv=lambda u: _f64_mv(u, hqT), smv=lambda u: _f64_mv(u, sd.T),
        stmv=lambda y: _f64_mv(y, sd), rat=rat, lo=lo_pre, hi=hi_pre,
        outer=outer, inners=inners, g_shift=g_shift, y_shift=y_shift,
        space=_lane_space(),
    )


def alm_shared(lanes, g_pre, c_off, lam, hq, sq, lo_pre, hi_pre, *, hs_num,
               hs_den, cs_num, cs_den, eh_num, eh_den, el_num, el_den, outer,
               inners, g_shift, y_shift):
    """``outer`` x ``inners`` ALM iterations with one Hessian and one
    constraint matrix shared by every problem.

    lanes, g_pre (B, Tp) int32 (lanes in [-128, 127]); c_off, lam (B, Cp)
    int32; hq (Tp, Tp) int8; sq (Cp, Tp) int8; lo_pre, hi_pre (Cp,) int32;
    the rationals are ints.  Returns (lanes (B, Tp), lam (B, Cp)) int32.
    Kernel for CUDA tensors, plain version for CPU tensors."""
    B, Tp = g_pre.shape
    Cp = c_off.shape[-1]
    i32 = torch.int32
    _check("alm_shared", [
        ("lanes", lanes, (B, Tp), i32), ("g_pre", g_pre, (B, Tp), i32),
        ("c_off", c_off, (B, Cp), i32), ("lam", lam, (B, Cp), i32),
        ("hq", hq, (Tp, Tp), torch.int8), ("sq", sq, (Cp, Tp), torch.int8),
        ("lo_pre", lo_pre, (Cp,), i32), ("hi_pre", hi_pre, (Cp,), i32),
    ])
    kw = dict(hs_num=hs_num, hs_den=hs_den, cs_num=cs_num, cs_den=cs_den,
              eh_num=eh_num, eh_den=eh_den, el_num=el_num, el_den=el_den,
              outer=outer, inners=inners, g_shift=g_shift, y_shift=y_shift)
    if lanes.device.type == "cpu":
        return alm_shared_plain(lanes, g_pre, c_off, lam, hq, sq, lo_pre,
                                hi_pre, **kw)
    K.require_cuda("alm_shared", lanes, g_pre, c_off, lam, hq, sq, lo_pre, hi_pre)
    if not (0 < Tp <= ALM_SHARED_MAX and 0 < Cp <= ALM_SHARED_MAX
            and Tp % 4 == 0 and Cp % 4 == 0):
        raise ValueError(f"alm_shared: Tp={Tp}, Cp={Cp} must be multiples of 4 in "
                         f"[4, {ALM_SHARED_MAX}] (K7's limit)")
    out_lanes = torch.empty_like(lanes)
    out_lam = torch.empty_like(lam)
    lib = K.library()
    scratch = torch.empty((lib.pint_alm_shared_scratch(B, Tp, Cp),), dtype=torch.int8,
                          device=lanes.device)
    with torch.cuda.device(lanes.device):
        err = lib.pint_alm_shared(
            lanes.data_ptr(), g_pre.data_ptr(), c_off.data_ptr(),
            lam.data_ptr(), hq.data_ptr(), sq.data_ptr(), lo_pre.data_ptr(),
            hi_pre.data_ptr(), out_lanes.data_ptr(), out_lam.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            B, Tp, Cp, outer, inners, g_shift, y_shift,
            *(int(kw[k]) for k in RATIONALS), K.stream_of(lanes),
        )
    K.check(err, "alm_shared")
    K.count_launch("alm_shared")
    return out_lanes, out_lam


def alm_shared_fused_words(u_words, g_pre, c_off, lam0, *, Hq, Sq, lo_pre,
                           hi_pre, hs_num, hs_den, cs_num, cs_den, eh_num,
                           eh_den, el_num, el_den, outer, inners, g_shift,
                           y_shift):
    """Words in, words out (``pint_tpu``'s ``alm_shared_fused_words``):
    u_words (B, Tp/4) int32 words; ``Hq``, ``Sq``, ``lo_pre``, ``hi_pre``
    numpy arrays or tensors.  Returns (words, lam)."""
    def on(a, dt):
        return torch.as_tensor(a, device=u_words.device).to(dt).contiguous()

    lanes, lam = alm_shared(
        unpack_controls(u_words), g_pre, c_off, lam0,
        on(Hq, torch.int8), on(Sq, torch.int8),
        on(lo_pre, torch.int32), on(hi_pre, torch.int32),
        hs_num=hs_num, hs_den=hs_den, cs_num=cs_num, cs_den=cs_den,
        eh_num=eh_num, eh_den=eh_den, el_num=el_num, el_den=el_den,
        outer=outer, inners=inners, g_shift=g_shift, y_shift=y_shift,
    )
    return pack_controls(lanes), lam


def alm_hqt_plain(lanes, g_pre, hqt, sqj, sqc, c_off, lo_pre, hi_pre, lam, sc,
                  *, outer, inners, g_shift, y_shift):
    """Plain PyTorch version of :func:`alm_hqt` (any device): the
    lane-space loop of ``pint_tpu``'s ``_kernel_factory``.  ``sqj`` is the
    kernel's second orientation of ``sqc`` and is not read here."""
    Hd = hqt.permute(2, 1, 0).to(torch.float64)        # (B, j, k)
    Sd = sqc.permute(2, 0, 1).to(torch.float64)        # (B, c, j)
    return _alm_loop(
        lanes, g_pre, c_off, lam,
        hmv=lambda u: _bmv(Hd, u), smv=lambda u: _bmv(Sd, u),
        stmv=lambda y: _bmv(Sd.transpose(1, 2), y),
        rat={k: sc[i][:, None] for i, k in enumerate(RATIONALS)},
        lo=lo_pre, hi=hi_pre, outer=outer, inners=inners, g_shift=g_shift,
        y_shift=y_shift, space=_lane_space(),
    )


def alm_hqt(lanes, g_pre, hqt, sqj, sqc, c_off, lo_pre, hi_pre, lam, sc, *,
            outer, inners, g_shift, y_shift):
    """``outer`` x ``inners`` ALM iterations with per-problem int8
    Hessians, constraint rows and rationals.

    lanes, g_pre (B, Tp) int32 (lanes in [-128, 127]); hqt (Tp, Tp, B)
    int8 with ``hqt[k, j, b] = Hq_b[j, k]``; sqj (Tp, Cp, B) and sqc
    (Cp, Tp, B) int8, both ``Sq_b[c, j]``; c_off, lo_pre, hi_pre, lam
    (B, Cp) int32; sc (8, B) int32, the rationals in
    :data:`~pint_tpu_torch.mpc.constrained.RATIONALS` order.  The slabs
    are batch-last and contiguous; past 64 lanes or rows (the cluster
    kernel) each may instead be problem-major (``hqt`` as
    ``Hq.permute(2, 1, 0)``, ``sqc`` and ``sqj`` as ``permute(1, 2, 0)`` of
    contiguous batch-first stacks), and the kernel raises on any other
    order.  Returns (lanes (B, Tp), lam (B, Cp)) int32.  Kernel for CUDA
    tensors, plain version for CPU tensors."""
    B, Tp = g_pre.shape
    Cp = c_off.shape[-1]
    i32, i8 = torch.int32, torch.int8
    _check("alm_hqt", [
        ("lanes", lanes, (B, Tp), i32), ("g_pre", g_pre, (B, Tp), i32),
        ("hqt", hqt, (Tp, Tp, B), i8), ("sqj", sqj, (Tp, Cp, B), i8),
        ("sqc", sqc, (Cp, Tp, B), i8), ("c_off", c_off, (B, Cp), i32),
        ("lo_pre", lo_pre, (B, Cp), i32), ("hi_pre", hi_pre, (B, Cp), i32),
        ("lam", lam, (B, Cp), i32), ("sc", sc, (8, B), i32),
    ])
    kw = dict(outer=outer, inners=inners, g_shift=g_shift, y_shift=y_shift)
    if lanes.device.type == "cpu":
        return alm_hqt_plain(lanes, g_pre, hqt, sqj, sqc, c_off, lo_pre,
                             hi_pre, lam, sc, **kw)
    ops = (lanes, g_pre, hqt, sqj, sqc, c_off, lo_pre, hi_pre, lam, sc)
    K.require_cuda("alm_hqt", lanes, g_pre, c_off, lo_pre, hi_pre, lam, sc,
                   slabs=(hqt, sqj, sqc))
    if not alm_fits(Tp, Cp):
        raise ValueError(f"alm_hqt: Tp={Tp}, Cp={Cp} must be multiples of 4 within "
                         "the reference's alm_viable (alm_fits)")
    allowed = _slab_orders(max(Tp, Cp))
    orders = (int(K.require_order("alm_hqt", "hqt", hqt, 1, allowed))
              | int(K.require_order("alm_hqt", "sqc", sqc, 0, allowed)) << 1
              | int(K.require_order("alm_hqt", "sqj", sqj, 0, allowed)) << 2)
    out_lanes = torch.empty_like(lanes)
    out_lam = torch.empty_like(lam)
    with torch.cuda.device(lanes.device):
        err = K.library().pint_alm(
            *(t.data_ptr() for t in ops), out_lanes.data_ptr(),
            out_lam.data_ptr(), B, Tp, Cp, outer, inners, g_shift, y_shift, orders,
            K.stream_of(lanes),
        )
    K.check(err, "alm_hqt")
    K.count_launch("alm")
    return out_lanes, out_lam


def alm_fused_words_pre(u_words, g_pre, hqt, hs_num, hs_den, sqj, sqc, cs_num,
                        cs_den, c_off, lo_pre, hi_pre, eh_num, eh_den, el_num,
                        el_den, lam0, *, outer, inners, g_shift, y_shift):
    """Words in, words out, int8 matrices already batch-last in the
    kernel orientations (``hqt`` from :func:`~pint_tpu_torch.mpc.
    condense_fused.lipq_fused`, ``sqj``/``sqc`` from ``pen_fused``); the
    rationals are (B,) int32.  Returns (words, lam)."""
    sc = torch.stack([hs_num, hs_den, cs_num, cs_den,
                      eh_num, eh_den, el_num, el_den])
    lanes, lam = alm_hqt(
        unpack_controls(u_words), g_pre, hqt, sqj, sqc, c_off, lo_pre,
        hi_pre, lam0, sc, outer=outer, inners=inners, g_shift=g_shift,
        y_shift=y_shift,
    )
    return pack_controls(lanes), lam


def alm_fused_words(u_words, g_pre, Hq, hs_num, hs_den, Sq, cs_num, cs_den,
                    c_off, lo_pre, hi_pre, eh_num, eh_den, el_num, el_den,
                    lam0, *, outer, inners, g_shift, y_shift):
    """:func:`alm_fused_words_pre` from batch-first Hq (B, Tp, Tp) and Sq
    (B, Cp, Tp): past 64 lanes or rows the problem-major views of Hq and Sq
    and one batch-first transpose of Sq for sqj; else one int8 transpose
    to each batch-last kernel orientation."""
    Tp, Cp = Hq.shape[-1], Sq.shape[1]
    if max(Tp, Cp) > K.LONG_LANES:
        hqt, sqc = Hq.permute(2, 1, 0), Sq.permute(1, 2, 0)
        sqj = Sq.transpose(1, 2).contiguous().permute(1, 2, 0)
    else:
        hqt, sqc = Hq.permute(2, 1, 0).contiguous(), Sq.permute(1, 2, 0).contiguous()
        sqj = Sq.permute(2, 1, 0).contiguous()
    return alm_fused_words_pre(
        u_words, g_pre, hqt, hs_num, hs_den, sqj, sqc, cs_num, cs_den, c_off,
        lo_pre, hi_pre, eh_num, eh_den, el_num, el_den, lam0, outer=outer,
        inners=inners, g_shift=g_shift, y_shift=y_shift,
    )
