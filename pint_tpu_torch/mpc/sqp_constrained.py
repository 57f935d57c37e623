"""State-constrained nonlinear SQP: hard ``lo <= F x <= hi`` on packed plans.

PyTorch port of ``pint_tpu/mpc/sqp_constrained.py``.
:class:`ConstrainedSQP` combines the SQP outer loop of
:class:`~pint_tpu_torch.mpc.ltv.QuantizedSQP` (host linearize and condense,
numpy) with the augmented-Lagrangian machinery: per SQP iteration the
constraint rows are re-stacked from the fresh linearization's propagators,
quantized per problem on the host, and the word-space ALM inner
:func:`_alm_batched` runs on the device; the multipliers carry over between
iterations, rescaled to the new c-unit.  Also here: the static
y-split shift (``_T_AMP``, ``_Y_SHIFT``), the vectorized rational
``_rational_vec`` and ``_alm_batched``, the batched integer ALM with
per-problem int8 Hessians and constraint rows -- the word-space reference
the K5 kernel (:func:`pint_tpu_torch.mpc.fused_alm.alm_hqt`) is held to, bit
for bit -- and its column-sharded forms for a tp mesh,
:func:`_alm_batched_cols` (plain column dots) and
:func:`_alm_batched_cols_hqt` (K10).  The reference's shared column body
``_alm_cols_loop`` is :func:`pint_tpu_torch.mpc.constrained._alm_loop`
here, the one body of every ALM form.  The reference's ``ConstrainedSQP``
runs its inner as the XLA ``_alm_batched``, not a Pallas kernel, so the port
runs that loop's torch form too (K5 is ``DeviceConstrainedSQP``'s inner).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

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
from pint_tpu_torch.mpc.condensed import condense_ltv_batch
from pint_tpu_torch.mpc.ltv import QuantizedSQP, _bmv, quantize_batch

__all__ = ["ConstrainedSQP"]

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


@dataclasses.dataclass(frozen=True)
class ConstrainedSQP:
    """SQP trajectory optimizer with hard per-step state constraints
    ``lo <= F x_k <= hi`` (k = 1..T), on packed int8 plans.

    The objective is ``sqp``'s (model, weights, target, iterations,
    device); ``F`` is (Cs, n) over physical states, ``lo``/``hi`` scalar
    or (Cs,).  Per SQP iteration: linearize + condense on the host, stack
    the constraint rows from the same propagators, quantize per problem,
    run ``alm_outer`` multiplier updates x ``sqp.pgd_iters`` PGD inners on
    ``sqp.device``.  Multipliers persist across SQP iterations."""

    sqp: QuantizedSQP
    F: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([[0.0, 1.0, 0.0]])
    )
    lo: float | np.ndarray = -1.0
    hi: float | np.ndarray = 1.0
    rho: float = 50.0
    alm_outer: int = 3
    row_pad: int = 64

    @functools.cached_property
    def _F(self) -> np.ndarray:
        return np.atleast_2d(np.asarray(self.F, float))

    @functools.cached_property
    def _bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        Cs = self._F.shape[0]
        lo = np.broadcast_to(np.asarray(self.lo, float), (Cs,))
        hi = np.broadcast_to(np.asarray(self.hi, float), (Cs,))
        if np.any(lo >= hi):
            raise ValueError("state constraint lo must be < hi per row")
        T = self.sqp.horizon
        return np.tile(lo, T), np.tile(hi, T)

    @property
    def device(self) -> torch.device:
        return self.sqp.device

    @property
    def n_rows(self) -> int:
        return self._F.shape[0] * self.sqp.horizon

    @functools.cached_property
    def padded_rows(self) -> int:
        return -(-self.n_rows // self.row_pad) * self.row_pad

    def init_words(self, batch: int) -> torch.Tensor:
        return self.sqp.init_words(batch)

    def init_lam(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.padded_rows), dtype=torch.int32,
                           device=self.device)

    # -- host-side per-iteration prep -----------------------------------------

    def _condense_constrained(self, x0_f: np.ndarray, lanes: np.ndarray):
        """Linearize/condense/stack/quantize for the whole batch (host
        numpy, the reference's code).  The objective half matches
        ``QuantizedSQP._condense_batch`` except alpha = 1/(lip + rho *
        penalty_lip); the constraint half is the batched form of
        ``quantize_constrained`` in lane units.  Returns (operands, c_unit
        (B,))."""
        s = self.sqp
        T, m = s.horizon, s.n_ctrl
        ls = s._lane_scales
        batch = x0_f.shape[0]
        u_phys = lanes.reshape(batch, T, m) * ls
        traj = s.model.reference_rollout(x0_f, u_phys)
        s._check_dims(traj.shape[-1])
        n = traj.shape[-1]
        if self._F.shape[1] != n:
            raise ValueError(
                f"F has {self._F.shape[1]} columns, state dim is {n}"
            )
        A_seq, B_seq = s.model.linearize(traj[:, :-1], u_phys)
        c_seq = (
            traj[:, 1:]
            - np.einsum("bkij,bkj->bki", A_seq, traj[:, :-1])
            - np.einsum("bkij,bkj->bki", B_seq, u_phys)
        )
        R_lane = ls[:, None] * np.asarray(s.R) * ls[None, :]
        H, G, g_ref, lip, Abar, Bbar, Cbar = condense_ltv_batch(
            A_seq, B_seq * ls, c_seq, np.asarray(s.Q), R_lane,
            s.Qf_matrix, np.asarray(s.x_ref, float), return_propagators=True,
        )
        Fm = self._F
        C, Tm, Tp, Cp = self.n_rows, T * m, s.padded, self.padded_rows
        S_b = np.einsum("ci,bkin->bkcn", Fm, Bbar).reshape(batch, C, Tm)
        P_b = np.einsum("ci,bkin->bkcn", Fm, Abar).reshape(batch, C, n)
        r_b = np.einsum("ci,bki->bkc", Fm, Cbar).reshape(batch, C)

        pen_lip = np.linalg.eigvalsh(
            S_b @ np.swapaxes(S_b, 1, 2)
        )[:, -1]
        alpha = 1.0 / (lip + self.rho * pen_lip)
        Hq, g_pre, hs_num, hs_den = quantize_batch(
            H, G, g_ref, alpha, x0_f, Tp, s.g_shift
        )

        # constraint quantization (per problem)
        s_scale = np.abs(S_b).max(axis=(1, 2)) / 127.0
        if (s_scale == 0).any():
            raise ValueError("constraint rows identically zero for a problem")
        Sq = np.zeros((batch, Cp, Tp), np.int8)
        Sq[:, :C, :Tm] = np.round(S_b / s_scale[:, None, None]).astype(
            np.int8
        )
        lo_r, hi_r = self._bounds
        row_amp = 127.0 * np.abs(S_b).sum(axis=2).max(axis=1)
        b_amp = float(max(np.abs(lo_r).max(), np.abs(hi_r).max()))
        c_unit = 2.0 * (row_amp + b_amp) / float(1 << _C_BITS)   # (B,)

        cs_num, cs_den = _rational_vec(
            s_scale / c_unit, 127 * 127 * Tp, 2**31 - 1, "cs"
        )
        base = (
            self.rho * s_scale * float(1 << _Y_SHIFT) * c_unit * alpha
        ) * float(1 << s.g_shift)
        eh_num, eh_den = _rational_vec(
            base * 128.0, 64 * 127 * Cp, 2**30 - 1, "eh"
        )
        el_num, el_den = _rational_vec(
            base, 127 * 127 * Cp, 2**30 - 1, "el"
        )

        sent = np.int32(1 << 30)
        lo_pre = np.full((batch, Cp), -sent, np.int32)
        hi_pre = np.full((batch, Cp), sent, np.int32)
        lo_pre[:, :C] = np.clip(
            np.round(lo_r / c_unit[:, None]), -sent, sent
        )
        hi_pre[:, :C] = np.clip(
            np.round(hi_r / c_unit[:, None]), -sent, sent
        )
        off = np.einsum("bn,bcn->bc", x0_f, P_b) + r_b
        off = np.nan_to_num(
            off / c_unit[:, None], posinf=_CX0_CAP, neginf=-_CX0_CAP
        )
        c_off = np.zeros((batch, Cp), np.int32)
        c_off[:, :C] = np.clip(np.round(off), -_CX0_CAP, _CX0_CAP)
        return dict(
            Hq=Hq, g_pre=g_pre, hs_num=hs_num, hs_den=hs_den, Sq=Sq,
            cs_num=cs_num, cs_den=cs_den, c_off=c_off, lo_pre=lo_pre,
            hi_pre=hi_pre, eh_num=eh_num, eh_den=eh_den, el_num=el_num,
            el_den=el_den,
        ), c_unit

    # -- public API ------------------------------------------------------------

    def solve(
        self,
        x0_f: np.ndarray,
        u_words: Optional[torch.Tensor] = None,
        lam: Optional[torch.Tensor] = None,
        track_costs: bool = True,
    ):
        """Run ``sqp.sqp_iters`` outer SQP iterations with the constrained
        inner solve.  Returns (words (B, Tp/4), lam (B, Cp) int32, both on
        the device, cost history or None)."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        s = self.sqp
        dev = self.device
        u_words = self.init_words(batch) if u_words is None else u_words.to(dev)
        lam = self.init_lam(batch) if lam is None else lam.to(dev)
        costs = (
            [s.true_cost(x0_f, s.lanes(u_words))] if track_costs else None
        )
        prev_c_unit = None
        for _ in range(s.sqp_iters):
            ops, c_unit = self._condense_constrained(x0_f, s.lanes(u_words))
            if prev_c_unit is not None:
                # the multiplier plane lives in c-pre units; relinearization
                # changes the per-problem c_unit, so carried multipliers are
                # rescaled to keep their physical value lam_pre * c_unit
                lam_np = lam.cpu().numpy().astype(np.int64)
                lam_np = np.clip(
                    np.round(lam_np * (prev_c_unit / c_unit)[:, None]),
                    -int(_LAM_CAP),
                    int(_LAM_CAP),
                ).astype(np.int32)
                lam = torch.as_tensor(lam_np, device=dev)
            prev_c_unit = c_unit
            u_words, lam = _alm_batched(
                u_words,
                *(
                    torch.as_tensor(ops[k], device=dev)
                    for k in (
                        "g_pre", "Hq", "hs_num", "hs_den", "Sq", "cs_num",
                        "cs_den", "c_off", "lo_pre", "hi_pre", "eh_num",
                        "eh_den", "el_num", "el_den",
                    )
                ),
                lam,
                outer=self.alm_outer,
                inners=s.pgd_iters,
                g_shift=s.g_shift,
                y_shift=_Y_SHIFT,
            )
            if track_costs:
                costs.append(s.true_cost(x0_f, s.lanes(u_words)))
        return u_words, lam, (
            np.stack(costs, axis=-1) if track_costs else None
        )

    # -- diagnostics -------------------------------------------------------------

    def constraint_trajectory(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """True (nonlinear-rollout) constraint values F x_k, (B, T, Cs)."""
        s = self.sqp
        u_phys = np.asarray(lanes).reshape(-1, s.horizon, s.n_ctrl) * s._lane_scales
        traj = s.model.reference_rollout(np.atleast_2d(x0_f), u_phys)
        return np.einsum("ci,bki->bkc", self._F, traj[:, 1:])

    def violation(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Max true-trajectory constraint violation per problem."""
        c = self.constraint_trajectory(x0_f, lanes)
        Cs = self._F.shape[0]
        lo = np.asarray(self._bounds[0]).reshape(-1, Cs)[0]
        hi = np.asarray(self._bounds[1]).reshape(-1, Cs)[0]
        return np.maximum(
            np.maximum(c - hi, 0), np.maximum(lo - c, 0)
        ).max(axis=(1, 2))

    # -- float64 reference (same algorithm, no quantization) --------------------

    def reference_solve(self, x0_f: np.ndarray):
        """Float64 SQP+ALM with the identical structure: per SQP iteration,
        linearize/condense/stack, then ``alm_outer`` x ``pgd_iters``
        projected-gradient inners with projection-form multiplier updates.
        Returns (lane plans (B, n_dec) float64, lam (B, C))."""
        s = self.sqp
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        T, m = s.horizon, s.n_ctrl
        ls = s._lane_scales
        lo_r, hi_r = self._bounds
        U = np.zeros((batch, s.n_dec))
        lam = np.zeros((batch, self.n_rows))
        for _ in range(s.sqp_iters):
            u_phys = U.reshape(batch, T, m) * ls
            traj = s.model.reference_rollout(x0_f, u_phys)
            A_seq, B_seq = s.model.linearize(traj[:, :-1], u_phys)
            c_seq = (
                traj[:, 1:]
                - np.einsum("bkij,bkj->bki", A_seq, traj[:, :-1])
                - np.einsum("bkij,bkj->bki", B_seq, u_phys)
            )
            R_lane = ls[:, None] * np.asarray(s.R) * ls[None, :]
            H, G, g_ref, lip, Abar, Bbar, Cbar = condense_ltv_batch(
                A_seq, B_seq * ls, c_seq, np.asarray(s.Q), R_lane,
                s.Qf_matrix, np.asarray(s.x_ref, float),
                return_propagators=True,
            )
            Fm = self._F
            n = traj.shape[-1]
            C = self.n_rows
            S_b = np.einsum("ci,bkin->bkcn", Fm, Bbar).reshape(batch, C, s.n_dec)
            P_b = np.einsum("ci,bkin->bkcn", Fm, Abar).reshape(batch, C, n)
            r_b = np.einsum("ci,bki->bkc", Fm, Cbar).reshape(batch, C)
            pen_lip = np.linalg.eigvalsh(S_b @ np.swapaxes(S_b, 1, 2))[:, -1]
            alpha = 1.0 / (lip + self.rho * pen_lip)
            g0 = np.einsum("bin,bn->bi", G, x0_f) + g_ref
            cx0 = np.einsum("bn,bcn->bc", x0_f, P_b) + r_b
            for _ in range(self.alm_outer):
                for _ in range(s.pgd_iters):
                    t = np.einsum("bcn,bn->bc", S_b, U) + cx0 + lam / self.rho
                    y = t - np.clip(t, lo_r, hi_r)
                    grad = (
                        np.einsum("bij,bj->bi", H, U)
                        + g0
                        + self.rho * np.einsum("bc,bcn->bn", y, S_b)
                    )
                    U = np.clip(U - alpha[:, None] * grad, -127.0, 127.0)
                t = np.einsum("bcn,bn->bc", S_b, U) + cx0 + lam / self.rho
                lam = self.rho * (t - np.clip(t, lo_r, hi_r))
        return U, lam
