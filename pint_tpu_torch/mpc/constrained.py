"""Hard linear state constraints: augmented-Lagrangian fixed-point MPC.

PyTorch port of ``pint_tpu/mpc/constrained.py``.  The host tier (numpy only)
is copied as it is: :class:`StateConstrainedQP`, :func:`constrain_states`,
the fixed-point constants, :class:`QuantizedConstrainedQP` and
:func:`quantize_constrained`.  :class:`ConstrainedPGD`, the LTI device
solver, runs its ALM loop on torch tensors:

    c(U, x0) = S U + P x0 + r          (stacked F x_k rows, k = 1..T)
    inner:  minimize_U f(U) + rho/2 dist^2(c + lam/rho, [lo, hi])
            over the control box       (error-feedback fixed-point PGD)
    outer:  lam <- rho * (t - Pi(t)),  t = c(U*) + lam/rho

On a CUDA device it runs the whole loop as the K7 kernel
(:func:`pint_tpu_torch.mpc.fused_alm.alm_shared_fused_words`); with
``fused=False`` it runs the word-space loop (saturating packed update
``add_signed_saturate`` + ``max_signed``) on any device, bit-identical to
``pint_tpu``'s XLA route and the reference K7 is held to on the card.

:class:`ConstrainedController` is the receding-horizon closed loop over
:class:`ConstrainedPGD` (K7 every tick on the card), stepping a fixed-point
plant such as the Q16 ``DoubleIntegrator``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.mpc.condensed import CondensedQP, QuantizedQP, quantize
from pint_tpu_torch.mpc.ltv import _lower_words
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W

__all__ = [
    "StateConstrainedQP",
    "QuantizedConstrainedQP",
    "ConstrainedController",
    "ConstrainedPGD",
    "constrain_states",
    "quantize_constrained",
]


@dataclasses.dataclass(frozen=True)
class StateConstrainedQP:
    """A condensed QP plus stacked linear state constraints.

    minimize 1/2 U^T H U + g(x0)^T U
    s.t.     |U| <= u_max                      (control box)
             lo <= S U + P x0 + r <= hi        (state rows, C of them)
    """

    qp: CondensedQP
    S: np.ndarray        # (C, Tm)
    P: np.ndarray        # (C, n)
    r: np.ndarray        # (C,)
    lo: np.ndarray       # (C,)
    hi: np.ndarray       # (C,)
    penalty_lipschitz: float   # lambda_max(S^T S)

    def constraint(self, U: np.ndarray, x0: np.ndarray) -> np.ndarray:
        """c(U, x0), batched over leading dims."""
        return U @ self.S.T + np.atleast_2d(x0) @ self.P.T + self.r

    def solve_alm(
        self,
        x0: np.ndarray,
        rho: float = 10.0,
        outer: int = 12,
        inners: int = 60,
        step: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 augmented-Lagrangian reference solver (CPU oracle).

        Batched over leading dims of x0.  Returns ``(U, lam)``.  The
        quantized device solver runs this exact iteration in fixed point.
        Structurally infeasible starts converge to a bounded
        least-violation compromise instead of diverging.
        """
        qp = self.qp
        x0 = np.atleast_2d(np.asarray(x0, np.float64))
        B = x0.shape[0]
        Tm = qp.H.shape[0]
        C = self.S.shape[0]
        L = qp.lipschitz + rho * self.penalty_lipschitz
        alpha = step if step is not None else 1.0 / L
        U = np.zeros((B, Tm))
        lam = np.zeros((B, C))
        cx0 = x0 @ self.P.T + self.r          # (B, C)
        g0 = x0 @ qp.G.T + qp.g_ref           # (B, Tm)
        for _ in range(outer):
            for _ in range(inners):
                t = U @ self.S.T + cx0 + lam / rho
                y = t - np.clip(t, self.lo, self.hi)
                grad = U @ qp.H.T + g0 + rho * (y @ self.S)
                U = np.clip(U - alpha * grad, -qp.u_max, qp.u_max)
            t = U @ self.S.T + cx0 + lam / rho
            lam = rho * (t - np.clip(t, self.lo, self.hi))
        return np.squeeze(U) if x0.ndim == 1 else U, lam

    def kkt_residual(
        self, U: np.ndarray, lam: np.ndarray, x0: np.ndarray
    ) -> np.ndarray:
        """Natural-map KKT residual ||U - Pi_box(U - grad L)||_inf per
        problem: zero exactly at a constrained optimum."""
        qp = self.qp
        U = np.atleast_2d(np.asarray(U, np.float64))
        x0 = np.atleast_2d(np.asarray(x0, np.float64))
        g0 = x0 @ qp.G.T + qp.g_ref
        grad = U @ qp.H.T + g0 + np.atleast_2d(lam) @ self.S
        proj = np.clip(U - grad, -qp.u_max, qp.u_max)
        return np.abs(U - proj).max(axis=-1)


def constrain_states(
    qp: CondensedQP,
    A_seq: np.ndarray,
    B_seq: np.ndarray,
    c_seq: Optional[np.ndarray],
    F: np.ndarray,
    lo,
    hi,
) -> StateConstrainedQP:
    """Stack per-step state constraints ``lo <= F x_k <= hi`` (k = 1..T)
    into condensed rows over the decision vector U.

    ``A_seq``/``B_seq`` are (T, n, n)/(T, n, m) -- pass ``np.broadcast_to``
    of the LTI pair for time-invariant plants; ``c_seq`` (T, n) or None are
    the affine offsets.  ``F`` is (Cs, n); ``lo``, ``hi`` are scalars or
    (Cs,) and apply at every step.  Rows for step k read
    F Bbar_k U + F Abar_k x0 + F Cbar_k.
    """
    A_seq = np.asarray(A_seq, float)
    B_seq = np.asarray(B_seq, float)
    T, n, m = B_seq.shape
    if A_seq.shape != (T, n, n):
        raise ValueError(f"A_seq {A_seq.shape} vs B_seq {B_seq.shape}")
    c_seq = np.zeros((T, n)) if c_seq is None else np.asarray(c_seq, float)
    F = np.atleast_2d(np.asarray(F, float))
    Cs = F.shape[0]
    if F.shape[1] != n:
        raise ValueError(f"F has {F.shape[1]} columns, state dim is {n}")
    lo = np.broadcast_to(np.asarray(lo, float), (Cs,))
    hi = np.broadcast_to(np.asarray(hi, float), (Cs,))
    if np.any(lo >= hi):
        raise ValueError("state constraint lo must be < hi per row")

    S = np.zeros((T * Cs, T * m))
    P = np.zeros((T * Cs, n))
    r = np.zeros(T * Cs)
    Bbar = np.zeros((n, T * m))
    Ak_prod = np.eye(n)
    c_acc = np.zeros(n)
    for k in range(T):
        Ak_prod = A_seq[k] @ Ak_prod
        if k:
            Bbar = A_seq[k] @ Bbar
        Bbar[:, k * m : (k + 1) * m] = B_seq[k]
        c_acc = A_seq[k] @ c_acc + c_seq[k]
        S[k * Cs : (k + 1) * Cs] = F @ Bbar
        P[k * Cs : (k + 1) * Cs] = F @ Ak_prod
        r[k * Cs : (k + 1) * Cs] = F @ c_acc

    pen_lip = float(np.linalg.eigvalsh(S.T @ S).max())
    return StateConstrainedQP(
        qp=qp,
        S=S,
        P=P,
        r=r,
        lo=np.tile(lo, T),
        hi=np.tile(hi, T),
        penalty_lipschitz=pen_lip,
    )


# fixed-point geometry of the constraint plane ("c-pre" units):
#   c_phys = c_pre * c_unit, with c_unit = c_ref / 2**C_BITS so that the
#   reachable |S U| range spans ~2**(C_BITS-1).  All constraint-side state
#   (bounds, offsets, multipliers, violations) is int32 in these units.
_C_BITS = 20
_LAM_CAP = np.int32(1 << 22)      # |lam/rho| cap in c-pre units (safeguarded ALM)
_CX0_CAP = 1 << 22                # clip of the x0-dependent offset
_Y_BITS = 13                      # y is split into two int8 planes (14-bit total)


@dataclasses.dataclass(frozen=True)
class QuantizedConstrainedQP:
    """Fixed-point operands for the device ALM solver.

    The objective side reuses :class:`QuantizedQP` quantized at the
    penalty-augmented step 1/(L_H + rho * L_S); the constraint side adds an
    int8 row matrix ``Sq`` and the int32 rational ladders that move values
    between the matmul-accumulator, c-pre and pre-shift-lane-unit scales:

      c_pre     = (lanes @ Sq^T) * cs_num >> cs_den        (+ cx0_pre)
      y14       = (t - clip(t, lo, hi) + ef) >> y_shift    (14-bit, EF carried)
      extra_pre = (y_hi @ Sq) * eh_num >> eh_den
                + (y_lo @ Sq) * el_num >> el_den           (penalty gradient)

    Every rational numerator is budgeted so the int32 product of the worst-
    case accumulator magnitude cannot overflow.
    """

    scqp: StateConstrainedQP
    qqp: QuantizedQP
    rho: float
    Sq: np.ndarray          # (Cp, Tp) int8
    s_scale: float
    c_unit: float
    cs_num: int
    cs_den: int
    eh_num: int
    eh_den: int
    el_num: int
    el_den: int
    y_shift: int
    lo_pre: np.ndarray      # (Cp,) int32 (padded rows get wide sentinels)
    hi_pre: np.ndarray
    n_rows: int             # C (unpadded)
    padded_rows: int        # Cp

    def c_off_pre(self, x0_phys: np.ndarray) -> np.ndarray:
        """int32 x0-dependent constraint offset (P x0 + r) in c-pre units,
        padded; the per-solve host prep mirroring QuantizedQP.g_lane_fixed."""
        sc = self.scqp
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        off = x0 @ sc.P.T + sc.r
        off = np.nan_to_num(off / self.c_unit, posinf=_CX0_CAP, neginf=-_CX0_CAP)
        off = np.clip(np.round(off), -_CX0_CAP, _CX0_CAP).astype(np.int32)
        pad = self.padded_rows - self.n_rows
        if pad:
            off = np.concatenate(
                [off, np.zeros(off.shape[:-1] + (pad,), np.int32)], axis=-1
            )
        return off


def _rational(value: float, acc_max: int, budget: int, what: str):
    """Largest-denominator int32 rational num/2**den ~ value such that
    |acc| <= acc_max keeps acc*num within ``budget``."""
    num_max = budget // acc_max
    if num_max < 1 or value <= 0:
        raise ValueError(f"{what}: scale {value!r} unrepresentable")
    den = max(0, min(31, int(np.floor(np.log2(num_max / value)))))
    num = int(round(value * 2**den))
    if num < 1 or num > num_max:
        raise ValueError(
            f"{what}: scale {value!r} out of the int32 rational budget "
            f"(num={num}, max={num_max}); rescale the problem or rho"
        )
    return num, den


def quantize_constrained(
    scqp: StateConstrainedQP,
    rho: float = 50.0,
    g_shift: int = 12,
    pad_to: int = 64,
) -> QuantizedConstrainedQP:
    """Quantize a state-constrained QP for the int8 ALM solver."""
    qp = scqp.qp
    # the inner problem's curvature includes the penalty Hessian rho S^T S;
    # folding the augmented Lipschitz into a derived CondensedQP reuses the
    # whole objective-side quantization path unchanged
    lip = qp.lipschitz + rho * scqp.penalty_lipschitz
    qp_aug = CondensedQP(
        H=qp.H, G=qp.G, g_ref=qp.g_ref, u_max=qp.u_max, lipschitz=lip
    )
    qqp = quantize(qp_aug, g_shift=g_shift, pad_to=pad_to)
    alpha = 1.0 / lip

    C, Tm = scqp.S.shape
    Tp = qqp.padded
    Cp = -(-C // pad_to) * pad_to
    s_scale = float(np.abs(scqp.S).max()) / 127.0
    if s_scale == 0.0:
        raise ValueError("constraint matrix S is identically zero")
    Sq = np.zeros((Cp, Tp), np.int8)
    Sq[:C, :Tm] = np.round(scqp.S / s_scale).astype(np.int8)

    # c-pre geometry: c_ref spans the reachable |S U| plus the bound range
    row_amp = float(np.abs(scqp.S).sum(axis=1).max()) * qp.u_max
    b_amp = float(max(np.abs(scqp.lo).max(), np.abs(scqp.hi).max()))
    c_ref = 2.0 * (row_amp + b_amp)
    c_unit = c_ref / float(1 << _C_BITS)

    # lanes @ Sq^T accumulator -> c-pre
    cs_f = qqp.u_scale * s_scale / c_unit
    cs_num, cs_den = _rational(cs_f, 127 * 127 * Tp, 2**31 - 1, "cs")

    # y-split matmul accumulators -> pre-shift lane units.  y14 is exact
    # (y_hi*128 + y_lo); worst-case |t| sets the shift so y14 fits 14 bits.
    t_amp = float(1 << (_C_BITS - 1)) + float(_CX0_CAP) + float(_LAM_CAP)
    y_shift = max(0, int(np.ceil(np.log2(t_amp * 2.0))) - _Y_BITS)
    base = rho * s_scale * float(1 << y_shift) * c_unit * alpha / qqp.u_scale
    base *= float(1 << g_shift)
    # each term gets half the int32 budget so their sum cannot overflow
    eh_num, eh_den = _rational(base * 128.0, 64 * 127 * Cp, 2**30 - 1, "eh")
    el_num, el_den = _rational(base, 127 * 127 * Cp, 2**30 - 1, "el")

    sent = np.int32(1 << 30)
    lo_pre = np.full(Cp, -sent, np.int32)
    hi_pre = np.full(Cp, sent, np.int32)
    lo_pre[:C] = np.clip(np.round(scqp.lo / c_unit), -sent, sent)
    hi_pre[:C] = np.clip(np.round(scqp.hi / c_unit), -sent, sent)

    return QuantizedConstrainedQP(
        scqp=scqp,
        qqp=qqp,
        rho=rho,
        Sq=Sq,
        s_scale=s_scale,
        c_unit=c_unit,
        cs_num=cs_num,
        cs_den=cs_den,
        eh_num=eh_num,
        eh_den=eh_den,
        el_num=el_num,
        el_den=el_den,
        y_shift=y_shift,
        lo_pre=lo_pre,
        hi_pre=hi_pre,
        n_rows=C,
        padded_rows=Cp,
    )


def _f64_mv(a, m):
    """int32 lanes (B, K) @ float64 matrix (K, N) -> int32 (B, N): an int8
    matvec as an exact float64 product (|acc| <= 128 * 127 * 256)."""
    return (a.to(torch.float64) @ m).to(torch.int32)


def _word_space():
    """(lanes_of, advance) of the word-space loop: the iterate is packed
    words, updated by ``add_signed_saturate`` then the -127 box floor."""
    def advance(words, delta):
        words = W.add_signed_saturate(CONTROL_LAYOUT, words, pack_controls(delta))
        return W.max_signed(CONTROL_LAYOUT, words,
                            torch.full_like(words, _lower_words()))
    return unpack_controls, advance


def _lane_space():
    """(lanes_of, advance) of the lane-space loop the kernels run: for
    in-range int8 lanes ``clip(u + d, -127, 127)`` equals the word-space
    update exactly."""
    return (lambda lanes: lanes,
            lambda lanes, delta: torch.clamp(lanes + delta, -127, 127))


def _alm_loop(x, g_pre, c_off, lam, *, hmv, smv, stmv, rat, lo, hi, outer,
              inners, g_shift, y_shift, space, hsmv=None):
    """The ALM iteration of ``pint_tpu``'s ``ConstrainedPGD.solve_words``,
    ``_alm_batched``, their column-sharded forms and both ALM kernels, in
    int32 with XLA's wrapping.

    ``hmv(lanes)`` -> (B, Tp) and ``smv(lanes)`` -> (B, Cp) are the int8
    matvecs ``Hq u`` and ``Sq u``, ``stmv(y)`` -> (B, Tp) is ``Sq^T y``;
    ``hsmv(lanes)``, when given, returns both of the inner iteration's
    ``(Hq u, Sq u)`` at once (one launch and one all-reduce on the column
    path), and ``smv`` then serves only the multiplier update.  ``rat``
    maps the eight rational names to ints or (B, 1) int32 tensors;
    ``space`` is :func:`_word_space` or :func:`_lane_space`.  Returns
    (iterate, lam)."""
    lanes_of, advance = space
    half = 1 << (g_shift - 1)
    y_half = (1 << y_shift) >> 1
    y_cap = (1 << _Y_BITS) - 1
    cap = int(_LAM_CAP)
    carry = torch.zeros_like(g_pre)
    ey = torch.zeros_like(c_off)
    if hsmv is None:
        def hsmv(lanes):
            return hmv(lanes), smv(lanes)

    def t_of(s_acc, lam):
        c_pre = (s_acc * rat["cs_num"]) >> rat["cs_den"]
        return c_pre + c_off + lam

    for _ in range(outer):
        for _ in range(inners):
            lanes = lanes_of(x)
            h_acc, s_acc = hsmv(lanes)
            pre = (h_acc * rat["hs_num"]) >> rat["hs_den"]
            t = t_of(s_acc, lam)
            y = t - torch.clamp(t, lo, hi) + ey
            y14 = torch.clamp((y + y_half) >> y_shift, -y_cap, y_cap)
            ey = y - (y14 << y_shift)
            y_hi = y14 >> 7
            y_lo = y14 - (y_hi << 7)
            extra = ((stmv(y_hi) * rat["eh_num"]) >> rat["eh_den"]) + (
                (stmv(y_lo) * rat["el_num"]) >> rat["el_den"])
            step = -(pre + g_pre + extra) + carry
            delta = torch.clamp((step + half) >> g_shift, -128, 127)
            carry = step - (delta << g_shift)
            x = advance(x, delta)
        # multiplier update at the inner solution, from the exact int32
        # violation (no y-quantization)
        t = t_of(smv(lanes_of(x)), lam)
        lam = torch.clamp(t - torch.clamp(t, lo, hi), -cap, cap)
    return x, lam


RATIONALS = ("hs_num", "hs_den", "cs_num", "cs_den", "eh_num", "eh_den",
             "el_num", "el_den")
"""The eight int32 rational names, in the order of the kernels' (8, B)
``sc`` plane."""


@dataclasses.dataclass(frozen=True)
class ConstrainedPGD:
    """Device ALM solver: outer multiplier updates around an error-feedback
    fixed-point PGD inner loop, integer end to end.

    Per inner iteration: the int8 matvecs ``lanes @ Hq^T`` (objective) and
    ``lanes @ Sq^T`` (constraints), the split penalty-gradient matvecs
    ``y_hi/y_lo @ Sq``, int32 rescales and the saturating packed-word
    update.  Bit-deterministic.

    ``fused``: ``None`` runs the whole loop as the K7 kernel on a CUDA
    device and the word-space loop on the CPU; ``True`` always takes the
    lane-space entry :func:`~pint_tpu_torch.mpc.fused_alm.
    alm_shared_fused_words` (K7 on CUDA, its plain version on the CPU);
    ``False`` always runs the word-space loop.  All three are
    bit-identical.  The int8 matvecs of the word-space loop run as exact
    float64 products."""

    qcqp: QuantizedConstrainedQP
    outer: int = 10
    inners: int = 40
    fused: Optional[bool] = None
    # keyword-only from here: the reference's next position is block_rows,
    # a TPU knob
    _: dataclasses.KW_ONLY
    device: object = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @property
    def _q(self) -> QuantizedQP:
        return self.qcqp.qqp

    @functools.cached_property
    def _ops(self) -> dict:
        """The shared operands on the device: int8 Hq/Sq (the kernel's),
        their float64 forms (the word-space matvecs) and the bounds."""
        q = self.qcqp
        dev = self.device
        Hq = torch.as_tensor(np.asarray(self._q.Hq, np.int8), device=dev)
        Sq = torch.as_tensor(np.asarray(q.Sq, np.int8), device=dev)
        return dict(
            Hq=Hq, Sq=Sq,
            HqT=Hq.to(torch.float64).T, Sd=Sq.to(torch.float64),
            lo=torch.as_tensor(np.asarray(q.lo_pre, np.int32), device=dev),
            hi=torch.as_tensor(np.asarray(q.hi_pre, np.int32), device=dev),
        )

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self._q.padded // 4), dtype=torch.int32, device=self.device
        )

    def init_lam(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self.qcqp.padded_rows), dtype=torch.int32, device=self.device
        )

    @property
    def _rationals(self) -> dict:
        q, qq = self.qcqp, self._q
        return dict(hs_num=qq.hs_num, hs_den=qq.hs_den, cs_num=q.cs_num,
                    cs_den=q.cs_den, eh_num=q.eh_num, eh_den=q.eh_den,
                    el_num=q.el_num, el_den=q.el_den)

    def _solve_words_xla(self, u_words, g_pre, c_off, lam):
        """The word-space loop (``pint_tpu``'s XLA route); the int8
        matvecs as exact float64 products."""
        o = self._ops
        return _alm_loop(
            u_words, g_pre, c_off, lam,
            hmv=lambda u: _f64_mv(u, o["HqT"]), smv=lambda u: _f64_mv(u, o["Sd"].T),
            stmv=lambda y: _f64_mv(y, o["Sd"]), rat=self._rationals,
            lo=o["lo"], hi=o["hi"], outer=self.outer, inners=self.inners,
            g_shift=self._q.g_shift, y_shift=self.qcqp.y_shift,
            space=_word_space(),
        )

    def solve_words(
        self,
        u_words: torch.Tensor,
        g_pre: torch.Tensor,
        c_off: torch.Tensor,
        lam0: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run ``outer`` multiplier updates x ``inners`` PGD steps.

        u_words (B, Tp/4) int32 words; g_pre (B, Tp) int32
        (``QuantizedQP.g_lane_fixed``); c_off (B, Cp) int32
        (``QuantizedConstrainedQP.c_off_pre``); lam0 (B, Cp) int32 optional
        multiplier warm start (lam/rho in c-pre units).  Returns
        (words, lam)."""
        from pint_tpu_torch.mpc.fused_alm import alm_shared_fused_words

        if lam0 is None:
            lam0 = torch.zeros_like(c_off)
        use_fused = (self.device.type == "cuda" if self.fused is None
                     else self.fused)
        if not use_fused:
            return self._solve_words_xla(u_words, g_pre, c_off, lam0)
        o = self._ops
        return alm_shared_fused_words(
            u_words, g_pre, c_off, lam0,
            Hq=o["Hq"], Sq=o["Sq"], lo_pre=o["lo"], hi_pre=o["hi"],
            outer=self.outer, inners=self.inners, g_shift=self._q.g_shift,
            y_shift=self.qcqp.y_shift, **self._rationals,
        )

    def solve(
        self, x0_phys: np.ndarray
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """End-to-end batched solve from the host: (words, U_phys (B, T)
        float32, lam_pre)."""
        x0 = np.atleast_2d(x0_phys)
        g_pre = torch.as_tensor(self._q.g_lane_fixed(x0), device=self.device)
        c_off = torch.as_tensor(self.qcqp.c_off_pre(x0), device=self.device)
        words, lam = self.solve_words(self.init_words(x0.shape[0]), g_pre, c_off)
        lanes = unpack_controls(words)[:, : self._q.horizon]
        return words, lanes.to(torch.float32) * float(np.float32(self._q.u_scale)), lam


def _mat_round(s_f: torch.Tensor, M: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """round(s_f @ M + ref) to int32 as the reference's jitted tick computes
    it on the CPU: XLA's dot over the state's n entries (n <= 6) rounds the
    first product to f32 and fuses each next one into the sum (an FMA), in
    index order; then ``+ ref`` in f32, round half to even, and a
    saturating conversion.  The FMA runs here in float64, where the product
    of two f32 values is exact, and rounds once to f32 (a second rounding
    can differ from a true FMA only when the f64 sum lands on an f32 tie:
    never in the parity tests).  The same float64 steps run on every
    device, so the card and the CPU agree bit for bit."""
    sd, Md = s_f.to(torch.float64), M.to(torch.float64)
    acc = (s_f[..., 0:1] * M[0]).to(torch.float64)
    for i in range(1, M.shape[0]):
        acc = (sd[..., i:i + 1] * Md[i] + acc).to(torch.float32).to(torch.float64)
    out = torch.round(acc.to(torch.float32) + ref).to(torch.float64)
    return torch.clamp(out, -(2.0**31), 2.0**31 - 1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ConstrainedController:
    """Receding-horizon closed loop with hard state constraints (the port of
    ``pint_tpu``'s ``ConstrainedController``).

    Each tick maps the fixed-point state to the QP's linear term and
    constraint offsets (f32 products, rounded), re-solves the ALM problem
    with :class:`ConstrainedPGD` (K7 on the card), applies the first
    control, steps the plant, and warm-starts the next tick by shifting the
    packed plan by ``inputs_per_step`` lanes and the multipliers by one
    time block of constraint rows.  The reference runs the loop as one
    ``lax.scan``; here it is a Python loop of ticks."""

    qcqp: QuantizedConstrainedQP
    plant_step: callable = dataclasses.field(repr=False)
    inputs_per_step: int = 1
    frac_bits: int = 16
    outer_per_tick: int = 3
    inners_per_outer: int = 15
    device: object = "cuda"

    def __post_init__(self):
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @functools.cached_property
    def _solver(self) -> ConstrainedPGD:
        return ConstrainedPGD(self.qcqp, outer=self.outer_per_tick,
                              inners=self.inners_per_outer, device=self.device)

    @functools.cached_property
    def _maps(self) -> dict:
        """The folded f32 maps state_fp -> g_pre (``g_mat``, ``g_ref``) and
        state_fp -> c_off_pre (``c_mat``, ``c_ref``), built in numpy as the
        reference builds them."""
        q, qq = self.qcqp, self.qcqp.qqp
        n = qq.qp.G.shape[1]
        G = np.zeros((n, qq.padded), np.float32)
        G[:, : qq.horizon] = (qq.qp.G * (qq.Gq_scale * 2.0**-self.frac_bits)).T.astype(
            np.float32)
        gr = np.zeros((qq.padded,), np.float32)
        gr[: qq.horizon] = (qq.qp.g_ref * qq.Gq_scale).astype(np.float32)
        Pm = np.zeros((q.scqp.P.shape[1], q.padded_rows), np.float32)
        Pm[:, : q.n_rows] = (q.scqp.P * (2.0**-self.frac_bits / q.c_unit)).T.astype(
            np.float32)
        cr = np.zeros((q.padded_rows,), np.float32)
        cr[: q.n_rows] = (q.scqp.r / q.c_unit).astype(np.float32)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in dict(g_mat=G, g_ref=gr, c_mat=Pm, c_ref=cr).items()}

    def tick(self, state_fp, u_words, lam):
        """One tick: (next state, shifted words, shifted multipliers, the
        applied lanes (..., inputs_per_step))."""
        mp = self._maps
        s_f = state_fp.to(torch.float32)
        g = _mat_round(s_f, mp["g_mat"], mp["g_ref"])
        c_off = _mat_round(s_f, mp["c_mat"], mp["c_ref"])
        u_words, lam = self._solver.solve_words(u_words, g, c_off, lam)
        lanes = unpack_controls(u_words)
        m = self.inputs_per_step
        u0 = lanes[..., :m]
        state2 = self.plant_step(state_fp, u0)
        shifted = torch.cat([lanes[..., m:], torch.zeros_like(lanes[..., :m])], dim=-1)
        # rows are time-major: one step's rows are n_rows / T of them, where
        # qqp.horizon is the decision length T * m
        rb = self.qcqp.n_rows * m // self.qcqp.qqp.horizon
        lam2 = torch.cat([lam[..., rb:], torch.zeros_like(lam[..., :rb])], dim=-1)
        return state2, pack_controls(shifted), lam2, u0

    def run(self, state0_fp, ticks: int):
        """Closed loop from state0_fp (B, n) int32: (states (B, ticks+1, n),
        applied control lanes (B, ticks, m))."""
        q = self.qcqp
        state = state0_fp.to(self.device)
        batch = state.shape[:-1]
        words = torch.zeros(batch + (q.qqp.padded // 4,), dtype=torch.int32,
                            device=self.device)
        lam = torch.zeros(batch + (q.padded_rows,), dtype=torch.int32, device=self.device)
        states, applied = [state], []
        for _ in range(ticks):
            state, words, lam, u0 = self.tick(state, words, lam)
            states.append(state)
            applied.append(u0)
        lanes = (torch.stack(applied, dim=-2) if applied
                 else torch.zeros(batch + (0, self.inputs_per_step), dtype=torch.int32,
                                  device=self.device))
        return torch.stack(states, dim=-2), lanes
