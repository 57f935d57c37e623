"""Plain reference of one state-constrained RTI tick of the unicycle MPC.

The tick of :mod:`portbench.reference.rti` with hard per-step state bounds
``lo <= F x_k <= hi`` (k = 1..T) on the linearized trajectory, solved by an
augmented Lagrangian method in fixed point: the constraint rows
S = F Bbar are quantized to int8 beside the Hessian, the step covers the
penalty's curvature (Lipschitz constant lip(H) + rho lip(S^T S)), and
``alm_outer`` rounds of ``pgd_iters`` projected-gradient steps each end in
a multiplier update.  Multipliers live in "c-pre" units, fixed-point
constraint units whose scale c_unit each problem sets from its rows and
bounds.  The plan and the multipliers are shifted one step for the next
tick.

Plain PyTorch, float32 for the condensation and the constraint rows,
exact int32 arithmetic (wrapping as two's complement) for the inner.  It
imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.rti import (  # noqa: F401  (shift_plan: the plan's shift)
    INV_127, Problem, condense, f32_to_i32, matvec, pack, power_lip, quantize,
    rational, shift_plan, step_terms, unpack)

C_BITS = 20                     # c-pre units: 2**C_BITS span the rows' reach
LAM_CAP = 1 << 22               # |multiplier| cap in c-pre units
CX0_CAP = 1 << 22               # cap of the state-dependent offset rows
Y_BITS = 13                     # the violation is split into two int8 planes
T_AMP = float(1 << (C_BITS - 1)) + float(CX0_CAP) + float(LAM_CAP)
Y_SHIFT = max(0, int(np.ceil(np.log2(T_AMP * 2.0))) - Y_BITS)
SENTINEL = 1 << 30              # the bound of a padding row


class ConstrainedProblem(Problem):
    """:class:`Problem` with the state rows F (Cs, 3), the bounds, the
    penalty rho, the ALM rounds and the padded row count."""

    def __init__(self, p: dict, device):
        super().__init__(p, device)
        self.F = torch.as_tensor(np.asarray(p["F"], np.float32), device=device)
        self.Cs = self.F.shape[0]
        self.C = self.Cs * self.T
        self.Cp = -(-self.C // p["row_pad"]) * p["row_pad"]
        lo = np.tile(np.broadcast_to(np.asarray(p["lo"], float), (self.Cs,)), self.T)
        hi = np.tile(np.broadcast_to(np.asarray(p["hi"], float), (self.Cs,)), self.T)
        self.lo = torch.as_tensor(lo.astype(np.float32), device=device)
        self.hi = torch.as_tensor(hi.astype(np.float32), device=device)
        self.b_amp = float(np.float32(max(np.abs(lo).max(), np.abs(hi).max())))
        self.rho = float(np.float32(p["rho"]))
        self.alm_outer = int(p["alm_outer"])


def shift_lam(pr: ConstrainedProblem, lam: torch.Tensor) -> torch.Tensor:
    """The next tick's multipliers: rows are time-major, so drop step 1's
    Cs rows, append Cs zero rows for the new last step, keep the padding."""
    Cs, C = pr.Cs, pr.C
    return torch.cat([lam[:, Cs:C], torch.zeros_like(lam[:, :Cs]), lam[:, C:]], dim=1)


def alm(pr: ConstrainedProblem, lanes, lam, g_pre, Hq, Sq, c_off, lo, hi, r):
    """``alm_outer`` x ``pgd_iters`` fixed-point ALM steps.  The gradient
    adds rho S^T y with y = t - clip(t, lo, hi) the violation of the rows
    t = S u + c_off + lam (c-pre units); y is rounded to 14 bits with error
    feedback and applied as two int8 planes.  Each outer round ends in
    lam <- clip(t - clip(t, lo, hi), +-LAM_CAP)."""
    half = 1 << (pr.g_shift - 1)
    y_half = (1 << Y_SHIFT) >> 1
    y_cap = (1 << Y_BITS) - 1
    carry = torch.zeros_like(g_pre)
    ey = torch.zeros_like(c_off)
    St = Sq.transpose(1, 2)                         # (N, Tm, Cp): S u = St^T u

    def rows(u, lam):
        return ((matvec(St, u) * r["cs_num"]) >> r["cs_den"]) + c_off + lam

    for _ in range(pr.alm_outer):
        for _ in range(pr.pgd_iters):
            pre = (matvec(Hq, lanes) * r["hs_num"]) >> r["hs_den"]
            t = rows(lanes, lam)
            y = t - torch.clamp(t, lo, hi) + ey
            y14 = torch.clamp((y + y_half) >> Y_SHIFT, -y_cap, y_cap)
            ey = y - (y14 << Y_SHIFT)
            y_hi = y14 >> 7
            y_lo = y14 - (y_hi << 7)
            extra = (((matvec(Sq, y_hi) * r["eh_num"]) >> r["eh_den"])
                     + ((matvec(Sq, y_lo) * r["el_num"]) >> r["el_den"]))
            step = -(pre + g_pre + extra) + carry
            delta = torch.clamp((step + half) >> pr.g_shift, -128, 127)
            carry = step - (delta << pr.g_shift)
            lanes = torch.clamp(lanes + delta, -127, 127)
        t = rows(lanes, lam)
        lam = torch.clamp(t - torch.clamp(t, lo, hi), -LAM_CAP, LAM_CAP)
    return lanes, lam


def crti_step(pr: ConstrainedProblem, x0: torch.Tensor, words: torch.Tensor,
              lam: torch.Tensor):
    """One tick's constrained SQP iteration: states x0 (N, 3) f32, warm words
    (N, Tm/4) and multipliers (N, Cp) -> (words, multipliers)."""
    N, Tm, C, Cp = x0.shape[0], pr.Tm, pr.C, pr.Cp
    lanes = unpack(words)
    H, g, (Abar, Bbar, Cbar) = condense(pr, x0, lanes)
    S = torch.einsum("ci,nkiu->nkcu", pr.F, Bbar).reshape(N, C, Tm)
    P = torch.einsum("ci,nkiq->nkcq", pr.F, Abar).reshape(N, C, -1)
    rr = torch.einsum("ci,nki->nkc", pr.F, Cbar).reshape(N, C)

    lip = power_lip(H, pr.power_iters)
    pen_lip = power_lip(S.transpose(1, 2) @ S, pr.power_iters)
    alpha = torch.div(torch.ones_like(lip), lip + pr.rho * pen_lip)
    Hq, h_max = quantize(H)
    g_pre, hs_num, hs_den = step_terms(pr, g, alpha, h_max)

    Sq, s_max = quantize(S)
    s_scale = s_max * INV_127
    row_amp = 127.0 * torch.amax(torch.abs(S).sum(2), dim=1)
    c_unit = torch.div(2.0 * (row_amp + pr.b_amp),
                       torch.full_like(row_amp, float(1 << C_BITS)))
    cs_num, cs_den = rational(torch.div(s_scale, c_unit), 127 * 127 * Tm, 2**31 - 1)
    base = (pr.rho * s_scale * float(1 << Y_SHIFT) * c_unit * alpha
            ) * float(1 << pr.g_shift)
    eh_num, eh_den = rational(base * 128.0, 64 * 127 * Cp, 2**30 - 1)
    el_num, el_den = rational(base, 127 * 127 * Cp, 2**30 - 1)

    def padded(x, fill=0):
        return torch.nn.functional.pad(x, (0, Cp - C), value=fill)

    def bound(b, fill):
        q = torch.round(torch.div(b[None, :], c_unit[:, None]))
        return padded(f32_to_i32(torch.clamp(q, -SENTINEL, SENTINEL)), fill)

    off = torch.einsum("nq,ncq->nc", x0, P) + rr
    off = torch.nan_to_num(torch.div(off, c_unit[:, None]), nan=0.0,
                           posinf=CX0_CAP, neginf=-CX0_CAP)
    c_off = padded(f32_to_i32(torch.clamp(torch.round(off), -CX0_CAP, CX0_CAP)))
    Sq = torch.nn.functional.pad(Sq, (0, 0, 0, Cp - C))      # (N, Cp, Tm)
    r = {k: v[:, None] for k, v in dict(
        hs_num=hs_num, hs_den=hs_den, cs_num=cs_num, cs_den=cs_den, eh_num=eh_num,
        eh_den=eh_den, el_num=el_num, el_den=el_den).items()}
    lam = torch.clamp(lam, -LAM_CAP, LAM_CAP)
    lanes, lam = alm(pr, lanes, lam, g_pre, Hq, Sq, c_off,
                     bound(pr.lo, -SENTINEL), bound(pr.hi, SENTINEL), r)
    return pack(lanes), lam
