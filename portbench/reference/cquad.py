"""Plain reference of one state-constrained RTI tick of the planar
quadrotor (birotor) MPC.

The plant, written from its equations: six states (x, y, theta, vx, vy,
omega; theta in turns), two rotor thrusts taken about hover,
f_i = hover + u_i, with mass 1 and the model's parabolic sine s (cosine
c(theta) = s(theta + 1/4))::

    ax = -(f1 + f2) s(theta),  ay = (f1 + f2) c(theta) - g,
    domega = (f2 - f1) 2**-torque_shift

by explicit Euler at dt = 2**-dt_shift.  One tick linearizes around the
warm plan, condenses the horizon in the direct form
``H = sum_k Bbar_k^T Q Bbar_k + Bbar_T^T (Qf - Q) Bbar_T + R``, stacks the
state rows ``lo <= F x_k <= hi`` (k = 1..T), and runs the constrained tick
of :mod:`portbench.reference.crti` (power iterations, int8 quantization,
``alm_outer`` x ``pgd_iters`` fixed-point ALM steps in exact integers).

Plain PyTorch in float32 for the dynamics, the condensation and the rows;
it imports nothing of the program under test, and the caller sets TF32 off
(:func:`portbench.compare.set_precision`).

Departures from the published method (RTI of Diehl, Bock & Schloeder 2005,
an SQP iteration a tick on the exact Jacobians):

- the plant's trigonometry is the model's parabolic sine (quarter turns
  exact, within 5.6% of sin(2 pi theta)) and its Jacobian that parabola's
  slope, as the program's plant has it;
- the QP is solved on int8 plan lanes by a fixed number of projected
  gradient steps, its Hessian and constraint rows quantized to int8, and
  the constraints by an augmented Lagrangian of ``alm_outer`` rounds with
  the multipliers in fixed point, as :mod:`portbench.reference.crti`
  describes; the plan and multipliers are warm-started from the previous
  tick's, shifted one step;
- gravity is 9.8125 m/s^2, the model's value exact in Q16.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.crti import (
    C_BITS, CX0_CAP, INV_127, LAM_CAP, SENTINEL, Y_SHIFT, alm, f32_to_i32, pack, power_lip,
    quantize, rational, step_terms, unpack)
from portbench.reference.rti import dsin_turns, propagate, sin_turns

GRAVITY = 9.8125


def constants(p: dict):
    """(dt, hover thrust a rotor, 2**-torque_shift, lane scale) of the
    configuration's model group, in float64: the hover thrust is half of g
    in Q``frac_bits`` (rounded down), a lane 2**(f_shift - frac_bits) N."""
    fb = p["frac_bits"]
    hover = (int(round(GRAVITY * 2.0**fb)) // 2) * 2.0**-fb
    return 2.0 ** -p["dt_shift"], hover, 2.0 ** -p["torque_shift"], 2.0 ** (p["f_shift"] - fb)


def linearize(x0: torch.Tensor, u: torch.Tensor, p: dict):
    """Roll the f32 model out from x0 (N, 6) under the thrust deltas u (N,
    T, 2) and return the Jacobians A (N, T, 6, 6), B (N, T, 6, 2) along it
    and the offsets c (N, T, 6) with x_{k+1} = A x_k + B u_k + c."""
    dt, hover, kq, _ = (float(np.float32(v)) for v in constants(p))
    g = float(np.float32(GRAVITY))
    st = x0
    traj = [x0]
    for k in range(u.shape[1]):
        x, y, th, vx, vy, om = st.unbind(-1)
        f = 2.0 * hover + u[:, k, 0] + u[:, k, 1]
        ax = -f * sin_turns(th)
        ay = f * sin_turns(th + 0.25) - g
        dom = (u[:, k, 1] - u[:, k, 0]) * kq
        st = torch.stack([x + vx * dt, y + vy * dt, th + om * dt,
                          vx + ax * dt, vy + ay * dt, om + dom * dt], -1)
        traj.append(st)
    traj = torch.stack(traj, 1)                                   # (N, T+1, 6)
    xs, th = traj[:, :-1], traj[:, :-1, 2]
    f = 2.0 * hover + u[..., 0] + u[..., 1]
    N, T = th.shape
    A = torch.eye(6, dtype=x0.dtype, device=x0.device).repeat(N, T, 1, 1)
    A[..., 0, 3] = A[..., 1, 4] = A[..., 2, 5] = dt
    A[..., 3, 2] = -dt * f * dsin_turns(th)
    A[..., 4, 2] = dt * f * dsin_turns(th + 0.25)
    B = torch.zeros((N, T, 6, 2), dtype=x0.dtype, device=x0.device)
    B[..., 3, :] = (-dt * sin_turns(th))[..., None]
    B[..., 4, :] = (dt * sin_turns(th + 0.25))[..., None]
    B[..., 5, 0], B[..., 5, 1] = -dt * kq, dt * kq
    c = traj[:, 1:] - (A @ xs[..., None])[..., 0] - (B @ u[..., None])[..., 0]
    return A, B, c


class QuadProblem:
    """The constants of one configuration on one device: the cost Q, Qf, R
    (lane units), the goal, the lane scales, the solver's sizes, the state
    rows F (Cs, 6), the bounds, the penalty and the padded row count: the
    members :func:`portbench.reference.crti.alm` and the step read."""

    def __init__(self, p: dict, device):
        self.p = p
        self.T = int(p["horizon"])
        self.m = 2
        self.Tm = self.T * self.m
        lane = constants(p)[3]
        s = np.array([lane, lane])
        self.lane_scales = s
        Q = np.diag(p["Q_diag"]).astype(np.float64)
        R_lane = s[:, None] * np.diag(p["R_diag"]).astype(np.float64) * s[None, :]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.s = f32(s)
        self.Q = f32(Q)
        self.dQ = f32(p["qf_scale"] * Q - Q)
        self.R_kron = f32(np.kron(np.eye(self.T), R_lane))
        self.x_ref = f32(np.asarray(p["x_ref"], np.float64))
        self.pgd_iters = int(p["pgd_iters"])
        self.power_iters = int(p["power_iters"])
        self.g_shift = int(p["g_shift"])
        self.F = f32(p["F"])
        self.Cs = self.F.shape[0]
        self.C = self.Cs * self.T
        self.Cp = -(-self.C // p["row_pad"]) * p["row_pad"]
        lo = np.tile(np.broadcast_to(np.asarray(p["lo"], float), (self.Cs,)), self.T)
        hi = np.tile(np.broadcast_to(np.asarray(p["hi"], float), (self.Cs,)), self.T)
        self.lo, self.hi = f32(lo), f32(hi)
        self.b_amp = float(np.float32(max(np.abs(lo).max(), np.abs(hi).max())))
        self.rho = float(np.float32(p["rho"]))
        self.alm_outer = int(p["alm_outer"])
        self.device = device


def condense(pr: QuadProblem, x0: torch.Tensor, lanes: torch.Tensor):
    """Linearize around the plan and condense the horizon: the QP
    0.5 U^T H U + g^T U in lanes, H (N, Tm, Tm) and g (N, Tm), with the
    stacks (Abar, Bbar, Cbar) the state rows need."""
    N = x0.shape[0]
    u = lanes.reshape(N, pr.T, pr.m).to(torch.float32) * pr.s
    A, B, c = linearize(x0, u, pr.p)
    Abar, Bbar, Cbar = propagate(A, B * pr.s, c)
    BT, AT = Bbar[:, -1], Abar[:, -1]
    Cx = Cbar - pr.x_ref
    H = torch.einsum("nkiu,ij,nkjv->nuv", Bbar, pr.Q, Bbar)
    H = H + torch.einsum("niu,ij,njv->nuv", BT, pr.dQ, BT) + pr.R_kron
    G = torch.einsum("nkiu,ij,nkjq->nuq", Bbar, pr.Q, Abar)
    G = G + torch.einsum("niu,ij,njq->nuq", BT, pr.dQ, AT)
    g_ref = torch.einsum("nkiu,ij,nkj->nu", Bbar, pr.Q, Cx)
    g_ref = g_ref + torch.einsum("niu,ij,nj->nu", BT, pr.dQ, Cx[:, -1])
    g = torch.einsum("nuq,nq->nu", G, x0) + g_ref
    return H, g, (Abar, Bbar, Cbar)


def cquad_step(pr: QuadProblem, x0: torch.Tensor, words: torch.Tensor, lam: torch.Tensor):
    """One tick's constrained SQP iteration: states x0 (N, 6) f32, warm words
    (N, Tm/4) and multipliers (N, Cp) -> (words, multipliers), as
    :func:`portbench.reference.crti.crti_step` makes it for the unicycle."""
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
