"""Plain reference of one real-time-iteration tick of the unicycle MPC.

One RTI tick re-optimizes a batch of warm-started plans for the states the
fleet reports: one SQP iteration (roll the plan out, linearize, condense
the horizon into a dense QP, estimate its Lipschitz constant, quantize it
to int8 and run a fixed-point projected-gradient inner with error
feedback), then the plan is shifted one step for the next tick.

Written from the method, in plain PyTorch, with no kernel, cache or
batching trick: float32 for the condensation, exact integers (float64
products of int8 values) for the inner.  The condensation uses the direct
form ``H = sum_k Bbar_k^T Q_k Bbar_k + R``; the Lipschitz estimate is a
plain power iteration.  It imports nothing of the program under test; the
caller sets TF32 off (:func:`portbench.compare.set_precision`).
"""

from __future__ import annotations

import numpy as np
import torch

LANES_PER_WORD = 4
F32_105 = float(np.float32(1.05))
INV_127 = float(np.float32(1.0 / 127.0))


# -- packed plans: four int8 lanes a little-endian int32 word --------------------


def unpack(words: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words -> (N, 4W) int32 lanes, lane k of word j is plan
    entry 4j + k, sign-extended from its byte."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(LANES_PER_WORD, device=words.device, dtype=torch.int64) * 8
    b = (w[..., None] >> shifts) & 0xFF
    lanes = (b ^ 0x80) - 0x80
    return lanes.reshape(*words.shape[:-1], -1).to(torch.int32)


def pack(lanes: torch.Tensor) -> torch.Tensor:
    """(N, 4W) lanes in [-128, 127] -> (N, W) int32 words."""
    b = lanes.to(torch.int64).reshape(*lanes.shape[:-1], -1, LANES_PER_WORD) & 0xFF
    shifts = torch.arange(LANES_PER_WORD, device=lanes.device, dtype=torch.int64) * 8
    w = (b << shifts).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def shift_plan(words: torch.Tensor, m: int) -> torch.Tensor:
    """The warm start of the next tick: the plan one step (m lanes) earlier,
    zeros in the last step."""
    lanes = unpack(words)
    nxt = torch.cat([lanes[:, m:], torch.zeros_like(lanes[:, :m])], dim=1)
    return pack(nxt)


# -- the unicycle (quadratic trigonometry, angles in turns) ----------------------


def sin_turns(t):
    """The model's parabolic sine of an angle in turns, of a torch tensor
    or a numpy array (the plant's float64): 16 h (1/2 - h) on each half
    turn h, negated on the second (an exact negation)."""
    floor = torch.floor if isinstance(t, torch.Tensor) else np.floor
    t = t - floor(t)
    second = t >= 0.5
    half = t - 0.5 * second
    val = 16.0 * half * (0.5 - half)
    return val - 2.0 * val * second


def dsin_turns(t: torch.Tensor) -> torch.Tensor:
    """Its derivative in turns."""
    t = torch.remainder(t, 1.0)
    half = torch.remainder(t, 0.5)
    dval = 16.0 * (0.5 - 2.0 * half)
    return torch.where(t >= 0.5, -dval, dval)


def linearize(x0: torch.Tensor, u: torch.Tensor, dt: float):
    """Roll the f32 model out from x0 (N, 3) under u (N, T, 2) and return
    the Jacobians A (N, T, 3, 3), B (N, T, 3, 2) along it and the offsets
    c (N, T, 3) with x_{k+1} = A x_k + B u_k + c."""
    x, y, th = x0[:, 0], x0[:, 1], x0[:, 2]
    traj = [x0]
    for k in range(u.shape[1]):
        v, w = u[:, k, 0], u[:, k, 1]
        x = x + v * sin_turns(th + 0.25) * dt
        y = y + v * sin_turns(th) * dt
        th = th + w * dt
        traj.append(torch.stack([x, y, th], dim=-1))
    traj = torch.stack(traj, dim=1)                            # (N, T+1, 3)
    xs, th = traj[:, :-1], traj[:, :-1, 2]
    v = u[..., 0]
    z, one = torch.zeros_like(th), torch.ones_like(th)
    A = torch.stack([
        torch.stack([one, z, v * dsin_turns(th + 0.25) * dt], -1),
        torch.stack([z, one, v * dsin_turns(th) * dt], -1),
        torch.stack([z, z, one], -1)], -2)
    B = torch.stack([
        torch.stack([sin_turns(th + 0.25) * dt, z], -1),
        torch.stack([sin_turns(th) * dt, z], -1),
        torch.stack([z, torch.full_like(th, dt)], -1)], -2)
    c = traj[:, 1:] - (A @ xs[..., None])[..., 0] - (B @ u[..., None])[..., 0]
    return A, B, c


def propagate(A, B_lane, c):
    """x_k = Abar_k x0 + Bbar_k U + Cbar_k for k = 1..T: the stacks
    Abar (N, T, n, n), Bbar (N, T, n, Tm), Cbar (N, T, n)."""
    N, T, n, m = B_lane.shape
    P = torch.eye(n, dtype=A.dtype, device=A.device).expand(N, n, n)
    S = torch.zeros((N, n, T * m), dtype=A.dtype, device=A.device)
    r = torch.zeros((N, n), dtype=A.dtype, device=A.device)
    Ps, Ss, rs = [], [], []
    for k in range(T):
        P = A[:, k] @ P
        S = A[:, k] @ S
        S[:, :, k * m:(k + 1) * m] += B_lane[:, k]
        r = (A[:, k] @ r[..., None])[..., 0] + c[:, k]
        Ps.append(P)
        Ss.append(S)
        rs.append(r)
    return torch.stack(Ps, 1), torch.stack(Ss, 1), torch.stack(rs, 1)


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and saturate to int32; NaN to 0."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return torch.clamp(torch.round(x), -(2.0**31), 2.0**31 - 1).to(torch.int32)


def rational(val, acc_max: int, budget: int):
    """int32 num / 2**den ~ val (N,), num no larger than budget // acc_max
    so that num times an accumulator of acc_max stays inside budget."""
    num_max = float(np.float32(budget // acc_max))
    den = torch.clamp(torch.floor(torch.log2(torch.div(
        torch.full_like(val, num_max), val))), 0, 31)
    den = f32_to_i32(den)
    return f32_to_i32(val * torch.exp2(den.to(torch.float32))), den


class Problem:
    """The constants of one configuration on one device: the cost Q, Qf, R
    (lane units), the goal, the lane scales and the solver's sizes."""

    def __init__(self, p: dict, device):
        self.T = int(p["horizon"])
        self.m = 2
        self.Tm = self.T * self.m
        self.dt = float(np.float32(2.0 ** -p["dt_shift"]))
        s = np.array([2.0 ** (p["v_shift"] - p["frac_bits"]),
                      2.0 ** (p["w_shift"] - p["frac_bits"])])
        self.lane_scales = s
        Q = np.diag(p["Q_diag"]).astype(np.float64)
        R = np.diag(p["R_diag"]).astype(np.float64)
        Qf = p["qf_scale"] * Q
        R_lane = s[:, None] * R * s[None, :]

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        self.s = f32(s)
        self.Q = f32(Q)
        self.dQ = f32(Qf - Q)
        self.R_kron = f32(np.kron(np.eye(self.T), R_lane))
        self.x_ref = f32(np.asarray(p["x_ref"], np.float64))
        self.pgd_iters = int(p["pgd_iters"])
        self.power_iters = int(p["power_iters"])
        self.g_shift = int(p["g_shift"])
        self.device = device


def condense(pr: Problem, x0: torch.Tensor, lanes: torch.Tensor):
    """Linearize around the plan and condense the horizon: the QP
    0.5 U^T H U + g^T U in lanes, H (N, Tm, Tm) and g (N, Tm), with the
    stacks (Abar, Bbar, Cbar) the state constraints need."""
    N = x0.shape[0]
    u = lanes.reshape(N, pr.T, pr.m).to(torch.float32) * pr.s
    A, B, c = linearize(x0, u, pr.dt)
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


def power_lip(M: torch.Tensor, iters: int) -> torch.Tensor:
    """1.05 times the power-iteration estimate of the largest eigenvalue of
    the symmetric PSD matrices M (N, d, d)."""
    N, d, _ = M.shape
    v = torch.full((N, d, 1), float(np.float32(1.0 / np.sqrt(d))),
                   dtype=torch.float32, device=M.device)
    for _ in range(iters):
        w = M @ v
        v = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-30)
    return (v * (M @ v)).sum((1, 2)) * F32_105


def quantize(M: torch.Tensor):
    """int8 matrices q(M) = clip(round(127 M / max|M|)) and max|M| (N,)."""
    m_max = torch.amax(torch.abs(M), dim=(1, 2))
    scale = torch.div(torch.full_like(m_max, 127.0), torch.clamp_min(m_max, 1e-30))
    q = torch.clamp(torch.round(M * scale[:, None, None]), -127, 127)
    return torch.where(q.isnan(), 0.0, q).to(torch.int8), m_max


def step_terms(pr: Problem, g, alpha, h_max):
    """The inner's integer terms: the linear term g_pre = g alpha 2**g_shift
    (int32, saturated) and the step rational hs_num / 2**hs_den ~
    alpha h_max / 127 * 2**g_shift."""
    gs = torch.nan_to_num(g * (alpha * float(2.0**pr.g_shift))[:, None], nan=0.0,
                          posinf=2.0**31 - 1, neginf=-(2.0**31))
    g_pre = f32_to_i32(gs)
    hs_num, hs_den = rational(alpha * h_max * INV_127 * float(2.0**pr.g_shift),
                              127 * 127 * pr.Tm, 2**31 - 1)
    return g_pre, hs_num, hs_den


def matvec(Mq: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """Exact int8 products: (Mq^T lanes) as int32, through float64."""
    return torch.einsum("nkj,nk->nj", Mq.to(torch.float64),
                        lanes.to(torch.float64)).to(torch.int32)


def pgd(pr: Problem, lanes, g_pre, Hq, hs_num, hs_den):
    """The fixed-point projected-gradient inner on int8 lanes with error
    feedback: each step u <- clip(u - round(alpha (H u + g)), +-127), the
    step carried in 2**-g_shift units of a lane."""
    half = 1 << (pr.g_shift - 1)
    num, den = hs_num[:, None], hs_den[:, None]
    carry = torch.zeros_like(g_pre)
    for _ in range(pr.pgd_iters):
        pre = (matvec(Hq, lanes) * num) >> den
        step = -(pre + g_pre) + carry
        delta = torch.clamp((step + half) >> pr.g_shift, -128, 127)
        carry = step - (delta << pr.g_shift)
        lanes = torch.clamp(lanes + delta, -127, 127)
    return lanes


def rti_step(pr: Problem, x0: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """One tick's SQP iteration: states x0 (N, 3) f32 and warm words (N,
    Tm/4) -> the re-optimized plan's words."""
    lanes = unpack(words)
    H, g, _ = condense(pr, x0, lanes)
    lip = power_lip(H, pr.power_iters)
    Hq, h_max = quantize(H)
    alpha = torch.div(torch.ones_like(lip), lip)
    g_pre, hs_num, hs_den = step_terms(pr, g, alpha, h_max)
    return pack(pgd(pr, lanes, g_pre, Hq, hs_num, hs_den))
