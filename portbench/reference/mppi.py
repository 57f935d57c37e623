"""Plain reference of one tick of sampling-based MPC (MPPI) of the unicycle.

Model predictive path-integral control (Williams, Drews, Goldfain, Rehg &
Theodorou, ICRA 2016) over packed int8 plans: a tick refines every plant's
plan by ``updates_per_tick`` updates, each on K perturbation plans handed
to it (int8 lanes, the noise the program drew):

1. candidate lanes = clamp(plan + noise, -128, 127), lane by lane: an int8
   add that saturates, which keeps every candidate inside the control box;
2. roll each candidate through the unicycle's fixed-point map from the
   plant's state (:func:`q16_step`);
3. score each trajectory in float32 (:func:`costs`): the squared distance
   of (x, y) to the goal summed over steps 1..T, 20 times that of the last
   state, and 1e-4 times the squared lanes;
4. weight the candidates by softmax(-(c - min c) / (temperature (median c
   - min c + 1e-6))), the median the mean of the two middle costs;
5. new plan = clamp(round(the weighted mean of the candidate lanes), -127,
   127).

Written from the method, in plain PyTorch: int32 lanes lane by lane (not
packed words), float32 for the score, the weighted mean as a batched
matrix product (:func:`weighted_mean`, which TF32 reaches where PyTorch
allows it).  It imports nothing of the program under test; the caller sets
TF32 off (:func:`portbench.compare.set_precision`).

A plant's first tick, and its tick after a reset, samples from the
cold-row table (:func:`cold_table`), which the configuration's
``noise_seed`` alone fixes.  Every other tick's noise is a fresh draw,
which the reference cannot rebuild (the program draws it on the card);
:func:`fresh_rows` says which rows' noise can be one.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.rti import pack, unpack

LANE_MIN, LANE_MAX = -128, 127       # an int8 lane
PLAN_MAX = 127                       # the plan's box, symmetric


class MPPIProblem:
    """The constants of one configuration on one device."""

    def __init__(self, p: dict, device):
        self.T = int(p["horizon"])
        self.L = 2 * self.T                  # lanes a plan: (v, w) a step
        self.K = int(p["samples"])
        self.U = int(p["updates_per_tick"])
        self.noise_lanes = int(p["noise_lanes"])
        self.temperature = float(p["temperature"])
        self.noise_seed = int(p["noise_seed"])
        self.frac_bits = int(p["frac_bits"])
        self.dt_shift = int(p["dt_shift"])
        self.v_shift = int(p["v_shift"])
        self.w_shift = int(p["w_shift"])
        self.lane_scales = np.array([2.0 ** (self.v_shift - self.frac_bits),
                                     2.0 ** (self.w_shift - self.frac_bits)])
        self.goal = torch.tensor(p["goal"], dtype=torch.float32, device=device)
        self.q = torch.tensor([2.0 ** self.frac_bits] * 2 + [2.0 ** 16],
                              dtype=torch.float32, device=device)
        self.table = cold_table(self).to(device)
        self.device = device


def cold_table(pr: MPPIProblem) -> torch.Tensor:
    """(U, K, L) int8: the noise of a cold plant's updates.  Update u's
    draw is the u-th of a float32 standard normal (1, K, L) from a CPU
    ``torch.Generator`` seeded by ``noise_seed``, times ``noise_lanes``,
    rounded half to even and clipped to [-127, 127]."""
    gen = torch.Generator().manual_seed(pr.noise_seed)
    out = []
    for _ in range(pr.U):
        z = torch.randn((1, pr.K, pr.L), generator=gen, dtype=torch.float32)
        out.append(torch.clamp(torch.round(z * pr.noise_lanes), -127, 127)[0])
    return torch.stack(out).to(torch.int8)


FRESH_SIGMAS = 7.0     # a slab's mean and spread: standard errors allowed


def fresh_rows(pr: MPPIProblem, words: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the rows whose noise (N, U, K, L) int8 can be a fresh
    draw of the rule :func:`cold_table` states.  A row is cold, and passes,
    where its words are zero and its noise is the cold-row table.  Each
    (K, L) slab of any other row must:

    - lie in [-127, 127];
    - have a mean within :data:`FRESH_SIGMAS` standard errors of 0, and a
      standard deviation within as many of its own standard errors of
      that of a rounded ``noise_lanes`` z, sqrt(noise_lanes**2 + 1/12);
    - be no other slab of the call, nor one of the table's: not the
      row's other update's, not another plant's, and not the row's of
      another tick handed in with it (the check hands in both ticks of a
      carried pair in one call).

    So noise that is zero, of the wrong spread, shared between plants,
    left over from the tick before, or the table again on a warm row is
    no draw."""
    N, U = noise.shape[:2]
    slabs = noise.reshape(N, U, -1)
    n = slabs.shape[-1]
    cold = (words == 0).all(1) & (noise == pr.table.to(noise.device)).flatten(1).all(1)
    s1 = slabs.sum(-1, dtype=torch.int64).to(torch.float64)
    s2 = (slabs.to(torch.int32) ** 2).sum(-1, dtype=torch.int64).to(torch.float64)
    mean = s1 / n
    std = (s2 / n - mean**2).clamp_min(0).sqrt()
    sd = (pr.noise_lanes**2 + 1.0 / 12.0) ** 0.5
    ok = ((slabs.amin(-1) >= -PLAN_MAX)
          & (mean.abs() <= FRESH_SIGMAS * sd / n**0.5)
          & ((std - sd).abs() <= FRESH_SIGMAS * sd / (2.0 * n) ** 0.5)).all(1)
    warm = slabs[~cold].reshape(-1, n)
    both = torch.cat([pr.table.to(noise.device).reshape(U, n), warm])
    _, inv, counts = torch.unique(both, dim=0, return_inverse=True, return_counts=True)
    alone = torch.ones(N, dtype=torch.bool, device=noise.device)
    alone[~cold] = (counts[inv[U:]] == 1).reshape(-1, U).all(1)
    return cold | (ok & alone)


def to_fixed(pr: MPPIProblem, x0: torch.Tensor) -> torch.Tensor:
    """(N, 3) float32 states -> int32: x, y in Q``frac_bits``, theta in Q16
    turns, rounded half to even."""
    return torch.round(x0 * pr.q).to(torch.int32)


def sin_q14(t16: torch.Tensor) -> torch.Tensor:
    """The model's parabolic sine of an int32 angle in Q16 turns, in Q14:
    16 h (1/2 - h) on each half turn h, negated on the second."""
    t = t16 & 0xFFFF
    half = t & 0x7FFF
    val = (half * (0x8000 - half)) >> 14
    second = ((t >> 15) & 1) == 1
    return torch.where(second, -val, val)


def q16_step(pr: MPPIProblem, x, y, th, v, w):
    """One step of the unicycle's fixed-point map on int32 tensors, the
    lanes v, w as int32:

        x' = x + (((v << v_shift) >> 2) cos(th) >> 12) >> dt_shift
        y' = y + (((v << v_shift) >> 2) sin(th) >> 12) >> dt_shift
        th' = th + (w << w_shift) >> dt_shift

    with cos(th) = sin(th + 1/4 turn), both in Q14; every shift arithmetic,
    every sum wrapping in int32."""
    vq = (v << pr.v_shift) >> 2
    cos = sin_q14(th + (1 << 14))
    sin = sin_q14(th)
    x = x + (((vq * cos) >> 12) >> pr.dt_shift)
    y = y + (((vq * sin) >> 12) >> pr.dt_shift)
    th = th + ((w << pr.w_shift) >> pr.dt_shift)
    return x, y, th


def saturating_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 lanes held as int32: a + b clamped to the int8 range."""
    return torch.clamp(a + b, LANE_MIN, LANE_MAX)


def rollout(pr: MPPIProblem, state: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """States (N, 3) int32 and candidate lanes (N, K, L) int32 -> the
    trajectories (N, K, T+1, 3)."""
    N, K = lanes.shape[:2]
    x, y, th = (state[:, i, None].expand(N, K) for i in range(3))
    out = [torch.stack([x, y, th], dim=-1)]
    for k in range(pr.T):
        x, y, th = q16_step(pr, x, y, th, lanes[..., 2 * k], lanes[..., 2 * k + 1])
        out.append(torch.stack([x, y, th], dim=-1))
    return torch.stack(out, dim=-2)


def costs(pr: MPPIProblem, states: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """Trajectories (..., T+1, 3) int32 and their lanes (..., L) -> (...)
    float32 costs."""
    xy = states[..., :2].to(torch.float32) * float(np.float32(2.0 ** -pr.frac_bits))
    d2 = ((xy - pr.goal) ** 2).sum(-1)
    run = d2[..., 1:].sum(-1)
    term = 20.0 * d2[..., -1]
    effort = 1e-4 * (lanes.to(torch.float32) ** 2).sum(-1)
    return run + term + effort


def weights(pr: MPPIProblem, c: torch.Tensor) -> torch.Tensor:
    """(N, K) costs -> (N, K) softmax weights, the temperature in units of
    (median - min); the median of an even K the mean of its two middles."""
    mu = c.min(-1, keepdim=True).values
    s = torch.sort(c, -1).values
    med = ((s[:, (pr.K - 1) // 2] + s[:, pr.K // 2]) * 0.5)[:, None]
    return torch.softmax(-(c - mu) / (((med - mu) + 1e-6) * pr.temperature), dim=-1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10-bit significand, to nearest with ties
    away from zero, as the tensor cores round their float32 operands."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def weighted_mean(w: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(N, K) weights and (N, K, L) int32 lanes -> (N, L) float32, one
    batched product.  Where PyTorch allows TF32 in float32 products
    (``torch.backends.cuda.matmul.allow_tf32``: the benchmark's control),
    both operands are first rounded to TF32, as a matrix product on the
    tensor cores rounds them: a product of one row makes cuBLAS take a
    matrix-vector kernel, which the switch never reaches, so the switch
    alone would leave the reference as it is."""
    a, b = w[:, None, :], cand.to(torch.float32)
    if torch.backends.cuda.matmul.allow_tf32:
        a, b = tf32(a), tf32(b)
    return torch.bmm(a, b)[:, 0]


def update(pr: MPPIProblem, plan: torch.Tensor, state: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """One update: plan (N, L) int32 lanes, state (N, 3) int32, noise (N,
    K, L) -> the new plan's lanes (N, L) int32."""
    cand = saturating_add(plan[:, None, :], noise.to(torch.int32))
    c = costs(pr, rollout(pr, state, cand), cand)
    mean = weighted_mean(weights(pr, c), cand)
    return torch.clamp(torch.round(mean), -PLAN_MAX, PLAN_MAX).to(torch.int32)


def mppi_step(pr: MPPIProblem, x0: torch.Tensor, words: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """One tick: states (N, 3) float32, warm words (N, L/4) int32, noise
    (N, U, K, L) int8 -> the refined plan's words (N, L/4)."""
    plan, state = unpack(words), to_fixed(pr, x0)
    for u in range(noise.shape[1]):
        plan = update(pr, plan, state, noise[:, u])
    return pack(plan)
