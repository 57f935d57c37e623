"""Composable trajectory costs for the sampling and gradient planners.

PyTorch port of ``pint_tpu/mpc/costs.py``.  Costs take trajectories --
fixed-point int32 states (the quantized rollouts, the MPPI scorer) or
float32 physical states (the differentiable twin of the nonlinear planner)
-- and control lanes, and return float32 scores.  Each factory returns
``cost(states, controls) -> (...)`` and :func:`combine` sums any number of
them.  Every operation is a torch op, so the costs differentiate under
``torch.autograd``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from pint_tpu_torch.mpc.condense_fused import true_div

CostFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

__all__ = [
    "combine",
    "goal_cost",
    "obstacle_cost",
    "control_effort_cost",
    "control_rate_cost",
]


def combine(*costs: CostFn) -> CostFn:
    def fn(states, controls):
        total = None
        for c in costs:
            v = c(states, controls)
            total = v if total is None else total + v
        return total

    return fn


def _xy(model, states) -> torch.Tensor:
    """Physical-unit xy from fixed-point (Q``frac_bits`` int) or physical
    (float) trajectories."""
    xy = states[..., :2]
    if not xy.dtype.is_floating_point:
        return xy.to(torch.float32) * float(np.float32(2.0**-model.frac_bits))
    return xy.to(torch.float32)


def goal_cost(model, goal_xy, terminal_weight: float = 20.0) -> CostFn:
    """Running + terminal squared distance to a goal point."""

    def fn(states, controls):
        xy = _xy(model, states)
        goal = torch.as_tensor(np.asarray(goal_xy), dtype=torch.float32,
                               device=xy.device)[..., None, :]
        d2 = torch.sum((xy - goal) ** 2, dim=-1)
        return torch.sum(d2[..., 1:], dim=-1) + terminal_weight * d2[..., -1]

    return fn


def obstacle_cost(model, centers_xy: Sequence, radius: float,
                  weight: float = 200.0) -> CostFn:
    """Soft-barrier penalty for entering circular obstacles: sum over time
    and obstacles of ``weight * max(0, 1 - d/r)^2``."""
    centers = np.asarray(centers_xy, np.float32).reshape(-1, 2)
    r = float(np.float32(radius))

    def fn(states, controls):
        xy = _xy(model, states)                                  # (..., T+1, 2)
        c = torch.as_tensor(centers, device=xy.device)
        d = torch.linalg.vector_norm(xy[..., None, :] - c, dim=-1)  # (..., T+1, K)
        pen = torch.clamp(1.0 - true_div(d, r), min=0.0)
        return weight * torch.sum(pen * pen, dim=(-2, -1))

    return fn


def control_effort_cost(weight: float = 1e-4) -> CostFn:
    """Quadratic penalty on control lane magnitudes."""

    def fn(states, controls):
        return weight * torch.sum(controls.to(torch.float32) ** 2, dim=(-2, -1))

    return fn


def control_rate_cost(weight: float = 1e-3) -> CostFn:
    """Penalty on step-to-step control changes (smoothness)."""

    def fn(states, controls):
        dc = torch.diff(controls.to(torch.float32), dim=-2)
        return weight * torch.sum(dc * dc, dim=(-2, -1))

    return fn
