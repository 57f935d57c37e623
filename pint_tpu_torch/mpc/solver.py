"""Fixed-point projected-gradient MPC solver on packed words (port of
``pint_tpu/mpc/solver.py:46-168``).

The word-space solver: the control iterate lives as int8 lanes packed four
to a word, each step is an int8 matvec, one int32 rescale and shift, and the
saturating packed update ``add_signed_saturate`` followed by the packed box
floor ``max_signed`` (pint.hpp:857-866, 987-1004).  It is the plain
reference the K2 kernel (:class:`pint_tpu_torch.mpc.fused.FusedPGD`) is held
to, and the route :class:`pint_tpu_torch.serving.MPCService` takes when it
does not use the kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.mpc.ltv import _lower_words
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W

__all__ = ["FixedPointPGD"]


class FixedPointPGD:
    """Word-space PGD for one quantized QP shared across the batch.

    ``error_feedback`` carries the sub-lane rounding residual between
    iterations in an int32 plane, as ``pint_tpu``'s solver does.  The int8
    matvec runs as a float64 product, exact for these magnitudes
    (|acc| <= 128 * 127 * Tp) and free of TF32, on any device."""

    def __init__(self, qqp: QuantizedQP, iters: int = 40,
                 error_feedback: bool = False, device="cuda"):
        self.qqp = qqp
        self.iters = iters
        self.error_feedback = error_feedback
        self.device = K.resolve_device(device)
        self._HqT = torch.as_tensor(
            np.asarray(qqp.Hq, np.float64).T, device=self.device
        )

    @property
    def Hq_dev(self) -> torch.Tensor:
        """The int8 Hessian (Tp, Tp) on the solver's device."""
        return torch.as_tensor(np.asarray(self.qqp.Hq, np.int8), device=self.device)

    @property
    def lower_words(self) -> torch.Tensor:
        """(1,) int32: the packed word of four -127 lanes, the box floor."""
        return torch.full((1,), _lower_words(), dtype=torch.int32, device=self.device)

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self.qqp.padded // 4), dtype=torch.int32, device=self.device
        )

    def solve_words(self, u_words: torch.Tensor, g_pre: torch.Tensor):
        """``iters`` PGD steps: u_words (B, Tp/4) int32 words, g_pre (B, Tp)
        int32 pre-shift lane units -> words."""
        q = self.qqp
        half = 1 << (q.g_shift - 1)
        lower = torch.full_like(u_words, _lower_words())
        carry = torch.zeros_like(g_pre) if self.error_feedback else None
        for _ in range(self.iters):
            lanes = unpack_controls(u_words)
            acc = (lanes.to(torch.float64) @ self._HqT).to(torch.int32)
            pre = (acc * q.hs_num) >> q.hs_den
            step = -(pre + g_pre)
            if carry is not None:
                step = step + carry
            delta = torch.clamp((step + half) >> q.g_shift, -128, 127)
            if carry is not None:
                carry = step - (delta << q.g_shift)
            u_words = W.add_signed_saturate(
                CONTROL_LAYOUT, u_words, pack_controls(delta)
            )
            u_words = W.max_signed(CONTROL_LAYOUT, u_words, lower)
        return u_words

    def solve(self, x0_phys: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cold-start solve of a batch of initial states: returns (packed
        words, physical control sequences (B, T) float32)."""
        g_pre = torch.as_tensor(
            self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)), device=self.device
        )
        words = self.solve_words(self.init_words(g_pre.shape[0]), g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.to(torch.float32) * float(np.float32(self.qqp.u_scale))

    def cost(self, lanes_phys: np.ndarray, x0_phys: np.ndarray) -> np.ndarray:
        """Float64 QP objective of a (batch of) control sequences, numpy in
        and out: the reference's own body."""
        qp = self.qqp.qp
        U = np.asarray(lanes_phys, np.float64)
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        g = x0 @ qp.G.T + qp.g_ref
        return 0.5 * np.einsum("bi,ij,bj->b", U, qp.H, U) + np.einsum(
            "bi,bi->b", g, U
        )
