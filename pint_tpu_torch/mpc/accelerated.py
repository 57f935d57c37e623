"""Accelerated fixed-point PGD (Nesterov-style momentum) on packed words.

PyTorch port of ``pint_tpu/mpc/accelerated.py``.  Each iteration, in lane
space:

    y   = clip(x + ((beta_num * (x - x_prev)) >> beta_den), -127, 127)
    x+  = clip(y + quantized_step(grad(y)), -127, 127)

with ``beta = (sqrt(kappa) - 1) / (sqrt(kappa) + 1)`` as the integer
rational ``beta_num / 2**beta_den``.  The iterate pair lives as packed words
and is re-packed every iteration, as in the reference.  It is the
single-device reference of ``ShardedPGD(momentum=True)`` and equals the K2
kernel's momentum branch (``FusedPGD(momentum=True)``).  The int8 matvec is
an exact float64 product.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.ops import kernels as K

__all__ = ["AcceleratedPGD", "beta_num"]


def beta_num(qqp: QuantizedQP, beta_den: int) -> int:
    """``round(beta * 2**beta_den)`` from the condition number of ``qqp``'s
    float Hessian."""
    eig = np.linalg.eigvalsh(qqp.qp.H)
    kappa = float(eig.max() / max(eig.min(), 1e-12))
    rk = np.sqrt(kappa)
    return int(round((rk - 1.0) / (rk + 1.0) * (1 << beta_den)))


class AcceleratedPGD:
    """Momentum-accelerated word-space solver (``FixedPointPGD``'s
    interface)."""

    def __init__(self, qqp: QuantizedQP, iters: int = 20, beta_den: int = 8,
                 device="cuda"):
        self.qqp = qqp
        self.iters = iters
        self.beta_den = beta_den
        self.device = K.resolve_device(device)
        self._HqT = torch.as_tensor(np.asarray(qqp.Hq, np.float64).T, device=self.device)

    @functools.cached_property
    def beta_num(self) -> int:
        return beta_num(self.qqp, self.beta_den)

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self.qqp.padded // 4), dtype=torch.int32, device=self.device
        )

    def solve_words(self, u_words: torch.Tensor, g_pre: torch.Tensor) -> torch.Tensor:
        q = self.qqp
        half = 1 << (q.g_shift - 1)
        bnum, bden = self.beta_num, self.beta_den
        x_words = xp_words = u_words
        for _ in range(self.iters):
            x, xp = unpack_controls(x_words), unpack_controls(xp_words)
            y = torch.clamp(x + ((bnum * (x - xp)) >> bden), -127, 127)
            acc = (y.to(torch.float64) @ self._HqT).to(torch.int32)
            pre = (acc * q.hs_num) >> q.hs_den
            delta = torch.clamp((-(pre + g_pre) + half) >> q.g_shift, -128, 127)
            x_words, xp_words = pack_controls(torch.clamp(y + delta, -127, 127)), x_words
        return x_words

    def solve(self, x0_phys: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        g_pre = torch.as_tensor(
            self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)), device=self.device
        )
        words = self.solve_words(self.init_words(g_pre.shape[0]), g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.to(torch.float32) * float(np.float32(self.qqp.u_scale))
