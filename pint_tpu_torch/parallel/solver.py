"""Mesh-sharded fixed-point MPC solvers (dp x tp, explicit all-reduces).

PyTorch port of ``pint_tpu/parallel/solver.py``.  Distribution plan, as in
the reference:

* **dp** shards the problem batch; no traffic in the solve.
* **tp** shards the condensed horizon ``Tp``.  Each rank holds the columns
  ``Hq[:, cols_r]`` of the int8 Hessian and the iterate block
  ``U[:, cols_r]`` as packed words.  One PGD iteration:

      partial_r = U_r @ Hq[:, cols_r]^T          (B_loc, Tp) int32
      acc       = psum(partial_r, tp)            the full gradient, exact
      step_r    = -(acc[:, cols_r] * hs + g_r)   this rank's columns
      U_r      <- max_signed(add_signed_saturate(U_r, pack(step_r)), floor)

An int32 sum is exact and associative, so every mesh shape gives the
single-device solver's words bit for bit.  The reference computes these
matvecs with an XLA dot, not a Pallas kernel; here they are exact float64
products, as in the port's other plain versions.  Each rank calls the
solvers on its own shards (:func:`~pint_tpu_torch.parallel.mesh.shard`);
``solve`` takes the global states and returns global results on every
rank.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import CONTROL_LAYOUT, pack_controls, unpack_controls
from pint_tpu_torch.mpc.accelerated import beta_num
from pint_tpu_torch.mpc.condensed import QuantizedQP
from pint_tpu_torch.mpc.constrained import (
    QuantizedConstrainedQP,
    _alm_loop,
    _f64_mv,
    _word_space,
)
from pint_tpu_torch.mpc.ltv import _lower_words
from pint_tpu_torch.ops import word as W
from pint_tpu_torch.parallel.mesh import Mesh, column_block, psum, shard, unshard

__all__ = ["ShardedPGD", "ShardedConstrainedPGD"]


class ShardedPGD:
    """dp x tp sharded PGD for one quantized QP shared by the batch.

    ``momentum`` runs the Nesterov extrapolation of
    :class:`~pint_tpu_torch.mpc.accelerated.AcceleratedPGD`: the second
    iterate plane shards like the first, and the words equal
    AcceleratedPGD's bit for bit."""

    def __init__(self, qqp: QuantizedQP, mesh: Mesh, iters: int = 40,
                 momentum: bool = False, beta_den: int = 8):
        self.block = column_block(qqp.padded, mesh.tp, "padded horizon")
        self.qqp = qqp
        self.mesh = mesh
        self.iters = iters
        self.momentum = momentum
        self.beta_den = beta_den
        self._cols = slice(mesh.r_tp * self.block, (mesh.r_tp + 1) * self.block)
        Hq = np.asarray(qqp.Hq, np.float64)
        # this rank's columns of Hq, transposed: (block, Tp)
        self._HcT = torch.as_tensor(Hq[:, self._cols].T.copy(), device=mesh.device)

    @property
    def tp(self) -> int:
        return self.mesh.tp

    @property
    def Hq_dev(self) -> torch.Tensor:
        """The whole int8 Hessian (Tp, Tp) on the mesh's device."""
        return torch.as_tensor(np.asarray(self.qqp.Hq, np.int8), device=self.mesh.device)

    @property
    def lower_words(self) -> torch.Tensor:
        """(1,) int32: the packed word of four -127 lanes, the box floor."""
        return torch.full((1,), _lower_words(), dtype=torch.int32, device=self.mesh.device)

    @functools.cached_property
    def beta_num(self) -> int:
        return beta_num(self.qqp, self.beta_den)

    def _acc_block(self, lanes):
        """This rank's block of the exact full gradient accumulator."""
        acc = psum(_f64_mv(lanes, self._HcT), self.mesh.tp_group)
        return acc[:, self._cols]

    def _iterate(self, words, g_r):
        q = self.qqp
        pre = (self._acc_block(unpack_controls(words)) * q.hs_num) >> q.hs_den
        half = 1 << (q.g_shift - 1)
        delta = torch.clamp((-(pre + g_r) + half) >> q.g_shift, -128, 127)
        words = W.add_signed_saturate(CONTROL_LAYOUT, words, pack_controls(delta))
        return W.max_signed(CONTROL_LAYOUT, words, torch.full_like(words, _lower_words()))

    def solve_words(self, u_words: torch.Tensor, g_pre: torch.Tensor):
        """``iters`` steps on this rank's shards: u_words (B_loc, block/4)
        int32 words, g_pre (B_loc, block) int32.  Returns (words, residual):
        the global L1 norm of the final gradient, summed over both axes."""
        words = u_words
        if self.momentum:
            bnum, bden = self.beta_num, self.beta_den
            prev = words
            for _ in range(self.iters):
                x, xp = unpack_controls(words), unpack_controls(prev)
                y = torch.clamp(x + ((bnum * (x - xp)) >> bden), -127, 127)
                words, prev = self._iterate(pack_controls(y), g_pre), words
        else:
            for _ in range(self.iters):
                words = self._iterate(words, g_pre)
        q = self.qqp
        grad = ((self._acc_block(unpack_controls(words)) * q.hs_num) >> q.hs_den) + g_pre
        local = grad.abs().to(torch.float32).sum().reshape(1)
        return words, float(psum(local, self.mesh.group).item())

    def init_words(self, batch: int) -> torch.Tensor:
        """This rank's shard of a cold plan for a global batch."""
        m = self.mesh
        return torch.zeros((batch // m.dp, self.block // 4), dtype=torch.int32,
                           device=m.device)

    def place_g(self, g_pre: np.ndarray) -> torch.Tensor:
        """This rank's shard of the global (B, Tp) linear term."""
        return shard(g_pre, self.mesh, ("dp", "tp"))

    def solve(self, x0_phys: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """Sharded solve of the global states: returns the global (words,
        u_phys (B, T) float32, residual) on every rank."""
        g = self.place_g(self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)))
        words, residual = self.solve_words(self.init_words(g.shape[0] * self.mesh.dp), g)
        words = unshard(words, self.mesh, ("dp", "tp"))
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.to(torch.float32) * float(np.float32(self.qqp.u_scale)), residual


class ShardedConstrainedPGD:
    """dp x tp sharded augmented-Lagrangian solver (hard state
    constraints), the mesh form of
    :class:`~pint_tpu_torch.mpc.constrained.ConstrainedPGD`.

    Each inner iteration every rank adds its column block to two exact
    int32 all-reduces, the objective gradient ``U_r @ Hq[:, cols_r]^T`` and
    the constraint value ``U_r @ Sq[:, cols_r]^T``.  The constraint-row
    plane (violations, error feedback, multipliers) is tp-replicated: each
    rank computes it from the reduced values with the same integer ops.
    The penalty gradient ``y @ Sq[:, cols_r]`` needs no collective.
    Bit-identical to ConstrainedPGD's word-space loop on every mesh."""

    def __init__(self, qcqp: QuantizedConstrainedQP, mesh: Mesh, outer: int = 10,
                 inners: int = 40):
        self.block = column_block(qcqp.qqp.padded, mesh.tp, "padded horizon")
        self.qcqp = qcqp
        self.mesh = mesh
        self.outer = outer
        self.inners = inners
        cols = slice(mesh.r_tp * self.block, (mesh.r_tp + 1) * self.block)
        self._cols = cols
        dev = mesh.device
        Hq = np.asarray(qcqp.qqp.Hq, np.float64)
        Sq = np.asarray(qcqp.Sq, np.float64)
        self._HcT = torch.as_tensor(Hq[:, cols].T.copy(), device=dev)   # (block, Tp)
        self._Sc = torch.as_tensor(Sq[:, cols].copy(), device=dev)      # (Cp, block)
        self._lo = torch.as_tensor(np.asarray(qcqp.lo_pre, np.int32), device=dev)
        self._hi = torch.as_tensor(np.asarray(qcqp.hi_pre, np.int32), device=dev)

    @property
    def tp(self) -> int:
        return self.mesh.tp

    def solve_words(self, u_words, g_pre, c_off, lam0=None):
        """``outer`` x ``inners`` ALM iterations on this rank's shards:
        u_words (B_loc, block/4), g_pre (B_loc, block), c_off and lam0
        (B_loc, Cp) tp-replicated.  Returns (words, lam); lam is the same
        on every tp rank."""
        q, qq = self.qcqp, self.qcqp.qqp
        grp = self.mesh.tp_group
        if lam0 is None:
            lam0 = torch.zeros_like(c_off)
        ScT = self._Sc.T
        return _alm_loop(
            u_words, g_pre, c_off, lam0,
            hmv=lambda u: psum(_f64_mv(u, self._HcT), grp)[:, self._cols],
            smv=lambda u: psum(_f64_mv(u, ScT), grp),
            stmv=lambda y: _f64_mv(y, self._Sc),
            rat=dict(hs_num=qq.hs_num, hs_den=qq.hs_den, cs_num=q.cs_num,
                     cs_den=q.cs_den, eh_num=q.eh_num, eh_den=q.eh_den,
                     el_num=q.el_num, el_den=q.el_den),
            lo=self._lo, hi=self._hi, outer=self.outer, inners=self.inners,
            g_shift=qq.g_shift, y_shift=q.y_shift, space=_word_space(),
        )

    def init_words(self, batch: int) -> torch.Tensor:
        m = self.mesh
        return torch.zeros((batch // m.dp, self.block // 4), dtype=torch.int32,
                           device=m.device)

    def solve(self, x0_phys: np.ndarray):
        """Sharded solve of the global states: returns the global (words,
        u_phys (B, T) float32, lam_pre) on every rank."""
        q, m = self.qcqp, self.mesh
        x0 = np.atleast_2d(x0_phys)
        g = shard(q.qqp.g_lane_fixed(x0), m, ("dp", "tp"))
        c_off = shard(q.c_off_pre(x0), m, ("dp", None))
        words, lam = self.solve_words(self.init_words(x0.shape[0]), g, c_off)
        words = unshard(words, m, ("dp", "tp"))
        lanes = unpack_controls(words)[:, : q.qqp.horizon]
        return (words, lanes.to(torch.float32) * float(np.float32(q.qqp.u_scale)),
                unshard(lam, m, ("dp", None)))
