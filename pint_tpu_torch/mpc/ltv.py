"""Quantized LTV/SQP MPC on packed int8 plans (port of ``pint_tpu/mpc/ltv.py``).

The sequential-quadratic-programming tier on the host: each outer (SQP)
iteration rolls the plan through the float64 reference dynamics, linearizes
the exact discrete map along that trajectory (``model.linearize``),
condenses the time-varying affine QP in absolute controls
(:func:`~pint_tpu_torch.mpc.condensed.condense_ltv_batch`), quantizes it per
problem (:func:`quantize_batch`), all in numpy as the reference does, and
solves it on the device with the word-space fixed-point PGD
:func:`_pgd_batched_h` (error feedback, saturating packed update, -127 box
floor), warm-started from the current packed plan.

:class:`QuantizedSQP` is the planner, :class:`SQPController` the
real-time-iteration closed loop over it (one host condensation a tick, the
state on the host every tick, as in the reference).  The reference runs its
inner as the XLA loop ``_pgd_batched_h``, not a Pallas kernel, so the port
runs that loop's torch form here too (K4 is ``DeviceSQP``'s inner).  Also
here: the column-sharded forms of the inner for a tp mesh
(:func:`_pgd_cols_loop`, :func:`_pgd_batched_h_cols` with the plain column
dot, :func:`_pgd_batched_h_cols_hqt` with K10).

Words live in int32 containers holding the reference's uint32 bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import (
    CONTROL_LAYOUT,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_tpu_torch.mpc.condensed import condense_ltv, condense_ltv_batch
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W

__all__ = ["QuantizedSQP", "SQPController"]


def _lower_words() -> int:
    """The packed word of four -127 lanes (the box floor), as the int32
    two's-complement value of its bits."""
    w = 0
    for off in CONTROL_LAYOUT.offsets:
        w |= (-127 & 0xFF) << off
    return w - (1 << 32) if w >> 31 else w


def quantize_batch(
    H: np.ndarray,
    G: np.ndarray,
    g_ref: np.ndarray,
    alpha: np.ndarray,
    x0_f: np.ndarray,
    Tp: int,
    g_shift: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-problem :func:`~pint_tpu_torch.mpc.condensed.quantize`
    in lane units (u_scale = 1, u_max = 127): the SQP inner-QP quantizer
    (numpy, the reference's code: its ``/ 127.0`` is an IEEE division).

    ``alpha`` (B,) is the PGD step per problem -- 1/lip for the plain SQP,
    1/(lip + rho * penalty_lip) for the state-constrained variant.  Returns
    (Hq (B,Tp,Tp) int8, g_pre (B,Tp) int32, hs_num (B,), hs_den (B,)).
    """
    batch = H.shape[0]
    aH = alpha[:, None, None] * H
    h_scale = np.abs(aH).max(axis=(1, 2)) / 127.0       # (B,)
    Hq = np.zeros((batch, Tp, Tp), np.int8)
    Hq[:, : H.shape[1], : H.shape[2]] = np.round(
        aH / h_scale[:, None, None]
    ).astype(np.int8)
    g = np.einsum("bin,bn->bi", G, x0_f) + g_ref        # (B, Tm)
    gq = np.round(
        np.nan_to_num(
            g * (alpha * float(2**g_shift))[:, None],
            posinf=2**31 - 1, neginf=-(2**31),
        )
    )
    g_pre = np.zeros((batch, Tp), np.int32)
    g_pre[:, : g.shape[1]] = np.clip(gq, -(2**31), 2**31 - 1).astype(
        np.int32
    )
    val = h_scale * float(2**g_shift)                   # (B,)
    num_max = (2**31 - 1) // (127 * 127 * Tp)
    hs_den = np.clip(
        np.floor(np.log2(num_max / val)), 0, 31
    ).astype(np.int32)
    hs_num = np.round(val * 2.0**hs_den).astype(np.int64)
    if (hs_num < 1).any() or (hs_num > num_max).any():
        raise ValueError(
            "step scale cannot be represented as an int32 rational "
            "(degenerate problem scaling); rescale Q/R or g_shift"
        )
    return Hq, g_pre, hs_num.astype(np.int32), hs_den


def _pgd_cols_loop(u_words, g_r, hs_num, hs_den, acc_of, *, iters, g_shift):
    """The error-feedback PGD iteration on packed words, shared by the
    single-device inner and its column-sharded forms (one body, so they
    cannot drift apart).  ``acc_of(lanes)`` supplies the raw int32 gradient
    accumulator of the iterate's columns; everything else -- step scaling,
    error feedback, the saturating packed update and the -127 box floor --
    is here.  u_words (B, K/4) int32 words; g_r (B, K) int32; hs_num,
    hs_den (B,) int32."""
    lower = torch.full_like(u_words, _lower_words())
    num, den = hs_num[:, None], hs_den[:, None]
    half = 1 << (g_shift - 1)
    carry = torch.zeros_like(g_r)
    words = u_words
    for _ in range(iters):
        pre = (acc_of(unpack_controls(words)) * num) >> den
        step = -(pre + g_r) + carry
        delta = torch.clamp((step + half) >> g_shift, -128, 127)
        carry = step - (delta << g_shift)
        words = W.add_signed_saturate(CONTROL_LAYOUT, words, pack_controls(delta))
        words = W.max_signed(CONTROL_LAYOUT, words, lower)
    return words


def _bmv(m, lanes):
    """Batched int8 matvec (B, N, K) @ (B, K) -> (B, N) int32 as an exact
    float64 product; ``m`` is already float64."""
    return torch.bmm(m, lanes.to(torch.float64)[:, :, None])[..., 0].to(torch.int32)


def _pgd_batched_h(u_words, g_pre, Hq, hs_num, hs_den, *, iters, g_shift):
    """Fixed-point PGD with a per-problem Hessian, on packed words.

    u_words (B, Tp/4) int32 words; g_pre (B, Tp) int32; Hq (B, Tp, Tp) int8;
    hs_num, hs_den (B,) int32.  The same iteration as ``pint_tpu``'s
    ``_pgd_batched_h``: saturating packed update, then the -127 box floor.
    The int8 matvec runs as an exact float64 batched product."""
    Hd = Hq.to(torch.float64)
    return _pgd_cols_loop(u_words, g_pre, hs_num, hs_den, lambda u: _bmv(Hd, u),
                          iters=iters, g_shift=g_shift)


def _pgd_batched_h_cols(u_words, g_r, Hq, hs_num, hs_den, *, iters, g_shift,
                        group, rank, block):
    """Column-sharded :func:`_pgd_batched_h` on tp rank ``rank`` of the
    process group ``group``: the horizon splits into ``block``-wide column
    blocks.  u_words (B, block/4) and g_r (B, block) are this rank's
    columns; Hq (B, Tp, Tp) int8 is tp-replicated.

    Each iteration this rank's columns contribute ``U_r @ Hq[:, :, cols_r]^T``
    to an exact int32 all-reduce of the full gradient, and the rank updates
    only its own columns: bit-identical to :func:`_pgd_batched_h`
    restricted to these columns."""
    from pint_tpu_torch.parallel.mesh import psum

    cols = slice(rank * block, (rank + 1) * block)
    Hc = Hq[:, :, cols].to(torch.float64)

    def acc_of(lanes):
        return psum(_bmv(Hc, lanes), group)[:, cols]

    return _pgd_cols_loop(u_words, g_r, hs_num, hs_den, acc_of,
                          iters=iters, g_shift=g_shift)


def _pgd_batched_h_cols_hqt(u_words, g_r, hqt, hs_num, hs_den, *, iters, g_shift,
                            group, rank, block):
    """:func:`_pgd_batched_h_cols` with the rank's matvec as K10
    (:func:`~pint_tpu_torch.mpc.fused_alm.pgd_matvec_cols`), launched once
    an iteration with the int32 all-reduce between launches.  hqt
    (Tm, Tm, B) int8 is the full slab that K3 emits (``Hq =
    hqt.permute(2, 1, 0)``); this rank reads its k-slice, which K10 takes
    batch-last: a view of K3's batch-last slab to 64 rows, one int8 copy of
    its problem-major slab past them.  Bit-identical to
    :func:`_pgd_batched_h_cols` (int32 sums are exact)."""
    from pint_tpu_torch.mpc.fused_alm import pgd_matvec_cols
    from pint_tpu_torch.parallel.mesh import psum

    cols = slice(rank * block, (rank + 1) * block)
    hqt_r = hqt[cols].contiguous()          # (block, Tm, B)

    def acc_of(lanes):
        return psum(pgd_matvec_cols(lanes, hqt_r), group)[:, cols]

    return _pgd_cols_loop(u_words, g_r, hs_num, hs_den, acc_of,
                          iters=iters, g_shift=g_shift)


@dataclasses.dataclass(frozen=True)
class QuantizedSQP:
    """SQP trajectory optimizer on packed int8 plans, for any model exposing
    ``reference_rollout(x0, u_phys)``, ``linearize(states, controls)`` and
    ``lane_scales`` (Unicycle, Pendulum, PlanarQuadrotor, ...).

    Cost: sum_{k=1..T} (x_k - x_ref_k)^T Q (x_k - x_ref_k) (terminal Qf at
    x_T) + sum_k u_k^T R u_k with u in physical units and the per-channel
    box |u_c| <= 127 * lane_scales[c] (the int8 lane range).  ``Qf``
    overrides ``qf_scale * Q`` when given (for example
    :func:`~pint_tpu_torch.mpc.condensed.dare_terminal` of the
    linearization at the operating point).  The host condensation is the
    reference's numpy; the inner runs on ``device`` (the card unless
    ``"cpu"`` is asked for; raises without a card)."""

    model: object = dataclasses.field(default_factory=Unicycle)
    horizon: int = 48
    Q: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([1.0, 1.0, 0.02])
    )
    R: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([0.02, 0.02])
    )
    qf_scale: float = 20.0
    Qf: Optional[np.ndarray] = None
    x_ref: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    sqp_iters: int = 6
    pgd_iters: int = 40
    g_shift: int = 12
    pad_to: int = 64
    device: object = "cuda"

    def __post_init__(self):
        if self.pad_to % 4 or self.pad_to < 4:
            raise ValueError("pad_to must be a positive multiple of 4 lanes")
        object.__setattr__(self, "device", K.resolve_device(self.device))

    @functools.cached_property
    def Qf_matrix(self) -> np.ndarray:
        if self.Qf is not None:
            return np.asarray(self.Qf, float)
        return self.qf_scale * np.asarray(self.Q, float)

    # -- geometry -------------------------------------------------------------

    @functools.cached_property
    def _lane_scales(self) -> np.ndarray:
        return np.asarray(self.model.lane_scales, np.float64)

    @property
    def n_ctrl(self) -> int:
        return len(self._lane_scales)

    @property
    def n_dec(self) -> int:
        return self.n_ctrl * self.horizon

    @functools.cached_property
    def padded(self) -> int:
        return -(-self.n_dec // self.pad_to) * self.pad_to

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.padded // 4), dtype=torch.int32,
                           device=self.device)

    def _check_dims(self, n: int) -> None:
        """Validate Q/R/x_ref against the model's state dim ``n`` (known
        only after the first rollout) and the control channel count."""
        m, T = self.n_ctrl, self.horizon
        if np.asarray(self.Q).shape != (n, n):
            raise ValueError(
                f"Q has shape {np.asarray(self.Q).shape}; the model's "
                f"state dim is {n}"
            )
        if np.asarray(self.R).shape != (m, m):
            raise ValueError(
                f"R has shape {np.asarray(self.R).shape}; the model has "
                f"{m} control channel(s)"
            )
        xr = np.asarray(self.x_ref, float)
        if xr.shape not in ((n,), (T, n)):
            raise ValueError(
                f"x_ref has shape {xr.shape}; expected ({n},) or ({T}, {n})"
            )

    # -- public API -------------------------------------------------------------

    def solve(
        self,
        x0_f: np.ndarray,
        u_words: Optional[torch.Tensor] = None,
        track_costs: bool = True,
    ) -> Tuple[torch.Tensor, Optional[np.ndarray]]:
        """Run ``sqp_iters`` outer iterations from the physical states x0_f
        (B, n) float64.

        Returns (packed words (B, Tp/4) int32 on the device, cost history
        (B, sqp_iters+1) of the true nonlinear objective, or None when
        ``track_costs=False``).  Deterministic: same inputs, same words."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        if u_words is None:
            u_words = self.init_words(batch)
        elif tuple(u_words.shape) != (batch, self.padded // 4):
            raise ValueError(
                f"u_words has shape {tuple(u_words.shape)}; expected "
                f"({batch}, {self.padded // 4}) packed words for horizon "
                f"{self.horizon} x {self.n_ctrl} channel(s) padded to "
                f"{self.padded} lanes"
            )
        else:
            u_words = u_words.to(self.device)
        costs = (
            [self.true_cost(x0_f, self.lanes(u_words))] if track_costs else None
        )
        for _ in range(self.sqp_iters):
            ops = self._condense_batch(x0_f, self.lanes(u_words))
            Hq, g_pre, hs_num, hs_den = (torch.as_tensor(a, device=self.device)
                                         for a in ops)
            u_words = _pgd_batched_h(u_words, g_pre, Hq, hs_num, hs_den,
                                     iters=self.pgd_iters, g_shift=self.g_shift)
            if track_costs:
                costs.append(self.true_cost(x0_f, self.lanes(u_words)))
        return u_words, (np.stack(costs, axis=-1) if track_costs else None)

    def _condense_batch(self, x0_f: np.ndarray, lanes: np.ndarray):
        """Vectorized linearize + condense + quantize for the whole batch
        (host numpy).  Returns (Hq (B,Tp,Tp) int8, g_pre (B,Tp) int32,
        hs_num (B,) int32, hs_den (B,) int32)."""
        T, m = self.horizon, self.n_ctrl
        s = self._lane_scales
        batch = x0_f.shape[0]
        u_phys = lanes.reshape(batch, T, m) * s
        traj = self.model.reference_rollout(x0_f, u_phys)  # (B, T+1, n)
        self._check_dims(traj.shape[-1])
        A_seq, B_seq = self.model.linearize(traj[:, :-1], u_phys)
        c_seq = (
            traj[:, 1:]
            - np.einsum("bkij,bkj->bki", A_seq, traj[:, :-1])
            - np.einsum("bkij,bkj->bki", B_seq, u_phys)
        )
        Q = np.asarray(self.Q)
        R_lane = s[:, None] * np.asarray(self.R) * s[None, :]
        H, G, g_ref, lip = condense_ltv_batch(
            A_seq, B_seq * s, c_seq, Q, R_lane,
            self.Qf_matrix, np.asarray(self.x_ref, float),
        )
        return quantize_batch(
            H, G, g_ref, 1.0 / lip, x0_f, self.padded, self.g_shift
        )

    def lanes(self, u_words: torch.Tensor) -> np.ndarray:
        """(B, n_dec) int32 lane plan on the host (drops the QP padding)."""
        return unpack_controls(u_words).cpu().numpy()[:, : self.n_dec]

    def plan_phys(self, u_words: torch.Tensor) -> np.ndarray:
        """(B, T, m) physical control sequences."""
        lanes = self.lanes(u_words)
        return (
            lanes.reshape(lanes.shape[0], self.horizon, self.n_ctrl)
            * self._lane_scales
        )

    # -- diagnostics ---------------------------------------------------------

    def true_cost(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """The actual nonlinear objective of lane plans (B, n_dec), by a
        float64 numpy rollout.  ``DeviceSQP`` shares this method."""
        T = self.horizon
        u_phys = np.asarray(lanes).reshape(-1, T, self.n_ctrl) * self._lane_scales
        traj = self.model.reference_rollout(np.atleast_2d(x0_f), u_phys)
        n = traj.shape[-1]
        self._check_dims(n)
        x_ref = np.broadcast_to(np.asarray(self.x_ref, float), (T, n))
        dx = traj[:, 1:] - x_ref
        Qs = np.stack([np.asarray(self.Q)] * (T - 1) + [self.Qf_matrix])
        state_cost = np.einsum("bki,kij,bkj->b", dx, Qs, dx)
        ctrl_cost = np.einsum("bki,ij,bkj->b", u_phys, np.asarray(self.R), u_phys)
        return state_cost + ctrl_cost

    # -- float64 reference (same algorithm, no quantization) -----------------

    def reference_solve(self, x0_f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 SQP with the same linearize/condense/PGD structure, one
        problem at a time: identical iteration counts and step rule,
        arithmetic in float64, box in lane units.  Returns (lane-valued
        plans (B, n_dec) float64, cost history)."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        T = self.horizon
        s = self._lane_scales
        U = np.zeros((batch, self.n_dec))
        costs = [self.true_cost(x0_f, U)]
        for _ in range(self.sqp_iters):
            for i in range(batch):
                u_phys = U[i].reshape(T, self.n_ctrl) * s
                traj = self.model.reference_rollout(x0_f[i], u_phys)
                A_seq, B_seq = self.model.linearize(traj[:-1], u_phys)
                c_seq = (
                    traj[1:]
                    - np.einsum("kij,kj->ki", A_seq, traj[:-1])
                    - np.einsum("kij,kj->ki", B_seq, u_phys)
                )
                qp = condense_ltv(
                    A_seq, B_seq * s, c_seq, np.asarray(self.Q),
                    s[:, None] * np.asarray(self.R) * s[None, :],
                    self.Qf_matrix, self.x_ref, u_max=127.0,
                )
                g = qp.G @ x0_f[i] + qp.g_ref
                alpha = 1.0 / qp.lipschitz
                u = U[i].copy()
                for _ in range(self.pgd_iters):
                    u = np.clip(u - alpha * (qp.H @ u + g), -127.0, 127.0)
                U[i] = u
            costs.append(self.true_cost(x0_f, U))
        return U, np.stack(costs, axis=-1)


@dataclasses.dataclass(frozen=True)
class SQPController:
    """Real-time-iteration closed loop: receding-horizon SQP MPC.

    Per tick: run ``iters_per_tick`` SQP iterations warm-started from the
    shifted previous plan, apply the first control on the quantized plant
    (the model's fixed-point ``step``, on the solver's device) and shift the
    packed plan by one step.  The state goes to the host every tick for the
    condensation, as in the reference.  Fully deterministic."""

    sqp: QuantizedSQP
    iters_per_tick: int = 1

    def run(
        self,
        x0_f: np.ndarray,
        ticks: int,
        u_words: Optional[torch.Tensor] = None,
        x_ref_traj: Optional[np.ndarray] = None,
    ):
        """Returns (states (B, ticks+1, n) int32 fixed point, applied
        controls (B, ticks, m) int32 lanes), both numpy.

        ``u_words`` warm-starts the first tick (plan offline, then track).
        ``x_ref_traj`` (>= ticks + horizon, n) makes the loop a trajectory
        tracker: tick t's QP takes ``x_ref_traj[t+1 : t+1+horizon]`` as its
        per-step reference."""
        tick_sqp = dataclasses.replace(self.sqp, sqp_iters=self.iters_per_tick)
        model = self.sqp.model
        m, n_dec = self.sqp.n_ctrl, self.sqp.n_dec
        T = self.sqp.horizon
        if x_ref_traj is not None:
            x_ref_traj = np.asarray(x_ref_traj, np.float64)
            if x_ref_traj.shape[0] < ticks + T:
                raise ValueError(
                    f"x_ref_traj has {x_ref_traj.shape[0]} steps; tracking "
                    f"{ticks} ticks at horizon {T} needs >= {ticks + T}"
                )
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        state_fp = torch.as_tensor(model.to_fixed(x0_f), device=self.sqp.device)
        words = self.sqp.init_words(batch) if u_words is None else u_words
        states = [state_fp.cpu().numpy()]
        applied = []
        for t in range(ticks):
            x_f = model.to_float(states[-1])
            if x_ref_traj is not None:
                tick_sqp = dataclasses.replace(
                    tick_sqp, x_ref=x_ref_traj[t + 1 : t + 1 + T]
                )
            words, _ = tick_sqp.solve(x_f, u_words=words, track_costs=False)
            lanes = unpack_controls(words)  # (B, Tp)
            u0 = lanes[:, :m]
            state_fp = model.step(state_fp, *(u0[:, c] for c in range(m)))
            # warm shift: drop the applied step, zero the tail
            shifted = torch.zeros_like(lanes)
            shifted[:, : n_dec - m] = lanes[:, m:n_dec]
            words = pack_controls(shifted)
            states.append(state_fp.cpu().numpy())
            applied.append(u0.cpu().numpy())
        return np.stack(states, axis=1), np.stack(applied, axis=1)
