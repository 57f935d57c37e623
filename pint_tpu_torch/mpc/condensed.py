"""Condensed-QP construction for linear-dynamics MPC (numpy only).

Copied from ``pint_tpu/mpc/condensed.py``: the port never imports jax, and
importing the reference package would.  Builds, on the host in float64, the
condensed quadratic program of a box-constrained linear MPC problem and
quantizes it into the int8/int32 fixed-point operands the PGD solvers
consume.  Ported: :class:`CondensedQP`, :class:`QuantizedQP`,
:func:`condense_lti`, :func:`condense_double_integrator` and
:func:`quantize`; the LTV condensations and ``dare_terminal`` wait
(ROADMAP queue 1).

Condensation (standard): with x_{k+1} = A x_k + B u_k,

    X = A_bar x0 + B_bar U
    J(U) = 1/2 U^T H U + g(x0)^T U + const
    H = B_bar^T Q_bar B_bar + R_bar
    g(x0) = B_bar^T Q_bar (A_bar x0 - X_ref)

Box u_k in [-u_max, u_max] maps exactly onto the int8 lane range [-127, 127]
via u_scale = u_max / 127.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CondensedQP",
    "QuantizedQP",
    "condense_lti",
    "condense_double_integrator",
    "quantize",
]

@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Float64 condensed QP: minimize 1/2 U^T H U + g^T U, |U| <= u_max.

    ``g_from_x0`` maps an initial state to the linear term:
    g = G x0 + g_ref."""

    H: np.ndarray          # (T, T)
    G: np.ndarray          # (T, n)  g(x0) = G @ x0 + g_ref
    g_ref: np.ndarray      # (T,)
    u_max: float
    lipschitz: float       # lambda_max(H)

    def gradient(self, U: np.ndarray, x0: np.ndarray) -> np.ndarray:
        return U @ self.H.T + x0 @ self.G.T + self.g_ref

    def solve_pgd(
        self, x0: np.ndarray, iters: int, step: Optional[float] = None
    ) -> np.ndarray:
        """Float64 projected gradient descent; batched over leading dims of
        x0.  This is the CPU reference the quantized solver is checked
        against (same iteration count and step)."""
        x0 = np.asarray(x0, dtype=np.float64)
        alpha = step if step is not None else 1.0 / self.lipschitz
        U = np.zeros(x0.shape[:-1] + (self.H.shape[0],), dtype=np.float64)
        for _ in range(iters):
            U = U - alpha * self.gradient(U, x0)
            U = np.clip(U, -self.u_max, self.u_max)
        return U


@dataclasses.dataclass(frozen=True)
class QuantizedQP:
    """Fixed-point operands for the PGD solvers.

    Scaling model (all scales are powers of two where it matters):

      U_phys = U_lane * u_scale                 (int8 lanes)
      H_q    = round(alpha * H / h_scale)       (int8, |.| <= 127)
      step direction: d_lane = -(U_lane @ H_q^T * h_scale + g_q) >> g_shift

    where g_q = round(alpha * g / (u_scale * 2^-g_shift)) pre-folds alpha and
    the output scale so the inner loop is one int8 matmul, one int32 add and
    one shift before the saturating packed update.
    """

    qp: CondensedQP
    Hq: np.ndarray         # (Tp, Tp) int8, zero-padded to a multiple of pad_to
    h_scale: float         # alpha*H ~ Hq * h_scale
    g_shift: int
    Gq_scale: float        # g_q = (G @ x0 + g_ref) * glin_scale (int32)
    u_scale: float
    horizon: int           # T (unpadded)
    padded: int            # Tp
    hs_num: int            # (acc * hs_num) >> hs_den ~ acc * h_scale * 2^g_shift
    hs_den: int

    def g_lane_fixed(self, x0_phys: np.ndarray) -> np.ndarray:
        """int32 linear term in pre-shifted lane units for given states."""
        g = x0_phys @ self.qp.G.T + self.qp.g_ref  # (B, T) float64
        # non-finite states (serving-path corruption) quantize to saturated
        # linear terms instead of raising / UB int casts
        g = np.nan_to_num(g * self.Gq_scale, posinf=2**31 - 1, neginf=-(2**31))
        gq = np.round(g).astype(np.int64)
        pad = self.padded - self.horizon
        if pad:
            gq = np.concatenate(
                [gq, np.zeros(gq.shape[:-1] + (pad,), np.int64)], axis=-1
            )
        return np.clip(gq, -(2**31), 2**31 - 1).astype(np.int32)


def condense_lti(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R,
    Qf: np.ndarray,
    T: int,
    x_ref: np.ndarray,
    u_max: float,
) -> CondensedQP:
    """Condense a box-constrained LTI MPC problem.

    x_{k+1} = A x_k + B u_k with A (n, n), B (n, m); cost
    sum_k (x_k - x_ref)^T Q (x_k - x_ref) + u_k^T R u_k (terminal Qf),
    box |u| <= u_max per input.  The decision vector flattens time-major:
    U = [u_0; u_1; ...] of length T*m -- the layout the packed int8
    solvers consume directly.
    """
    A = np.atleast_2d(np.asarray(A, float))
    B = np.asarray(B, float).reshape(A.shape[0], -1)
    n, m = B.shape
    R = np.eye(m) * R if np.isscalar(R) else np.asarray(R, float)
    # A_bar: stacked powers; B_bar[k] maps U -> x_{k+1}
    Abar = np.zeros((T, n, n))
    Bbar = np.zeros((T, n, T * m))
    Ak = np.eye(n)
    for k in range(T):
        Ak = Ak @ A          # A^(k+1)
        Abar[k] = Ak
        for j in range(k + 1):
            Bbar[k, :, j * m : (j + 1) * m] = (
                np.linalg.matrix_power(A, k - j) @ B
            )
    # block-diagonal weights over stacked states
    Qs = [Q] * (T - 1) + [Qf]
    H = np.zeros((T * m, T * m))
    Gg = np.zeros((T * m, n))
    g_ref = np.zeros(T * m)
    for k in range(T):
        Qk = Qs[k]
        H += Bbar[k].T @ Qk @ Bbar[k]
        Gg += Bbar[k].T @ Qk @ Abar[k]
        g_ref += -Bbar[k].T @ Qk @ x_ref
    H += np.kron(np.eye(T), R)
    lip = float(np.linalg.eigvalsh(H).max())
    return CondensedQP(H=H, G=Gg, g_ref=g_ref, u_max=u_max, lipschitz=lip)


def condense_double_integrator(
    T: int = 50,
    dt: float = 1.0 / 32.0,
    q_pos: float = 1.0,
    q_vel: float = 0.1,
    r: float = 0.01,
    qf_scale: float = 10.0,
    u_max: float = 1.0,
    x_ref: Tuple[float, float] = (0.0, 0.0),
) -> CondensedQP:
    """Condensed QP for the exactly-discretized 1-D double integrator
    (the discrete map of pint_tpu.models.DoubleIntegrator)."""
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    Q = np.diag([q_pos, q_vel])
    Qf = qf_scale * Q
    return condense_lti(A, B, Q, r, Qf, T, np.asarray(x_ref, float), u_max)


def quantize(
    qp: CondensedQP,
    iters_step: Optional[float] = None,
    g_shift: int = 12,
    pad_to: int = 64,
) -> QuantizedQP:
    """Quantize a condensed QP for the int8 PGD solvers.

    ``g_shift`` sets the fixed-point resolution of the step direction: the
    int32 pre-shift accumulator carries 2^g_shift sub-lane resolution, so
    gradient steps smaller than one int8 lane unit still accumulate across
    iterations (dithering-free but biased toward zero; adequate for PGD
    whose fixed points are at the box boundary or interior stationarity).
    """
    T = qp.H.shape[0]
    Tp = -(-T // pad_to) * pad_to
    alpha = iters_step if iters_step is not None else 1.0 / qp.lipschitz
    u_scale = qp.u_max / 127.0

    aH = alpha * qp.H  # dimensionless (maps lane units to lane units)
    h_scale = float(np.abs(aH).max()) / 127.0
    Hq = np.zeros((Tp, Tp), dtype=np.int8)
    Hq[:T, :T] = np.round(aH / h_scale).astype(np.int8)

    # d_pre = -(U_lane @ aH^T / u... ) in lane units * 2^g_shift:
    #   lane_delta_pre = -(U_lane @ Hq^T) * h_scale * 2^g_shift  - g_pre
    # we fold h_scale*2^g_shift into an int ratio applied in int32:
    #   hs_num / 2^hs_den ~ h_scale * 2^g_shift  (power-of-two friendly)
    # and the linear term g(x0) in the same pre-shift lane units:
    #   g_pre = alpha * g_phys / u_scale * 2^g_shift
    Gq_scale = alpha / u_scale * float(2**g_shift)

    # integer ratio for the matmul-accumulator rescale: pick the largest
    # hs_den such that |acc| * hs_num cannot overflow int32
    # (|acc| <= 127*127*Tp from the int8 matmul)
    val = h_scale * float(2**g_shift)
    acc_max = 127 * 127 * Tp
    num_max = (2**31 - 1) // acc_max
    # hs_den is an int32 arithmetic-shift amount: it must stay in [0, 31]
    hs_den = max(0, min(31, int(np.floor(np.log2(num_max / val)))))
    hs_num = int(round(val * 2**hs_den))
    if hs_num < 1:
        raise ValueError(
            f"step scale {val!r} cannot be represented as an int32 rational "
            "(problem scaling is degenerate); rescale the QP or raise g_shift"
        )
    if hs_num > num_max:
        raise ValueError(
            f"step scale {val!r} overflows the int32 accumulator budget "
            f"(hs_num={hs_num} > {num_max}); lower g_shift or rescale"
        )

    return QuantizedQP(
        qp=qp,
        Hq=Hq,
        h_scale=h_scale,
        g_shift=g_shift,
        Gq_scale=Gq_scale,
        u_scale=u_scale,
        horizon=T,
        padded=Tp,
        hs_num=hs_num,
        hs_den=hs_den,
    )
