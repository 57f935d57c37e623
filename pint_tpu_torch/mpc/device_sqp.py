"""Device-resident quantized SQP: the nonlinear-MPC iteration on one device.

PyTorch port of ``pint_tpu/mpc/device_sqp.py`` (``DeviceSQP``), default path
only.  Each SQP iteration, for a batch of problems at once:

* nominal rollout + linearization with the model's float32 twins
  (``rollout_f32``, ``linearize_f32``); for the unicycle these and the
  propagator recursion are one kernel
  (:func:`~pint_tpu_torch.mpc.propagate.chain_fused`), which writes the
  recursion's stacks bit for bit;
* condensation: the propagator recursion (``propagate``: "unroll", the
  step-by-step recursion; "scan" and "auto", the same recursion (see
  :meth:`DeviceSQP._propagate_mode`); "allpairs", the closed form from
  log-depth prefix products and per-step Gauss-Jordan inverses), then the
  Hessian contraction (``reduce``: "sym", the symmetric square
  ``Ht = W^T W`` with ``W = L^T B-stack`` and ``Q = L L^T``, for a PSD Q;
  "einsum", the two-operand form any Q takes; "blocked", 2 x 2 block
  triangular with the mirror; "btrans", one batched GEMM), keeping the
  Hessian batch-last (Tm, Tm, B).  The port keeps its stacks batch-first
  (B, T, n, ...); the contractions are batched f32 products;
* Lipschitz estimate + int8 quantization, then the int32 step rationals
  and linear term: in one pass (K3,
  :func:`~pint_tpu_torch.mpc.condense_fused.lipq_fused`) where
  :func:`~pint_tpu_torch.mpc.condense_fused.lipq_fits` takes the horizon
  and ``lipq`` is not False, otherwise in the torch form of the
  reference's ``lipq=False`` phases (:meth:`DeviceSQP._lipschitz_phase`,
  :meth:`DeviceSQP._quantize_phase`);
* the fixed-point PGD inner with error feedback: K4
  (:func:`~pint_tpu_torch.mpc.fused_alm.pgd_fused_words_pre`) where
  :func:`~pint_tpu_torch.mpc.fused_alm.pgd_fits` takes the horizon and
  ``fused`` is not False, otherwise the word-space ``ltv._pgd_batched_h``,
  the reference's XLA inner.

Each choice is made once, at construction, from the shapes
(:attr:`DeviceSQP.forms`), as the reference's ``_use_lipq`` and
``_use_fused`` gates choose, so every horizon solves on the card.  On a
CUDA device the chain's kernel, K3 and K4 are the hand-written kernels; on
the CPU their plain PyTorch versions.  ``use_kernels=False`` runs the plain
versions on any device: it is the reference the kernels are held to on the
card.
:meth:`DeviceSQP.sharded_solve_words` runs the same iteration on a (dp, tp)
process mesh; with tp > 1 its PGD inner is column-sharded over K10.

Each phase of an iteration is a host range in a ``torch.profiler`` trace
(:func:`~pint_tpu_torch.utils.profiling.span`), the phases siblings:
``pint.sqp.linearize``, ``pint.sqp.propagate``, ``pint.sqp.reduce``,
``pint.sqp.quantize`` (K3 or the torch phases, the linear term and the step
rationals) and ``pint.sqp.inner``; the chain's kernel is one launch inside
``pint.sqp.propagate``.  On a CUDA device
:meth:`DeviceSQP.solve_words` replays its iterations as one CUDA graph a
call shape from the shape's second call on, each replay a host range
``pint.sqp.replay`` (:mod:`pint_tpu_torch.utils.graphs`); the phases' ranges
then mark only the eager first call and the capture.

The f32 contractions must run in full f32: on a CUDA device the solver
refuses to run with ``torch.backends.cuda.matmul.allow_tf32`` set.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import Unicycle, unpack_controls
from pint_tpu_torch.mpc.condense_fused import (
    INV_127,
    lipq_fits,
    lipq_fused,
    lipq_plain,
    true_div,
)
from pint_tpu_torch.mpc.fused_alm import (
    pgd_fits,
    pgd_fused_words_pre,
    pgd_fused_words_pre_plain,
)
from pint_tpu_torch.mpc.ltv import (
    QuantizedSQP,
    _pgd_batched_h,
    _pgd_batched_h_cols,
    _pgd_batched_h_cols_hqt,
)
from pint_tpu_torch.mpc.propagate import chain_form, chain_fused, chain_plain
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.utils.graphs import _Graphed
from pint_tpu_torch.utils.profiling import span

__all__ = ["DeviceSQP"]

PROPAGATE = ("allpairs", "auto", "scan", "unroll")
REDUCE = ("einsum", "blocked", "btrans", "sym")


def _inv_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Batched small-matrix inverse by pivot-free Gauss-Jordan (the
    reference's ``_inv_unrolled``: n elementwise row updates over the
    batch).  Exact enough here: the inputs are one-step discretizations
    A = I + O(dt), so no pivot degenerates.  ``torch.linalg.inv`` would
    round differently."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    aug = torch.cat([M, eye], dim=-1)                       # (..., n, 2n)
    for p in range(n):
        pivot = aug[..., p, :] / aug[..., p, p : p + 1]
        aug = aug - aug[..., :, p : p + 1] * pivot[..., None, :]
        aug[..., p, :] = pivot
    return aug[..., :, n:]


def _block_diag(D: torch.Tensor) -> torch.Tensor:
    """(B, T, m, m) per-step blocks -> (B, T*m, T*m) block diagonal."""
    Bn, T, m, _ = D.shape
    eye = torch.eye(T, dtype=D.dtype, device=D.device)
    return torch.einsum("bpij,pq->bpiqj", D, eye).reshape(Bn, T * m, T * m)


def _assoc_scan(combine, x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``x`` along dim 1 in ``jax.lax.associative_scan``'s
    log-depth order (pairs combined, the odd prefixes by recursion, the
    even ones from them), so that each prefix is the same product tree as
    the reference's.  ``combine(earlier, later)``."""
    n = x.shape[1]
    if n < 2:
        return x
    odd = _assoc_scan(combine, combine(x[:, 0 : n - 1 : 2], x[:, 1::2]))
    even = combine(odd[:, :-1] if n % 2 == 0 else odd, x[:, 2::2])
    even = torch.cat([x[:, :1], even], dim=1)
    out = torch.empty_like(x)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def sharded_program(cache, mesh, dev, whole_inner, cols_inner, make_prog):
    """The scaffolding of both ``sharded_solve_words``: the program of
    ``mesh``, memoized in ``cache``.  ``dev`` (a :class:`DeviceSQP`) gives
    the device and the plan's width.  At tp == 1 the plan needs no gather
    and ``whole_inner`` runs; at tp > 1 one exact int32 all-gather an SQP
    iteration rebuilds the plan over the tp group and ``cols_inner(cols,
    block)`` builds the column inner of this rank's columns.
    ``make_prog(gather, inner)`` returns the callable."""
    prog = cache.get(mesh)
    if prog is not None:
        return prog
    from pint_tpu_torch.parallel.mesh import all_gather_cols, column_block

    if not K.same_device(mesh.device, dev.device):
        raise ValueError(f"mesh on {mesh.device}, solver on {dev.device}")
    block = column_block(dev.n_dec, mesh.tp, "horizon*n_ctrl =")
    if mesh.tp == 1:
        prog = make_prog(lambda lanes: lanes, whole_inner)
    else:
        cols = slice(mesh.r_tp * block, (mesh.r_tp + 1) * block)
        prog = make_prog(
            lambda lanes: all_gather_cols(lanes, mesh.tp_group, mesh.r_tp, mesh.tp),
            cols_inner(cols, block))
    cache[mesh] = prog
    return prog


def _f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """Round-half-even f32 -> int32, saturating like XLA's conversion
    (torch's own cast wraps out-of-range values)."""
    return torch.clamp(torch.round(x).to(torch.float64), -(2.0**31), 2.0**31 - 1).to(
        torch.int32
    )


def _power_lipschitz(apply, B: int, Tm: int, iters: int, device) -> torch.Tensor:
    """lambda_max per problem of the PSD operator ``apply`` ((B, Tm, 1) f32
    vectors to the same) with the 1.05 safety factor: ``iters`` normalised
    power steps from the constant unit vector, then the Rayleigh quotient,
    each a batched f32 product.  Returns (B,) f32."""
    v = torch.full((B, Tm, 1), float(np.float32(1.0 / np.sqrt(Tm))),
                   dtype=torch.float32, device=device)
    for _ in range(iters):
        w = apply(v)
        v = w / (torch.sqrt((w * w).sum(1, keepdim=True)) + 1e-30)
    return (v * apply(v)).sum((1, 2)) * float(np.float32(1.05))


@dataclasses.dataclass(frozen=True)
class DeviceSQP:
    """SQP trajectory optimizer on packed int8 plans, on one device.

    Same problem definition as ``pint_tpu``'s ``DeviceSQP``: symmetric lane
    box, cost sum (x_k - x_ref)^T Q (x_k - x_ref) + u^T R u with terminal Qf
    (``qf_scale * Q`` unless ``Qf`` is given).  ``horizon * n_ctrl`` must be
    a multiple of 4.  ``reduce="sym"`` needs Q PSD, which is checked at
    construction; ``"einsum"`` takes any Q."""

    model: object = dataclasses.field(default_factory=Unicycle)
    horizon: int = 48
    Q: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([1.0, 1.0, 0.02])
    )
    R: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([0.02, 0.02])
    )
    qf_scale: float = 20.0
    Qf: object = None
    x_ref: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    sqp_iters: int = 6
    pgd_iters: int = 40
    g_shift: int = 12
    power_iters: int = 16
    propagate: str = "auto"
    reduce: str = "sym"
    # keyword-only from here: the reference's next positions are
    # fused, fused_block (a TPU knob), lipq, lipq_block (one too)
    _: dataclasses.KW_ONLY
    lipq: "bool | None" = None
    fused: "bool | None" = None
    device: object = "cuda"
    use_kernels: bool = True

    def __post_init__(self):
        if self.propagate not in PROPAGATE:
            raise ValueError(f"propagate must be one of {PROPAGATE}, got {self.propagate!r}")
        if self.reduce not in REDUCE:
            raise ValueError(f"reduce must be one of {REDUCE}, got {self.reduce!r}")
        if self.n_dec % 4:
            raise ValueError(
                f"horizon*n_ctrl = {self.n_dec} must be a multiple of 4 "
                "(int8 lanes pack 4-per-word)"
            )
        n = np.asarray(self.Q).shape[0]
        if np.asarray(self.Q).shape != (n, n):
            raise ValueError(f"Q must be square, got {np.asarray(self.Q).shape}")
        if np.asarray(self.R).shape != (self.n_ctrl, self.n_ctrl):
            raise ValueError(
                f"R has shape {np.asarray(self.R).shape}; the model has "
                f"{self.n_ctrl} control channel(s)"
            )
        object.__setattr__(self, "device", K.resolve_device(self.device))
        if self.reduce == "sym":
            self._Q_sqrt  # validate Q (PSD) now, not at the first solve
        self.forms    # choose each stage's form now, from the shapes

    @functools.cached_property
    def forms(self) -> dict:
        """The form each stage of an SQP iteration takes, chosen from the
        model and the shapes alone: ``chain`` is "fused" (rollout,
        linearization and the recursion in one kernel,
        :func:`~pint_tpu_torch.mpc.propagate.chain_fused`, or its plain
        version) where the model has ``fused_chain`` (the :class:`Unicycle`)
        and the iteration runs the recursion (:meth:`_propagate_mode` "unroll"), else "torch"
        (:meth:`_linearize_phase`, then the recursion or "allpairs");
        ``condense`` is "lipq" (K3; its plain version with
        ``use_kernels=False`` or on the CPU) where ``lipq`` is not False and
        :func:`lipq_fits` takes ``n_dec``, else "torch"
        (:meth:`_lipschitz_phase` and :meth:`_quantize_phase`); ``inner`` is
        "pgd_hqt" (K4, or its plain version) where ``fused`` is not False
        and :func:`pgd_fits` takes ``n_dec``, else "pgd_batched_h" (the
        word-space ``ltv._pgd_batched_h``).  ``lipq=True`` past K3's fit
        takes the torch form, as the reference's ``_use_lipq`` does past
        ``lipq_viable``; ``fused=True`` past K4's fit takes the word-space
        inner, as its ``_use_fused`` does past ``pgd_viable``."""
        return dict(
            chain=chain_form(self.model, self._propagate_mode() == "unroll"),
            condense="lipq" if self.lipq is not False and lipq_fits(self.n_dec)
            else "torch",
            inner="pgd_hqt" if self.fused is not False and pgd_fits(self.n_dec)
            else "pgd_batched_h",
        )

    # -- geometry (the problem definition is QuantizedSQP's, so are these
    # members, the true nonlinear objective of cost parity among them) ------

    _lane_scales = QuantizedSQP._lane_scales
    n_ctrl = QuantizedSQP.n_ctrl
    n_dec = QuantizedSQP.n_dec
    Qf_matrix = QuantizedSQP.Qf_matrix
    true_cost = QuantizedSQP.true_cost
    _check_dims = QuantizedSQP._check_dims

    def init_words(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self.n_dec // 4), dtype=torch.int32, device=self.device
        )

    @functools.cached_property
    def _Q_sqrt(self) -> np.ndarray:
        """PSD square root L of Q (Q = L L^T), via eigh so semidefinite Q
        works; raises for an indefinite Q."""
        Qn = np.asarray(self.Q, np.float64)
        w, V = np.linalg.eigh((Qn + Qn.T) / 2.0)
        if w.min() < -1e-9 * max(1.0, w.max()):
            raise ValueError(
                f"reduce='sym' needs Q PSD; eigenvalues {w}. For an indefinite "
                "Q use reduce='einsum'."
            )
        return V * np.sqrt(np.clip(w, 0.0, None))

    @functools.cached_property
    def _consts(self):
        """Q, Qf - Q, R_kron, x_ref, L (Q = L L^T; for ``reduce="sym"``)
        and the lane scales as f32 tensors on the device."""
        T = self.horizon
        s = self._lane_scales
        R_lane = s[:, None] * np.asarray(self.R) * s[None, :]
        Q = np.asarray(self.Q, np.float64)
        x_ref = np.broadcast_to(np.asarray(self.x_ref, np.float64), (T, Q.shape[0]))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        return dict(
            Q=f32(Q),
            dQ=f32(self.Qf_matrix - Q),
            R_kron=f32(np.kron(np.eye(T), R_lane)),
            x_ref=f32(x_ref),
            L=f32(self._Q_sqrt) if self.reduce == "sym" else None,
            s=f32(s),
        )

    # -- condensation -----------------------------------------------------------

    def _linearize_phase(self, x0_f, lanes):
        """f32 rollout + linearization around the lane plan ``lanes`` (B,
        T m), T read from its width.  Returns (A_seq (B,T,n,n), B_lane
        (B,T,n,m) lane-scaled, c_seq (B,T,n))."""
        m = self.n_ctrl
        s = self._consts["s"]
        u_phys = lanes.reshape(lanes.shape[0], -1, m).to(torch.float32) * s
        traj = self.model.rollout_f32(x0_f, u_phys)
        n = traj.shape[-1]
        if np.asarray(self.Q).shape != (n, n):
            raise ValueError(
                f"Q has shape {np.asarray(self.Q).shape}; the model's state "
                f"dim is {n}"
            )
        A_seq, B_seq = self.model.linearize_f32(traj[:, :-1], u_phys)
        c_seq = (
            traj[:, 1:]
            - (A_seq * traj[:, :-1, None, :]).sum(-1)
            - (B_seq * u_phys[:, :, None, :]).sum(-1)
        )
        return A_seq, B_seq * s, c_seq

    def _propagate_unrolled(self, A_seq, B_lane, c_seq):
        """The propagator recursion, unrolled over the horizon, batch first:
        P_k = A_k P_{k-1}, S_k = A_k S_{k-1} + [0..B_k..0], c_k = A_k
        c_{k-1} + c_k.  Returns (Abar (B,T,n,n), Bbar (B,T,n,Tm),
        Cbar (B,T,n)), T and m read from the shapes."""
        Bn, T, n, _ = A_seq.shape
        m = B_lane.shape[-1]
        dev = A_seq.device
        P = torch.eye(n, dtype=torch.float32, device=dev).expand(Bn, n, n)
        S = torch.zeros((Bn, n, T * m), dtype=torch.float32, device=dev)
        c = torch.zeros((Bn, n), dtype=torch.float32, device=dev)
        Ps, Ss, cs = [], [], []
        for k in range(T):
            Ak = A_seq[:, k]
            P = (Ak[:, :, :, None] * P[:, None, :, :]).sum(2)
            S = (Ak[:, :, :, None] * S[:, None, :, :]).sum(2)
            S[:, :, k * m : (k + 1) * m] += B_lane[:, k]
            c = (Ak * c[:, None, :]).sum(-1) + c_seq[:, k]
            Ps.append(P)
            Ss.append(S)
            cs.append(c)
        return torch.stack(Ps, 1), torch.stack(Ss, 1), torch.stack(cs, 1)

    def _stacks(self, x0_f, lanes, chain):
        """The propagator stacks (Abar, Bbar, Cbar) around the lane plan in
        the form ``chain`` names (a solver's ``forms["chain"]``):
        :func:`~pint_tpu_torch.mpc.propagate.chain_fused` where it is
        "fused" and ``use_kernels`` holds, else its plain version,
        :meth:`_linearize_phase` then :meth:`_propagate_unrolled`."""
        fused = chain == "fused" and self.use_kernels
        return (chain_fused if fused else chain_plain)(self, x0_f, lanes)

    def _condense_allpairs(self, A_seq, B_lane, c_seq, x0_f):
        """``propagate="allpairs"``: the closed-form condensation of the
        reference's ``_condense_allpairs``, batch-first.  Prefix products
        P_k = A_k ... A_0 and their inverses (per-step Gauss-Jordan
        inverses, :func:`_inv_unrolled`) by log-depth scans in the
        reference's combine order, W_j = P_j^-1 B_j, the suffix sums
        M'_j = sum_{k>=j} P_k^T Q P_k + P_{T-1}^T (Qf-Q) P_{T-1} and
        r_j likewise, then H[j1, j2] = W_{j1}^T M'_{max} W_{j2} (+ R_kron),
        g = G x0 + [W_j^T r_j]_j.  Returns (H (B, Tm, Tm), g (B, Tm))."""
        c = self._consts
        T, m = self.horizon, self.n_ctrl
        Q, dQ = c["Q"], c["dQ"]
        P = _assoc_scan(lambda x, y: y @ x, A_seq)                # (B,T,n,n)
        Pinv = _assoc_scan(lambda x, y: x @ y, _inv_unrolled(A_seq))
        W = Pinv @ B_lane                                        # (B,T,n,m)
        v = torch.einsum("bjin,bjn->bji", Pinv, c_seq)
        Cbar = torch.einsum("bkin,bkn->bki", P, torch.cumsum(v, dim=1))
        Cx = Cbar - c["x_ref"]                                   # (B,T,n)
        QP = torch.einsum("ij,bkjq->bkiq", Q, P)
        E = torch.einsum("bkiq,bkir->bkqr", QP, P)               # P_k^T Q P_k
        PT = P[:, T - 1]
        FT = torch.einsum("biq,ij,bjr->bqr", PT, dQ, PT)
        Mp = torch.flip(torch.cumsum(torch.flip(E, [1]), 1), [1]) + FT[:, None]
        d = torch.einsum("bkiq,bki->bkq", QP, Cx)
        r = torch.flip(torch.cumsum(torch.flip(d, [1]), 1), [1])
        r = r + torch.einsum("biq,ij,bj->bq", PT, dQ, Cx[:, T - 1])[:, None]
        Y = Mp @ W                                               # (B,T,n,m)
        U = torch.einsum("bpni,bqnj->bpiqj", W, Y)               # (B,T,m,T,m)
        idx = torch.arange(T, device=U.device)
        mask = (idx[:, None] <= idx[None, :]).to(U.dtype)
        U = (U * mask[None, :, None, :, None]).reshape(-1, T * m, T * m)
        D = torch.einsum("bpni,bpnj->bpij", W, Y)
        H = U + U.transpose(1, 2) - _block_diag(D) + c["R_kron"]
        g_x0 = torch.einsum("bpqm,bq->bpm", Y, x0_f)
        g_ref = torch.einsum("bpni,bpn->bpi", W, r)
        return H, (g_x0 + g_ref).reshape(-1, T * m)

    def _reduce_linear(self, BQ, BQT, Abar, Cx, x0_f):
        """The linear term g = G x0 + g_ref from the Q-weighted stacks BQ
        (B,T,n,Tm) and BQT (B,n,Tm) (the reference's ``_reduce_linear``;
        n-contractions, shared by the einsum, blocked and btrans forms)."""
        T = self.horizon
        G = torch.einsum("btjn,btjq->bnq", BQ, Abar)
        G = G + torch.einsum("bjn,bjq->bnq", BQT, Abar[:, T - 1])
        g_ref = torch.einsum("btjn,btj->bn", BQ, Cx)
        g_ref = g_ref + torch.einsum("bjn,bj->bn", BQT, Cx[:, T - 1])
        return torch.einsum("bnq,bq->bn", G, x0_f) + g_ref

    def _weighted(self, Bbar, Cbar):
        """(BQ = Q-weighted Bbar (B,T,n,Tm), BT = Bbar_{T-1}, BQT = its
        (Qf - Q)-weighted form (B,n,Tm), Cx = Cbar - x_ref)."""
        c = self._consts
        BQ = torch.einsum("btin,ij->btjn", Bbar, c["Q"])
        BT = Bbar[:, self.horizon - 1]
        BQT = torch.einsum("bin,ij->bjn", BT, c["dQ"])
        return BQ, BT, BQT, Cbar - c["x_ref"]

    def _reduce_phase(self, Abar, Bbar, Cbar, x0_f):
        """``reduce="einsum"``: Ht = sum_k BQ_k^T Bbar_k + BQT^T B_T +
        R_kron, the two-operand form any Q takes (an indefinite Q too).
        Returns (Ht (Tm, Tm, B) batch-last, g (B, Tm))."""
        BQ, BT, BQT, Cx = self._weighted(Bbar, Cbar)
        Hb = torch.einsum("btjn,btjm->bnm", BQ, Bbar)
        Hb = Hb + torch.einsum("bjn,bjm->bnm", BQT, BT) + self._consts["R_kron"]
        return self._hand_over(Hb), self._reduce_linear(BQ, BQT, Abar, Cx, x0_f)

    def _reduce_blocked(self, Abar, Bbar, Cbar, x0_f):
        """``reduce="blocked"``: the einsum form as a 2 x 2 block-triangular
        Ht, the lower-left block the upper-right's exact transpose (steps
        before T/2 add nothing to the blocks of the second half's columns).
        Returns (Ht (Tm, Tm, B), g (B, Tm))."""
        T, m = self.horizon, self.n_ctrl
        Th = T // 2
        h = Th * m
        BQ, BT, BQT, Cx = self._weighted(Bbar, Cbar)
        lo, hi = slice(0, h), slice(h, self.n_dec)

        def block(k0, a, b):
            return (torch.einsum("btjn,btjm->bnm", BQ[:, k0:, :, a], Bbar[:, k0:, :, b])
                    + torch.einsum("bjn,bjm->bnm", BQT[:, :, a], BT[:, :, b]))

        H_ll, H_lh, H_hh = block(0, lo, lo), block(Th, lo, hi), block(Th, hi, hi)
        top = torch.cat([H_ll, H_lh], dim=2)
        bot = torch.cat([H_lh.transpose(1, 2), H_hh], dim=2)
        Hb = torch.cat([top, bot], dim=1) + self._consts["R_kron"]
        return self._hand_over(Hb), self._reduce_linear(BQ, BQT, Abar, Cx, x0_f)

    def _reduce_btrans(self, Abar, Bbar, Cbar, x0_f):
        """``reduce="btrans"``: the einsum form as one batched GEMM over the
        flattened (B, T*n, Tm) stacks.  Returns (Ht (Tm, Tm, B), g (B, Tm))."""
        T = self.horizon
        Bn, _, n, Tm = Bbar.shape
        BQ, BT, BQT, Cx = self._weighted(Bbar, Cbar)
        Hb = torch.bmm(BQ.reshape(Bn, T * n, Tm).transpose(1, 2), Bbar.reshape(Bn, T * n, Tm))
        Hb = Hb + torch.bmm(BQT.transpose(1, 2), BT) + self._consts["R_kron"]
        return self._hand_over(Hb), self._reduce_linear(BQ, BQT, Abar, Cx, x0_f)

    def _reduce_sym(self, Abar, Bbar, Cbar, x0_f):
        """``reduce="sym"``: Ht = W^T W + BQT^T B_T + R_kron with
        W = L^T Bbar (the terminal ``Qf - Q`` term, not necessarily PSD,
        stays two-operand); g = G x0 + g_ref.  Returns (Ht (Tm, Tm, B)
        batch-last, g (B, Tm))."""
        c = self._consts
        T, Tm = self.horizon, self.n_dec
        Bn, _, n, _ = Bbar.shape
        L = c["L"]
        Cx = Cbar - c["x_ref"]                                   # (B,T,n)
        W = torch.einsum("btin,il->btln", Bbar, L)               # (B,T,n,Tm)
        Wf = W.reshape(Bn, T * n, Tm)
        BT = Bbar[:, T - 1]                                      # (B,n,Tm)
        BQT = torch.einsum("bin,ij->bjn", BT, c["dQ"])           # (B,n,Tm)
        Hb = torch.bmm(Wf.transpose(1, 2), Wf)
        Hb = Hb + torch.bmm(BQT.transpose(1, 2), BT) + c["R_kron"]
        LA = torch.einsum("btjq,jl->btlq", Abar, L)              # (B,T,n,n)
        LCx = torch.einsum("btj,jl->btl", Cx, L)                 # (B,T,n)
        G = torch.einsum("btln,btlq->bnq", W, LA)
        G = G + torch.einsum("bjn,bjq->bnq", BQT, Abar[:, T - 1])
        g_ref = torch.einsum("btln,btl->bn", W, LCx)
        g_ref = g_ref + torch.einsum("bjn,bj->bn", BQT, Cx[:, T - 1])
        g = (G * x0_f[:, None, :]).sum(-1) + g_ref
        return self._hand_over(Hb), g

    def _propagate_mode(self) -> str:
        """The propagation form an iteration runs: "allpairs", or the
        recursion ("unroll") for "unroll", "scan" and "auto".  The
        reference's "scan" feeds each step's control block through a
        materialized (T, n, Tm, B) injection tensor; adding its zeros
        changes no bit, so on the port scan and unroll are the same
        computation and run the same code.  The reference's "auto" picks
        between those two by a TPU crossover, so here it is the recursion
        at every horizon.  "allpairs" is a different computation (its (H, g)
        differ from the recursion's in roundoff, within 1e-4 of max) and is
        taken only by name, as in the reference.  On one H100 80GB HBM3 at
        700 W, ``chip_smoke.py``'s ``phase_forms`` times it against the
        recursion (kernel device ms of one SQP iteration of the unicycle,
        whose recursion is one kernel, B = 4096): slower at every T, from
        T = 8 (1.209 against 0.299) to T = 64 (10.175 against 5.804)."""
        return "allpairs" if self.propagate == "allpairs" else "unroll"

    def _hand_over(self, Hb):
        """Ht (Tm, Tm, B), ``Ht[k, j, b] = Hb[b, k, j]``, from the
        batch-first condensed Hessian Hb (B, Tm, Tm) that every form
        computes, in the order the kernels at Tm take: past 64 rows
        (:data:`~pint_tpu_torch.ops.kernels.LONG_LANES`) Hb's problem-major
        view, which K3's long form and the torch phases read without a copy
        (a batch-last copy reads and writes 1.07 GB at Tm 256, B 4096); to 64
        one batch-last copy, which K3's register kernel stages by TMA boxes
        of 8 problems."""
        Ht = Hb.contiguous().permute(1, 2, 0)
        return Ht if self.n_dec > K.LONG_LANES else Ht.contiguous()

    def _reduce(self, Abar, Bbar, Cbar, x0_f):
        """The contraction ``reduce`` names: (Ht (Tm, Tm, B), g (B, Tm))."""
        red = {"einsum": self._reduce_phase, "blocked": self._reduce_blocked,
               "btrans": self._reduce_btrans, "sym": self._reduce_sym}[self.reduce]
        return red(Abar, Bbar, Cbar, x0_f)

    def _condense_ht(self, x0_f, lanes):
        """f32 linearize + condense in the configured ``propagate`` and
        ``reduce`` forms: (Ht (Tm, Tm, B), g (B, Tm))."""
        if self._propagate_mode() == "allpairs":
            with span("pint.sqp.linearize"):
                A_seq, B_lane, c_seq = self._linearize_phase(x0_f, lanes)
            with span("pint.sqp.propagate"):
                H, g = self._condense_allpairs(A_seq, B_lane, c_seq, x0_f)
            with span("pint.sqp.reduce"):
                return self._hand_over(H), g
        stacks = self._stacks(x0_f, lanes, self.forms["chain"])
        with span("pint.sqp.reduce"):
            return self._reduce(*stacks, x0_f)

    def _condense_hg(self, x0_f, lanes):
        """(H (B, Tm, Tm), g (B, Tm)): the batch-first public layout."""
        Ht, g = self._condense_ht(x0_f, lanes)
        return Ht.permute(2, 0, 1), g

    def _g_pre_from(self, g, alpha):
        """int32 pre-shift linear term from f32 g (B, Tm) and per-problem
        step alpha, saturating non-finite values like the reference."""
        gs = torch.nan_to_num(
            g * (alpha * float(2.0**self.g_shift))[:, None],
            nan=0.0, posinf=2.0**31 - 1, neginf=-(2.0**31),
        )
        return _f32_to_i32(gs)

    def _step_rationals(self, h_scale):
        """int32 rational num / 2**den ~ h_scale * 2**g_shift."""
        val = h_scale * float(2.0**self.g_shift)
        num_max = float(np.float32((2**31 - 1) // (127 * 127 * self.n_dec)))
        hs_den = torch.clamp(torch.floor(torch.log2(true_div(num_max, val))), 0, 31)
        hs_num = _f32_to_i32(val * torch.exp2(hs_den))
        return hs_num, hs_den.to(torch.int32)

    def _lipschitz_phase(self, Ht):
        """Power iteration for lambda_max(H) (PSD) with the 1.05 safety
        factor, on Ht (Tm, Tm, B) in either order: the torch form of the
        reference's ``_lipschitz_phase`` (``pint_tpu/mpc/device_sqp.py:
        645-667``).  Ht's batch-first view (one copy where Ht is batch-last,
        to 64 rows), then each step is one
        batched f32 product that allocates only (B, Tm) vectors.  Sums run
        in the GEMM's order, not XLA's: against JAX ``lip`` agrees to f32
        roundoff.  Returns lip (B,)."""
        Tm, _, B = Ht.shape
        Hb = Ht.permute(2, 0, 1).contiguous()  # (B, k, j): a view past 64 rows
        return _power_lipschitz(lambda v: torch.bmm(Hb, v), B, Tm, self.power_iters,
                                Ht.device)

    def _quantize_phase(self, Ht, g, lip):
        """int8 Hessian, int32 linear term and step rationals from Ht
        (Tm, Tm, B), g (B, Tm) and lip (B,): the torch form of
        the reference's ``_quantize_phase`` (``pint_tpu/mpc/device_sqp.py:
        759-780``), bit for bit given the same Ht, g and lip.  ``1.0 / lip``
        and ``127.0 / h_max`` are IEEE divisions; XLA compiles ``alpha *
        h_max / 127.0`` as a multiply by f32(1/127).  Returns (hqt
        (Tm, Tm, B) int8 in the kernel orientation, ``hqt[k, j, b] =
        Hq_b[j, k] = q(Ht[j, k, b])``, problem-major past 64 rows and
        batch-last to it, g_pre, hs_num, hs_den)."""
        alpha = true_div(1.0, lip)
        long = Ht.shape[0] > K.LONG_LANES
        Hb = Ht.permute(2, 0, 1)                                 # (B, k, j)
        if long:        # the problem-major view the reduce hands over
            Hb = Hb.contiguous()
        h_max = torch.amax(torch.abs(Hb), dim=(1, 2))
        q = Hb * true_div(127.0, h_max)[:, None, None]
        hq = q.round_().clamp_(-127, 127).to(torch.int8)
        del q  # a GiB of f32 at T = 128, B = 4096: free it first
        hs_num, hs_den = self._step_rationals(alpha * h_max * INV_127)
        hqt = hq.permute(2, 1, 0)   # past 64 rows problem-major with rows j
        return ((hqt if long else hqt.contiguous()), self._g_pre_from(g, alpha),
                hs_num, hs_den)

    def _quantize(self, Ht, g, form, extra_lip=None):
        """The quantization step of an SQP iteration from Ht (Tm, Tm, B)
        and g (B, Tm), in the form ``form`` names (a solver's
        ``forms["condense"]``): "lipq", K3 (its plain version with
        ``use_kernels=False`` or on the CPU), or "torch",
        :meth:`_lipschitz_phase` then :meth:`_quantize_phase`.
        ``extra_lip`` (B,), where given, is added to lip before the step
        ``alpha = 1 / lip``.  Returns ((hqt (Tm, Tm, B) int8 in the kernel
        orientation, g_pre (B, Tm) int32, hs_num, hs_den (B,) int32), alpha
        (B,) f32)."""
        if form == "torch":
            lip = self._lipschitz_phase(Ht)
        else:
            lipq = lipq_fused if self.use_kernels else lipq_plain
            hqt, lip, h_max = lipq(Ht, power_iters=self.power_iters)
        if extra_lip is not None:
            lip = lip + extra_lip
        alpha = true_div(1.0, lip)
        if form == "torch":
            return self._quantize_phase(Ht, g, lip), alpha
        _, hs_num, hs_den = self._lipq_rationals(alpha, h_max)
        return (hqt, self._g_pre_from(g, alpha), hs_num, hs_den), alpha

    def _condense(self, x0_f, lanes):
        """Condense and quantize in the form ``forms["condense"]`` names
        (:meth:`_quantize`): (hqt (Tm, Tm, B) int8 in the kernel
        orientation, g_pre (B, Tm) int32, hs_num, hs_den (B,) int32), the
        operands of either inner and of both sharded inners."""
        Ht, g = self._condense_ht(x0_f, lanes)
        with span("pint.sqp.quantize"):
            return self._quantize(Ht, g, self.forms["condense"])[0]

    def _lipq_rationals(self, alpha, h_max):
        """(h_scale, hs_num, hs_den) from the step alpha and K3's h_max.
        The reference's jitted ``alpha * h_max / 127.0`` compiles to a
        multiply by f32(1/127), so that is what runs here."""
        h_scale = alpha * h_max * INV_127
        return (h_scale, *self._step_rationals(h_scale))

    def _run_inner(self, words, x0_f, lanes):
        """One SQP iteration: :meth:`_condense`, then the inner
        ``forms["inner"]`` names (all bit-identical given the same
        operands)."""
        hqt, g_pre, hs_num, hs_den = self._condense(x0_f, lanes)
        kw = dict(iters=self.pgd_iters, g_shift=self.g_shift)
        with span("pint.sqp.inner"):
            if self.forms["inner"] == "pgd_batched_h":
                return _pgd_batched_h(words, g_pre, hqt.permute(2, 1, 0).contiguous(),
                                      hs_num, hs_den, **kw)
            inner = pgd_fused_words_pre if self.use_kernels else pgd_fused_words_pre_plain
            return inner(words, g_pre, hqt, hs_num, hs_den, **kw)

    # -- public API -------------------------------------------------------------

    def _x0(self, x0_f) -> torch.Tensor:
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "DeviceSQP and DeviceConstrainedSQP need full-f32 GEMMs: set "
                "torch.backends.cuda.matmul.allow_tf32 = False"
            )
        return torch.as_tensor(x0_f, dtype=torch.float32, device=self.device)

    def _iterate(self, words, x0_f, gather, inner):
        """``sqp_iters`` SQP iterations: ``gather`` turns the iterate's lanes
        into the full plan the condensation linearizes around, ``inner``
        (words, x0_f, lanes) runs one condensation and PGD inner."""
        for _ in range(self.sqp_iters):
            lanes = gather(unpack_controls(words))[:, : self.n_dec]
            words = inner(words, x0_f, lanes)
        return words

    def solve_words(self, u_words: torch.Tensor, x0_f) -> torch.Tensor:
        """``sqp_iters`` SQP iterations.  u_words (B, Tm/4) int32 packed
        plan (warm start); x0_f (B, n) physical states.  On a CUDA device
        the iterations replay as one CUDA graph a call shape from the
        shape's second call on (:mod:`pint_tpu_torch.utils.graphs`)."""
        return self._graphed(u_words, self._x0(x0_f))

    @functools.cached_property
    def _graphed(self):
        return _Graphed(lambda words, x0_f: self._iterate(
            words, x0_f, lambda lanes: lanes, self._run_inner))

    @functools.cached_property
    def _sharded_cache(self) -> dict:
        return {}

    def sharded_solve_words(self, mesh):
        """The dp x tp sharded solve over ``mesh``
        (:func:`pint_tpu_torch.parallel.make_mesh`): a callable
        (u_words (B_loc, Tm/(4 tp)), x0_f (B_loc, n)) -> words on this
        rank's shards -- its dp block of the batch (states tp-replicated)
        and its tp block of the plan's words.

        **dp** shards problems.  **tp** shards the PGD inner's horizon
        columns: each SQP iteration one exact int32 all-gather rebuilds the
        lane plan, every tp rank runs the same f32 condensation and
        quantization on it (:meth:`_condense`, either form), and the column inner adds the rank's K10 matvec to an exact
        int32 all-reduce every iteration (:func:`~pint_tpu_torch.mpc.ltv.
        _pgd_batched_h_cols_hqt`; the plain column dot
        :func:`~pint_tpu_torch.mpc.ltv._pgd_batched_h_cols` with
        ``use_kernels=False`` or ``fused=False``, as the reference's
        ``resolve_tp_fused(False, ...)`` takes its XLA dot).  With tp == 1
        each shard runs :meth:`solve_words`'s iteration, in the inner
        ``forms["inner"]`` names, with no collective.

        Bit-identical to :meth:`solve_words` on every mesh shape as long as
        every tp rank computes the same f32 condensation and quantization
        bit for bit: the same operations on the same inputs on one kind of
        device, in either form.  Programs are memoized per mesh."""

        def cols_inner(cols, block):
            kw = dict(iters=self.pgd_iters, g_shift=self.g_shift,
                      group=mesh.tp_group, rank=mesh.r_tp, block=block)
            kernel = self.use_kernels and self.fused is not False

            def inner(words, x0_f, lanes):
                hqt, g_pre, hs_num, hs_den = self._condense(x0_f, lanes)
                with span("pint.sqp.inner"):
                    g_r = g_pre[:, cols].contiguous()
                    if kernel:
                        return _pgd_batched_h_cols_hqt(words, g_r, hqt, hs_num, hs_den,
                                                       **kw)
                    return _pgd_batched_h_cols(words, g_r, hqt.permute(2, 1, 0),
                                               hs_num, hs_den, **kw)

            return inner

        def make_prog(gather, inner):
            return lambda u_words, x0_f: self._iterate(
                u_words, self._x0(x0_f), gather, inner)

        return sharded_program(self._sharded_cache, mesh, self, self._run_inner,
                               cols_inner, make_prog)

    def solve(self, x0_f: np.ndarray):
        """Cold-start convenience: returns (words, physical plans (B, T, m)
        numpy)."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        words = self.solve_words(
            self.init_words(x0_f.shape[0]), x0_f.astype(np.float32)
        )
        lanes = unpack_controls(words)[:, : self.n_dec].cpu().numpy()
        plans = lanes.reshape(-1, self.horizon, self.n_ctrl) * self._lane_scales
        return words, plans
