"""Device-resident state-constrained SQP: nonlinear MPC with hard
``lo <= F x_k <= hi`` on one device.

PyTorch port of ``pint_tpu/mpc/device_constrained.py``
(``DeviceConstrainedSQP``), default path.  Each SQP iteration, for a batch
of problems at once:

* the condensation of :class:`~pint_tpu_torch.mpc.device_sqp.DeviceSQP`
  (f32 rollout + linearization, the propagator recursion in every
  ``dev.propagate`` form, for the unicycle all three in one kernel, then
  the contraction ``dev.reduce`` names);
* constraint-row stacking S = F Bbar, P = F Abar, r = F Cbar from the same
  propagator stacks, batch-last, in one kernel
  (:func:`~pint_tpu_torch.mpc.stack.stack_fused`) where
  :func:`~pint_tpu_torch.mpc.stack.stack_fits` takes the shape, else in two
  einsums;
* K3 (:func:`~pint_tpu_torch.mpc.condense_fused.lipq_fused`) on the
  Hessian where ``lipq`` is not False and
  :func:`~pint_tpu_torch.mpc.condense_fused.lipq_fits` takes Tm, and K6
  (:func:`~pint_tpu_torch.mpc.condense_fused.pen_fused`) on the constraint
  rows where K3 runs and
  :func:`~pint_tpu_torch.mpc.condense_fused.pen_fits` takes (C, Tm) (the
  reference's ``_use_lipq``): power
  iterations and int8 quantization in both kernel orientations; each
  otherwise in the torch form of the reference's ``lipq=False`` branch
  (``DeviceSQP._lipschitz_phase`` and ``DeviceSQP._quantize_phase``;
  :meth:`DeviceConstrainedSQP._pen_lipschitz` and
  :meth:`DeviceConstrainedSQP._quantize_rows`);
* the int32 rationals, bounds and offsets in c-pre units, and the
  multiplier rescale across relinearizations (lam lives in c-pre units
  whose per-problem scale moves with the trajectory);
* ``alm_outer x pgd_iters`` integer ALM iterations as the K5 kernel
  (:func:`~pint_tpu_torch.mpc.fused_alm.alm_fused_words_pre`) where
  :func:`~pint_tpu_torch.mpc.fused_alm.alm_fits` takes (Tp, Cp), otherwise
  the word-space ``_alm_batched``, the reference's XLA inner.

Each choice is made once, at construction, from the shapes
(:attr:`DeviceConstrainedSQP.forms`).

The device and ``use_kernels`` are ``dev``'s: on a CUDA device K3, K6 and
K5 are the hand-written kernels, on the CPU their plain versions, and
``use_kernels=False`` runs the plain versions on any device (the reference
the kernels are held to on the card).  ``fused=False`` runs the word-space
``_alm_batched`` inner instead of the lane-space one (bit-identical).

:meth:`DeviceConstrainedSQP.sharded_solve_words` runs the same iteration on
a (dp, tp) process mesh; with tp > 1 its ALM inner is column-sharded over
K10.

Each phase of an iteration is a host range in a ``torch.profiler`` trace,
the phases siblings: :class:`~pint_tpu_torch.mpc.device_sqp.DeviceSQP`'s
``pint.sqp.linearize``, ``pint.sqp.propagate``, ``pint.sqp.reduce``,
``pint.sqp.quantize`` and ``pint.sqp.inner``, and the constraints'
``pint.crti.stack`` (S, P, r), ``pint.crti.pen`` (K6 or the torch phases)
and ``pint.crti.scale`` (the ALM's rationals, bounds, offsets and the
multiplier rescale).  On a CUDA device
:meth:`DeviceConstrainedSQP.solve_words` replays them as one CUDA graph a
call shape from the shape's second call on, as ``DeviceSQP.solve_words``
does.

The f32 contractions must run in full f32: on a CUDA device the solver
refuses to run with ``torch.backends.cuda.matmul.allow_tf32`` set.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.condense_fused import (
    INV_127,
    lipq_fits,
    pen_fits,
    pen_fused,
    pen_plain,
    true_div,
)
from pint_tpu_torch.mpc.constrained import RATIONALS, _C_BITS, _CX0_CAP, _LAM_CAP
from pint_tpu_torch.mpc.device_sqp import (
    DeviceSQP,
    _f32_to_i32,
    _power_lipschitz,
    sharded_program,
)
from pint_tpu_torch.mpc.fused_alm import alm_fits, alm_fused_words_pre, alm_hqt_plain
from pint_tpu_torch.mpc.propagate import chain_form
from pint_tpu_torch.mpc.reduce import reduce_form
from pint_tpu_torch.mpc.stack import stack_fits, stack_fused, stack_plain
from pint_tpu_torch.mpc.sqp_constrained import (
    _Y_SHIFT,
    _alm_batched,
    _alm_batched_cols,
    _alm_batched_cols_hqt,
)
from pint_tpu_torch.utils.graphs import _Graphed
from pint_tpu_torch.utils.profiling import span

__all__ = ["DeviceConstrainedSQP"]

_REST = ("cs_num", "cs_den", "c_off", "lo_pre", "hi_pre", "eh_num", "eh_den",
         "el_num", "el_den")
"""The ALM inners' operands after the Hessian and constraint rows, in
their argument order."""


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts: round half to even, saturate, NaN to
    0 (so a non-finite problem's shift amounts stay in range)."""
    return _f32_to_i32(torch.nan_to_num(x, nan=0.0))


def _rational_traced(val: torch.Tensor, acc_max: int, budget: int):
    """int32 rational num/2**den ~ val (B,) (the on-device form of
    ``sqp_constrained._rational_vec``; no validation raises -- degenerate
    scales are the caller's documented precondition, as in the
    reference)."""
    num_max = float(np.float32(budget // acc_max))
    den = torch.clamp(torch.floor(torch.log2(true_div(num_max, val))), 0, 31)
    den = _to_i32(den)
    num = _to_i32(val * torch.exp2(den.to(torch.float32)))
    return num, den


def _pad_rows(x, dim, n):
    """The int8 rows ``x`` (d0, d1, B) zero-padded along ``dim`` (0 or 1)
    to ``n``, in x's own memory order: ``x`` itself when nothing is
    padded, batch-last stays batch-last, problem-major stays
    problem-major."""
    if x.shape[dim] == n:
        return x
    if x.is_contiguous():
        pad = [0] * 6
        pad[5 - 2 * dim] = n - x.shape[dim]
        return torch.nn.functional.pad(x, pad)
    pad = [0] * 4                                 # on the (B, d0, d1) stack
    pad[3 - 2 * dim] = n - x.shape[dim]
    return torch.nn.functional.pad(x.permute(2, 0, 1), pad).permute(1, 2, 0)


@dataclasses.dataclass(frozen=True)
class DeviceConstrainedSQP:
    """On-device SQP with hard per-step state constraints on packed plans.

    ``dev`` carries the model/cost geometry, the device and ``use_kernels``
    (:class:`DeviceSQP`; its ``sqp_iters``/``pgd_iters`` mean SQP outers /
    ALM inner PGD steps here); ``F`` is (Cs, n) over physical states,
    ``lo``/``hi`` scalar or (Cs,), enforced at every step k = 1..T of the
    linearized trajectory."""

    dev: DeviceSQP = dataclasses.field(default_factory=DeviceSQP)
    F: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([[0.0, 1.0, 0.0]])
    )
    lo: "float | np.ndarray" = -1.0
    hi: "float | np.ndarray" = 1.0
    rho: float = 50.0
    alm_outer: int = 3
    row_pad: int = 64
    fused: Optional[bool] = None
    # keyword-only from here: the reference's next position is fused_block,
    # a TPU knob
    _: dataclasses.KW_ONLY
    lipq: Optional[bool] = None

    def __post_init__(self):
        self._bounds  # validate lo < hi now, not at the first solve
        self.forms    # choose each stage's form now, from the shapes

    @functools.cached_property
    def forms(self) -> dict:
        """The form each stage of an SQP iteration takes, chosen from the
        model and the shapes alone: ``chain`` is "fused" (rollout,
        linearization and the recursion in one kernel,
        :func:`~pint_tpu_torch.mpc.propagate.chain_fused`, or its plain
        version) where ``dev``'s model has the chain kernel (the
        :class:`~pint_tpu_torch.models.dynamics.Unicycle` and the
        :class:`~pint_tpu_torch.models.quadrotor.PlanarQuadrotor`,
        :func:`~pint_tpu_torch.mpc.propagate.chain_form`), since the
        constraint rows run the recursion in every ``propagate`` form, else
        "torch"; ``reduce`` is "kernel" (one kernel,
        :func:`~pint_tpu_torch.mpc.reduce.reduce_fused`, or its plain
        version) where ``dev``'s ``reduce`` is "sym" and
        :func:`~pint_tpu_torch.mpc.reduce.reduce_fits` takes the shape, for
        the same reason, else "torch"; ``stack`` is "kernel" (one kernel,
        :func:`~pint_tpu_torch.mpc.stack.stack_fused`, or its plain version)
        where :func:`~pint_tpu_torch.mpc.stack.stack_fits` takes (n, Cs, T,
        Tm), else "torch" (two einsums); ``condense`` is "lipq" (K3, or its
        plain version) where ``lipq`` is not False and :func:`lipq_fits`
        takes Tm, else
        "torch"; ``constraints`` is "pen" (K6, or its plain version) where
        the condensation is "lipq" and :func:`pen_fits` takes (C, Tm), else
        "torch".  These are the reference's ``_use_lipq`` gates
        (``lipq_viable`` and ``pen_viable``): K6 runs wherever the reference
        runs it, and past K3's fit neither kernel runs.  ``inner`` is "alm"
        (K5, or its plain version) where ``fused`` is not False and
        :func:`alm_fits` takes (Tp, Cp), else "alm_batched" (the word-space
        ``_alm_batched``)."""
        Tm, C, Cp = self.dev.n_dec, self.n_rows, self.padded_rows
        lipq = self.lipq is not False and lipq_fits(Tm)
        Cs, n = self._F.shape
        return dict(
            chain=chain_form(self.dev.model, True),
            reduce=reduce_form(self.dev, True),
            stack="kernel" if stack_fits(n, Cs, self.dev.horizon, Tm) else "torch",
            condense="lipq" if lipq else "torch",
            constraints="pen" if lipq and pen_fits(C, Tm) else "torch",
            inner="alm" if self.fused is not False and alm_fits(Tm, Cp)
            else "alm_batched",
        )

    @property
    def device(self) -> torch.device:
        return self.dev.device

    @functools.cached_property
    def _F(self) -> np.ndarray:
        return np.atleast_2d(np.asarray(self.F, float))

    @functools.cached_property
    def _bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        Cs = self._F.shape[0]
        lo = np.broadcast_to(np.asarray(self.lo, float), (Cs,))
        hi = np.broadcast_to(np.asarray(self.hi, float), (Cs,))
        if np.any(lo >= hi):
            raise ValueError("state constraint lo must be < hi per row")
        T = self.dev.horizon
        return np.tile(lo, T), np.tile(hi, T)

    @property
    def n_rows(self) -> int:
        return self._F.shape[0] * self.dev.horizon

    @functools.cached_property
    def padded_rows(self) -> int:
        return -(-self.n_rows // self.row_pad) * self.row_pad

    def init_words(self, batch: int) -> torch.Tensor:
        return self.dev.init_words(batch)

    def init_lam(self, batch: int) -> torch.Tensor:
        return torch.zeros(
            (batch, self.padded_rows), dtype=torch.int32, device=self.device
        )

    @functools.cached_property
    def _consts(self) -> dict:
        """F, the padded bounds in physical units and b_amp, on the
        device."""
        lo_r, hi_r = self._bounds

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        return dict(F=f32(self._F), lo=f32(lo_r), hi=f32(hi_r),
                    b_amp=float(np.float32(max(np.abs(lo_r).max(),
                                               np.abs(hi_r).max()))))

    # -- condensation + constraint stacking -------------------------------------

    def _stack_constraints(self, Abar, Bbar, Cbar):
        """Constraint stacks from the batch-first propagators Abar
        (B,T,n,n), Bbar (B,T,n,Tm), Cbar (B,T,n): row k*Cs+c is constraint
        c at step k+1.  Returns S_t (C,Tm,B) contiguous (K6's input), P_t
        (C,n,B) and r_t (C,B), batch-last as in the reference; in the form
        ``forms["stack"]`` names: the kernel where ``use_kernels`` holds,
        else its plain version, or the torch form's two einsums."""
        if self.forms["stack"] == "kernel":
            stack = stack_fused if self.dev.use_kernels else stack_plain
            return stack(self._F, Abar, Bbar, Cbar)
        return self._stack_einsum(Abar, Bbar, Cbar)

    def _stack_einsum(self, Abar, Bbar, Cbar):
        """The torch form of :meth:`_stack_constraints`, past
        :func:`~pint_tpu_torch.mpc.stack.stack_fits`: two einsums and their
        batch-last copies."""
        Tm, C = self.dev.n_dec, self.n_rows
        Fj = self._consts["F"]                                    # (Cs, n)
        S_t = torch.einsum("ci,bkit->kctb", Fj, Bbar).reshape(C, Tm, -1)
        P_t = torch.einsum("ci,bkir->kcrb", Fj, Abar)
        P_t = P_t.reshape(C, Abar.shape[2], -1)
        r_t = torch.einsum("ci,bki->kcb", Fj, Cbar).reshape(C, -1)
        return S_t.contiguous(), P_t, r_t

    def _pen_lipschitz(self, S_t):
        """Power iteration for lambda_max(S S^T) per problem (it equals
        lambda_max(S^T S)) with the 1.05 safety factor, on the batch-last
        S_t (C, Tm, B): the torch form of the reference's
        ``_pen_lipschitz`` (``pint_tpu/mpc/device_constrained.py:185-203``).
        One batch-first copy of S_t, then two batched f32 products a step;
        against JAX it agrees to f32 roundoff.  Returns pen_lip (B,)."""
        _, Tm, B = S_t.shape
        Sb = S_t.permute(2, 0, 1).contiguous()                   # (B, C, Tm)
        SbT = Sb.transpose(1, 2)
        return _power_lipschitz(lambda v: torch.bmm(SbT, torch.bmm(Sb, v)), B, Tm,
                                self.dev.power_iters, S_t.device)

    def _quantize_rows(self, S_t):
        """The constraint rows' int8 quantization from S_t (C, Tm, B): the
        torch form of the reference's ``lipq=False`` branch
        (``pint_tpu/mpc/device_constrained.py:274-284``), bit for bit given
        the same S_t.  ``max|S| / 127`` compiles to a multiply by
        f32(1/127) and ``S_t / s_scale`` is an IEEE division.  Returns
        (sqc (C, Tm, B) int8, ``sqc[c, j, b] = Sq_b[c, j]``; s_scale (B,);
        row_amp (B,) = 127 max_c sum_j |S|)."""
        a = torch.abs(S_t)
        s_scale = torch.amax(a, dim=(0, 1)) * INV_127
        q = true_div(S_t, s_scale)
        sqc = q.round_().clamp_(-127, 127).to(torch.int8)
        return sqc, s_scale, 127.0 * torch.amax(a.sum(1), dim=0)

    def _condense_constrained_dev(self, x0_f, lanes):
        """Per-iteration prep: linearize, condense, stack, quantize in the
        forms ``forms["condense"]`` (K3, or the torch phases) and
        ``forms["constraints"]`` (K6, or the torch phases) name, the
        rationals, bounds and offsets.  Returns (ops dict, c_unit (B,)
        f32); ops carries the kernel-orientation int8 matrices
        ``hqt``/``sqj``/``sqc`` (constraint rows zero-padded to Cp) in the
        order their stage hands over: batch-last, or problem-major past 64
        lanes (K3's and the torch phases' ``hqt``) and past 64 rows or
        columns (K6's rows)."""
        d = self.dev
        Tp = d.n_dec
        C, Cp = self.n_rows, self.padded_rows
        c = self._consts

        # the constraint rows need the propagator stacks, so every
        # ``propagate`` form, "allpairs" too (the reference's allpairs takes
        # its scan here), runs the recursion
        Abar, Bbar, Cbar = d._stacks(x0_f, lanes, self.forms["chain"])
        with span("pint.sqp.reduce"):
            Ht, g = d._reduce(Abar, Bbar, Cbar, x0_f, self.forms["reduce"])
        with span("pint.crti.stack"):
            S_t, P_t, r_t = self._stack_constraints(Abar, Bbar, Cbar)
        rho = float(np.float32(self.rho))
        # the rows before the Hessian's step, which needs their pen_lip, so
        # that the Hessian's quantization is one phase
        with span("pint.crti.pen"):
            if self.forms["constraints"] == "pen":
                pen = pen_fused if d.use_kernels else pen_plain
                sqc, sqj, pen_lip, s_scale, row_amp = pen(S_t, power_iters=d.power_iters)
            else:
                pen_lip = self._pen_lipschitz(S_t)
                sqc, s_scale, row_amp = self._quantize_rows(S_t)
                sqj = sqc.transpose(0, 1).contiguous()
            sqc, sqj = _pad_rows(sqc, 0, Cp), _pad_rows(sqj, 1, Cp)
        with span("pint.sqp.quantize"):
            (hqt, g_pre, hs_num, hs_den), alpha = d._quantize(
                Ht, g, self.forms["condense"], rho * pen_lip)

        with span("pint.crti.scale"):
            c_unit = true_div(2.0 * (row_amp + c["b_amp"]), float(1 << _C_BITS))
            cs_num, cs_den = _rational_traced(
                true_div(s_scale, c_unit), 127 * 127 * Tp, 2**31 - 1)
            base = (
                rho * s_scale * float(1 << _Y_SHIFT)
                * c_unit * alpha
            ) * float(1 << d.g_shift)
            eh_num, eh_den = _rational_traced(base * 128.0, 64 * 127 * Cp, 2**30 - 1)
            el_num, el_den = _rational_traced(base, 127 * 127 * Cp, 2**30 - 1)

            sent = 1 << 30

            def bound(b_phys, fill):
                rows = torch.clamp(
                    torch.round(true_div(b_phys[None, :], c_unit[:, None])), -sent, sent)
                return torch.nn.functional.pad(_to_i32(rows), (0, Cp - C), value=fill)

            # constant offset rows: c_off = (x0 . P + r) / c_unit
            off = torch.einsum("bn,cnb->bc", x0_f, P_t) + r_t.T
            off = torch.nan_to_num(true_div(off, c_unit[:, None]), nan=0.0,
                                   posinf=_CX0_CAP, neginf=-_CX0_CAP)
            c_off = _to_i32(torch.clamp(torch.round(off), -_CX0_CAP, _CX0_CAP))
            ops = dict(
                g_pre=g_pre, hqt=hqt, hs_num=hs_num, hs_den=hs_den, sqj=sqj,
                sqc=sqc, cs_num=cs_num, cs_den=cs_den,
                c_off=torch.nn.functional.pad(c_off, (0, Cp - C)),
                lo_pre=bound(c["lo"], -sent), hi_pre=bound(c["hi"], sent),
                eh_num=eh_num, eh_den=eh_den, el_num=el_num, el_den=el_den,
            )
        return ops, c_unit

    def _run_inner(self, words, ops, lam):
        """The ALM inner on the quantized operands, in the form
        ``forms["inner"]`` names: K5 (its plain version with
        ``use_kernels=False``), or the word-space ``_alm_batched`` (with
        ``fused=False``, or past K5's fit) -- bit-identical given the same
        operands."""
        d = self.dev
        kw = dict(outer=self.alm_outer, inners=d.pgd_iters,
                  g_shift=d.g_shift, y_shift=_Y_SHIFT)
        rest = [ops[k] for k in _REST]
        if self.forms["inner"] == "alm_batched":
            return _alm_batched(
                words, ops["g_pre"], ops["hqt"].permute(2, 1, 0), ops["hs_num"],
                ops["hs_den"], ops["sqc"].permute(2, 0, 1), *rest, lam, **kw)
        if d.use_kernels:
            return alm_fused_words_pre(
                words, ops["g_pre"], ops["hqt"], ops["hs_num"], ops["hs_den"],
                ops["sqj"], ops["sqc"], *rest, lam, **kw)
        sc = torch.stack([ops[k] for k in RATIONALS])
        lanes, lam = alm_hqt_plain(
            unpack_controls(words), ops["g_pre"], ops["hqt"], ops["sqj"],
            ops["sqc"], ops["c_off"], ops["lo_pre"], ops["hi_pre"], lam, sc,
            **kw)
        return pack_controls(lanes), lam

    # -- public API --------------------------------------------------------------

    def _x0_lam(self, u_words, x0_f, lam):
        """Validated f32 states and multipliers (zeros when ``lam`` is
        None) for a batch of ``u_words``."""
        x0_f = self.dev._x0(x0_f)
        B = x0_f.shape[0]
        if self._F.shape[1] != x0_f.shape[-1]:
            raise ValueError(
                f"F has {self._F.shape[1]} columns, state dim is {x0_f.shape[-1]}"
            )
        if u_words.shape[0] != B:
            raise ValueError(f"u_words batch {u_words.shape[0]} != x0 batch {B}")
        if lam is None:
            lam = self.init_lam(B)
        elif tuple(lam.shape) != (B, self.padded_rows):
            raise ValueError(
                f"lam shape {tuple(lam.shape)} != ({B}, {self.padded_rows})"
            )
        return x0_f, lam

    def _iterate(self, words, x0_f, lam, gather, inner):
        """``dev.sqp_iters`` SQP iterations: ``gather`` turns the iterate's
        lanes into the full plan, ``inner`` (words, ops, lam) runs the ALM
        inner; between iterations the multipliers are rescaled to the new
        linearization's c-pre units."""
        cap = float(_LAM_CAP)
        prev_cu = None
        for _ in range(self.dev.sqp_iters):
            lanes = gather(unpack_controls(words))[:, : self.dev.n_dec]
            ops, c_unit = self._condense_constrained_dev(x0_f, lanes)
            with span("pint.crti.scale"):
                if prev_cu is None:
                    lam = torch.clamp(lam, -int(_LAM_CAP), int(_LAM_CAP))
                else:
                    # keep the physical value lam_pre * c_unit across the
                    # relinearization's new per-problem c_unit
                    scale = true_div(prev_cu, c_unit)
                    lam = _to_i32(torch.clamp(
                        torch.round(lam.to(torch.float32) * scale[:, None]), -cap, cap))
            with span("pint.sqp.inner"):
                words, lam = inner(words, ops, lam)
            prev_cu = c_unit
        return words, lam

    def solve_words(
        self,
        u_words: torch.Tensor,
        x0_f,
        lam: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``dev.sqp_iters`` constrained SQP iterations.

        x0_f (B, n) float32 physical states; u_words (B, Tm/4) int32 packed
        plan (warm start); lam (B, padded_rows) int32 multipliers (zeros
        when omitted).  Returns (words, lam) -- pass both back in for
        warm-started receding-horizon use.  On a CUDA device the
        iterations replay as one CUDA graph a call shape from the shape's
        second call on (:mod:`pint_tpu_torch.utils.graphs`)."""
        x0_f, lam = self._x0_lam(u_words, x0_f, lam)
        return self._graphed(u_words, x0_f, lam)

    @functools.cached_property
    def _graphed(self):
        return _Graphed(lambda words, x0_f, lam: self._iterate(
            words, x0_f, lam, lambda lanes: lanes, self._run_inner))

    @functools.cached_property
    def _sharded_cache(self) -> dict:
        return {}

    def sharded_solve_words(self, mesh):
        """The dp x tp sharded constrained solve over ``mesh``: a callable
        (u_words (B_loc, Tm/(4 tp)), x0_f (B_loc, n), lam (B_loc, Cp) or
        None) -> (words, lam) on this rank's shards; states and multipliers
        are tp-replicated.

        **dp** shards problems.  **tp** shards the ALM inner's horizon
        columns: each SQP iteration one exact int32 all-gather rebuilds the
        plan, every tp rank runs the same condensation and quantization
        (either form), and each
        inner iteration the rank's K10 launch over its combined gradient
        and constraint slab feeds one exact int32 all-reduce
        (:func:`~pint_tpu_torch.mpc.sqp_constrained._alm_batched_cols_hqt`;
        the plain column dots :func:`~pint_tpu_torch.mpc.sqp_constrained.
        _alm_batched_cols` with ``use_kernels=False`` or ``fused=False``).
        The multiplier plane and its rescale are computed identically on
        every tp rank, so ``lam`` needs no collective to stay replicated.
        With tp == 1 each shard runs the whole-column inner as
        :meth:`solve_words` does.  Bit-identical to :meth:`solve_words` on
        every mesh shape; programs are memoized per mesh."""
        d = self.dev

        def cols_inner(cols, block):
            kw = dict(outer=self.alm_outer, inners=d.pgd_iters, g_shift=d.g_shift,
                      y_shift=_Y_SHIFT, group=mesh.tp_group, rank=mesh.r_tp,
                      block=block)
            kernel = d.use_kernels and self.fused is not False

            def inner(words, ops, lam):
                g_r = ops["g_pre"][:, cols].contiguous()
                rest = [ops[k] for k in _REST]
                if kernel:
                    return _alm_batched_cols_hqt(
                        words, g_r, ops["hqt"], ops["hs_num"], ops["hs_den"],
                        ops["sqj"], *rest, lam, **kw)
                return _alm_batched_cols(
                    words, g_r, ops["hqt"].permute(2, 1, 0), ops["hs_num"],
                    ops["hs_den"], ops["sqc"].permute(2, 0, 1), *rest, lam, **kw)

            return inner

        def make_prog(gather, inner):
            def prog(u_words, x0_f, lam=None):
                x0_f, lam = self._x0_lam(u_words, x0_f, lam)
                return self._iterate(u_words, x0_f, lam, gather, inner)

            return prog

        return sharded_program(self._sharded_cache, mesh, d, self._run_inner,
                               cols_inner, make_prog)

    def solve(self, x0_f: np.ndarray):
        """Cold-start convenience: returns (words, lam, physical plans
        (B, T, m) numpy)."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float32))
        d = self.dev
        words, lam = self.solve_words(self.init_words(x0_f.shape[0]), x0_f)
        lanes = unpack_controls(words)[:, : d.n_dec].cpu().numpy()
        plans = lanes.reshape(-1, d.horizon, d.n_ctrl) * d._lane_scales
        return words, lam, plans

    def violation(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Max true-trajectory (f32 rollout) constraint violation per
        problem, on the host."""
        d = self.dev
        u_phys = torch.as_tensor(
            np.asarray(lanes).reshape(-1, d.horizon, d.n_ctrl) * d._lane_scales,
            dtype=torch.float32,
        )
        x0 = torch.as_tensor(np.atleast_2d(np.asarray(x0_f)), dtype=torch.float32)
        traj = d.model.rollout_f32(x0, u_phys)
        c = np.einsum("ci,bki->bkc", self._F, traj[:, 1:].numpy())
        Cs = self._F.shape[0]
        lo = self._bounds[0].reshape(-1, Cs)[0]
        hi = self._bounds[1].reshape(-1, Cs)[0]
        return np.maximum(
            np.maximum(c - hi, 0), np.maximum(lo - c, 0)
        ).max(axis=(1, 2))
