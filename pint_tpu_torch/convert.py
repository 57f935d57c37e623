"""Carry state across from the reference package.

Functions here take the reference's numpy arrays and plain dataclass fields
(never JAX objects), so the port still never imports jax.  A test uses them
to give both packages the same problem and the same warm words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch.models import DoubleIntegrator, Pendulum, PlanarQuadrotor, Unicycle
from pint_tpu_torch.mpc.condensed import CondensedQP, QuantizedQP
from pint_tpu_torch.mpc.constrained import (
    QuantizedConstrainedQP,
    StateConstrainedQP,
)
from pint_tpu_torch.mpc.controller import LTIController, RecedingHorizonController
from pint_tpu_torch.mpc.device_constrained import DeviceConstrainedSQP
from pint_tpu_torch.mpc.device_sqp import DeviceSQP
from pint_tpu_torch.mpc.ltv import QuantizedSQP
from pint_tpu_torch.mpc.mppi import QuantizedMPPI
from pint_tpu_torch.mpc.nonlinear import QuantizedNonlinearPGD
from pint_tpu_torch.mpc.sqp_constrained import ConstrainedSQP
from pint_tpu_torch.ops import kernels as K

__all__ = ["constrained_sqp_config", "device_constrained_config", "device_sqp_config",
           "lti_controller_config", "model_config", "mppi_config", "nonlinear_config",
           "quantized_constrained_qp_from_arrays", "quantized_qp_from_arrays",
           "quantized_sqp_config", "words_from_numpy", "words_to_numpy"]

_SIGNED = {np.dtype(np.uint8): np.int8, np.dtype(np.uint16): np.int16,
           np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def words_from_numpy(words: np.ndarray, device="cuda") -> torch.Tensor:
    """Unsigned numpy words (u8/u16/u32/u64) -> the port's signed container
    tensor holding the same bits (a ``.view``, no value conversion).  The
    reference's planar uint32 pair words ``(2, ...)`` become the int32 pairs
    that :mod:`pint_tpu_torch.ops.swar`'s pair entries take.  On the card
    unless ``device="cpu"`` is asked for; raises without a card."""
    device = K.resolve_device(device)
    words = np.asarray(words)
    signed = _SIGNED.get(words.dtype)
    if signed is None:
        raise ValueError(f"no container for words of dtype {words.dtype}")
    return torch.from_numpy(words.view(signed).copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's container tensor (words, or int32 pairs) -> unsigned
    numpy words, same bits."""
    a = words.detach().cpu().numpy()
    return a.view(np.dtype(f"uint{a.dtype.itemsize * 8}"))


def _condensed_qp_from_arrays(ref) -> CondensedQP:
    return CondensedQP(
        H=np.asarray(ref.H), G=np.asarray(ref.G), g_ref=np.asarray(ref.g_ref),
        u_max=float(ref.u_max), lipschitz=float(ref.lipschitz),
    )


def quantized_qp_from_arrays(ref) -> QuantizedQP:
    """The port's :class:`QuantizedQP` from a reference ``QuantizedQP``'s
    numpy fields (``ref.qp.H`` ... ``ref.hs_den``)."""
    return QuantizedQP(
        qp=_condensed_qp_from_arrays(ref.qp), Hq=np.asarray(ref.Hq, np.int8), h_scale=float(ref.h_scale),
        g_shift=int(ref.g_shift), Gq_scale=float(ref.Gq_scale),
        u_scale=float(ref.u_scale), horizon=int(ref.horizon),
        padded=int(ref.padded), hs_num=int(ref.hs_num), hs_den=int(ref.hs_den),
    )


_MODELS = {cls.__name__: cls for cls in (DoubleIntegrator, Pendulum, PlanarQuadrotor,
                                         Unicycle)}


def model_config(m):
    """The port's model with a reference model's dataclass fields."""
    cls = _MODELS.get(type(m).__name__)
    if cls is None:
        raise ValueError(f"no port of model {type(m).__name__}")
    return cls(**{f.name: getattr(m, f.name) for f in dataclasses.fields(cls)})


def device_sqp_config(ref, **overrides) -> DeviceSQP:
    """The port's :class:`DeviceSQP` with a reference ``DeviceSQP``'s
    problem fields (model, horizon, Q, R, Qf, x_ref, iterations, g_shift,
    power_iters, propagate, reduce) and its form flags ``lipq`` and
    ``fused``; ``overrides`` sets the port's own (``device``, ...)."""
    kw = dict(
        model=model_config(ref.model),
        horizon=int(ref.horizon),
        Q=np.asarray(ref.Q, float), R=np.asarray(ref.R, float),
        qf_scale=float(ref.qf_scale),
        Qf=None if ref.Qf is None else np.asarray(ref.Qf, float),
        x_ref=np.asarray(ref.x_ref, float),
        sqp_iters=int(ref.sqp_iters), pgd_iters=int(ref.pgd_iters),
        g_shift=int(ref.g_shift), power_iters=int(ref.power_iters),
        propagate=ref.propagate, reduce=ref.reduce,
        lipq=ref.lipq, fused=ref.fused,
    )
    kw.update(overrides)
    return DeviceSQP(**kw)


def quantized_constrained_qp_from_arrays(ref) -> QuantizedConstrainedQP:
    """The port's :class:`QuantizedConstrainedQP` from a reference one's
    numpy fields (``qqp`` through :func:`quantized_qp_from_arrays`)."""
    sc = ref.scqp
    scqp = StateConstrainedQP(
        qp=_condensed_qp_from_arrays(sc.qp), S=np.asarray(sc.S), P=np.asarray(sc.P), r=np.asarray(sc.r),
        lo=np.asarray(sc.lo), hi=np.asarray(sc.hi),
        penalty_lipschitz=float(sc.penalty_lipschitz),
    )
    ints = ("cs_num", "cs_den", "eh_num", "eh_den", "el_num", "el_den",
            "y_shift", "n_rows", "padded_rows")
    return QuantizedConstrainedQP(
        scqp=scqp, qqp=quantized_qp_from_arrays(ref.qqp), rho=float(ref.rho),
        Sq=np.asarray(ref.Sq, np.int8), s_scale=float(ref.s_scale),
        c_unit=float(ref.c_unit), lo_pre=np.asarray(ref.lo_pre, np.int32),
        hi_pre=np.asarray(ref.hi_pre, np.int32),
        **{k: int(getattr(ref, k)) for k in ints},
    )


def device_constrained_config(ref, **overrides) -> DeviceConstrainedSQP:
    """The port's :class:`DeviceConstrainedSQP` with a reference one's
    fields; ``dev`` through :func:`device_sqp_config` (so ``dev`` keeps the
    reference's ``dev.lipq`` and ``dev.fused``).  The reference's TPU-only
    ``fused_block`` and ``lipq_block`` are dropped.
    ``overrides`` sets fields of either: the constrained solver's own
    (``fused``, ``rho``, ...) and the rest on ``dev`` (``device``,
    ``use_kernels``, ...)."""
    own = {f.name for f in dataclasses.fields(DeviceConstrainedSQP)}
    dev_kw = {k: v for k, v in overrides.items() if k not in own}
    kw = dict(
        dev=device_sqp_config(ref.dev, **dev_kw),
        F=np.asarray(ref.F, float), lo=np.asarray(ref.lo, float),
        hi=np.asarray(ref.hi, float), rho=float(ref.rho),
        alm_outer=int(ref.alm_outer), row_pad=int(ref.row_pad),
        fused=ref.fused, lipq=ref.lipq,
    )
    kw.update({k: v for k, v in overrides.items() if k in own})
    return DeviceConstrainedSQP(**kw)


def quantized_sqp_config(ref, **overrides) -> QuantizedSQP:
    """The port's :class:`QuantizedSQP` with a reference ``QuantizedSQP``'s
    fields (the model through :func:`model_config`); ``overrides`` sets the
    port's own (``device``, ...)."""
    kw = dict(
        model=model_config(ref.model), horizon=int(ref.horizon),
        Q=np.asarray(ref.Q, float), R=np.asarray(ref.R, float),
        qf_scale=float(ref.qf_scale),
        Qf=None if ref.Qf is None else np.asarray(ref.Qf, float),
        x_ref=np.asarray(ref.x_ref, float), sqp_iters=int(ref.sqp_iters),
        pgd_iters=int(ref.pgd_iters), g_shift=int(ref.g_shift), pad_to=int(ref.pad_to),
    )
    kw.update(overrides)
    return QuantizedSQP(**kw)


def constrained_sqp_config(ref, **overrides) -> ConstrainedSQP:
    """The port's :class:`ConstrainedSQP` with a reference one's fields;
    ``sqp`` through :func:`quantized_sqp_config`.  ``overrides`` sets fields
    of either: the constrained solver's own (``rho``, ...) and the rest on
    ``sqp`` (``device``, ...)."""
    own = {f.name for f in dataclasses.fields(ConstrainedSQP)}
    kw = dict(
        sqp=quantized_sqp_config(ref.sqp, **{k: v for k, v in overrides.items()
                                             if k not in own}),
        F=np.asarray(ref.F, float), lo=np.asarray(ref.lo, float),
        hi=np.asarray(ref.hi, float), rho=float(ref.rho),
        alm_outer=int(ref.alm_outer), row_pad=int(ref.row_pad),
    )
    kw.update({k: v for k, v in overrides.items() if k in own})
    return ConstrainedSQP(**kw)


def lti_controller_config(ref, plant_step=None, **overrides):
    """The port's :class:`LTIController` or
    :class:`RecedingHorizonController` with a reference one's fields (its
    ``QuantizedQP`` through :func:`quantized_qp_from_arrays`).  An
    ``LTIController``'s plant step is a function of the caller's, on the
    port's tensors, and must be given; a ``RecedingHorizonController``
    steps its model (through :func:`model_config`).  ``overrides`` sets the
    port's own (``device``, ...)."""
    qqp = quantized_qp_from_arrays(ref.qqp)
    if type(ref).__name__ == "RecedingHorizonController":
        kw = dict(qqp=qqp, model=model_config(ref.model),
                  iters_per_tick=int(ref.iters_per_tick), use_fused=bool(ref.use_fused))
        kw.update(overrides)
        return RecedingHorizonController(**kw)
    if plant_step is None:
        raise ValueError("an LTIController needs the caller's plant_step on the "
                         "port's tensors")
    kw = dict(qqp=qqp, plant_step=plant_step, inputs_per_step=int(ref.inputs_per_step),
              frac_bits=int(ref.frac_bits), iters_per_tick=int(ref.iters_per_tick),
              use_fused=bool(ref.use_fused), error_feedback=bool(ref.error_feedback))
    kw.update(overrides)
    return LTIController(**kw)


def mppi_config(ref, **overrides) -> QuantizedMPPI:
    """The port's :class:`QuantizedMPPI` with a reference one's fields."""
    kw = dict(model=model_config(ref.model), horizon=int(ref.horizon),
              samples=int(ref.samples), noise_lanes=int(ref.noise_lanes),
              temperature=float(ref.temperature))
    kw.update(overrides)
    return QuantizedMPPI(**kw)


def nonlinear_config(ref, **overrides) -> QuantizedNonlinearPGD:
    """The port's :class:`QuantizedNonlinearPGD` with a reference one's
    fields."""
    kw = dict(model=model_config(ref.model), horizon=int(ref.horizon),
              iters=int(ref.iters), step_lanes=float(ref.step_lanes),
              final_lanes=float(ref.final_lanes))
    kw.update(overrides)
    return QuantizedNonlinearPGD(**kw)
