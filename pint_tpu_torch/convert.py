"""Carry state across from the reference package.

Functions here take the reference's numpy arrays and plain dataclass fields
(never JAX objects), so the port still never imports jax.  A test uses them
to give both packages the same problem and the same warm words.
"""

from __future__ import annotations

import numpy as np
import torch

from pint_tpu_torch.models.dynamics import Unicycle
from pint_tpu_torch.mpc.condensed import CondensedQP, QuantizedQP
from pint_tpu_torch.mpc.device_sqp import DeviceSQP

__all__ = ["device_sqp_config", "quantized_qp_from_arrays", "words_from_numpy",
           "words_to_numpy"]

_SIGNED = {np.dtype(np.uint8): np.int8, np.dtype(np.uint16): np.int16,
           np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def words_from_numpy(words: np.ndarray, device="cpu") -> torch.Tensor:
    """Unsigned numpy words (u8/u16/u32/u64) -> the port's signed container
    tensor holding the same bits (a ``.view``, no value conversion).  The
    reference's planar uint32 pair words ``(2, ...)`` become the int32 pairs
    that :mod:`pint_tpu_torch.ops.swar`'s pair entries take."""
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


def quantized_qp_from_arrays(ref) -> QuantizedQP:
    """The port's :class:`QuantizedQP` from a reference ``QuantizedQP``'s
    numpy fields (``ref.qp.H`` ... ``ref.hs_den``)."""
    qp = CondensedQP(
        H=np.asarray(ref.qp.H), G=np.asarray(ref.qp.G),
        g_ref=np.asarray(ref.qp.g_ref), u_max=float(ref.qp.u_max),
        lipschitz=float(ref.qp.lipschitz),
    )
    return QuantizedQP(
        qp=qp, Hq=np.asarray(ref.Hq, np.int8), h_scale=float(ref.h_scale),
        g_shift=int(ref.g_shift), Gq_scale=float(ref.Gq_scale),
        u_scale=float(ref.u_scale), horizon=int(ref.horizon),
        padded=int(ref.padded), hs_num=int(ref.hs_num), hs_den=int(ref.hs_den),
    )


def device_sqp_config(ref, **overrides) -> DeviceSQP:
    """The port's :class:`DeviceSQP` with a reference ``DeviceSQP``'s
    problem fields (model, horizon, Q, R, Qf, x_ref, iterations, g_shift,
    power_iters); ``overrides`` sets the port's own (``device``, ...)."""
    m = ref.model
    if type(m).__name__ != "Unicycle":
        raise NotImplementedError(
            f"model {type(m).__name__} is not ported yet (ROADMAP queue 1)"
        )
    kw = dict(
        model=Unicycle(dt_shift=m.dt_shift, frac_bits=m.frac_bits,
                       v_shift=m.v_shift, w_shift=m.w_shift),
        horizon=int(ref.horizon),
        Q=np.asarray(ref.Q, float), R=np.asarray(ref.R, float),
        qf_scale=float(ref.qf_scale),
        Qf=None if ref.Qf is None else np.asarray(ref.Qf, float),
        x_ref=np.asarray(ref.x_ref, float),
        sqp_iters=int(ref.sqp_iters), pgd_iters=int(ref.pgd_iters),
        g_shift=int(ref.g_shift), power_iters=int(ref.power_iters),
    )
    kw.update(overrides)
    return DeviceSQP(**kw)
