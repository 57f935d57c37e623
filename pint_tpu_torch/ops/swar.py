"""SWAR elementwise kernels: the counterpart of ``pint_tpu/ops/pallas.py``.

Entry points with the same names as ``pallas.py``'s: factories cached per
``(layout, name)`` that return a callable over word tensors of any shape.
The tensor's device chooses the route, so there is no ``interpret``
argument: a CUDA tensor runs the hand-written kernel of ``csrc/swar.cu``,
a CPU tensor runs the plain PyTorch version (the :mod:`~pint_tpu_torch.ops.word`
formulas), and nothing else is accepted (:mod:`~pint_tpu_torch.ops.kernels`).

Entry, the TPU kernel it replaces, and its launch-count name:

- ``binop``: K1 ``_binop_impl``, ``swar_binop``;
- ``shift``: K9 ``_shift_impl``, ``swar_shift``;
- ``saturating_accumulate`` on words: K8 ``_sat_accum_impl``, ``swar_sat_accum``;
- ``binop_pair``: K11a ``_binop_pair_impl``, ``swar_binop_pair``;
- ``shift_pair``: K11b ``_shift_pair_impl``, ``swar_shift_pair``;
- ``saturating_accumulate`` on int32 pairs: K11c ``_sat_accum_split_impl``,
  ``swar_sat_accum_pair``.

Words are the layout's signed container (:func:`~pint_tpu_torch.ops.word.container_dtype`).
64-bit layouts run the ``uint64_t`` form of the same kernels on int64 words
(``pallas.py`` sends ``binop``/``shift`` of a 64-bit layout to XLA because
Mosaic has no 64-bit vectors).  The pair entries take u64 words as planar
int32 pairs ``(2, ...)`` (:mod:`~pint_tpu_torch.ops.split64`); for a 64-bit
layout ``saturating_accumulate`` takes either int64 words or such pairs,
with the deltas as ``(2, steps, ...)``.

A shift amount is a Python int or a 0-d integer tensor, reduced modulo
2**32 as ``pint_tpu`` reduces it.  An amount on the card is read by the
kernel from device memory, so a shift never waits for the device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import word as W
from pint_tpu_torch.ops.split64 import merge_u64, split_u64

__all__ = [
    "supported",
    "binop",
    "binop_pair",
    "shift",
    "shift_pair",
    "saturating_accumulate",
    "binop_plain",
    "shift_plain",
    "sat_accum_plain",
    "BINOP_NAMES",
    "SHIFT_NAMES",
]

BINOP_NAMES = W.BINOP_NAMES
SHIFT_NAMES = ("shift_left", "shift_right_unsigned")

_MAX_TERMS = 10
_U64 = ctypes.c_uint64
_I32 = ctypes.c_int32


class _SwarLayout(ctypes.Structure):
    """``pint::SwarLayout`` of ``csrc/swar.cuh``, field for field."""

    _fields_ = [
        ("hi_mask", _U64), ("body_mask", _U64), ("lo_mask", _U64),
        ("sat_final_mask", _U64),
        ("sat_mask", _U64 * _MAX_TERMS), ("group_mask", _U64 * _MAX_TERMS),
        ("sat_shift", _I32 * _MAX_TERMS), ("sat_has_mask", _I32 * _MAX_TERMS),
        ("group_width", _I32 * _MAX_TERMS),
        ("n_sat", _I32), ("has_final_mask", _I32), ("n_groups", _I32),
        ("max_width", _I32), ("all_same", _I32), ("width0", _I32),
    ]


@functools.lru_cache(maxsize=None)
def _c_layout(layout: PackedLayout) -> _SwarLayout:
    c = _SwarLayout()
    c.hi_mask, c.body_mask, c.lo_mask = layout.hi_mask, layout.body_mask, layout.lo_mask
    c.has_final_mask = layout.sat_final_mask is not None
    c.sat_final_mask = layout.sat_final_mask or 0
    c.n_sat = len(layout.sat_terms)
    for i, (sh, mask) in enumerate(layout.sat_terms):
        c.sat_shift[i], c.sat_has_mask[i] = sh, mask is not None
        c.sat_mask[i] = mask or 0
    c.n_groups = len(layout.width_groups)
    for i, (w, mask) in enumerate(layout.width_groups):
        c.group_width[i], c.group_mask[i] = w, mask
    c.max_width, c.all_same = layout.max_width, layout.all_same
    c.width0 = layout.widths[0]
    return c


def supported(layout: PackedLayout) -> bool:
    """Whether a kernel exists for the layout's word width: always, for
    8/16/32/64-bit words (kept as API, as ``pallas.supported`` is)."""
    return layout.word_bits in (8, 16, 32, 64)


# ---------------------------------------------------------------------------
# operand checks
# ---------------------------------------------------------------------------


def _check_words(name: str, layout: PackedLayout, *ts: torch.Tensor) -> None:
    dt = W.container_dtype(layout)
    for t in ts:
        if t.dtype != dt:
            raise ValueError(f"{name}: {layout} words are {dt}, got {t.dtype}")
        if t.shape != ts[0].shape:
            raise ValueError(
                f"{name}: shapes {tuple(ts[0].shape)} and {tuple(t.shape)} differ"
            )


def _is_pair(t: torch.Tensor) -> bool:
    return t.dtype == torch.int32 and t.dim() >= 1 and t.shape[0] == 2


def _check_pairs(name: str, layout: PackedLayout, *ts: torch.Tensor) -> None:
    """Planar pair words have the halves on the LEADING axis: (2, ...).
    A trailing pair axis would be silently misread, so anything whose first
    dim is not exactly 2 is refused."""
    if layout.word_bits != 64:
        raise ValueError(f"{name} is for u64 layouts, got {layout}")
    for t in ts:
        if not _is_pair(t) or t.shape != ts[0].shape:
            raise ValueError(
                f"{name}: pair words must be planar int32 (2, ...) of one shape "
                f"-- [0]=low half, [1]=high half; got {tuple(t.shape)} {t.dtype}"
            )


def _launch_args(name: str, *ts: torch.Tensor):
    """Contiguous copies of the operands on their common CUDA device."""
    ts = tuple(t.contiguous() for t in ts)
    K.require_cuda(name, *ts)
    return ts


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def binop_plain(layout: PackedLayout, name: str, a, b, *, pair=False):
    """The ``word.py`` formula ``name`` on words, or on planar pairs."""
    f = getattr(W, name)
    if pair:
        return split_u64(f(layout, merge_u64(a), merge_u64(b)))
    return f(layout, a, b)


def shift_plain(layout: PackedLayout, name: str, v, amount, *, pair=False):
    """The ``word.py`` runtime shift ``name`` on words, or on planar pairs."""
    f = getattr(W, name)
    if pair:
        return split_u64(f(layout, merge_u64(v), amount))
    return f(layout, v, amount)


def sat_accum_plain(layout: PackedLayout, signed: bool, acc, deltas):
    """``acc <- sat(acc + d_s)`` for each delta plane, one formula call a
    step; int32 pairs ``(2, ...)`` with deltas ``(2, steps, ...)`` for a
    64-bit layout go through int64 words."""
    f = W.add_signed_saturate if signed else W.add_unsigned_saturate
    pair = layout.word_bits == 64 and _is_pair(acc)
    x = merge_u64(acc) if pair else acc
    for s in range(deltas.shape[1] if pair else deltas.shape[0]):
        x = f(layout, x, merge_u64(deltas[:, s]) if pair else deltas[s])
    return split_u64(x) if pair else x


# ---------------------------------------------------------------------------
# binops (K1, K11a)
# ---------------------------------------------------------------------------


def _binop_run(layout: PackedLayout, name: str, pair: bool):
    op = BINOP_NAMES.index(name)
    count = "swar_binop_pair" if pair else "swar_binop"
    c_layout = _c_layout(layout)

    def run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if pair:
            _check_pairs(count, layout, a, b)
        else:
            _check_words(count, layout, a, b)
        if a.device.type == "cpu" and b.device.type == "cpu":
            return binop_plain(layout, name, a, b, pair=pair)
        a, b = _launch_args(count, a, b)
        out = torch.empty_like(a)
        n = a.numel() // 2 if pair else a.numel()
        if n == 0:
            return out
        with torch.cuda.device(a.device):
            err = K.library().pint_swar_binop(
                layout.word_bits, int(pair), op, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), n, ctypes.addressof(c_layout), K.stream_of(a))
        K.check(err, count)
        K.count_launch(count)
        return out

    run.__name__ = run.__qualname__ = name
    return run


@functools.lru_cache(maxsize=None)
def binop(layout: PackedLayout, name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A binary SWAR op ``(words, words) -> words`` (K1): the kernel for
    CUDA words, the ``word.py`` formula for CPU words.  Both operands have
    one shape and the layout's container dtype."""
    if name not in BINOP_NAMES:
        raise ValueError(f"unknown binop {name!r}")
    return _binop_run(layout, name, pair=False)


@functools.lru_cache(maxsize=None)
def binop_pair(layout: PackedLayout, name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A binary SWAR op on u64 words carried as planar int32 pairs
    ``(2, ...)``: ``pair[0]`` the low half, ``pair[1]`` the high (K11a)."""
    if name not in BINOP_NAMES:
        raise ValueError(f"unknown binop {name!r}")
    if layout.word_bits != 64:
        raise ValueError(f"binop_pair is for u64 layouts, got {layout}")
    return _binop_run(layout, name, pair=True)


# ---------------------------------------------------------------------------
# shifts (K9, K11b)
# ---------------------------------------------------------------------------


def _amount_arg(name: str, amount, device: torch.device):
    """``(amount tensor on the card or None, amount as an int)`` for the
    shift kernel."""
    if isinstance(amount, torch.Tensor):
        W.amount_u32(amount)  # refuses non-integer dtypes
        if amount.device.type == "cpu":
            return None, W.amount_u32(int(amount))
        if amount.device != device:
            raise ValueError(f"{name}: amount on {amount.device}, words on {device}")
        return amount.to(torch.int64), 0
    return None, W.amount_u32(amount)


def _shift_run(layout: PackedLayout, name: str, pair: bool):
    left = name == "shift_left"
    count = "swar_shift_pair" if pair else "swar_shift"
    c_layout = _c_layout(layout)

    def run(v: torch.Tensor, amount) -> torch.Tensor:
        if pair:
            _check_pairs(count, layout, v)
        else:
            _check_words(count, layout, v)
        if isinstance(amount, torch.Tensor) and amount.dim():
            raise ValueError(f"{count}: the amount is one value, got shape "
                             f"{tuple(amount.shape)}")
        if v.device.type == "cpu":
            return shift_plain(layout, name, v, amount, pair=pair)
        (v,) = _launch_args(count, v)
        amt_dev, amt = _amount_arg(count, amount, v.device)
        out = torch.empty_like(v)
        n = v.numel() // 2 if pair else v.numel()
        if n == 0:
            return out
        with torch.cuda.device(v.device):
            err = K.library().pint_swar_shift(
                layout.word_bits, int(pair), int(left), v.data_ptr(),
                out.data_ptr(), n, None if amt_dev is None else amt_dev.data_ptr(),
                amt, ctypes.addressof(c_layout), K.stream_of(v))
        K.check(err, count)
        K.count_launch(count)
        return out

    run.__name__ = run.__qualname__ = name
    return run


@functools.lru_cache(maxsize=None)
def shift(layout: PackedLayout, name: str) -> Callable[[torch.Tensor, object], torch.Tensor]:
    """A lane shift ``(words, amount) -> words`` by a runtime amount (K9)."""
    if name not in SHIFT_NAMES:
        raise ValueError(f"unknown shift {name!r}")
    return _shift_run(layout, name, pair=False)


@functools.lru_cache(maxsize=None)
def shift_pair(layout: PackedLayout, name: str) -> Callable[[torch.Tensor, object], torch.Tensor]:
    """A lane shift on planar int32 pair words ``(2, ...)`` (K11b)."""
    if name not in SHIFT_NAMES:
        raise ValueError(f"unknown shift {name!r}")
    if layout.word_bits != 64:
        raise ValueError(f"shift_pair is for u64 layouts, got {layout}")
    return _shift_run(layout, name, pair=True)


# ---------------------------------------------------------------------------
# fused saturating accumulate (K8, K11c)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def saturating_accumulate(
    layout: PackedLayout, *, signed: bool = True, steps: int = 1
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Fused multi-step saturating accumulate ``(acc, deltas) -> acc``:
    ``acc <- sat(acc + d_s)`` for each of ``steps`` delta planes, one pass
    over memory.  ``deltas`` is ``(steps, *acc.shape)`` (K8); for a 64-bit
    layout, ``acc`` may also be planar int32 pairs ``(2, ...)`` with
    ``deltas`` ``(2, steps, ...)`` (K11c)."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    c_layout = _c_layout(layout)

    def run(acc: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        pair = layout.word_bits == 64 and _is_pair(acc)
        count = "swar_sat_accum_pair" if pair else "swar_sat_accum"
        if pair:
            _check_pairs(count, layout, acc)
            want = (2, steps, *acc.shape[1:])
        else:
            _check_words(count, layout, acc)
            want = (steps, *acc.shape)
        if deltas.dtype != acc.dtype or tuple(deltas.shape) != want:
            raise ValueError(f"{count}: deltas must be {want} {acc.dtype}, got "
                             f"{tuple(deltas.shape)} {deltas.dtype}")
        if acc.device.type == "cpu" and deltas.device.type == "cpu":
            return sat_accum_plain(layout, signed, acc, deltas)
        acc, deltas = _launch_args(count, acc, deltas)
        out = torch.empty_like(acc)
        n = acc.numel() // 2 if pair else acc.numel()
        if n == 0:
            return out
        with torch.cuda.device(acc.device):
            err = K.library().pint_swar_sat_accum(
                layout.word_bits, int(pair), int(signed), acc.data_ptr(),
                deltas.data_ptr(), out.data_ptr(), n, steps,
                ctypes.addressof(c_layout), K.stream_of(acc))
        K.check(err, count)
        K.count_launch(count)
        return out

    return run
