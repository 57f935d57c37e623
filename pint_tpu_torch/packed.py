"""`PackedArray`: the user-facing packed-lane tensor type (PyTorch port).

Counterpart of ``pint_tpu/packed.py``: a tensor of packed words in the
layout's signed container (:func:`~pint_tpu_torch.ops.word.container_dtype`)
plus a :class:`PackedLayout`.  The free functions mirror the reference's
public op surface (pint.hpp:799-1029) by name::

    lay = PackedLayout(5, 6, 5)                               # <5,6,5>
    a = PackedArray.pack(lay, [1, 20, 10], device="cuda")
    b = PackedArray.pack(lay, [3, 2, 1], device="cuda")
    s = add_wrap(a, b)                                        # pint::add_wrap
    s.lanes()                                                 # ToArray / get<I>

The ten binops and the two shifts go through :mod:`pint_tpu_torch.ops.swar`:
its CUDA kernels for words on the card, the ``word.py`` formulas for words on
the CPU.  Operands of different shapes are broadcast first, as jnp
broadcasting allows in ``pint_tpu``.  Lane values come back in the word's
container, as in ``pint_tpu`` they come back in the word dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import swar
from pint_tpu_torch.ops import word as W

__all__ = [
    "PackedArray",
    "get",
    "get_signed",
    "add_wrap",
    "add_unsigned_saturate",
    "add_signed_saturate",
    "sub_wrap",
    "sub_unsigned_saturate",
    "sub_signed_saturate",
    "min_unsigned",
    "max_unsigned",
    "min_signed",
    "max_signed",
    "shift_left",
    "shift_right_unsigned",
    "slice_lanes",
]


def _device(device):
    return None if device is None else K.resolve_device(device)


@dataclasses.dataclass(frozen=True, eq=False)
class PackedArray:
    """A tensor of packed words plus the lane layout describing them."""

    word: torch.Tensor
    layout: PackedLayout

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_words(cls, layout: PackedLayout, words, *, device=None) -> "PackedArray":
        """Wrap raw words (the ``packed_int(value)`` ctor, pint.hpp:768).
        Unsigned numpy or torch words keep their bits; other values convert
        by value, wrapping.  ``device`` defaults to a tensor's own device,
        else the CPU."""
        return cls(W._as_word(layout, words, _device(device)), layout)

    @classmethod
    def pack(cls, layout: PackedLayout, *lanes, device=None) -> "PackedArray":
        """Pack per-lane values with truncation (pint.hpp:770-774).

        Accepts one array per lane, a single lanes-last stacked array, or a
        flat python sequence of scalars (one per lane)."""
        if len(lanes) == 1 and isinstance(lanes[0], (list, tuple)):
            lanes = tuple(lanes[0])
        dev = _device(device)
        if dev is None:
            dev = next((x.device for x in lanes if isinstance(x, torch.Tensor)),
                       torch.device("cpu"))
        return cls(W.pack(layout, *[W._as_word(layout, x, dev) for x in lanes]),
                   layout)

    @classmethod
    def zeros(cls, layout: PackedLayout, shape=(), *, device="cpu") -> "PackedArray":
        return cls(torch.zeros(shape, dtype=W.container_dtype(layout),
                               device=K.resolve_device(device)), layout)

    # -- views --------------------------------------------------------------

    @property
    def shape(self):
        return self.word.shape

    @property
    def dtype(self):
        return self.word.dtype

    @property
    def device(self):
        return self.word.device

    def value(self) -> torch.Tensor:
        """The raw word tensor (``packed_int::value``, pint.hpp:776)."""
        return self.word

    def get(self, index: int) -> torch.Tensor:
        return W.get(self.layout, self.word, index)

    def get_signed(self, index: int) -> torch.Tensor:
        return W.get_signed(self.layout, self.word, index)

    def lanes(self) -> torch.Tensor:
        """All lanes zero-extended, stacked on a trailing axis."""
        return W.unpack(self.layout, self.word)

    def lanes_signed(self) -> torch.Tensor:
        return W.unpack_signed(self.layout, self.word)

    def astype_words(self, dtype) -> "PackedArray":
        return PackedArray(self.word.to(dtype), self.layout)

    # -- operators (pint.hpp:776-783) ---------------------------------------

    def _check(self, other: "PackedArray"):
        if not isinstance(other, PackedArray):
            raise TypeError(f"expected PackedArray, got {type(other)!r}")
        if other.layout != self.layout:
            raise ValueError(f"layout mismatch: {self.layout} vs {other.layout}")

    def __or__(self, other):
        self._check(other)
        return PackedArray(self.word | other.word, self.layout)

    def __and__(self, other):
        self._check(other)
        return PackedArray(self.word & other.word, self.layout)

    def __xor__(self, other):
        self._check(other)
        return PackedArray(self.word ^ other.word, self.layout)

    def __invert__(self):
        return PackedArray(~self.word, self.layout)

    def equal(self, other) -> torch.Tensor:
        """Elementwise word equality (``operator==``, pint.hpp:778)."""
        self._check(other)
        return self.word == other.word

    def not_equal(self, other) -> torch.Tensor:
        """Elementwise word inequality (``operator!=``, pint.hpp:779).
        Python's ``==``/``!=`` stay identity comparisons: a boolean tensor
        has no single truth value."""
        self._check(other)
        return self.word != other.word

    def __getitem__(self, idx):
        return PackedArray(self.word[idx], self.layout)

    def reshape(self, *shape):
        return PackedArray(self.word.reshape(*shape), self.layout)

    def __repr__(self):
        # per-lane repr, as the reference's GTest PrintTo (pint_test.cpp:46-56)
        lanes = self.lanes().cpu().numpy()
        lanes = lanes.view(np.dtype(f"uint{lanes.dtype.itemsize * 8}"))
        return f"PackedArray({self.layout}, lanes={lanes.tolist()})"


def _binop(name):
    fn = getattr(W, name)

    def op(a: PackedArray, b: PackedArray) -> PackedArray:
        a._check(b)
        x, y = torch.broadcast_tensors(a.word, b.word)
        return PackedArray(
            swar.binop(a.layout, name)(x.contiguous(), y.contiguous()), a.layout
        )

    op.__name__ = op.__qualname__ = name
    op.__doc__ = fn.__doc__
    return op


add_wrap = _binop("add_wrap")
add_unsigned_saturate = _binop("add_unsigned_saturate")
add_signed_saturate = _binop("add_signed_saturate")
sub_wrap = _binop("sub_wrap")
sub_unsigned_saturate = _binop("sub_unsigned_saturate")
sub_signed_saturate = _binop("sub_signed_saturate")
min_unsigned = _binop("min_unsigned")
max_unsigned = _binop("max_unsigned")
min_signed = _binop("min_signed")
max_signed = _binop("max_signed")


def get(a: PackedArray, index: int) -> torch.Tensor:
    """Lane ``index`` zero-extended (pint.hpp:799-807)."""
    return a.get(index)


def get_signed(a: PackedArray, index: int) -> torch.Tensor:
    """Lane ``index`` sign-extended (pint.hpp:809-822)."""
    return a.get_signed(index)


def shift_left(a: PackedArray, amount) -> PackedArray:
    """Per-lane left shift by a runtime amount (pint.hpp:1006-1017)."""
    return PackedArray(swar.shift(a.layout, "shift_left")(a.word, amount), a.layout)


def shift_right_unsigned(a: PackedArray, amount) -> PackedArray:
    """Per-lane logical right shift by a runtime amount (pint.hpp:1019-1029)."""
    return PackedArray(
        swar.shift(a.layout, "shift_right_unsigned")(a.word, amount), a.layout
    )


def slice_lanes(a: PackedArray, start: int, end: int) -> PackedArray:
    """Lanes [start, end) as a new PackedArray (pint.hpp:923-932)."""
    sub, word = W.slice_word(a.layout, a.word, start, end)
    return PackedArray(word, sub)
