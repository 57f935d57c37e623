"""Branch-free SWAR lane arithmetic on word tensors (PyTorch port).

Counterpart of ``pint_tpu/ops/word.py:107-360``: pack, lane access and the
ten add/sub/min/max formulas of the reference library (pint.hpp:758-1004)
for 8-, 16- and 32-bit words.  Word tensors are *signed* containers
(``torch.int8``/``int16``/``int32``) that hold the unsigned word's bits:
torch has no add, shift or compare on uint16/uint32.  Consequences, each
handled below:

* a mask constant is passed as the two's-complement value of its bits
  (:func:`_k`);
* ``>>`` on a signed container is arithmetic, so every logical right shift
  masks off the smeared sign bits afterwards (:func:`_shr`);
* add, sub and ``<<`` wrap modulo 2**word_bits, as the unsigned ops do.

64-bit layouts and the runtime-amount shifts (``word.py:368-462``) are not
ported yet.
"""

from __future__ import annotations

import torch

from pint_tpu_torch.layout import PackedLayout

__all__ = [
    "container_dtype",
    "pack",
    "unpack",
    "unpack_signed",
    "get",
    "get_signed",
    "slice_word",
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
    "BINOP_NAMES",
]

BINOP_NAMES = (
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
)

_CONTAINERS = {8: torch.int8, 16: torch.int16, 32: torch.int32}


def container_dtype(layout: PackedLayout) -> torch.dtype:
    """The signed torch dtype that holds the layout's unsigned words."""
    dt = _CONTAINERS.get(layout.word_bits)
    if dt is None:
        raise NotImplementedError(
            f"{layout!r}: 64-bit words are not ported yet (ROADMAP queue 1)"
        )
    return dt


def _k(layout: PackedLayout, value: int) -> int:
    """Mask ``value`` as the two's-complement int of its word bits."""
    wb = layout.word_bits
    v = value & ((1 << wb) - 1)
    return v - (1 << wb) if v >> (wb - 1) else v


def _shr(layout: PackedLayout, x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of container words by a static ``s``."""
    if not s:
        return x
    return (x >> s) & _k(layout, (1 << (layout.word_bits - s)) - 1)


def _as_word(layout: PackedLayout, x) -> torch.Tensor:
    """Value conversion (wrapping) into the layout's container."""
    x = torch.as_tensor(x)
    dt = container_dtype(layout)
    return x if x.dtype == dt else x.to(dt)


# ---------------------------------------------------------------------------
# pack / unpack / lane access
# ---------------------------------------------------------------------------


def pack(layout: PackedLayout, *lanes) -> torch.Tensor:
    """Pack per-lane tensors into words, truncating each lane to its width
    (``make_truncate``, pint.hpp:592-601).  Accepts one tensor per lane or a
    single stacked tensor whose last axis is the lane axis."""
    if len(lanes) == 1 and not isinstance(lanes[0], (list, tuple)):
        stacked = torch.as_tensor(lanes[0])
        if stacked.dim() and stacked.shape[-1] == layout.num_lanes:
            lanes = tuple(stacked[..., i] for i in range(layout.num_lanes))
    if len(lanes) != layout.num_lanes:
        raise ValueError(
            f"expected {layout.num_lanes} lane arrays, got {len(lanes)}"
        )
    word = None
    for lane, ones, off in zip(lanes, layout.lane_ones, layout.offsets):
        v = _as_word(layout, lane) & _k(layout, ones)
        v = v << off if off else v
        word = v if word is None else word | v
    return word


def get(layout: PackedLayout, word: torch.Tensor, index: int) -> torch.Tensor:
    """Lane ``index`` zero-extended, in the container (pint.hpp:799-807)."""
    v = _shr(layout, word, layout.offsets[index])
    return v & _k(layout, layout.lane_ones[index])


def get_signed(
    layout: PackedLayout, word: torch.Tensor, index: int
) -> torch.Tensor:
    """Lane ``index`` sign-extended (pint.hpp:809-822): the lane's top bit
    goes to the sign position, then the *arithmetic* shift brings it back."""
    off, w = layout.offsets[index], layout.widths[index]
    up = layout.word_bits - (off + w)
    shifted = word << up if up else word
    return shifted >> (layout.word_bits - w)


def unpack(layout: PackedLayout, word: torch.Tensor) -> torch.Tensor:
    """All lanes zero-extended, stacked on a new trailing axis."""
    return torch.stack(
        [get(layout, word, i) for i in range(layout.num_lanes)], dim=-1
    )


def unpack_signed(layout: PackedLayout, word: torch.Tensor) -> torch.Tensor:
    """All lanes sign-extended, stacked on a new trailing axis."""
    return torch.stack(
        [get_signed(layout, word, i) for i in range(layout.num_lanes)], dim=-1
    )


def slice_word(
    layout: PackedLayout,
    word: torch.Tensor,
    start: int,
    end: int,
    *,
    keep_word_dtype: bool = False,
):
    """Lanes [start, end) as a new packed word re-based to bit 0
    (pint.hpp:923-932).  Returns ``(sub_layout, sub_word)``."""
    sub = layout.slice(start, end)
    lo_bits = sum(layout.widths[:start])
    mid_bits = sum(layout.widths[start:end])
    v = _shr(layout, word, lo_bits) & _k(layout, (1 << mid_bits) - 1)
    return sub, (v if keep_word_dtype else v.to(container_dtype(sub)))


# ---------------------------------------------------------------------------
# carry / borrow / overflow bit vectors
# ---------------------------------------------------------------------------


def _carry_add_vector(a, b):
    """Bit k set iff a+b carries out of bit k (pint.hpp:375-378)."""
    return (a & b) | ((a | b) & ~(a + b))


def _carry_sub_vector(a, b):
    """Bit k set iff a-b borrows out of bit k (pint.hpp:380-383)."""
    return (~a & b) | (~(a ^ b) & (a - b))


def _overflow_signed_sub_vector(a, b, res):
    """Signed-overflow bits of a-b=res (pint.hpp:385-388)."""
    return (~a & b & res) | (a & ~(b | res))


# ---------------------------------------------------------------------------
# saturation-mask machinery
# ---------------------------------------------------------------------------


def _dispatch_mask(layout: PackedLayout, carries):
    """A 1 at the LSB of every lane whose hi-order carry bit is set
    (pint.hpp:443-542, strategy from ``PackedLayout.sat_terms``).  The
    shifts are logical: a term without a mask of its own would otherwise
    keep the smeared sign bits."""
    acc = None
    for shift, mask in layout.sat_terms:
        t = _shr(layout, carries, shift)
        if mask is not None:
            t = t & _k(layout, mask)
        acc = t if acc is None else acc | t
    if layout.sat_final_mask is not None:
        acc = acc & _k(layout, layout.sat_final_mask)
    return acc


def _smear(layout: PackedLayout, carries):
    """``(c << 1) - dispatch(c)``: all-ones over each carrying lane
    (pint.hpp:544-551)."""
    return (carries << 1) - _dispatch_mask(layout, carries)


def _signed_sat_mask(layout: PackedLayout, overflow):
    """0111... over each overflowed lane (pint.hpp:563-567)."""
    return overflow - _dispatch_mask(layout, overflow)


def _apply_signed_saturation(layout: PackedLayout, total, overflow):
    """Clamp overflowed lanes to INT_MAX/INT_MIN (pint.hpp:569-574)."""
    m1 = _signed_sat_mask(layout, overflow)
    m2 = _signed_sat_mask(layout, overflow & ~total)
    return ((total ^ overflow) | m1) ^ m2


# ---------------------------------------------------------------------------
# add / sub
# ---------------------------------------------------------------------------


def add_wrap(layout: PackedLayout, a, b):
    """Per-lane modular add (pint.hpp:826-838)."""
    m2 = _k(layout, layout.hi_mask)
    m1 = _k(layout, layout.body_mask)
    return ((a & m1) + (b & m1)) ^ ((a ^ b) & m2)


def add_unsigned_saturate(layout: PackedLayout, a, b):
    """Per-lane unsigned add clamping to all-ones (pint.hpp:840-855)."""
    m2 = _k(layout, layout.hi_mask)
    carries = _carry_add_vector(a, b) & m2
    return add_wrap(layout, a, b) | _smear(layout, carries)


def add_signed_saturate(layout: PackedLayout, a, b):
    """Per-lane signed add clamping to INT_MAX/INT_MIN
    (pint.hpp:857-866, 576-582)."""
    m2 = _k(layout, layout.hi_mask)
    wrapped = add_wrap(layout, a, b)
    overflow = ~(a ^ b) & (wrapped ^ b) & m2
    return _apply_signed_saturation(layout, wrapped, overflow)


def sub_wrap(layout: PackedLayout, a, b):
    """Per-lane modular subtract via a + ~b + 1-per-lane (pint.hpp:870-884)."""
    m3 = _k(layout, layout.lo_mask)
    m2 = _k(layout, layout.hi_mask)
    m1 = _k(layout, layout.body_mask)
    nb = ~b
    return (
        ((a & m1) + (nb & m1) + (m3 & m1))
        ^ ((a ^ nb) & m2)
        ^ (m2 & m3)
    )


def sub_unsigned_saturate(layout: PackedLayout, a, b):
    """Per-lane unsigned subtract clamping to zero (pint.hpp:886-908)."""
    m2 = _k(layout, layout.hi_mask)
    m3 = _k(layout, layout.lo_mask)
    partial = add_wrap(layout, a, ~b)
    borrows = _carry_sub_vector(a, b) & m2
    saturated = partial | _smear(layout, borrows)
    return add_wrap(layout, saturated, m3)


def sub_signed_saturate(layout: PackedLayout, a, b):
    """Per-lane signed subtract with INT_MAX/INT_MIN clamping
    (pint.hpp:910-919, 584-590)."""
    m2 = _k(layout, layout.hi_mask)
    diff = sub_wrap(layout, a, b)
    overflow = _overflow_signed_sub_vector(a, b, diff) & m2
    return _apply_signed_saturation(layout, diff, overflow)


# ---------------------------------------------------------------------------
# min / max
# ---------------------------------------------------------------------------


def _interleave(a, b, mask):
    """Per-bit select: mask ? a : b (pint.hpp:603-606)."""
    return (a & mask) | (b & ~mask)


def min_unsigned(layout: PackedLayout, a, b):
    """Per-lane unsigned min (pint.hpp:936-950)."""
    m2 = _k(layout, layout.hi_mask)
    return _interleave(a, b, _smear(layout, _carry_sub_vector(a, b) & m2))


def max_unsigned(layout: PackedLayout, a, b):
    """Per-lane unsigned max (pint.hpp:952-966)."""
    m2 = _k(layout, layout.hi_mask)
    return _interleave(a, b, _smear(layout, _carry_sub_vector(b, a) & m2))


def min_signed(layout: PackedLayout, a, b):
    """Per-lane signed min: bias-flip the sign bits, compare unsigned
    (pint.hpp:968-985)."""
    m2 = _k(layout, layout.hi_mask)
    lt = _smear(layout, _carry_sub_vector(a ^ m2, b ^ m2) & m2)
    return _interleave(a, b, lt)


def max_signed(layout: PackedLayout, a, b):
    """Per-lane signed max (pint.hpp:987-1004)."""
    m2 = _k(layout, layout.hi_mask)
    gt = _smear(layout, _carry_sub_vector(b ^ m2, a ^ m2) & m2)
    return _interleave(a, b, gt)
