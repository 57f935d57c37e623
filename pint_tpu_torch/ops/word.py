"""Branch-free SWAR lane arithmetic on word tensors (PyTorch port).

Counterpart of ``pint_tpu/ops/word.py``: pack, lane access, the ten
add/sub/min/max formulas and the two runtime-amount lane shifts of the
reference library (pint.hpp:758-1029) for 8-, 16-, 32- and 64-bit words.
Word tensors are *signed* containers (``torch.int8``/``int16``/``int32``/
``int64``) that hold the unsigned word's bits: torch has no add, shift or
compare on uint16/uint32/uint64.  Consequences, each handled below:

* a mask constant is passed as the two's-complement value of its bits
  (:func:`_k`);
* ``>>`` on a signed container is arithmetic, so every logical right shift
  masks off the smeared sign bits afterwards (:func:`_shr`);
* add, sub and ``<<`` wrap modulo 2**word_bits, as the unsigned ops do;
* a runtime shift amount is reduced modulo 2**32 as ``pint_tpu``'s uint32
  cast reduces it, so a negative amount zeroes the word (:func:`_amount`),
  and no shift is ever by the word width or more (:func:`_shl_full`).
"""

from __future__ import annotations

import operator

import numpy as np
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
    "shift_left",
    "shift_right_unsigned",
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

_CONTAINERS = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}
_UNSIGNED = {torch.uint8: torch.int8, torch.uint16: torch.int16,
             torch.uint32: torch.int32, torch.uint64: torch.int64}


def container_dtype(layout: PackedLayout) -> torch.dtype:
    """The signed torch dtype that holds the layout's unsigned words."""
    return _CONTAINERS[layout.word_bits]


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


def _as_word(layout: PackedLayout, x, device=None) -> torch.Tensor:
    """``x`` in the layout's container on ``device`` (default: a tensor's
    own device, else the CPU).  Unsigned numpy or torch words of the
    container's size keep their bits; anything else converts by value,
    wrapping modulo 2**word_bits."""
    if not isinstance(x, torch.Tensor):
        if isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)
        else:  # Python values: ints up to 2**64 - 1 stay exact
            try:
                a = np.asarray(x, dtype=np.int64)
            except OverflowError:
                a = np.asarray(x, dtype=np.uint64)
        if a.dtype.kind == "u":
            a = a.view(f"int{a.dtype.itemsize * 8}")
        x = torch.from_numpy(a.copy())
    dt = container_dtype(layout)
    if _UNSIGNED.get(x.dtype) == dt:
        x = x.view(dt)
    x = x if device is None else x.to(device)
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


# ---------------------------------------------------------------------------
# lane shifts (runtime amounts, branch-free)
# ---------------------------------------------------------------------------


def amount_u32(amount) -> "int | torch.Tensor":
    """A shift amount reduced modulo 2**32, as ``pint_tpu``'s
    ``astype(uint32)`` reduces it: a Python int, or an int64 tensor of the
    amount tensor's shape on its device.  Raises for non-integers."""
    if isinstance(amount, torch.Tensor):
        if amount.dtype.is_floating_point or amount.dtype.is_complex or (
            amount.dtype == torch.bool
        ):
            raise TypeError(f"shift amount must be integral, got {amount.dtype}")
        return amount.to(torch.int64) & 0xFFFFFFFF
    if isinstance(amount, (bool, np.bool_)):
        raise TypeError("shift amount must be integral, got bool")
    try:
        return operator.index(amount) & 0xFFFFFFFF
    except TypeError:
        raise TypeError(
            f"shift amount must be integral, got {type(amount).__name__}"
        ) from None


def _amount(layout: PackedLayout, amount, word: torch.Tensor):
    """``(amt, guard)`` as ``pint_tpu/ops/word.py:_amount`` makes them.

    The amount is taken modulo 2**32 (so -1 is 2**32 - 1) in int64, where
    the uint32 arithmetic is exact: ``guard`` is all-ones iff that value is
    below the widest lane -- the sign bit of the uint32
    ``max_width - a32 - 1`` (pint.hpp:1011-1013) -- and ``amt`` is it
    clamped to ``word_bits``.  Both are 0-d tensors in the word's container
    on the word's device."""
    a32 = amount_u32(amount)
    a32 = torch.as_tensor(a32, dtype=torch.int64, device=word.device)
    sign = ((layout.max_width - a32 - 1) & 0xFFFFFFFF) >> 31
    dt = container_dtype(layout)
    guard = sign.to(dt) - 1
    amt = torch.clamp(a32, max=layout.word_bits).to(dt)
    return amt, guard


def _wb(x: torch.Tensor) -> int:
    return x.element_size() * 8


def _lshr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift by a tensor ``s`` in [0, word_bits - 1]: the
    arithmetic shift, then a mask of the low ``word_bits - s`` bits built
    as ``~((MIN >> s) << 1)`` (no shift by the word width)."""
    top = torch.full((), -(1 << (_wb(x) - 1)), dtype=x.dtype, device=x.device)
    return (x >> s) & ~((top >> s) << 1)


def _shl_full(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Left shift exact mod 2**w for ``k`` in [0, word_bits]: two shifts,
    neither by the word width (what torch or C++ does there is not relied
    on)."""
    k1 = torch.clamp(k, max=_wb(x) - 1)
    return (x << k1) << (k - k1)


def _shr_full(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Logical right shift for ``k`` in [0, word_bits], in two steps."""
    k1 = torch.clamp(k, max=_wb(x) - 1)
    return _lshr(_lshr(x, k1), k - k1)


def _sat_to_zero(x: torch.Tensor) -> torch.Tensor:
    """0 if the word's sign bit is set, else x (pint.hpp:616-620): the
    arithmetic shift smears the sign bit over the word."""
    return ~(x >> (_wb(x) - 1)) & x


def shift_left(layout: PackedLayout, word: torch.Tensor, amount) -> torch.Tensor:
    """Per-lane left shift by a runtime amount (pint.hpp:1006-1017): clear
    the top ``amount`` bits of every lane, then one whole-word shift; the
    guard zeroes the word when ``amount >= max(widths)``.  ``amount`` is a
    Python int or an integer tensor (0-d, or broadcastable to ``word``)."""
    amt, guard = _amount(layout, amount, word)
    lo = torch.full((), _k(layout, layout.lo_mask), dtype=word.dtype,
                    device=word.device)
    if layout.all_same:
        # keep the low (B0 - amount) bits of each lane (pint.hpp:661-668)
        keep = _shl_full(lo, _sat_to_zero(layout.widths[0] - amt)) - lo
    else:
        # per-width mask collection (pint.hpp:630-658)
        keep = torch.zeros_like(amt)
        for w, mask_w in layout.width_groups:
            mw = torch.full_like(lo, _k(layout, mask_w))
            keep = keep | (_shl_full(mw, _sat_to_zero(w - amt)) - mw)
    return guard & _shl_full(keep & word, amt)


def shift_right_unsigned(
    layout: PackedLayout, word: torch.Tensor, amount
) -> torch.Tensor:
    """Per-lane logical right shift by a runtime amount (pint.hpp:1019-1029):
    clear the bottom ``min(width, amount)`` bits of each lane, then one
    whole-word logical shift."""
    amt, guard = _amount(layout, amount, word)
    lo = torch.full((), _k(layout, layout.lo_mask), dtype=word.dtype,
                    device=word.device)
    if layout.all_same:
        clear = _shl_full(lo, amt) - lo                      # pint.hpp:698-705
    else:
        clear = torch.zeros_like(amt)                        # pint.hpp:670-695
        for w, mask_w in layout.width_groups:
            mw = torch.full_like(lo, _k(layout, mask_w))
            kmin = w - _sat_to_zero(w - amt)
            clear = clear | (_shl_full(mw, kmin) - mw)
    return guard & _shr_full(~clear & word, amt)
