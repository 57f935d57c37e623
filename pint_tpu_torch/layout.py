"""Lane-layout machinery, copied from ``pint_tpu/layout.py`` (numpy only).

The port carries this module as a copy because importing it from
``pint_tpu`` would import jax.  The masks stay plain Python ints holding the
unsigned bit patterns; :mod:`pint_tpu_torch.ops.word` converts them to the
two's-complement value of its signed word container where it uses them.

The reference library (pint.hpp:27-756) derives,
at C++ compile time, a set of whole-word bit masks from a lane-width parameter
pack ``<B0, B1, ...>``:

* lane offsets (prefix sums of widths)            -- pint.hpp:288-292
* ``mask_hiorder`` (top bit of every lane)        -- pint.hpp:323-329
* ``mask_loorder`` (bottom bit of every lane)     -- pint.hpp:331-337
* per-lane all-ones / field masks                 -- pint.hpp:339-365
* the word type that fits the widths              -- pint.hpp:710-734, 789-795
* a 3-way "saturation-mask strategy" selection    -- pint.hpp:409-551

Mask derivation runs once, in Python, when a :class:`PackedLayout` is
constructed.  This module is pure Python and numpy -- the L0+L1 layer of
SURVEY.md section 1.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "PackedLayout",
    "word_bits_for",
]

_WORD_SIZES = (8, 16, 32, 64)


def word_bits_for(total_bits: int) -> int:
    """Smallest machine-word size (8/16/32/64) holding ``total_bits``.

    Mirrors the selection of ``make_packed_int`` (pint.hpp:789-795, via
    ``clp2`` :710-722 and ``find_appropriate_int`` :724-734), which resolves to
    "first of {8,16,32,64} that is >= sum(widths)".  Verified against the
    boundary table in the reference test suite (pint_test.cpp:58-87).
    """
    for wb in _WORD_SIZES:
        if total_bits <= wb:
            return wb
    raise ValueError(
        f"packed lanes need {total_bits} bits; the widest supported word is 64"
    )


def _popcount(x: int) -> int:
    return bin(x).count("1")


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Describes how lanes of widths ``widths`` pack into one unsigned word.

    This object is hashable and immutable.  All mask fields are Python ints
    holding unsigned bit patterns.

    Lane 0 occupies the least-significant bits, matching the reference's
    ``make_truncate`` packing order (pint.hpp:390-407, 592-601).
    """

    widths: Tuple[int, ...]

    def __init__(self, *widths: int):
        if len(widths) == 1 and isinstance(widths[0], (tuple, list)):
            widths = tuple(widths[0])
        if not widths:
            raise ValueError("at least one lane width is required")
        for w in widths:
            if not isinstance(w, (int, np.integer)) or w < 1:
                raise ValueError(f"lane widths must be positive ints, got {w!r}")
        object.__setattr__(self, "widths", tuple(int(w) for w in widths))
        if self.total_bits > 64:
            raise ValueError(
                f"widths {self.widths} need {self.total_bits} bits; max is 64"
            )

    # ---- basic geometry ---------------------------------------------------

    @functools.cached_property
    def num_lanes(self) -> int:
        return len(self.widths)

    @functools.cached_property
    def total_bits(self) -> int:
        return sum(self.widths)

    @functools.cached_property
    def word_bits(self) -> int:
        return word_bits_for(self.total_bits)

    @functools.cached_property
    def word_dtype(self) -> np.dtype:
        """Unsigned numpy dtype of the backing word."""
        return np.dtype(f"uint{self.word_bits}")

    @functools.cached_property
    def signed_dtype(self) -> np.dtype:
        return np.dtype(f"int{self.word_bits}")

    @functools.cached_property
    def offsets(self) -> Tuple[int, ...]:
        """Bit offset of each lane's LSB (pint.hpp:288-292)."""
        out, acc = [], 0
        for w in self.widths:
            out.append(acc)
            acc += w
        return tuple(out)

    # ---- masks ------------------------------------------------------------

    @functools.cached_property
    def word_ones(self) -> int:
        return (1 << self.word_bits) - 1

    @functools.cached_property
    def used_mask(self) -> int:
        """All-ones over the occupied low ``total_bits`` (pint.hpp:339-348)."""
        return (1 << self.total_bits) - 1

    @functools.cached_property
    def hi_mask(self) -> int:
        """OR of the top bit of every lane (``mask_hiorder``, pint.hpp:323-329)."""
        m = 0
        for off, w in zip(self.offsets, self.widths):
            m |= 1 << (off + w - 1)
        return m

    @functools.cached_property
    def lo_mask(self) -> int:
        """OR of the bottom bit of every lane (``mask_loorder``, pint.hpp:331-337)."""
        m = 0
        for off in self.offsets:
            m |= 1 << off
        return m

    @functools.cached_property
    def body_mask(self) -> int:
        """``~hi_mask`` within the occupied bits -- "mask1" of add_wrap
        (pint.hpp:832-833)."""
        return ~self.hi_mask & self.used_mask

    @functools.cached_property
    def lane_ones(self) -> Tuple[int, ...]:
        """Per-lane all-ones value at bit 0 (pint.hpp:339-348)."""
        return tuple((1 << w) - 1 for w in self.widths)

    @functools.cached_property
    def field_masks(self) -> Tuple[int, ...]:
        """Per-lane all-ones mask in word position."""
        return tuple(
            ones << off for ones, off in zip(self.lane_ones, self.offsets)
        )

    @functools.cached_property
    def max_width(self) -> int:
        return max(self.widths)

    @functools.cached_property
    def all_same(self) -> bool:
        return len(set(self.widths)) == 1

    # ---- saturation-smear strategy ---------------------------------------
    #
    # The unsigned saturation mask turns a vector of per-lane carry-out bits
    # (at lane hi-order positions) into all-ones masks over the overflowed
    # lanes:  smear(c) = (c << 1) - dispatch(c), where dispatch(c) places a 1
    # at the LSB of every carrying lane.  The reference picks one of three
    # dispatch strategies at compile time (pint.hpp:409-551):
    #
    #   type 0 (all widths equal):   c >> (B0-1)
    #   type 1 (shifted hi bits of distinct widths land only on lane LSBs):
    #                                (OR_{B in unique} c >> (B-1)) & lo_mask
    #   type 2 (general):            OR_w ((c >> (w-1)) & lo_mask_w)
    #
    # We reproduce the same selection (fewer shifts) but store
    # it as a uniform list of (shift, mask-or-None) terms plus a final mask.

    @functools.cached_property
    def sat_type(self) -> int:
        """Which dispatch strategy applies (pint.hpp:443-456)."""
        if self.all_same:
            return 0
        # type-1 predicate (pint.hpp:424-441): for every unique width B, the
        # bits of hi_mask >> (B-1) that land on lane LSB positions must
        # jointly cover every lane exactly once.
        total = 0
        for b in sorted(set(self.widths)):
            total += _popcount((self.hi_mask >> (b - 1)) & self.lo_mask)
        return 1 if total == self.num_lanes else 2

    @functools.cached_property
    def sat_terms(self) -> Tuple[Tuple[int, Optional[int]], ...]:
        """Dispatch as ((shift, mask_or_None), ...) OR-reduced terms."""
        if self.sat_type == 0:
            return ((self.widths[0] - 1, None),)
        if self.sat_type == 1:
            return tuple((b - 1, None) for b in sorted(set(self.widths)))
        # type 2: group lane LSB positions by width (unzip_to_map,
        # pint.hpp:492-542)
        groups: dict[int, int] = {}
        for off, w in zip(self.offsets, self.widths):
            groups[w] = groups.get(w, 0) | (1 << off)
        return tuple((w - 1, m) for w, m in sorted(groups.items()))

    @functools.cached_property
    def sat_final_mask(self) -> Optional[int]:
        """Mask applied once after the OR-reduction (type 1 only)."""
        return self.lo_mask if self.sat_type == 1 else None

    @functools.cached_property
    def width_groups(self) -> Tuple[Tuple[int, int], ...]:
        """(width, lo-order mask restricted to lanes of that width) pairs --
        the per-width mask collection used by the heterogeneous shift paths
        (pint.hpp:630-658, 670-705)."""
        groups: dict[int, int] = {}
        for off, w in zip(self.offsets, self.widths):
            groups[w] = groups.get(w, 0) | (1 << off)
        return tuple(sorted(groups.items()))

    # ---- derived layouts --------------------------------------------------

    def slice(self, start: int, end: int) -> "PackedLayout":
        """Sub-layout of lanes [start, end) (``sliced_int``, pint.hpp:746-754).

        Note: matching the reference, the slice keeps the *parent's* word
        width (the C++ slice returns ``packed_int<Integer, ...>`` with the
        original Integer).  We return the natural layout of the sliced widths;
        word-dtype adaptation happens in the ops layer.
        """
        if not (0 <= start < end <= self.num_lanes):
            raise ValueError(
                f"bad slice bounds [{start}, {end}) for {self.num_lanes} lanes"
            )
        return PackedLayout(*self.widths[start:end])

    # ---- niceties ---------------------------------------------------------

    def __repr__(self) -> str:
        return f"PackedLayout{self.widths}<u{self.word_bits}>"

    def __hash__(self) -> int:
        return hash(self.widths)

    def __eq__(self, other) -> bool:
        return isinstance(other, PackedLayout) and self.widths == other.widths
