"""Per-lane exact-integer numpy oracle for the SWAR word ops.

Copied from ``pint_tpu/utils/oracle.py`` (numpy only, so the port never
imports jax).  Independent CPU implementation of the packed-lane semantics,
written the "obvious" way (unpack -> ordinary per-lane integer arithmetic -> repack)
rather than with whole-word bit tricks.  This mirrors the reference test
suite's oracle style, where expected values are spelled as plain C arithmetic
(pint_test.cpp:156 etc.), and doubles as the CPU reference path for
correctness sweeps.

Arithmetic runs on numpy *object* arrays of Python ints, so lane widths up to
64 (and the uint64 word of make_packed_int sums 33..64, pint_test.cpp:82-87)
are exact with no overflow concerns.  Speed is irrelevant here by design.
"""

from __future__ import annotations

import numpy as np

from pint_tpu_torch.layout import PackedLayout

__all__ = ["Oracle"]


def _to_object_words(word) -> np.ndarray:
    arr = np.asarray(word)
    out = np.empty(arr.shape, dtype=object)
    flat_in = arr.reshape(-1)
    flat_out = out.reshape(-1)
    for i in range(flat_in.size):
        flat_out[i] = int(flat_in[i])
    return out


class Oracle:
    """Reference semantics for one layout, on arrays of Python ints.

    ``unpack``/``unpack_signed``/``pack`` use object arrays internally;
    outputs convert back to int64/uint64 where they fit.
    """

    def __init__(self, layout: PackedLayout):
        self.layout = layout

    # -- lane conversion ---------------------------------------------------

    def _unpack_obj(self, word) -> np.ndarray:
        words = _to_object_words(word)
        lanes = np.empty(words.shape + (self.layout.num_lanes,), dtype=object)
        for i, (off, ones) in enumerate(
            zip(self.layout.offsets, self.layout.lane_ones)
        ):
            lanes[..., i] = (words >> off) & ones
        return lanes

    def _unpack_signed_obj(self, word) -> np.ndarray:
        lanes = self._unpack_obj(word)
        for i, w in enumerate(self.layout.widths):
            half, full = 1 << (w - 1), 1 << w
            col = lanes[..., i]
            lanes[..., i] = np.where(col >= half, col - full, col)
        return lanes

    def _pack_obj(self, lanes: np.ndarray) -> np.ndarray:
        word = np.zeros(lanes.shape[:-1], dtype=object)
        for i, (off, ones) in enumerate(
            zip(self.layout.offsets, self.layout.lane_ones)
        ):
            word |= (lanes[..., i] & ones) << off
        return word

    @staticmethod
    def _to_uint64(word_obj: np.ndarray) -> np.ndarray:
        out = np.empty(word_obj.shape, dtype=np.uint64)
        flat_in = word_obj.reshape(-1)
        flat_out = out.reshape(-1)
        for i in range(flat_in.size):
            flat_out[i] = np.uint64(flat_in[i] & 0xFFFFFFFFFFFFFFFF)
        return out

    def unpack(self, word) -> np.ndarray:
        """Per-lane zero-extended values, int64 (lanes fit: width <= 64 only
        for the single-lane case, where values still fit uint64; cast per
        element)."""
        lanes = self._unpack_obj(word)
        return np.array(
            [[int(v) for v in row] for row in lanes.reshape(-1, lanes.shape[-1])],
            dtype=np.uint64,
        ).reshape(lanes.shape).astype(np.int64, casting="unsafe")

    def unpack_signed(self, word) -> np.ndarray:
        lanes = self._unpack_signed_obj(word)
        return np.array(
            [[int(v) for v in row] for row in lanes.reshape(-1, lanes.shape[-1])],
            dtype=np.int64,
        ).reshape(lanes.shape)

    def pack(self, lanes) -> np.ndarray:
        lanes = np.asarray(lanes)
        obj = np.empty(lanes.shape, dtype=object)
        flat_in, flat_out = lanes.reshape(-1), obj.reshape(-1)
        for i in range(flat_in.size):
            flat_out[i] = int(flat_in[i])
        return self._to_uint64(self._pack_obj(obj))

    # -- per-lane arithmetic -----------------------------------------------

    def _binary(self, a, b, fn, signed: bool):
        la = self._unpack_signed_obj(a) if signed else self._unpack_obj(a)
        lb = self._unpack_signed_obj(b) if signed else self._unpack_obj(b)
        out = np.empty_like(la)
        for i, w in enumerate(self.layout.widths):
            col = np.empty(la[..., i].shape, dtype=object)
            fa, fb, fc = (
                la[..., i].reshape(-1),
                lb[..., i].reshape(-1),
                col.reshape(-1),
            )
            for j in range(fa.size):
                fc[j] = fn(int(fa[j]), int(fb[j]), w)
            out[..., i] = col
        return self._to_uint64(self._pack_obj(out))

    def add_wrap(self, a, b):
        return self._binary(a, b, lambda x, y, w: (x + y) & ((1 << w) - 1), False)

    def sub_wrap(self, a, b):
        return self._binary(a, b, lambda x, y, w: (x - y) & ((1 << w) - 1), False)

    def add_unsigned_saturate(self, a, b):
        return self._binary(
            a, b, lambda x, y, w: min(x + y, (1 << w) - 1), False
        )

    def sub_unsigned_saturate(self, a, b):
        return self._binary(a, b, lambda x, y, w: max(x - y, 0), False)

    @staticmethod
    def _sclip(v, w):
        return max(-(1 << (w - 1)), min(v, (1 << (w - 1)) - 1))

    def add_signed_saturate(self, a, b):
        return self._binary(a, b, lambda x, y, w: self._sclip(x + y, w), True)

    def sub_signed_saturate(self, a, b):
        return self._binary(a, b, lambda x, y, w: self._sclip(x - y, w), True)

    def min_unsigned(self, a, b):
        return self._binary(a, b, lambda x, y, w: min(x, y), False)

    def max_unsigned(self, a, b):
        return self._binary(a, b, lambda x, y, w: max(x, y), False)

    def min_signed(self, a, b):
        return self._binary(a, b, lambda x, y, w: min(x, y), True)

    def max_signed(self, a, b):
        return self._binary(a, b, lambda x, y, w: max(x, y), True)

    def shift_left(self, word, amount):
        if amount >= self.layout.max_width:
            return np.zeros(np.asarray(word).shape, dtype=np.uint64)
        lanes = self._unpack_obj(word)
        for i, w in enumerate(self.layout.widths):
            lanes[..., i] = (lanes[..., i] << amount) & ((1 << w) - 1)
        return self._to_uint64(self._pack_obj(lanes))

    def shift_right_unsigned(self, word, amount):
        if amount >= self.layout.max_width:
            return np.zeros(np.asarray(word).shape, dtype=np.uint64)
        lanes = self._unpack_obj(word)
        for i in range(self.layout.num_lanes):
            lanes[..., i] = lanes[..., i] >> amount
        return self._to_uint64(self._pack_obj(lanes))
