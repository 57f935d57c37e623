"""Port parity: pint_tpu_torch.ops.word against pint_tpu.ops.word.

The same seeded numpy words go through both; JAX's unsigned words and the
port's signed containers are compared through a numpy ``.view``.
Tolerance: bit-identical."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pint_tpu.layout import PackedLayout as JLayout
from pint_tpu.ops import word as JW
from pint_tpu_torch.layout import PackedLayout as TLayout
from pint_tpu_torch.ops import word as TW

LAYOUTS = [
    (8, 8, 8, 8),        # the control layout
    (16, 16),
    (32,),
    (4, 4, 4, 4, 4, 4),  # 24 bits in a u32 word
    (3, 5),              # u8, heterogeneous
    (5, 6, 5),           # u16, heterogeneous
    (1, 7, 8, 16),       # u32, heterogeneous (general dispatch)
    (10, 11, 11),
]
N = 2048


def _words(widths, seed):
    jl = JLayout(*widths)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**jl.word_bits, N, dtype=np.uint64)
    a = a.astype(jl.word_dtype)
    # edge patterns: zero, all ones, lane hi bits
    a[:3] = [0, jl.word_ones, jl.hi_mask]
    return jl, TLayout(*widths), a


def _t(a):
    return torch.from_numpy(a.view(np.dtype(f"int{a.dtype.itemsize * 8}")).copy())


def _u(t, dtype):
    return t.numpy().view(dtype)


@pytest.mark.parametrize("op", TW.BINOP_NAMES)
@pytest.mark.parametrize("widths", LAYOUTS, ids=str)
def test_binop_bit_identical(widths, op):
    jl, tl, a = _words(widths, 1)
    _, _, b = _words(widths, 2)
    ref = np.asarray(getattr(JW, op)(jl, jnp.asarray(a), jnp.asarray(b)))
    got = getattr(TW, op)(tl, _t(a), _t(b))
    assert got.dtype == TW.container_dtype(tl)
    np.testing.assert_array_equal(_u(got, jl.word_dtype), ref)


@pytest.mark.parametrize("widths", LAYOUTS, ids=str)
def test_lane_access_bit_identical(widths):
    jl, tl, a = _words(widths, 3)
    np.testing.assert_array_equal(
        _u(TW.unpack(tl, _t(a)), jl.word_dtype),
        np.asarray(JW.unpack(jl, jnp.asarray(a))),
    )
    np.testing.assert_array_equal(
        TW.unpack_signed(tl, _t(a)).numpy(),
        np.asarray(JW.unpack_signed(jl, jnp.asarray(a))),
    )
    for i in range(jl.num_lanes):
        np.testing.assert_array_equal(
            TW.get_signed(tl, _t(a), i).numpy(),
            np.asarray(JW.get_signed(jl, jnp.asarray(a), i)),
        )


@pytest.mark.parametrize("widths", LAYOUTS, ids=str)
def test_pack_bit_identical(widths):
    jl, tl, _ = _words(widths, 4)
    rng = np.random.default_rng(5)
    lanes = rng.integers(-(2**20), 2**20, (N, jl.num_lanes)).astype(np.int32)
    np.testing.assert_array_equal(
        _u(TW.pack(tl, torch.from_numpy(lanes)), jl.word_dtype),
        np.asarray(JW.pack(jl, jnp.asarray(lanes))),
    )


@pytest.mark.parametrize("widths", [w for w in LAYOUTS if len(w) > 1], ids=str)
def test_slice_word_bit_identical(widths):
    jl, tl, a = _words(widths, 6)
    for start, end in [(0, 1), (1, jl.num_lanes), (0, jl.num_lanes - 1)]:
        for keep in (False, True):
            _, ref = JW.slice_word(jl, jnp.asarray(a), start, end,
                                   keep_word_dtype=keep)
            _, got = TW.slice_word(tl, _t(a), start, end, keep_word_dtype=keep)
            ref = np.asarray(ref)
            np.testing.assert_array_equal(_u(got, ref.dtype), ref)


def test_u64_layouts_not_ported():
    with pytest.raises(NotImplementedError, match="64-bit"):
        TW.container_dtype(TLayout(32, 32))
