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
    (8,) * 8,            # u64, the reference's u64 bench config
    (20, 20, 24),        # u64, lane 1 straddles bit 32
    (7, 7, 9, 9, 11, 12),  # u64, repeated heterogeneous widths
    (33,),               # u64, one lane wider than 32 bits
    (5, 59),
]
N = 2048
# amounts of the runtime shifts: in range, at and past the widest lane and
# the word, and the values that only the uint32 reduction of pint_tpu's
# _amount gives a meaning (negative, >= 2**31, >= 2**32)
AMOUNTS = [0, 1, 3, 7, 12, 31, 32, 33, 63, 64, 100, -1, -8, 2**31, 2**32 + 1,
           "max_width", "max_width-1"]


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


def _amount(jl, amount):
    if amount == "max_width":
        return jl.max_width
    if amount == "max_width-1":
        return jl.max_width - 1
    return amount


@pytest.mark.parametrize("amount", AMOUNTS, ids=str)
@pytest.mark.parametrize("op", ["shift_left", "shift_right_unsigned"])
@pytest.mark.parametrize("widths", LAYOUTS, ids=str)
def test_runtime_shift_bit_identical(widths, op, amount):
    """Python-int and 0-d tensor amounts against pint_tpu with the same
    amount as a traced int64 scalar."""
    jl, tl, a = _words(widths, 7)
    k = _amount(jl, amount)
    ref = np.asarray(getattr(JW, op)(jl, jnp.asarray(a), jnp.asarray(k, jnp.int64)))
    for amt in (k, torch.tensor(k, dtype=torch.int64)):
        got = getattr(TW, op)(tl, _t(a), amt)
        assert got.dtype == TW.container_dtype(tl) and got.shape == (N,)
        np.testing.assert_array_equal(_u(got, jl.word_dtype), ref)


@pytest.mark.parametrize("bad", [1.0, True, torch.tensor(2.0), torch.tensor(True)],
                         ids=str)
def test_runtime_shift_rejects_non_integer_amount(bad):
    with pytest.raises(TypeError, match="integral"):
        TW.shift_left(TLayout(8, 8), torch.zeros(3, dtype=torch.int16), bad)


@pytest.mark.parametrize("widths", [(3, 5), (5, 6, 5), (8, 8, 8, 8), (20, 20, 24)],
                         ids=str)
def test_container_dtype_every_width(widths):
    tl = TLayout(*widths)
    assert TW.container_dtype(tl).itemsize * 8 == tl.word_bits
