"""Port parity: pint_tpu_torch.ops.swar against pint_tpu.ops.pallas.

Every entry of the port's swar module gets the same seeded canonical words
as pint_tpu's Pallas entry, which runs in interpret mode on the CPU as
tests/test_pallas.py and tests/test_split64.py run it, over those files'
layouts.  On CPU tensors the port runs its plain versions; the CUDA kernels
are held to those in tests/test_torch_kernels_cuda.py.  Tolerance:
bit-identical.  pint_tpu's Pallas entries fail on an empty input, so the
empty cases compare with pint_tpu.ops.word instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.layout import PackedLayout as JLayout
from pint_tpu.ops import pallas as JP
from pint_tpu.ops import word as JW
from pint_tpu_torch.convert import words_from_numpy, words_to_numpy
from pint_tpu_torch.layout import PackedLayout as TLayout
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.ops import swar as S
from pint_tpu_torch.ops.split64 import merge_u64, split_u64

NATIVE = [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (5, 6, 5), (3, 3)]  # test_pallas.py
U64 = [(8,) * 8, (20, 20, 24), (7, 7, 9, 9, 11, 12), (33,),           # test_split64.py
       (1, 2, 3, 4, 5, 6, 11, 10, 9, 8), (5, 59)]
SHIFT_AMOUNTS = [0, 1, 3, 7, 12, 100, -1]


def _rand(widths, shape, seed):
    """Canonical words (bits above total_bits clear), numpy unsigned."""
    jl = JLayout(*widths)
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
    return (w & np.uint64(jl.used_mask)).astype(jl.word_dtype)


def _pair(w):
    """numpy u64 words -> planar (2, ...) uint32 pairs."""
    return np.stack([w & np.uint64(0xFFFFFFFF), w >> np.uint64(32)]).astype(np.uint32)


def _eq(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    out = words_to_numpy(got)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("op", S.BINOP_NAMES)
@pytest.mark.parametrize("widths", NATIVE + U64, ids=str)
def test_binop_parity(widths, op):
    a, b = _rand(widths, (1000,), 0), _rand(widths, (1000,), 1)
    ref = JP.binop(JLayout(*widths), op)(jnp.asarray(a), jnp.asarray(b))
    _eq(S.binop(TLayout(*widths), op)(words_from_numpy(a), words_from_numpy(b)), ref)


@pytest.mark.parametrize("op", S.BINOP_NAMES)
@pytest.mark.parametrize("widths", U64, ids=str)
def test_binop_pair_parity(widths, op):
    a, b = _pair(_rand(widths, (1000,), 4)), _pair(_rand(widths, (1000,), 5))
    ref = JP.binop_pair(JLayout(*widths), op)(jnp.asarray(a), jnp.asarray(b))
    got = S.binop_pair(TLayout(*widths), op)(words_from_numpy(a), words_from_numpy(b))
    assert got.dtype == torch.int32
    _eq(got, ref)


@pytest.mark.parametrize("amount", SHIFT_AMOUNTS)
@pytest.mark.parametrize("op", S.SHIFT_NAMES)
@pytest.mark.parametrize("widths", NATIVE + [(8,) * 8, (20, 20, 24)], ids=str)
def test_shift_parity(widths, op, amount):
    v = _rand(widths, (777,), 2)
    ref = JP.shift(JLayout(*widths), op)(jnp.asarray(v), amount)
    fn = S.shift(TLayout(*widths), op)
    _eq(fn(words_from_numpy(v), amount), ref)
    _eq(fn(words_from_numpy(v), torch.tensor(amount)), ref)


@pytest.mark.parametrize("amount", [0, 3, 32, 40, 64, 100, -1])
@pytest.mark.parametrize("op", S.SHIFT_NAMES)
@pytest.mark.parametrize("widths", [(8,) * 8, (20, 20, 24)], ids=str)
def test_shift_pair_parity(widths, op, amount):
    v = _pair(_rand(widths, (777,), 6))
    ref = JP.shift_pair(JLayout(*widths), op)(jnp.asarray(v), amount)
    _eq(S.shift_pair(TLayout(*widths), op)(words_from_numpy(v), amount), ref)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("widths", NATIVE + [(8,) * 8, (20, 20, 24)], ids=str)
def test_saturating_accumulate_parity(widths, signed):
    steps = 4
    acc = _rand(widths, (500,), 7)
    deltas = np.stack([_rand(widths, (500,), 8 + s) for s in range(steps)])
    ref = JP.saturating_accumulate(JLayout(*widths), signed=signed, steps=steps)(
        jnp.asarray(acc), jnp.asarray(deltas))
    fn = S.saturating_accumulate(TLayout(*widths), signed=signed, steps=steps)
    _eq(fn(words_from_numpy(acc), words_from_numpy(deltas)), ref)
    if JLayout(*widths).word_bits == 64:
        # the pair I/O form: acc (2, n), deltas (2, steps, n)
        got = fn(words_from_numpy(_pair(acc)), words_from_numpy(_pair(deltas)))
        _eq(got, _pair(np.asarray(ref)))


@pytest.mark.parametrize("shape", [(33, 70), (), (0,), (3, 0)], ids=str)
@pytest.mark.parametrize("widths", [(8, 8, 8, 8), (3, 3), (20, 20, 24)], ids=str)
def test_shapes(widths, shape):
    """2-D, 0-d and empty words through every entry."""
    jl, tl = JLayout(*widths), TLayout(*widths)
    a, b = _rand(widths, shape, 10), _rand(widths, shape, 11)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = words_from_numpy(a), words_from_numpy(b)
    empty = a.size == 0
    op = "min_signed"
    ref = JW.min_signed(jl, ja, jb) if empty else JP.binop(jl, op)(ja, jb)
    _eq(S.binop(tl, op)(ta, tb), ref)
    ref = (JW.shift_left(jl, ja, 3) if empty
           else JP.shift(jl, "shift_left")(ja, 3))
    _eq(S.shift(tl, "shift_left")(ta, 3), ref)
    deltas = np.stack([b, a])
    ref = JW.add_signed_saturate(jl, JW.add_signed_saturate(jl, ja, jb), ja)
    _eq(S.saturating_accumulate(tl, steps=2)(ta, words_from_numpy(deltas)), ref)
    if jl.word_bits == 64:
        ref = np.asarray(JW.min_signed(jl, ja, jb))
        _eq(S.binop_pair(tl, op)(words_from_numpy(_pair(a)), words_from_numpy(_pair(b))),
            _pair(ref))


def test_u64_words_and_pairs_agree():
    """binop on int64 words and binop_pair on their pairs give one result,
    through split_u64/merge_u64."""
    tl = TLayout(20, 20, 24)
    a, b = words_from_numpy(_rand((20, 20, 24), (300,), 20)), \
        words_from_numpy(_rand((20, 20, 24), (300,), 21))
    for op in S.BINOP_NAMES:
        words = S.binop(tl, op)(a, b)
        pairs = S.binop_pair(tl, op)(split_u64(a), split_u64(b))
        assert torch.equal(merge_u64(pairs), words)


def test_split_merge_round_trip():
    w = np.array([0, 1, 0xFFFFFFFF, 0x100000000, 2**63, 2**64 - 1], np.uint64)
    t = words_from_numpy(w)
    pair = split_u64(t)
    np.testing.assert_array_equal(words_to_numpy(pair), _pair(w))
    assert torch.equal(merge_u64(pair), t)


def test_cpu_words_launch_nothing():
    """A CPU tensor runs the plain version: no launch is counted."""
    tl = TLayout(8, 8, 8, 8)
    x = torch.zeros(8, dtype=torch.int32)
    before = K.launch_counts()
    S.binop(tl, "add_wrap")(x, x)
    S.shift(tl, "shift_left")(x, 1)
    S.saturating_accumulate(tl, steps=1)(x, x[None])
    assert K.launch_counts() == before


def test_factories_cached_and_checked():
    tl = TLayout(8, 8, 8, 8)
    assert S.binop(tl, "add_wrap") is S.binop(TLayout(8, 8, 8, 8), "add_wrap")
    assert S.supported(tl) and S.supported(TLayout(20, 20, 24))
    with pytest.raises(ValueError, match="unknown binop"):
        S.binop(tl, "mul")
    with pytest.raises(ValueError, match="unknown shift"):
        S.shift(tl, "rotate")
    with pytest.raises(ValueError, match="u64"):
        S.binop_pair(tl, "add_wrap")
    with pytest.raises(ValueError, match="u64"):
        S.shift_pair(tl, "shift_left")


@pytest.mark.parametrize("case", ["dtype", "shape", "trailing_pair", "deltas",
                                  "amount_shape", "amount_float"])
def test_bad_operands_raise(case):
    tl, t64 = TLayout(8, 8, 8, 8), TLayout(20, 20, 24)
    x = torch.zeros(6, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        if case == "dtype":
            S.binop(tl, "add_wrap")(x.to(torch.int64), x.to(torch.int64))
        elif case == "shape":
            S.binop(tl, "add_wrap")(x, x[:3])
        elif case == "trailing_pair":
            S.binop_pair(t64, "add_wrap")(x.reshape(3, 2), x.reshape(3, 2))
        elif case == "deltas":
            S.saturating_accumulate(tl, steps=2)(x, x[None])
        elif case == "amount_shape":
            S.shift(tl, "shift_left")(x, torch.tensor([1, 2]))
        else:
            S.shift(tl, "shift_left")(x, torch.tensor(1.0))
