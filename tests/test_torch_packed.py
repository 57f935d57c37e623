"""Port parity: pint_tpu_torch.PackedArray and its free functions against
pint_tpu.PackedArray, on the cases of tests/test_ops.py (the reference's
GTest cases, pint_test.cpp), and the port's Oracle against pint_tpu's.

Each case packs the same lanes in both packages, runs the same op, and
requires the words to be bit-identical (compared through a numpy .view)
and equal to the expected lanes where test_ops.py states them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pint_tpu as jt
import pint_tpu_torch as pt
from pint_tpu.utils import Oracle as JOracle
from pint_tpu_torch.convert import words_to_numpy
from pint_tpu_torch.utils import Oracle as TOracle


def _both(widths, *lanes):
    """The same packed value in both packages."""
    return (jt.PackedArray.pack(jt.PackedLayout(*widths), *[jnp.asarray(v) for v in lanes]),
            pt.PackedArray.pack(pt.PackedLayout(*widths), *lanes, device="cpu"))


def _same(j, t):
    assert j.layout.widths == t.layout.widths
    np.testing.assert_array_equal(words_to_numpy(t.word), np.asarray(j.word))


# (op, widths, a, b, expected lanes or None): test_ops.py's binop cases
BINOP_CASES = [
    ("add_wrap", (5, 6, 5), (1, 20, 10), (3, 2, 1), (4, 22, 11)),
    ("add_wrap", (5, 6, 5), (1, 60, 10), (31, 20, 27), (32, 80, 37)),
    ("add_wrap", (3, 3, 3), (3, 4, 5), (5, 6, 7), (8, 10, 12)),
    ("add_wrap", (1, 1, 1), (1, 0, 1), (0, 0, 1), (1, 0, 0)),
    ("add_unsigned_saturate", (3, 3, 3), (1, 2, 3), (2, 3, 4), (3, 5, 7)),
    ("add_unsigned_saturate", (3, 3, 3), (1, 2, 3), (7, 4, 6), (7, 6, 7)),
    ("add_unsigned_saturate", (1, 1, 1), (1, 0, 1), (0, 0, 1), (1, 0, 1)),
    ("add_unsigned_saturate", (3, 4, 3), (1, 2, 3), (7, 4, 6), (7, 6, 7)),
    ("add_signed_saturate", (4, 4, 4), (1, 2, 3), (2, 3, 4), (3, 5, 7)),
    ("add_signed_saturate", (4, 4, 4), (-1, -2, -3), (-2, -3, -4), (-3, -5, -7)),
    ("add_signed_saturate", (4, 4, 4), (1, -2, 3), (-2, 3, -4), (-1, 1, -1)),
    ("add_signed_saturate", (4, 4, 4), (1, 2, 3), (7, 4, 6), (7, 6, 7)),
    ("add_signed_saturate", (4, 4, 4), (-1, -2, -3), (-8, -4, -6), (-8, -6, -8)),
    ("add_signed_saturate", (4, 5, 4), (1, 2, 3), (2, 3, 4), (3, 5, 7)),
    ("add_signed_saturate", (4, 5, 4), (-1, -2, -3), (-2, -3, -4), (-3, -5, -7)),
    ("add_signed_saturate", (4, 5, 4), (1, -2, 3), (-2, 3, -4), (-1, 1, -1)),
    ("add_signed_saturate", (4, 5, 4), (1, 10, 3), (7, 14, 6), (7, 15, 7)),
    ("add_signed_saturate", (4, 5, 4), (-1, -12, -3), (-8, -14, -6), (-8, -16, -8)),
    ("sub_wrap", (5, 6, 5), (4, 20, 10), (3, 2, 1), (1, 18, 9)),
    ("sub_wrap", (3, 3, 3), (7, 6, 5), (1, 2, 3), (6, 4, 2)),
    ("sub_wrap", (1, 1, 1), (1, 1, 0), (1, 0, 0), (0, 1, 0)),
    ("sub_wrap", (3, 3, 3), (1, 4, 2), (7, 2, 6), (-6, 2, -4)),
    ("sub_wrap", (1, 1, 1), (1, 0, 0), (1, 1, 0), (0, -1, 0)),
    ("sub_unsigned_saturate", (5, 6, 5), (4, 20, 10), (3, 2, 1), (1, 18, 9)),
    ("sub_unsigned_saturate", (5, 6, 5), (4, 2, 1), (3, 20, 10), (1, 0, 0)),
    ("sub_unsigned_saturate", (1, 1, 1), (1, 0, 0), (1, 1, 0), (0, 0, 0)),
    ("sub_signed_saturate", (5, 6, 5), (4, 20, 10), (3, 2, 1), (1, 18, 9)),
    ("sub_signed_saturate", (5, 6, 5), (-4, -20, -10), (-3, -2, -1), (-1, -18, -9)),
    ("sub_signed_saturate", (4, 6, 4), (4, 0, 7), (-6, -32, 1), (7, 31, 6)),
    ("sub_signed_saturate", (4, 6, 4), (-4, -2, -6), (6, 30, 1), (-8, -32, -7)),
    ("min_unsigned", (4, 6, 4), (1, 2, 3), (4, 5, 15), (1, 2, 3)),
    ("max_unsigned", (4, 6, 4), (1, 2, 3), (4, 5, 15), (4, 5, 15)),
    ("min_unsigned", (4, 6, 4), (4, 5, 15), (1, 2, 3), (1, 2, 3)),
    ("max_unsigned", (4, 6, 4), (4, 5, 15), (1, 2, 3), (4, 5, 15)),
    ("min_unsigned", (4, 6, 4), (4, 5, 3), (1, 15, 3), (1, 5, 3)),
    ("max_unsigned", (4, 6, 4), (4, 5, 3), (1, 15, 3), (4, 15, 3)),
    ("min_signed", (4, 6, 4), (-1, -5, 0), (-4, -2, -8), (-4, -5, -8)),
    ("max_signed", (4, 6, 4), (-1, -5, 0), (-4, -2, -8), (-1, -2, 0)),
    ("min_signed", (4, 6, 4), (1, 5, 0), (4, 2, 7), (1, 2, 0)),
    ("max_signed", (4, 6, 4), (1, 5, 0), (4, 2, 7), (4, 5, 7)),
    ("min_signed", (4, 6, 4), (-1, 5, 0), (4, -2, 7), (-1, -2, 0)),
    ("max_signed", (4, 6, 4), (-1, 5, 0), (4, -2, 7), (4, 5, 7)),
    # README worked examples (test_ops.py:345-368)
    ("add_wrap", (5, 6, 5), (2, 10, 20), (1, 2, 12), (3, 12, 0)),
    ("add_unsigned_saturate", (5, 6, 5), (2, 10, 20), (1, 2, 12), (3, 12, 31)),
    ("add_wrap", (5, 6, 5), (1, 20, 10), (30, 60, 20), (31, 16, 30)),
    ("add_unsigned_saturate", (5, 6, 5), (1, 20, 10), (31, 60, 20), (31, 63, 30)),
    # a u64 layout, not in test_ops.py
    ("add_signed_saturate", (20, 20, 24), (2**19 - 1, -5, 3), (1, -2**19, -4), None),
    ("sub_unsigned_saturate", (32, 32), (5, 2**32 - 1), (6, 1), (0, 2**32 - 2)),
]


@pytest.mark.parametrize("op, widths, a, b, expected", BINOP_CASES,
                         ids=lambda v: str(v) if not isinstance(v, str) else v)
def test_binop_case(op, widths, a, b, expected):
    (ja, ta), (jb, tb) = _both(widths, *a), _both(widths, *b)
    got = getattr(pt, op)(ta, tb)
    _same(getattr(jt, op)(ja, jb), got)
    if expected is not None:
        _same(_both(widths, *expected)[0], got)


SHIFT_CASES = [  # test_ops.py:304-342
    ("shift_left", (4, 4, 4), (1, 2, 3), 2, (4, 8, 12)),
    ("shift_left", (4, 4, 4), (1, 2, 3), 3, (8, 0, 8)),
    ("shift_left", (4, 4, 4), (1, 2, 3), 4, (0, 0, 0)),
    ("shift_left", (4, 4, 4), (1, 2, 3), 5, (0, 0, 0)),
    ("shift_left", (3, 7, 6), (1, 2, 3), 2, (4, 8, 12)),
    ("shift_left", (3, 7, 6), (1, 2, 3), 3, (0, 16, 24)),
    ("shift_left", (3, 7, 6), (1, 2, 3), 6, (0, 0, 0)),
    ("shift_right_unsigned", (4, 4, 4), (4, 8, 12), 2, (1, 2, 3)),
    ("shift_right_unsigned", (4, 4, 4), (4, 8, 12), 3, (0, 1, 1)),
    ("shift_right_unsigned", (4, 4, 4), (4, 8, 12), 4, (0, 0, 0)),
    ("shift_right_unsigned", (4, 4, 4), (4, 8, 12), 5, (0, 0, 0)),
    ("shift_right_unsigned", (3, 7, 6), (4, 8, 12), 2, (1, 2, 3)),
    ("shift_right_unsigned", (3, 7, 6), (5, 106, 42), 4, (0, 6, 2)),
    ("shift_right_unsigned", (3, 7, 6), (5, 106, 42), 6, (0, 1, 0)),
    ("shift_left", (20, 20, 24), (1, 2**19, 3), 19, None),
    ("shift_right_unsigned", (20, 20, 24), (1, 2**19, 3), -1, (0, 0, 0)),
]


@pytest.mark.parametrize("op, widths, value, amount, expected", SHIFT_CASES,
                         ids=lambda v: str(v) if not isinstance(v, str) else v)
def test_shift_case(op, widths, value, amount, expected):
    jv, tv = _both(widths, *value)
    ref = getattr(jt, op)(jv, jnp.asarray(amount, jnp.int64))
    for amt in (amount, torch.tensor(amount)):   # int and tensor amounts
        got = getattr(pt, op)(tv, amt)
        _same(ref, got)
        if expected is not None:
            _same(_both(widths, *expected)[0], got)


def test_pack_get_slice():
    lay = pt.PackedLayout(5, 6, 5)
    assert int(pt.PackedArray.pack(lay, 1, 20, 10, device="cpu").word) == 1 | (20 << 5) | (10 << 11)
    r = pt.PackedArray.pack(lay, 33, 66, 234, device="cpu")
    assert int(r.word) == (33 & 0x1F) | ((66 & 0x3F) << 5) | ((234 & 0x1F) << 11)
    r = pt.PackedArray.pack(lay, [1, -3, -10], device="cpu")
    assert [int(pt.get_signed(r, i)) for i in range(3)] == [1, -3, -10]
    assert [int(pt.get(r, i)) for i in range(3)] == [1, 61, 22]
    jv, tv = _both((1, 2, 3, 4, 5), 1, 2, 3, 4, 5)
    s = pt.slice_lanes(tv, 2, 4)
    assert s.layout.widths == (3, 4)
    _same(jt.slice_lanes(jv, 2, 4), s)
    np.testing.assert_array_equal(s.lanes().numpy(), [3, 4])


@pytest.mark.parametrize("widths", [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (3, 3),
                                    (20, 20, 24)], ids=str)
def test_lanes_and_batches(widths):
    """Stacked lanes in, every view out, against pint_tpu, and each batch
    element against the same op on that element alone."""
    jl = jt.PackedLayout(*widths)
    rng = np.random.default_rng(0)
    lanes = rng.integers(-(2**20), 2**20, (64, jl.num_lanes))
    ja = jt.PackedArray.pack(jl, jnp.asarray(lanes))
    ta = pt.PackedArray.pack(pt.PackedLayout(*widths), torch.as_tensor(lanes))
    _same(ja, ta)
    bits = np.dtype(f"uint{jl.word_bits}")
    np.testing.assert_array_equal(ta.lanes().numpy().view(bits), np.asarray(ja.lanes()))
    np.testing.assert_array_equal(ta.lanes_signed().numpy(), np.asarray(ja.lanes_signed()))
    perm = np.arange(64)[::-1].copy()
    tb = ta[torch.as_tensor(perm)].reshape(8, 8)
    both = pt.add_unsigned_saturate(ta.reshape(8, 8), tb)
    _same(jt.add_unsigned_saturate(ja.reshape(8, 8), ja[jnp.asarray(perm)].reshape(8, 8)),
          both)
    for i in range(0, 8, 3):
        single = pt.add_unsigned_saturate(ta.reshape(8, 8)[i, i], tb[i, i])
        assert int(single.word) == int(both.word[i, i])


def test_broadcast_operands():
    """(4, 1) with (1, 5) words broadcast to (4, 5), as jnp broadcasting
    does in pint_tpu."""
    jl, tl = jt.PackedLayout(8, 8, 8, 8), pt.PackedLayout(8, 8, 8, 8)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (4, 1), dtype=np.uint32)
    b = rng.integers(0, 2**32, (1, 5), dtype=np.uint32)
    got = pt.sub_signed_saturate(pt.PackedArray.from_words(tl, a, device="cpu"),
                                 pt.PackedArray.from_words(tl, b, device="cpu"))
    ref = jt.sub_signed_saturate(jt.PackedArray.from_words(jl, jnp.asarray(a)),
                                 jt.PackedArray.from_words(jl, jnp.asarray(b)))
    assert got.shape == (4, 5)
    _same(ref, got)


def test_operator_overloads():
    lay = pt.PackedLayout(4, 4)
    a = pt.PackedArray.pack(lay, 3, 5, device="cpu")
    b = pt.PackedArray.pack(lay, 1, 4, device="cpu")
    assert int((a | b).word) == (int(a.word) | int(b.word))
    assert int((a & b).word) == (int(a.word) & int(b.word))
    assert int((a ^ b).word) == (int(a.word) ^ int(b.word))
    assert int((~a).word) & 0xFF == ~int(a.word) & 0xFF
    assert bool(a.equal(pt.PackedArray.pack(lay, 3, 5, device="cpu")))
    assert not bool(a.not_equal(pt.PackedArray.pack(lay, 3, 5, device="cpu")))
    assert bool(a.not_equal(b))
    batch = pt.PackedArray.from_words(lay, np.array([0x35, 0x14], np.uint8), device="cpu")
    both = pt.PackedArray.from_words(lay, np.array([0x35, 0x99], np.uint8), device="cpu")
    np.testing.assert_array_equal(batch.not_equal(both).numpy(), [False, True])
    np.testing.assert_array_equal(batch.equal(both).numpy(), [True, False])
    other = pt.PackedArray.pack(pt.PackedLayout(4, 5), 1, 1, device="cpu")
    with pytest.raises(ValueError):
        a.not_equal(other)
    with pytest.raises(ValueError):
        pt.add_wrap(a, other)
    with pytest.raises(TypeError):
        pt.add_wrap(a, a.word)


def test_constructors_and_repr():
    lay = pt.PackedLayout(32, 32)
    w = pt.PackedArray.from_words(lay, [2**64 - 1, 5], device="cpu")
    assert w.dtype == torch.int64 and w.device.type == "cpu"
    np.testing.assert_array_equal(words_to_numpy(w.word), [2**64 - 1, 5])
    np.testing.assert_array_equal(
        words_to_numpy(pt.PackedArray.from_words(lay, torch.tensor([-1])).word), [2**64 - 1])
    z = pt.PackedArray.zeros(pt.PackedLayout(5, 6, 5), (2, 3), device="cpu")
    assert z.shape == (2, 3) and z.dtype == torch.int16
    assert repr(pt.PackedArray.pack(pt.PackedLayout(8, 8), 255, 1, device="cpu")) == \
        "PackedArray(PackedLayout(8, 8)<u16>, lanes=[255, 1])"
    packed = pt.PackedArray.pack(lay, 1, 2, device="cpu")
    assert packed.astype_words(torch.int32).dtype == torch.int32
    if not torch.cuda.is_available():   # asking for a card that is not there
        with pytest.raises(RuntimeError, match="cuda"):
            pt.PackedArray.zeros(lay, (2,), device="cuda")


@pytest.mark.parametrize("widths", [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (5, 6, 5),
                                    (3, 3), (8,) * 8, (20, 20, 24)], ids=str)
def test_oracle_parity(widths):
    """The port's Oracle equals pint_tpu's on every op, and the port's
    PackedArray ops equal both on canonical words."""
    jl, tl = jt.PackedLayout(*widths), pt.PackedLayout(*widths)
    jo, to = JOracle(jl), TOracle(tl)
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 2**64 - 1, 256, dtype=np.uint64, endpoint=True)
            & np.uint64(jl.used_mask) for _ in range(2))
    ta = pt.PackedArray.from_words(tl, a.astype(jl.word_dtype), device="cpu")
    tb = pt.PackedArray.from_words(tl, b.astype(jl.word_dtype), device="cpu")
    for op in pt.ops.swar.BINOP_NAMES:
        exp = getattr(jo, op)(a, b)
        np.testing.assert_array_equal(getattr(to, op)(a, b), exp)
        got = words_to_numpy(getattr(pt, op)(ta, tb).word).astype(np.uint64)
        np.testing.assert_array_equal(got, exp)
    for op in ("shift_left", "shift_right_unsigned"):
        for amount in (0, 3, jl.max_width):
            exp = getattr(jo, op)(a, amount)
            np.testing.assert_array_equal(getattr(to, op)(a, amount), exp)
            got = words_to_numpy(getattr(pt, op)(ta, amount).word).astype(np.uint64)
            np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(to.unpack(a), jo.unpack(a))
    np.testing.assert_array_equal(to.unpack_signed(a), jo.unpack_signed(a))
    np.testing.assert_array_equal(to.pack(jo.unpack(a)), jo.pack(jo.unpack(a)))


@pytest.mark.parametrize("widths", [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (5, 6, 5),
                                    (20, 20, 24)], ids=str)
def test_profiling_parity(widths):
    """op_word_costs and roofline_report equal pint_tpu's on the same
    inputs; the port names the integer bound "alu" where pint_tpu says
    "vpu"."""
    from pint_tpu.utils import profiling as JProf
    from pint_tpu_torch.utils import profiling as TProf

    jl, tl = jt.PackedLayout(*widths), pt.PackedLayout(*widths)
    assert TProf.op_word_costs(tl) == JProf.op_word_costs(jl)
    rates = {"add_unsigned_saturate": 2.3e11, "shift_left": 3.4e11, "min_signed": 1e9}
    for alu in (1e13, 1e11):
        got = TProf.roofline_report(tl, rates, 2.9e12, alu)
        ref = JProf.roofline_report(jl, rates, 2.9e12, alu)
        for op in rates:
            assert got[op]["bound"] == {"vpu": "alu", "mem": "mem"}[ref[op]["bound"]]
            for k in ("measured_Gwords_per_s", "speed_of_light_Gwords_per_s", "efficiency"):
                assert got[op][k] == ref[op][k]


def test_profiling_trace_writes_chrome_trace(tmp_path):
    from pint_tpu_torch.utils.profiling import trace

    lay = pt.PackedLayout(8, 8, 8, 8)
    with trace(str(tmp_path / "t")):
        pt.add_wrap(pt.PackedArray.zeros(lay, (64,), device="cpu"),
                    pt.PackedArray.zeros(lay, (64,), device="cpu"))
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
