"""Port parity: the native host SWAR tier (``pint_tpu_torch.native``) against
the port's Oracle and ``ops/word.py``, and against the reference's
``pint_tpu.native.NativeOps`` on the same words.

The cases of tests/test_native.py, parametrized the same way (7 layouts x
10 binops, 7 x 2 shifts, pack/unpack at every word width), on the port's
library.  Tolerance: bit-identical words and lanes.  The whole module skips
only where the C++ compiler is missing (decided in a fixture, at run time).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from pint_tpu.native import NativeOps as JNativeOps
from pint_tpu.native import native_available as j_native_available
from pint_tpu_torch.convert import words_from_numpy, words_to_numpy
from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.native import BINOP_NAMES, SHIFT_NAMES, NativeOps, native_available
from pint_tpu_torch.ops import word as W
from pint_tpu_torch.utils import Oracle

REPO = Path(__file__).resolve().parents[1]

LAYOUTS = [
    PackedLayout(8, 8, 8, 8),
    PackedLayout(1, 2, 3, 4, 5, 6, 11),
    PackedLayout(5, 6, 5),
    PackedLayout(3, 3),
    PackedLayout(*([8] * 8)),
    PackedLayout(64),
    PackedLayout(1),
]
PACK_LAYOUTS = [
    PackedLayout(3, 3),                 # u8
    PackedLayout(5, 6, 5),              # u16
    PackedLayout(8, 8, 8, 8),           # u32
    PackedLayout(1, 2, 3, 4, 5, 6, 11), # u32 heterogeneous
    PackedLayout(*([8] * 8)),           # u64 <8x8>
    PackedLayout(64),                   # u64 single full-width lane
]
SHIFT_AMOUNTS = (0, 1, 3, 7, 12, 100, -1, 2**32 + 1)


@pytest.fixture(scope="module")
def native():
    if not native_available():
        pytest.skip("no C++ compiler: the native tier cannot build here")
    return NativeOps


def _rand(layout, n, seed, full=False):
    """Canonical words (unused bits zero), or every bit random."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << layout.word_bits, size=n, dtype=np.uint64)
    if not full:
        w &= np.uint64(layout.used_mask)
    return w.astype(layout.word_dtype)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", BINOP_NAMES)
def test_native_binop_matches_oracle(native, layout, opname):
    a, b = _rand(layout, 512, 0), _rand(layout, 512, 1)
    got = getattr(native(layout), opname)(a, b)
    expected = getattr(Oracle(layout), opname)(a.astype(np.uint64), b.astype(np.uint64))
    assert got.dtype == layout.word_dtype
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  expected & np.uint64(layout.word_ones))


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", SHIFT_NAMES)
def test_native_shift_matches_oracle(native, layout, opname):
    nat, oracle = native(layout), Oracle(layout)
    v = _rand(layout, 256, 2)
    for amount in range(0, layout.max_width + 2):
        got = getattr(nat, opname)(v, amount)
        expected = getattr(oracle, opname)(v.astype(np.uint64), amount)
        np.testing.assert_array_equal(got.astype(np.uint64),
                                      expected & np.uint64(layout.word_ones),
                                      err_msg=f"{opname}({amount}) {layout}")


def test_native_pack_unpack(native):
    layout = PackedLayout(8, 8, 8, 8)
    nat = native(layout)
    lanes = np.random.default_rng(3).integers(-128, 128, size=(64, 4), dtype=np.int32)
    words = nat.pack(lanes)
    np.testing.assert_array_equal(nat.unpack(words, signed=True), lanes)
    np.testing.assert_array_equal(nat.unpack(words, signed=False), lanes & 0xFF)


@pytest.mark.parametrize("layout", PACK_LAYOUTS, ids=str)
def test_native_pack_unpack_all_widths(native, layout):
    """Truncating pack, unsigned unpack and sign-extending unpack at every
    word width, against the offsets and against ``ops/word.py``'s pack,
    unpack and unpack_signed on the same lanes."""
    nat = native(layout)
    rng = np.random.default_rng(7)
    n = 128
    lanes = np.stack([rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
                      for _ in layout.widths], axis=-1)
    words = nat.pack(lanes)
    assert words.dtype == layout.word_dtype
    exp = np.zeros(n, dtype=np.uint64)
    for j, (w, off) in enumerate(zip(layout.widths, layout.offsets)):
        ones = np.uint64(~np.uint64(0)) if w >= 64 else np.uint64((1 << w) - 1)
        exp |= (lanes[:, j].astype(np.uint64) & ones) << np.uint64(off)
    np.testing.assert_array_equal(words.astype(np.uint64), exp)
    np.testing.assert_array_equal(words_to_numpy(W.pack(layout, torch.from_numpy(lanes))),
                                  words)

    t = words_from_numpy(words, device="cpu")
    uns = nat.unpack(words, signed=False)
    for j, (w, off) in enumerate(zip(layout.widths, layout.offsets)):
        ones = (1 << w) - 1 if w < 64 else (1 << 64) - 1
        np.testing.assert_array_equal(uns[:, j].astype(object) & ones,
                                      (words.astype(object) >> off) & ones)
    np.testing.assert_array_equal(uns, W.unpack(layout, t).to(torch.int64).numpy())
    np.testing.assert_array_equal(nat.unpack(words, signed=True),
                                  W.unpack_signed(layout, t).to(torch.int64).numpy())

    in_range = np.stack([rng.integers(-(1 << (w - 1)) if w > 1 else -1,
                                      (1 << (w - 1)) if w > 1 else 1, size=n, dtype=np.int64)
                         for w in layout.widths], axis=-1)
    np.testing.assert_array_equal(nat.unpack(nat.pack(in_range), signed=True), in_range)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_native_matches_word_path_on_full_range_words(native, layout):
    """Every binop and shift (amounts past the widest lane, -1 and 2**32 +
    1 among them) bit-identical to ``ops/word.py`` on words whose every bit
    is random, unused bits included: the words ``chip_smoke.py`` holds the
    native tier to K1, K9, K11a and K11b on."""
    nat = native(layout)
    a, b = _rand(layout, 2048, 4, full=True), _rand(layout, 2048, 5, full=True)
    ta, tb = words_from_numpy(a, device="cpu"), words_from_numpy(b, device="cpu")
    for op in BINOP_NAMES:
        np.testing.assert_array_equal(getattr(nat, op)(a, b),
                                      words_to_numpy(getattr(W, op)(layout, ta, tb)),
                                      err_msg=f"{op} {layout}")
    for op in SHIFT_NAMES:
        for amount in SHIFT_AMOUNTS:
            np.testing.assert_array_equal(getattr(nat, op)(a, amount),
                                          words_to_numpy(getattr(W, op)(layout, ta, amount)),
                                          err_msg=f"{op}({amount}) {layout}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_native_matches_the_reference_native(native, layout):
    """The port's library and the reference's, each built from its own
    copy of swar.cpp, on the same words: every binop, every shift, pack and
    both unpacks."""
    if not j_native_available():
        pytest.skip("the reference's native library cannot build here")
    nat, ref = native(layout), JNativeOps(layout)
    a, b = _rand(layout, 1024, 8, full=True), _rand(layout, 1024, 9, full=True)
    for op in BINOP_NAMES:
        np.testing.assert_array_equal(getattr(nat, op)(a, b), getattr(ref, op)(a, b))
    for op in SHIFT_NAMES:
        for amount in range(0, layout.max_width + 2):
            np.testing.assert_array_equal(getattr(nat, op)(a, amount),
                                          getattr(ref, op)(a, amount))
    for signed in (False, True):
        np.testing.assert_array_equal(nat.unpack(a, signed=signed), ref.unpack(a, signed=signed))
    lanes = ref.unpack(a, signed=True)
    np.testing.assert_array_equal(nat.pack(lanes), ref.pack(lanes))


def test_native_broadcasts_and_keeps_shape(native):
    """A scalar operand broadcasts; a 2-D buffer keeps its shape."""
    layout = PackedLayout(5, 6, 5)
    nat = native(layout)
    a = _rand(layout, 96, 10).reshape(8, 12)
    got = nat.add_wrap(a, a[0, 0])
    assert got.shape == (8, 12)
    t = words_from_numpy(a, device="cpu")
    np.testing.assert_array_equal(got, words_to_numpy(W.add_wrap(layout, t, t[0, 0])))


def test_library_builds_into_the_port_build_dir(native):
    """The library lies under pint_tpu_torch/_build/, named by the source's
    hash, and nothing of the port's is built under pint_tpu/."""
    from pint_tpu_torch import native as N

    lib = Path(N.load_library()._name)
    assert lib.parent == REPO / "pint_tpu_torch" / "_build"
    assert lib.name.startswith("_pint_swar_") and lib.suffix == ".so"
    assert N._so_path() == lib
    assert lib.name not in {p.name for p in (REPO / "pint_tpu" / "native").iterdir()}

