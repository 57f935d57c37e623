"""Port parity: checkpoints (``pint_tpu_torch.utils.checkpoint``) against
``pint_tpu.utils.checkpoint``, in one process.

The cases of tests/test_utils.py:24-105 that need no mesh, files crossing
between the packages in both directions (compared by keys, dtypes and
values: ``np.savez`` stamps its zip entries with the time, so bytes
differ), files JAX writes on conftest's 8-device virtual mesh read by the
port's ``load_full``, and the resume claim of ``save_solver_state``: a
solve interrupted, saved, loaded and resumed gives the uninterrupted
solve's words bit for bit.  The sharded cases on real meshes run in
tests/test_torch_parallel.py's gloo worlds.  Tolerance: bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pint_tpu import PackedArray as JPackedArray
from pint_tpu import PackedLayout as JPackedLayout
from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import quantize as j_quantize
from pint_tpu.parallel import make_mesh as j_make_mesh
from pint_tpu.utils import checkpoint as J
from pint_tpu_torch import PackedArray, PackedLayout
from pint_tpu_torch.convert import quantized_qp_from_arrays, words_from_numpy, words_to_numpy
from pint_tpu_torch.mpc import FixedPointPGD, FusedPGD
from pint_tpu_torch.utils import checkpoint as C

WIDTHS = [(8, 8, 8, 8), (3, 3), (5, 6, 5), (8,) * 8, (20, 20, 24)]
IDS = ["u32", "u8", "u16", "u64", "u64_20_20_24"]


def _words(widths, shape, seed):
    lay = PackedLayout(*widths)
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << lay.word_bits, size=shape, dtype=np.uint64)
    return lay, w.astype(lay.word_dtype)


def _same_file(a, b, skip=()):
    """Two .npz files hold the same keys, and under each the same dtype and
    values."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k in skip:
                continue
            assert za[k].dtype == zb[k].dtype, k
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_packed_checkpoint_roundtrip(tmp_path):
    """tests/test_utils.py:24."""
    lay = PackedLayout(8, 8, 8, 8)
    words = np.arange(64, dtype=np.uint32)
    p = tmp_path / "ckpt.npz"
    C.save_packed(p, PackedArray.from_words(lay, words, device="cpu"))
    back = C.load_packed(p, device="cpu")
    assert back.layout == lay and back.device.type == "cpu"
    np.testing.assert_array_equal(words_to_numpy(back.word), words)


def test_solver_state_roundtrip(tmp_path):
    """tests/test_utils.py:35, with the port's container words."""
    u = torch.arange(32, dtype=torch.int32).reshape(2, 16) - 16
    g = torch.arange(128, dtype=torch.int32).reshape(2, 64)
    p = tmp_path / "state.npz"
    C.save_solver_state(p, u, g, iters_done=17, meta={"horizon": 50})
    u2, g2, it, meta = C.load_solver_state(p)
    assert u2.dtype == np.uint32 and g2.dtype == np.int32
    np.testing.assert_array_equal(u2, words_to_numpy(u))
    np.testing.assert_array_equal(g2, g.numpy())
    assert it == 17 and meta["horizon"] == 50


def test_solver_state_rejects_other_dtypes(tmp_path):
    g = np.zeros((2, 64), np.int32)
    with pytest.raises(ValueError, match="32-bit words"):
        C.save_solver_state(tmp_path / "s.npz", np.zeros((2, 16), np.int64), g, iters_done=0)
    with pytest.raises(ValueError, match="int32"):
        C.save_solver_state(tmp_path / "s.npz", np.zeros((2, 16), np.uint32),
                            g.astype(np.int64), iters_done=0)


@pytest.mark.parametrize("widths", WIDTHS, ids=IDS)
def test_packed_files_cross_both_ways(tmp_path, widths):
    """The same words saved by each package: equal keys, dtypes (the
    unsigned word dtype) and values; each package loads the other's."""
    lay, words = _words(widths, (6, 5), 1)
    jl = JPackedLayout(*widths)
    C.save_packed(tmp_path / "port.npz", PackedArray.from_words(lay, words, device="cpu"))
    J.save_packed(tmp_path / "jax.npz", JPackedArray.from_words(jl, jnp.asarray(words)))
    _same_file(tmp_path / "port.npz", tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as z:
        assert z["words"].dtype == lay.word_dtype
    back = C.load_packed(tmp_path / "jax.npz", device="cpu")
    assert back.layout == lay
    np.testing.assert_array_equal(words_to_numpy(back.word), words)
    jback = J.load_packed(tmp_path / "port.npz")
    assert jback.layout == jl
    np.testing.assert_array_equal(np.asarray(jback.word), words)


def test_solver_state_files_cross_both_ways(tmp_path):
    _, u = _words((8, 8, 8, 8), (3, 16), 2)
    g = np.random.default_rng(3).integers(-2**31, 2**31, (3, 64), dtype=np.int64).astype(np.int32)
    meta = {"iters": 40, "x": [1.5, 2.0]}
    C.save_solver_state(tmp_path / "port.npz", words_from_numpy(u, device="cpu"),
                        torch.from_numpy(g), iters_done=9, meta=meta)
    J.save_solver_state(tmp_path / "jax.npz", jnp.asarray(u), jnp.asarray(g), iters_done=9,
                        meta=meta)
    _same_file(tmp_path / "port.npz", tmp_path / "jax.npz")
    for got in (C.load_solver_state(tmp_path / "jax.npz"),
                J.load_solver_state(tmp_path / "port.npz")):
        np.testing.assert_array_equal(got[0], u)
        np.testing.assert_array_equal(got[1], g)
        assert got[2:] == (9, meta)


@pytest.mark.parametrize("widths", WIDTHS[:4], ids=IDS[:4])
def test_whole_array_sharded_files_cross_both_ways(tmp_path, widths):
    """``save_sharded`` with no mesh (one process, the whole array) writes
    the file JAX writes for an array on one device: same keys, dtypes and
    values.  Each package's ``load_full`` reads the other's, and JAX's
    ``load_sharded`` puts the port's file on its 8-device mesh."""
    lay, words = _words(widths, (16, 8), 4)
    jl = JPackedLayout(*widths)
    p_port = C.save_sharded(str(tmp_path / "port"),
                            PackedArray.from_words(lay, words, device="cpu"))
    one = jax.device_put(jnp.asarray(words), jax.devices()[0])
    p_jax = J.save_sharded(str(tmp_path / "jax"), JPackedArray.from_words(jl, one))
    assert p_port.endswith("port.proc0.npz")
    _same_file(p_port, p_jax)
    for load_full, prefix in ((C.load_full, "jax"), (J.load_full, "port")):
        full, w = load_full(str(tmp_path / prefix))
        assert w == lay.widths and full.dtype == lay.word_dtype
        np.testing.assert_array_equal(full, words)
    sharding = NamedSharding(j_make_mesh(dp=4, tp=2), P("dp", "tp"))
    back, w = J.load_sharded(str(tmp_path / "port"), sharding)
    assert w == lay.widths
    np.testing.assert_array_equal(np.asarray(back), words)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_plain_arrays_keep_their_dtype(tmp_path, kind):
    """A numpy array or a tensor that is not a PackedArray is stored in its
    own dtype, with no widths."""
    vals = np.arange(8 * 4, dtype=np.int32).reshape(8, 4) - 9
    arr = vals if kind == "numpy" else torch.from_numpy(vals)
    path = C.save_sharded(str(tmp_path / "v"), arr)
    with np.load(path) as z:
        assert str(z["dtype"]) == "<i4" and "widths" not in z.files
    full, widths = J.load_full(str(tmp_path / "v"))
    assert widths is None and full.dtype == np.int32
    np.testing.assert_array_equal(full, vals)


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_jax_virtual_mesh_files_load_in_the_port(tmp_path, dp, tp):
    """JAX's save_sharded on its 8-device mesh (one file, 8 shards) read by
    the port's load_full; words stay unsigned."""
    jl = JPackedLayout(8, 8, 8, 8)
    words = np.arange(16 * 8, dtype=np.uint32).reshape(16, 8) * 2654435761
    sharding = NamedSharding(j_make_mesh(dp=dp, tp=tp), P("dp", "tp"))
    prefix = str(tmp_path / "plan")
    J.save_sharded(prefix, JPackedArray.from_words(jl, jax.device_put(jnp.asarray(words),
                                                                       sharding)))
    full, widths = C.load_full(prefix)
    assert widths == jl.widths and full.dtype == np.uint32
    np.testing.assert_array_equal(full, words)


def test_missing_coverage_raises(tmp_path):
    """tests/test_utils.py:80-105's single-process half: a file holding half
    the rows cannot serve the whole array."""
    vals = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    prefix = str(tmp_path / "half")
    C.save_sharded(prefix, vals)
    with np.load(prefix + ".proc0.npz") as z:
        keep = {k: z[k] for k in z.files}
    keep["data0"], keep["bounds0"] = vals[:4], np.array([[0, 4], [0, 4]], np.int64)
    np.savez(prefix + ".proc0.npz", **keep)
    with pytest.raises(ValueError, match="cover only"):
        C.load_full(prefix)
    with pytest.raises(FileNotFoundError):
        C.load_full(str(tmp_path / "nothing"))
    with pytest.raises(ValueError, match="mesh"):
        C.save_sharded(prefix, vals, spec=("dp", None))


@pytest.mark.parametrize("solver", ["FixedPointPGD", "FusedPGD"])
def test_resume_from_solver_state_is_bit_identical(tmp_path, solver):
    """``save_solver_state``'s claim: 7 iterations, a snapshot, a load and 8
    more give the words of 15 uninterrupted ones (and JAX's FixedPointPGD's
    15)."""
    ref = j_quantize(j_condense(T=50))
    qqp = quantized_qp_from_arrays(ref)
    cls = {"FixedPointPGD": FixedPointPGD, "FusedPGD": FusedPGD}[solver]
    rng = np.random.default_rng(12)
    x0 = np.stack([rng.uniform(-3, 3, 16), rng.uniform(-1, 1, 16)], -1)
    g = torch.as_tensor(qqp.g_lane_fixed(x0))
    whole = cls(qqp, iters=15, device="cpu")
    want = whole.solve_words(whole.init_words(16), g)
    first = cls(qqp, iters=7, device="cpu")
    part = first.solve_words(first.init_words(16), g)
    C.save_solver_state(tmp_path / "s.npz", part, g, iters_done=7, meta={"solver": solver})
    u, g2, done, meta = C.load_solver_state(tmp_path / "s.npz")
    rest = cls(qqp, iters=15 - done, device="cpu")
    got = rest.solve_words(words_from_numpy(u, device="cpu"), torch.from_numpy(g2))
    assert meta == {"solver": solver} and not torch.equal(part, want)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    from pint_tpu.mpc import FixedPointPGD as JFixed

    jw = jax.jit(JFixed(ref, iters=15).solve_words)(jnp.zeros((16, ref.padded // 4), jnp.uint32),
                                                     jnp.asarray(g.numpy()))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(jw))
