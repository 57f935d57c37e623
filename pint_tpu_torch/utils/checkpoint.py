"""Checkpoint/resume for solver state (port of ``pint_tpu/utils/checkpoint.py``).

The persistent state of a solve is the MPC iterate -- packed control words
plus the quantized-QP description -- and long batched sweeps want cheap
periodic snapshots.  The format is the reference's, so files cross between
the two packages in both directions: a single ``.npz`` with the packed
words, the lane widths and solver metadata.  Words are stored in the
layout's unsigned ``word_dtype`` (through
:func:`~pint_tpu_torch.convert.words_to_numpy`), never as the port's signed
container, and come back in the container on the device.

Sharded checkpoints: :func:`save_sharded` has every process write ONLY its
own block to ``{prefix}.proc{K}.npz`` (no gather), with the block's bounds
in the global array, and :func:`load_sharded` assembles this rank's block
under any (mesh, spec) from whichever shard files cover it, so a
checkpoint saved on one mesh restores onto another.
"""

from __future__ import annotations

import glob
import json
from typing import Optional, Tuple

import numpy as np
import torch

from pint_tpu_torch.convert import words_from_numpy, words_to_numpy
from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.packed import PackedArray
from pint_tpu_torch.parallel.mesh import _SPECS, _block

__all__ = [
    "save_packed",
    "load_packed",
    "save_solver_state",
    "load_solver_state",
    "save_sharded",
    "load_sharded",
    "load_full",
]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_packed(path, arr: PackedArray) -> None:
    """Snapshot a PackedArray (words + layout) to ``path``.npz."""
    np.savez(
        path,
        words=words_to_numpy(arr.word),
        widths=np.asarray(arr.layout.widths, np.int64),
    )


def load_packed(path, device="cuda") -> PackedArray:
    """The PackedArray of a :func:`save_packed` file, on the card unless
    ``device="cpu"`` is asked for; raises without a card."""
    device = K.resolve_device(device)
    with np.load(path) as z:
        layout = PackedLayout(*[int(w) for w in z["widths"]])
        words = z["words"]
    return PackedArray.from_words(layout, words_from_numpy(words, device=device))


def save_solver_state(
    path,
    u_words,
    g_pre,
    *,
    iters_done: int,
    meta: Optional[dict] = None,
) -> None:
    """Snapshot an in-flight PGD solve (iterate + linear term + progress).

    ``u_words`` are CONTROL_LAYOUT's 32-bit words (the port's int32
    container or unsigned numpy), stored as uint32; ``g_pre`` is stored as
    int32.  The words are integer-exact, so a resume from the snapshot
    takes the exact trajectory the uninterrupted solve would have taken.
    On multi-process runs, pass this rank's shard and a per-rank path."""
    u = _host(u_words)
    g = _host(g_pre)
    if u.dtype.itemsize != 4 or u.dtype.kind not in "iu":
        raise ValueError(f"u_words must be 32-bit words, got {u.dtype}")
    if g.dtype != np.int32:
        raise ValueError(f"g_pre must be int32, got {g.dtype}")
    np.savez(
        path,
        u_words=u.view(np.uint32),
        g_pre=g,
        iters_done=np.int64(iters_done),
        meta=json.dumps(meta or {}),
    )


def load_solver_state(path) -> Tuple[np.ndarray, np.ndarray, int, dict]:
    """(u_words uint32, g_pre int32, iters_done, meta), numpy as the
    reference returns them: :func:`~pint_tpu_torch.convert.words_from_numpy`
    puts the words back on a device."""
    with np.load(path) as z:
        return (
            z["u_words"],
            z["g_pre"],
            int(z["iters_done"]),
            json.loads(str(z["meta"])),
        )


# ---------------------------------------------------------------------------
# Sharded (multi-process) checkpoints
# ---------------------------------------------------------------------------

def _spec(spec, ndim: int) -> tuple:
    """``spec`` (one of :func:`~pint_tpu_torch.parallel.mesh.shard`'s) over
    ``ndim`` dimensions; the dimensions past it are not cut."""
    spec = tuple(spec)
    if spec not in _SPECS:
        raise ValueError(f"unsupported spec {spec}")
    return (spec + (None,) * ndim)[:ndim]


def _parts(mesh, axis) -> Tuple[int, int]:
    """(number of blocks, this rank's block) along a dimension cut by
    ``axis``."""
    if axis is None:
        return 1, 0
    return (mesh.dp, mesh.r_dp) if axis == "dp" else (mesh.tp, mesh.r_tp)


def _window(shape, mesh, spec) -> Tuple[Tuple[int, int], ...]:
    """This rank's block of a global ``shape`` under ``spec``, as
    ((start, stop), ...): :func:`~pint_tpu_torch.parallel.mesh.shard`'s cut."""
    out = []
    for n, axis in zip(shape, _spec(spec, len(shape))):
        cut = _block(n, *_parts(mesh, axis))
        out.append((cut.start, cut.stop))
    return tuple(out)


def save_sharded(prefix, arr, mesh=None, spec=None) -> str:
    """Save THIS rank's block of a global array.

    ``arr`` is the block this rank holds under ``mesh`` and ``spec``
    (:func:`~pint_tpu_torch.parallel.mesh.shard`'s cut: ("dp", "tp"),
    ("dp", None), ...); ``mesh=None`` means one process holding the whole
    array.  Writes ``{prefix}.proc{K}.npz`` (K this process's rank) with
    the block's data and its global bounds, the global shape and dtype, and
    the lane widths when ``arr`` is a :class:`PackedArray`.  A PackedArray's
    words are stored in the layout's unsigned word dtype; a numpy array
    keeps its dtype (pass words through
    :func:`~pint_tpu_torch.convert.words_to_numpy`), and so does a tensor.
    No communication: every rank calls this with the same prefix and writes
    only its own file.  Returns the path written."""
    widths = None
    if isinstance(arr, PackedArray):
        widths = np.asarray(arr.layout.widths, np.int64)
        data = words_to_numpy(arr.word)
    else:
        data = _host(arr)
    data = np.ascontiguousarray(data)
    if mesh is None:
        if spec is not None:
            raise ValueError("a spec needs the mesh it cuts")
        spec, rank, count = (None,) * data.ndim, 0, 1
    else:
        if spec is None:
            raise ValueError("save_sharded on a mesh needs the block's spec")
        spec = _spec(spec, data.ndim)
        rank, count = mesh.ranks[mesh.index], torch.distributed.get_world_size()
    shape, key = [], []
    for n, axis in zip(data.shape, spec):
        parts, i = _parts(mesh, axis)
        shape.append(n * parts)
        key.append((i * n, (i + 1) * n))
    payload = {
        "shape": np.asarray(shape, np.int64),
        "dtype": np.str_(data.dtype.str),
        "nshards": np.int64(1),
        "process_index": np.int64(rank),
        "process_count": np.int64(count),
        "data0": data,
        "bounds0": np.asarray(key, np.int64).reshape(data.ndim, 2),
    }
    if widths is not None:
        payload["widths"] = widths
    path = f"{prefix}.proc{rank}.npz"
    np.savez(path, **payload)
    return path


def _read_shard_files(prefix):
    """All shard files visible to this process -> (shape, dtype, widths,
    {bounds: data})."""
    paths = sorted(glob.glob(f"{prefix}.proc*.npz"))
    if not paths:
        raise FileNotFoundError(f"no shard files match {prefix}.proc*.npz")
    shape = dtype = widths = None
    shards = {}
    for path in paths:
        with np.load(path) as z:
            fshape = tuple(int(d) for d in z["shape"])
            fdtype = np.dtype(str(z["dtype"]))
            if shape is None:
                shape, dtype = fshape, fdtype
            elif (fshape, fdtype) != (shape, dtype):
                raise ValueError(
                    f"{path}: shape/dtype {fshape}/{fdtype} disagrees with "
                    f"{shape}/{dtype} from earlier shard files"
                )
            if "widths" in z:
                widths = tuple(int(w) for w in z["widths"])
            for i in range(int(z["nshards"])):
                key = tuple((int(a), int(b)) for a, b in z[f"bounds{i}"])
                shards[key] = z[f"data{i}"]
    return shape, dtype, widths, shards


def _assemble_window(shards, key, dtype, prefix):
    """Assemble the target window ``key`` from intersecting saved shards.

    Handles arbitrary resharding: the save-time tiling need not align with
    the restore-time tiling as long as the visible shard files jointly
    cover the window."""
    out = np.zeros([b - a for a, b in key], dtype)
    filled = np.zeros(out.shape, bool)
    for skey, data in shards.items():
        isect = [(max(t0, s0), min(t1, s1)) for (t0, t1), (s0, s1) in zip(key, skey)]
        if any(a >= b for a, b in isect):
            continue
        dst = tuple(slice(a - t0, b - t0) for (a, b), (t0, _) in zip(isect, key))
        src = tuple(slice(a - s0, b - s0) for (a, b), (s0, _) in zip(isect, skey))
        out[dst] = data[src]
        filled[dst] = True
    if not filled.all():
        raise ValueError(
            f"{prefix}: saved shards cover only {int(filled.sum())} of "
            f"{filled.size} elements of index {key} needed by the target "
            f"block; copy the other ranks' shard files here or re-save "
            f"on a compatible mesh (saved: {sorted(shards)})"
        )
    return out


def load_sharded(prefix, mesh, spec) -> Tuple[torch.Tensor, Optional[tuple]]:
    """Restore this rank's block of a :func:`save_sharded` checkpoint (the
    port's or the reference's) under ``mesh`` and ``spec``, from the
    ``{prefix}.proc*.npz`` files this process can see.  The saving mesh and
    spec may differ, as long as the files cover the block.  Returns
    (tensor on ``mesh.device``, widths-or-None): unsigned words come back
    in the port's signed container, so wrap a packed checkpoint with
    ``PackedArray(t, PackedLayout(*widths))``."""
    shape, dtype, widths, shards = _read_shard_files(prefix)
    key = _window(shape, mesh, spec)
    data = shards.get(key)
    if data is None:
        data = _assemble_window(shards, key, dtype, prefix)
    if dtype.kind == "u":
        return words_from_numpy(data, device=mesh.device), widths
    return torch.from_numpy(np.array(data)).to(mesh.device), widths


def load_full(prefix) -> Tuple[np.ndarray, Optional[tuple]]:
    """Assemble the FULL array from all visible shard files (host-side
    inspection / resharding entry).  Requires complete coverage.  Returns
    (numpy array, widths-or-None)."""
    shape, dtype, widths, shards = _read_shard_files(prefix)
    out = np.zeros(shape, dtype)
    filled = np.zeros(shape, bool)
    for key, data in shards.items():
        sl = tuple(slice(a, b) for a, b in key)
        out[sl] = data
        filled[sl] = True
    if not filled.all():
        raise ValueError(
            f"{prefix}: shard files cover only {int(filled.sum())} of "
            f"{filled.size} elements; gather every rank's file first"
        )
    return out, widths
