"""The (dp, tp) process mesh and the collectives of the multi-device tier.

PyTorch port of ``pint_tpu/parallel/mesh.py``.  Where the reference lays a
``jax.sharding.Mesh`` over devices and lets XLA insert the collectives
inside ``shard_map``, the port runs one process a device under
``torch.distributed`` and calls the collectives itself.  Axis convention,
as in the reference:

* ``dp`` -- data parallel over problems (no communication in a solve);
* ``tp`` -- tensor parallel over the condensed horizon: each rank holds a
  column block of the iterate, and the gradient is an exact int32 sum of
  every rank's column contribution.

Ranks enumerate dp-major (``rank = r_dp * tp + r_tp``), so a tp group is a
run of consecutive ranks and stays on one host where it can.  Every
collective of the tier goes through :func:`psum` and
:func:`all_gather_cols`, so the transport lives here and nowhere else.
The groups take the default group's backend (``gloo`` or ``nccl``); no
other backend is created behind the caller's back.

A rank's data is its block of the global arrays, cut by :func:`shard` (the
counterpart of ``NamedSharding`` + ``device_put``) and joined by
:func:`unshard`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pint_tpu_torch.ops import kernels as K

__all__ = ["Mesh", "all_gather_cols", "column_block", "host_local_mesh",
           "make_mesh", "psum", "shard", "unshard"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a (dp, tp) mesh: its coordinates and the process
    groups of its tp row and of the whole mesh (the tier needs no
    collective over dp alone).  Hashed by identity, so a program memoized on
    a mesh uses that mesh's groups."""

    dp: int
    tp: int
    ranks: tuple           # the mesh's global ranks, dp-major
    index: int             # this rank's position in ``ranks``
    device: torch.device
    group: object          # every rank of the mesh
    tp_group: object       # this rank's tp row

    @property
    def r_dp(self) -> int:
        return self.index // self.tp

    @property
    def r_tp(self) -> int:
        return self.index % self.tp


def _new_group(ranks: Sequence[int], backend: str):
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(ranks), backend=backend)


def _build(blocks: Sequence[Sequence[int]], dp: int, tp: int, device) -> Mesh:
    """The mesh of the block holding this rank.  Every rank creates every
    block's groups in the same order, as ``new_group`` requires."""
    backend = dist.get_backend()
    me = dist.get_rank()
    mine = None
    for ranks in blocks:
        group = _new_group(ranks, backend)
        tp_groups = [_new_group(ranks[d * tp:(d + 1) * tp], backend) for d in range(dp)]
        if me in ranks:
            index = list(ranks).index(me)
            mine = Mesh(dp=dp, tp=tp, ranks=tuple(ranks), index=index,
                        device=_rank_device(device), group=group,
                        tp_group=tp_groups[index // tp])
    return mine


def _rank_device(device) -> torch.device:
    """``device`` resolved; a bare ``"cuda"`` is this rank's card, one
    process a card: ``cuda:LOCAL_RANK`` where the launcher sets it, else
    the current CUDA device (which :func:`~pint_tpu_torch.parallel.
    distributed.initialize` sets for NCCL)."""
    dev = K.resolve_device(device)
    local = os.environ.get("LOCAL_RANK")
    if dev == torch.device("cuda") and local is not None:
        return torch.device("cuda", int(local))
    return dev


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call pint_tpu_torch.parallel.distributed."
            "initialize() (or torch.distributed.init_process_group) first"
        )
    return dist.get_world_size()


def _dims(n: int, dp: Optional[int], tp: int):
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} processes not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} processes, have {n}")
    return dp, tp


def make_mesh(dp: Optional[int] = None, tp: int = 1, *, device="cuda") -> Mesh:
    """A (dp, tp) mesh over every process of the initialized world, one
    device a process, on this rank's card unless ``device`` names another
    (:func:`_rank_device`).  ``dp=None`` takes all the processes tp leaves.
    Raises when ``dp * tp`` is not the world size."""
    n = _world()
    dp, tp = _dims(n, dp, tp)
    return _build([list(range(n))], dp, tp, device)


def host_local_mesh(tp: int = 1, *, device="cuda") -> Mesh:
    """A mesh over this host's processes only: the ``LOCAL_WORLD_SIZE``
    consecutive ranks that torchrun starts on one host (the whole world
    when it is not set)."""
    n = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local:
        raise ValueError(f"world size {n} is not a multiple of LOCAL_WORLD_SIZE={local}")
    dp, tp = _dims(local, None, tp)
    blocks = [list(range(h * local, (h + 1) * local)) for h in range(n // local)]
    return _build(blocks, dp, tp, device)


def column_block(n: int, tp: int, what: str) -> int:
    """Columns of each tp rank; raises unless the ``n`` lanes (``what``)
    split into whole 4-lane words across tp."""
    if n % (4 * tp):
        raise ValueError(f"{what} {n} must divide into 4-lane words across tp={tp}")
    return n // tp


# -- collectives ---------------------------------------------------------------


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, in place (pass a tensor the caller owns).
    An int32 sum is exact and wraps as XLA's ``psum`` does."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_cols(x: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """The tiled all-gather along columns: (B, K) on each of ``size`` ranks
    -> (B, size*K), rank r's block at columns [r*K, (r+1)*K).  Written as a
    sum of each rank's block in a zero tensor -- exact, since the blocks are
    disjoint -- so it needs only ``all_reduce``, which every backend has
    for CUDA tensors (gloo's CUDA all-gather is not documented)."""
    B, k = x.shape
    out = torch.zeros((B, size * k), dtype=x.dtype, device=x.device)
    out[:, rank * k:(rank + 1) * k] = x
    return psum(out, group)


# -- placement -----------------------------------------------------------------


def _block(n: int, parts: int, i: int) -> slice:
    if n % parts:
        raise ValueError(f"dimension {n} does not split into {parts} blocks")
    s = n // parts
    return slice(i * s, (i + 1) * s)


_SPECS = {("dp", "tp"), ("dp", None), (None, None)}


def shard(x, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of the global array ``x`` (numpy or tensor) under
    ``spec``: ("dp", "tp") cuts rows by r_dp and columns by r_tp, ("dp",
    None) rows only, (None, None) nothing.  Returns a contiguous tensor on
    the mesh's device."""
    spec = tuple(spec)
    if spec not in _SPECS:
        raise ValueError(f"unsupported spec {spec}")
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    idx = [slice(None)] * x.dim()
    if spec[0] == "dp":
        idx[0] = _block(x.shape[0], mesh.dp, mesh.r_dp)
    if spec[1] == "tp":
        idx[1] = _block(x.shape[1], mesh.tp, mesh.r_tp)
    return x[tuple(idx)].to(mesh.device).contiguous()


def unshard(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """Inverse of :func:`shard`: every rank's block joined into the global
    tensor, on every rank (a sum of disjoint blocks over the mesh)."""
    spec = tuple(spec)
    if spec not in _SPECS:
        raise ValueError(f"unsupported spec {spec}")
    if spec == (None, None):
        return x
    rows = x.shape[0] * mesh.dp
    cols = x.shape[1] * (mesh.tp if spec[1] == "tp" else 1)
    out = torch.zeros((rows, cols) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    if spec[1] == "tp" or mesh.r_tp == 0:   # a tp-replicated block counts once
        r = _block(rows, mesh.dp, mesh.r_dp)
        c = _block(cols, mesh.tp, mesh.r_tp) if spec[1] == "tp" else slice(None)
        out[r, c] = x
    return psum(out, mesh.group)
