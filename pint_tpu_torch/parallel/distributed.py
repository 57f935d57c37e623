"""Multi-process initialization and cross-process aggregation.

PyTorch port of ``pint_tpu/parallel/distributed.py``: one process a
device, wired by ``torch.distributed``.  :func:`initialize` takes the
coordinator's address, the process count and this process's id from its
arguments or from the environment -- the reference's names
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) or torchrun's
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) -- and starts
the default process group over TCP.  Solves/s is aggregated by
:func:`aggregate_rate`, one float64 all-reduce off the hot path.

Unlike the reference, :func:`initialize` is a no-op only when nothing at
all is given, and it never swallows an exception: a half-configured or
failing launch raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["aggregate_rate", "initialize", "is_multi_process", "process_info"]


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def _env_address() -> Optional[str]:
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return addr


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Start the default process group from the arguments or the env.

    ``coordinator_address`` is ``host:port`` of rank 0, or a whole
    ``init_method`` URL (``file:///shared/path`` rendezvous through a file
    every rank can reach, no port to choose).  ``backend``
    defaults to ``nccl`` when CUDA is available (each process then takes
    device ``process_id % device_count``) and ``gloo`` otherwise.  A no-op
    when no address, count or id is given anywhere; raises when only some
    are."""
    addr = coordinator_address or _env_address()
    n = num_processes if num_processes is not None else _env_int("NUM_PROCESSES", "WORLD_SIZE")
    pid = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    if addr is None and n is None and pid is None:
        return
    if addr is None or n is None or pid is None:
        raise ValueError(
            f"initialize needs the coordinator address, the process count and "
            f"this process's id; got address={addr!r}, count={n!r}, id={pid!r}"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    init = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=init, world_size=n, rank=pid)


def is_multi_process() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """This process's index and the world's size; one device a process."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def aggregate_rate(local_rate: float) -> float:
    """Global solves/s: the sum over processes of each one's locally
    measured rate (one float64 all-reduce; the input unchanged in a single
    process)."""
    if not is_multi_process():
        return float(local_rate)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([float(local_rate)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return float(t.item())
