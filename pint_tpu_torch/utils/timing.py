"""Timing on the card with CUDA events.

PyTorch returns from a launch before the device has run it, so a host clock
around a launch measures the enqueue.  :func:`cuda_ms` brackets each run
with CUDA events and synchronizes before reading them; :func:`host_ms` times
work that itself ends in a device-to-host copy or a synchronize (a service
tick).  Both raise without a CUDA device: a CPU number is never reported
as a device time.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

__all__ = ["cuda_ms", "host_ms"]


def cuda_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2) -> List[float]:
    """Device milliseconds of each of ``reps`` calls of ``fn`` (after
    ``warmup`` untimed calls), by CUDA events on the current stream."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def host_ms(fn: Callable[[], object], reps: int = 10) -> List[float]:
    """Host milliseconds of each of ``reps`` calls of ``fn``, each ended by
    ``torch.cuda.synchronize()``."""
    if not torch.cuda.is_available():
        raise RuntimeError("host_ms needs a CUDA device")
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out
