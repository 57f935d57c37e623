"""Timing on the card with CUDA events.

PyTorch returns from a launch before the device has run it, so a host clock
around a launch measures the enqueue.  :func:`cuda_ms` brackets each run
with CUDA events and synchronizes before reading them; :func:`host_ms` times
work that itself ends in a device-to-host copy or a synchronize (a service
tick).  For a kernel shorter than its wrapper's host work, the events of
:func:`cuda_ms` also bracket the host time before the launch; :func:`queued_ms`
queues the calls behind a device sleep first, so the events bracket device
work alone.  All raise without a CUDA device: a CPU number is never
reported as a device time.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

__all__ = ["cuda_ms", "host_ms", "queued_ms"]


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


_SLEEP_CYCLES = 50_000_000
"""The device sleep each run of :func:`queued_ms` is queued behind: about
25 ms at the H100's clock.  It must outlast the host's enqueue of one run."""


def queued_ms(fn: Callable[[], object], calls: int = 20, reps: int = 5) -> List[float]:
    """Device milliseconds of one call of ``fn``, from ``reps`` runs of
    ``calls`` calls each.  Each run is enqueued behind ``torch.cuda._sleep``
    (:data:`_SLEEP_CYCLES`), so the device is still asleep while the host
    enqueues and the events see only the calls' device work.  The host must
    enqueue a run within the sleep, so keep ``calls`` small for a ``fn`` of
    many launches."""
    if not torch.cuda.is_available():
        raise RuntimeError("queued_ms needs a CUDA device")
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out
