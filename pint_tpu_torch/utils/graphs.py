"""One CUDA graph a call shape of a tensor function (private to the port).

:class:`_Graphed` wraps ``fn(*tensors) -> tensor or tuple of tensors``, a
function whose device work depends only on its inputs' shapes, and on a
CUDA device replays it as one graph instead of issuing its operations one
by one from Python.  What it does depends only on what it can see in the
input:

* a CPU tensor among the inputs: ``fn`` runs directly, always;
* on a CUDA device, per key (each input's shape, dtype and device): the
  first call runs ``fn`` eagerly, which is also the warm-up (libraries,
  handles and cached constants are made there); the second captures ``fn``
  into a ``torch.cuda.CUDAGraph`` over static copies of the inputs, in a
  memory pool of its own, and replays it; every later call copies its
  inputs into the static buffers (stream ordered) and replays.  Every call
  returns outputs of its own (clones of the static outputs), so nothing
  the caller keeps is overwritten by the next replay.  The last
  :data:`_KEYS` keys are kept, the least recently used dropped first.

A capture that fails raises: there is no fallback to the eager path.  A
graph destroyed while another captures (its ``reset`` frees memory, which
capture forbids) invalidates that capture, so each capture first collects
the cyclic garbage, where a dropped solver's graphs wait: a solver and its
wrapper refer to each other.

A replay launches the port's kernels that the capture recorded, so it adds
their launch counts (the difference over the capture of every name
:func:`~pint_tpu_torch.ops.kernels.count_launch` counts, those of
:func:`~pint_tpu_torch.ops.kernels.launch_counts` and the chain kernel's
alike) each time.  Each replay is a host range ``pint.sqp.replay``
(:func:`~pint_tpu_torch.utils.profiling.span`); ``captures`` and
``replays`` count captures and replays on the wrapper, and
:data:`launch_ns` sums the host nanoseconds of every wrapper's
``graph.replay()`` calls, the launch alone (the serving layer's phase clock
reads it).

A shape has a second key, for its graph with the device clock on
(:class:`~pint_tpu_torch.utils.profiling.DeviceClock`).  With the clock
off the capture records the function's device work alone.  With it on,
each span inside the function adds two event-record nodes, and the graph
keeps those pairs and hands them to the clock at each replay.  A shape's
first call in one clock state captures at once where its graph in the
other state is made (that graph's first call was the warm-up), over that
graph's static inputs and into its memory pool, so the second variant adds
no pool of its own.
"""

from __future__ import annotations

import collections
import contextlib
import gc
from typing import NamedTuple

import torch

from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.utils import profiling
from pint_tpu_torch.utils.profiling import span, stamp

_KEYS = 4
"""Call shapes a wrapper keeps (eager-seen or captured)."""

_CUDAGraph = torch.cuda.CUDAGraph
_capture = torch.cuda.graph

_CLOCKED = "clocked"
"""Appended to a shape's key for its clocked variant; the plain graph's key
is the shape alone."""

launch_ns = [0]
"""Host nanoseconds in ``graph.replay()``, summed over every wrapper (one
item, so that adding to it is cheap)."""


def _on_card(args) -> bool:
    """Whether every input is on a CUDA device."""
    return all(a.is_cuda for a in args)


class _Entry(NamedTuple):
    """A captured call: the graph, its static inputs and outputs, the
    kernel launches one replay makes, and the device clock's event pairs
    it records (none in a plain graph)."""

    graph: object
    static_in: tuple
    static_out: object
    counts: dict
    events: tuple


class _Graphed:
    """``fn`` replayed as one CUDA graph a call shape (module docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self._keys = collections.OrderedDict()     # key -> _Entry, or None once seen
        self.captures = 0
        self.replays = 0

    def __call__(self, *args: torch.Tensor):
        if not _on_card(args):
            return self.fn(*args)
        clock = profiling._ACTIVE           # the clock itself: a call less a tick
        key = shape = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        if clock is not None:
            key = shape + (_CLOCKED,)
        entry = self._keys.get(key)
        if entry is not None:
            self._keys.move_to_end(key)
            return self._replay(entry, args, count=True)
        other = self._keys.get(shape + (_CLOCKED,) if clock is None else shape)
        if key not in self._keys and other is None:
            self._remember(key, None)
            return self.fn(*args)
        entry = self._capture(args, clock, other)
        self._remember(key, entry)
        return self._replay(entry, args, count=False)

    def _remember(self, key, entry) -> None:
        self._keys[key] = entry
        self._keys.move_to_end(key)
        while len(self._keys) > _KEYS:
            self._keys.popitem(last=False)

    def _capture(self, args, clock=None, other=None) -> _Entry:
        """Capture ``fn`` over static buffers shaped as ``args`` (a capture
        runs nothing; each replay copies its inputs in first); the launch
        counts the capture adds stand for the replay that follows it.  With
        the device clock on, the spans' event pairs recorded in the capture
        go to the graph.  ``other``, the shape's graph in the other clock
        state, lends its static inputs and its memory pool."""
        static_in = other.static_in if other else tuple(torch.empty_like(a) for a in args)
        graph = _CUDAGraph()
        before = dict(K._counts)
        n = len(clock.pairs) if clock else 0
        gc.collect()        # no graph of cyclic garbage is destroyed inside the capture
        with _capture(graph, **({"pool": other.graph.pool()} if other else {})), \
                (clock.capturing() if clock else contextlib.nullcontext()):
            out = self.fn(*static_in)
        events = ()
        if clock:
            events = tuple(clock.pairs[n:])
            del clock.pairs[n:]
        after = dict(K._counts)
        self.captures += 1
        counts = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        return _Entry(graph, static_in, out, counts, events)

    def _replay(self, entry: _Entry, args, count: bool):
        with span("pint.sqp.replay"):
            for s, a in zip(entry.static_in, args):
                s.copy_(a)
            t = stamp()
            entry.graph.replay()
            launch_ns[0] += stamp() - t
            if entry.events:
                profiling._ACTIVE.pairs.extend(entry.events)
            self.replays += 1
            if count:
                for name, n in entry.counts.items():
                    for _ in range(n):
                        K.count_launch(name)
            out = entry.static_out
            if isinstance(out, torch.Tensor):
                return out.clone()
            return tuple(o.clone() for o in out)
