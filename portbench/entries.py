"""Which of the port's kernels each kernel entry can launch, and that
entry's share of its roofline, read from the CUDA sources under
``pint_tpu_torch/csrc/``.

A kernel entry is a name of ``ops.kernels.launch_counts()``: ``lipq`` (K3),
``pen`` (K6), ``alm`` (K5), ``pgd_hqt`` (K4) and the others.  An entry
calls the C functions ``pint_<entry>`` of the sources (or those whose name
it begins or that begin with it and an underscore: ``pint_pgd_hqt_words``,
``pint_swar_binop`` for ``swar_binop_pair``); those run the kernels of
their own file and of every file whose ``pint_*`` functions they call in
turn.  So ``alm`` launches the ``__global__`` functions of ``alm.cu``, and
``pgd_hqt`` those of ``pgd_hqt.cu`` and, past 64 lanes, of ``alm.cu``
(``pint_pgd_wide``).  Nothing here names a kernel: the names are read from
the sources when first asked for, as :func:`portbench.trace.port_kernels`
reads them, so a kernel renamed or added is still its file's.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Dict, FrozenSet, Optional

from portbench import costs, trace

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_DEFINED = re.compile(r"\b(pint_\w+)\s*\([^()]*\)\s*\{")     # a definition, not a call
_CALLED = re.compile(r"\b(pint_\w+)\s*\(")


def csrc() -> Path:
    import pint_tpu_torch

    return Path(pint_tpu_torch.__file__).parent / "csrc"


class _OneFile:
    """A directory of one source, for :func:`portbench.trace.port_kernels`."""

    def __init__(self, path: Path):
        self.path = path

    def glob(self, pattern: str):
        return [self.path] if self.path.match(pattern) else []


@functools.lru_cache(maxsize=None)
def kernel_files(root: Path) -> Dict[str, str]:
    """Each ``__global__`` function declared in a ``.cu`` under ``root`` ->
    the name of that file."""
    return {k: p.name for p in sorted(root.glob("*.cu"))
            for k in trace.port_kernels(_OneFile(p))}


@functools.lru_cache(maxsize=None)
def _calls(root: Path):
    """(each ``pint_*`` function defined in a ``.cu`` -> its file, each
    ``.cu`` -> the ``pint_*`` functions it calls), comments left out."""
    defined, calls = {}, {}
    for p in sorted(root.glob("*.cu")):
        text = _COMMENT.sub("", p.read_text())
        for m in _DEFINED.finditer(text):
            defined[m.group(1)] = p.name
        calls[p.name] = {m.group(1) for m in _CALLED.finditer(text)}
    return defined, calls


def files(entry: str, root: Path) -> Optional[FrozenSet[str]]:
    """The ``.cu`` files under ``root`` whose kernels a launch of ``entry``
    can run, or None when no C function of the sources is the entry's."""
    defined, calls = _calls(root)
    out = {f for name, f in defined.items()
           if name == f"pint_{entry}" or name.startswith(f"pint_{entry}_")
           or f"pint_{entry}".startswith(name + "_")}
    todo = list(out)
    while todo:
        for name in calls[todo.pop()]:
            f = defined.get(name)
            if f is not None and f not in out:
                out.add(f)
                todo.append(f)
    return frozenset(out) or None


def roofline(summary, cell, entry: str) -> Optional[float]:
    """100 x the least time an H100 could take for the work of ``entry``'s
    launch (:mod:`portbench.costs`, at the shape the kind's ``work()``
    gives it) over the device ms a tick of the kernels its files declare.

    None where the slice cannot tell that time apart: its kernel entries
    called a tick (``summary.calls``) are not the kind's ``LAUNCHES``, the
    kind's work has no entry of that name, another entry called in the tick
    can launch kernels of the same files (or is not found in the sources),
    or none of those kernels ran."""
    if summary.calls != cell.kind.LAUNCHES:
        return None
    shape = dict(cell.kind.work(cell.config, cell.traffic["batch"])).get(entry)
    root = csrc()
    own = files(entry, root)
    if shape is None or own is None:
        return None
    for other in summary.calls:
        if other != entry:
            theirs = files(other, root)
            if theirs is None or theirs & own:
                return None
    names = [k for k, f in kernel_files(root).items() if f in own]
    if not names:
        return None
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    ops = [o for o in summary.select(port=True) if pattern.search(o.name)]
    if not ops:
        return None
    bound = costs.bound_ms(costs.kernel_cost(entry, **shape))[0]
    return 100.0 * bound / (summary.busy_ns(ops) / 1e6 / summary.ticks)
