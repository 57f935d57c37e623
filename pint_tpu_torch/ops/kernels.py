"""Build, load and count the port's hand-written CUDA kernels.

Takes the place of ``pint_tpu/ops/pallas.py:on_tpu_backend`` as the one gate
between the kernels and their plain PyTorch versions: a wrapper runs its
kernel for a CUDA tensor and its plain version for a CPU tensor, and for
nothing else.  There is no fallback from one to the other.

The kernels are CUDA C++ for ``sm_90a`` under ``pint_tpu_torch/csrc/``.  The
first call that needs one compiles every ``csrc/*.cu`` with ``nvcc`` -- one
process a source, all started together -- and links them into one shared
library with a plain C interface, under ``pint_tpu_torch/_build/``, named by
a hash of the sources and flags, and loads it with ``ctypes``.  A build that
fails raises with the compiler's output.

Each wrapper adds one to its launch count where it launches its kernel, so a
caller can show that a run went through the kernels
(:func:`launch_counts`, :func:`reset_launch_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = [
    "KERNELS",
    "LONG_LANES",
    "SWAR_KERNELS",
    "build",
    "check",
    "count_launch",
    "launch_counts",
    "library",
    "problem_major",
    "require_cuda",
    "require_order",
    "resolve_device",
    "reset_launch_counts",
    "stream_of",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    # lanes, g, hq, out, scratch, B, Tp, iters, hs_num, hs_den, g_shift,
    # momentum, beta_num, beta_den, stream
    "pint_fused_pgd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # words, g, hq, out, scratch, B, Tp, iters, hs_num, hs_den, g_shift, stream
    "pint_fused_pgd_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # lanes, hqt, out, B, K, rows, stream
    "pint_matvec_cols": [_P, _P, _P, _I, _I, _I, _P],
    # lanes, g, hqt, hs_num, hs_den, out, B, Tp, iters, g_shift, orders,
    # stream (orders: bit 0, hqt problem-major)
    "pint_pgd_hqt": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # words, g, hqt, hs_num, hs_den, out, B, Tp, iters, g_shift, orders,
    # stream
    "pint_pgd_hqt_words": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # ht, hqt, lip, hmax, B, Tm, power_iters, stream
    "pint_lipq": [_P, _P, _P, _P, _I, _I, _I, _P],
    # st, sqc, sqj, lip, s_scale, row_amp, scratch, B, C, Tm, power_iters,
    # batch_first (the rows stay in scratch), stream
    "pint_pen": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # lanes, g, hqt, sqj, sqc, c_off, lo, hi, lam, sc, out_lanes, out_lam,
    # B, Tp, Cp, outer, inners, g_shift, y_shift, orders, stream (orders:
    # bits 0, 1, 2 for hqt, sqc, sqj problem-major)
    "pint_alm": [_P] * 12 + [_I] * 8 + [_P],
    # lanes, g, c_off, lam, hq, sq, lo, hi, out_lanes, out_lam, scratch, B,
    # Tp, Cp, outer, inners, g_shift, y_shift, hs_num, hs_den, cs_num,
    # cs_den, eh_num, eh_den, el_num, el_den, stream
    "pint_alm_shared": [_P] * 11 + [_I] * 15 + [_P],
    # lanes, x0, scales, abar, bbar, cbar, B, T, dt, stream
    "pint_propagate": [_P] * 6 + [_I, _I, _F, _P],
    # lanes, x0, scales, abar, bbar, cbar, B, T, dt, g, hover2, k, stream
    "pint_propagate_quad": [_P] * 6 + [_I, _I, _F, _F, _F, _F, _P],
    # abar, bbar, cbar, x0, L, dq, rk, xref, ht, g, B, T, n, m,
    # problem_major, stream
    "pint_reduce": [_P] * 10 + [_I] * 5 + [_P],
    # abar, bbar, cbar, f (host), st, pt, rt, B, T, n, Tm, cs, stream
    "pint_stack": [_P] * 7 + [_I] * 5 + [_P],
    # words, noise, state0, out, best, B, K, L, noise_stride, xs, ws, scale,
    # goal x, goal y, temperature, stream
    "pint_mppi_update": [_P] * 5 + [_I] * 3 + [_L, _I, _I] + [_F] * 4 + [_P],
    # word_bits, pair, op, a, b, out, n, layout*, stream
    "pint_swar_binop": [_I, _I, _I, _P, _P, _P, _L, _P, _P],
    # word_bits, pair, left, v, out, n, amount_dev (or null), amount,
    # layout*, stream
    "pint_swar_shift": [_I, _I, _I, _P, _P, _L, _P, _L, _P, _P],
    # word_bits, pair, signed, acc, deltas, out, n, steps, layout*, stream
    "pint_swar_sat_accum": [_I, _I, _I, _P, _P, _P, _L, _I, _P, _P],
}

# C entries that return a size in bytes: name -> argtypes
_SIZES = {
    # B, C, Tm -> the scratch pint_pen needs
    "pint_pen_scratch": [_I, _I, _I],
    # B, Tp, Cp -> the scratch pint_alm_shared needs (0 to 256 lanes and rows)
    "pint_alm_shared_scratch": [_I, _I, _I],
    # B, Tp, momentum -> the scratch pint_fused_pgd(_packed) needs (0 to Tp 256)
    "pint_fused_pgd_scratch": [_I, _I, _I],
}

SWAR_KERNELS = ("swar_binop", "swar_shift", "swar_sat_accum",
                "swar_binop_pair", "swar_shift_pair", "swar_sat_accum_pair")
"""Launch-count names of ``ops/swar.py``: K1, K9 and K8 on native words,
and K11a-c on u64 planar pairs."""

KERNELS = ("fused_pgd", "fused_pgd_packed", "pgd_hqt", "pgd_matvec_cols", "lipq",
           "alm", "alm_shared", "pen") + SWAR_KERNELS
"""Launch-count names: K2 and K2p (``mpc/fused.py``), K4 (its lanes and its
words entry both count as ``pgd_hqt``), K10, K5 and K7 (``mpc/fused_alm.py``),
K3 and K6 (``mpc/condense_fused.py``) and the SWAR kernels."""

_counts = dict.fromkeys(KERNELS, 0)
"""Launches since the last :func:`reset_launch_counts`, by name: those of
:data:`KERNELS`, and of any other port kernel whose wrapper reads its own
count (``mpc/propagate.py``'s chain kernel, "propagate",
``mpc/reduce.py``'s reduce kernel, "reduce", ``mpc/stack.py``'s
constraint stacking, "stack", and ``mpc/mppi.py``'s update, "mppi")."""
_lib = None
_lib_lock = threading.Lock()


def count_launch(name: str) -> None:
    _counts[name] = _counts.get(name, 0) + 1


def launch_counts() -> dict:
    """Launches of :data:`KERNELS` since the last :func:`reset_launch_counts`."""
    return {k: _counts[k] for k in KERNELS}


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is none, rather than running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for but torch.cuda.is_available() "
            "is False"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev


def same_device(a, b) -> bool:
    """Whether ``a`` and ``b`` name one device; a bare ``"cuda"`` is the
    current CUDA device."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type or None not in (a.index, b.index) or a.index == b.index:
        return a == b
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH, or CUDA_HOME/bin): the port's kernels are "
            "built from csrc/ at first use"
        )
    return cand


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list) -> list:
    """Run the commands all at once and return their outputs; raise with
    the output of the first that fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{text}"
            )
    return outs


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library; returns its
    path.  A library with the sources' hash is reused as it is.  Beside it,
    ``<library>.ptxas.txt`` keeps each source's ``-Xptxas -v`` report
    (registers, stack and spills of every kernel)."""
    out = BUILD_DIR / f"libpint_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds, srcs = [], [], sorted(CSRC.glob("*.cu"))
        for src in srcs:
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmds.append([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", objs[-1],
                         str(src)])
        reports = _run(cmds)
        so = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
        out.with_suffix(".ptxas.txt").write_text("".join(
            f"== {src.name}\n{text}" for src, text in zip(srcs, reports)))
        os.replace(so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            lib.pint_error_string.argtypes = [ctypes.c_int]
            lib.pint_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        msg = library().pint_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry's arg."""
    return torch.cuda.current_stream(t.device).cuda_stream


LONG_LANES = 64
"""Past this many lanes (K3's Tm, K4's Tp, K5's larger of Tp and Cp) the
long-form kernels run, and the solvers hand them their per-problem slabs
problem-major (:func:`problem_major`); to it, batch-last and contiguous."""


def problem_major(t: torch.Tensor, rows: int) -> bool:
    """True when the (d0, d1, B) tensor ``t`` lies problem-major: each
    problem's d0 x d1 slab one contiguous run, a row along dim ``rows`` (0
    or 1) after another, the other dim the fastest.  ``rows=0`` is
    ``x.permute(1, 2, 0)`` of a contiguous (B, d0, d1) ``x`` (Ht, sqc,
    sqj); ``rows=1`` is ``x.permute(2, 1, 0)`` of a contiguous (B, d1, d0)
    ``x`` (hqt, whose rows j are ``Hq_b[j, :]``).  Strides of dims of size
    1 do not count."""
    d0, d1, _ = t.shape
    want = (d1, 1, d0 * d1) if rows == 0 else (1, d0, d0 * d1)
    return all(n == 1 or st == w for n, st, w in zip(t.shape, t.stride(), want))


def require_order(name: str, what: str, t: torch.Tensor, rows: int,
                  orders: tuple) -> bool:
    """Whether ``t`` lies problem-major (:func:`problem_major` with
    ``rows``) for a kernel built for ``orders`` (``"batch_last"``, the
    contiguous (d0, d1, B) layout, and/or ``"problem_major"``); raises on
    any other memory order, and never copies."""
    if "problem_major" in orders and problem_major(t, rows):
        return True
    if "batch_last" in orders and t.is_contiguous():
        return False
    said = {"batch_last": "batch-last and contiguous", "problem_major": "problem-major"}
    raise ValueError(f"{name}: {what} {tuple(t.shape)} with strides {t.stride()} is not "
                     f"{' or '.join(said[o] for o in orders)}, the order this kernel "
                     "takes at this shape")


def require_cuda(name: str, *tensors: torch.Tensor, slabs=()) -> torch.device:
    """The common device of ``tensors`` and ``slabs``; raises unless all
    are on one CUDA device and each of ``tensors`` is contiguous (the
    memory order of ``slabs`` is for :func:`require_order`)."""
    dev = (*tensors, *slabs)[0].device
    for t in (*tensors, *slabs):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev
