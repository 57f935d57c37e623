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
    "SWAR_KERNELS",
    "build",
    "check",
    "count_launch",
    "launch_counts",
    "library",
    "require_cuda",
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

# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
_SIGNATURES = {
    # lanes, g, hq, out, B, Tp, iters, hs_num, hs_den, g_shift,
    # momentum, beta_num, beta_den, stream
    "pint_fused_pgd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # lanes, g, hqt, hs_num, hs_den, out, B, Tp, iters, g_shift, stream
    "pint_pgd_hqt": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ht, hqt, lip, hmax, B, Tm, power_iters, stream
    "pint_lipq": [_P, _P, _P, _P, _I, _I, _I, _P],
    # word_bits, pair, op, a, b, out, n, layout*, stream
    "pint_swar_binop": [_I, _I, _I, _P, _P, _P, _L, _P, _P],
    # word_bits, pair, left, v, out, n, amount_dev (or null), amount,
    # layout*, stream
    "pint_swar_shift": [_I, _I, _I, _P, _P, _L, _P, _L, _P, _P],
    # word_bits, pair, signed, acc, deltas, out, n, steps, layout*, stream
    "pint_swar_sat_accum": [_I, _I, _I, _P, _P, _P, _L, _I, _P, _P],
}

SWAR_KERNELS = ("swar_binop", "swar_shift", "swar_sat_accum",
                "swar_binop_pair", "swar_shift_pair", "swar_sat_accum_pair")
"""Launch-count names of ``ops/swar.py``: K1, K9 and K8 on native words,
and K11a-c on u64 planar pairs."""

KERNELS = ("fused_pgd", "pgd_hqt", "lipq") + SWAR_KERNELS
"""Launch-count names: K2 (``mpc/fused.py``), K4 (``mpc/fused_alm.py``), K3
(``mpc/condense_fused.py``) and the SWAR kernels."""

_counts = dict.fromkeys(KERNELS, 0)
_lib = None
_lib_lock = threading.Lock()


def count_launch(name: str) -> None:
    _counts[name] += 1


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_counts)


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


def _run(cmds: list) -> None:
    """Run the commands all at once; raise with the output of the first
    that fails, after every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{text}"
            )


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached shared library; returns its
    path.  A library with the sources' hash is reused as it is."""
    out = BUILD_DIR / f"libpint_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(os.path.join(tmp, src.stem + ".o"))
            cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)])
        _run(cmds)
        so = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]])
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


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common device of ``tensors``; raises unless all are on one
    CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev
