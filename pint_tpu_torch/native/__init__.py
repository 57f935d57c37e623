"""ctypes binding for the native host-side SWAR library (port of
``pint_tpu/native/__init__.py``).

Builds ``swar.cpp`` (the port's copy of ``pint_tpu/native/swar.cpp``) with
the system C++ compiler (``$CXX``, else ``g++``) on first use, into
``pint_tpu_torch/_build/`` under a name carrying the source's hash, and
exposes :class:`NativeOps`, a numpy-buffer API with the same op surface as
:mod:`pint_tpu_torch.ops.word`.  It is the host data pipeline's path
(packing control buffers without framework dispatch) and a third
independent implementation for differential tests.  It runs on the host by
purpose, so it takes no device: words go in and come out as unsigned numpy
buffers in the layout's ``word_dtype``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from pint_tpu_torch.layout import PackedLayout

__all__ = ["NativeOps", "native_available", "load_library"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "swar.cpp"
BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None

BINOP_NAMES = (
    "add_wrap",
    "sub_wrap",
    "add_unsigned_saturate",
    "sub_unsigned_saturate",
    "add_signed_saturate",
    "sub_signed_saturate",
    "min_unsigned",
    "max_unsigned",
    "min_signed",
    "max_signed",
)
SHIFT_NAMES = ("shift_left", "shift_right_unsigned")

_SUFFIX = {8: "u8", 16: "u16", 32: "u32", 64: "u64"}


def _so_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"_pint_swar_{tag}.so"


def _build(so: Path) -> None:
    """Compile into a temporary file beside ``so`` and move it into place,
    so that a process loading ``so`` never finds it half written."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [os.environ.get("CXX", "g++"), *_FLAGS, "-o", tmp, str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry point."""
    p, n = ctypes.c_void_p, ctypes.c_size_t
    lib.pint_layout_sizeof.argtypes = []
    lib.pint_layout_sizeof.restype = ctypes.c_int
    lib.pint_layout_init.argtypes = [p, ctypes.c_int, p]
    lib.pint_layout_init.restype = ctypes.c_int
    for sfx in _SUFFIX.values():
        for name in BINOP_NAMES:
            fn = getattr(lib, f"pint_{name}_{sfx}")
            fn.argtypes, fn.restype = [p, p, p, p, n], None
        for name in SHIFT_NAMES:
            fn = getattr(lib, f"pint_{name}_{sfx}")
            fn.argtypes, fn.restype = [p, p, ctypes.c_uint, p, n], None
        for name in ("pack", "unpack", "unpack_signed"):
            fn = getattr(lib, f"pint_{name}_{sfx}")
            fn.argtypes, fn.restype = [p, p, ctypes.c_int, p, p, n], None


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises ``RuntimeError``
    (every later call too) when the build or the load fails."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is not None:
            raise RuntimeError(_BUILD_ERROR)
        so = _so_path()
        try:
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            _declare(lib)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or ""
            _BUILD_ERROR = f"native swar build failed: {e}\n{detail}".rstrip()
            raise RuntimeError(_BUILD_ERROR) from e
        _LIB = lib
        return _LIB


def native_available() -> bool:
    try:
        load_library()
        return True
    except RuntimeError:
        return False


class NativeOps:
    """Buffer-level SWAR ops for one layout, on contiguous numpy arrays."""

    def __init__(self, layout: PackedLayout):
        self.layout = layout
        lib = load_library()
        self._lib = lib
        self._desc = ctypes.create_string_buffer(lib.pint_layout_sizeof())
        self._widths = (ctypes.c_int * layout.num_lanes)(*layout.widths)
        rc = lib.pint_layout_init(self._widths, layout.num_lanes, self._desc)
        if rc != 0:
            raise ValueError(f"pint_layout_init failed with code {rc}")
        self._sfx = _SUFFIX[layout.word_bits]

    # -- helpers ------------------------------------------------------------

    def _words(self, x) -> np.ndarray:
        return np.ascontiguousarray(x, dtype=self.layout.word_dtype)

    def _binop(self, name: str, a, b) -> np.ndarray:
        a = self._words(a)
        b = np.ascontiguousarray(np.broadcast_to(self._words(b), a.shape))
        out = np.empty_like(a)
        getattr(self._lib, f"pint_{name}_{self._sfx}")(
            self._desc, a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size)
        return out

    def _shift(self, name: str, v, amount: int) -> np.ndarray:
        v = self._words(v)
        out = np.empty_like(v)
        getattr(self._lib, f"pint_{name}_{self._sfx}")(
            self._desc, v.ctypes.data, int(amount) & 0xFFFFFFFF, out.ctypes.data, v.size)
        return out

    # -- ops ----------------------------------------------------------------

    @property
    def _lane_dtype(self):
        """int32 lane buffers below 64-bit words, int64 for u64 (lane
        values up to 64 bits; pint.hpp ctor/get work at every Integer
        width, pint.hpp:768-774, 799-822)."""
        return np.int64 if self.layout.word_bits == 64 else np.int32

    def pack(self, lanes: np.ndarray) -> np.ndarray:
        """(..., n_lanes) int lanes -> (...) packed words, at every word
        width u8/u16/u32/u64 (truncating ctor semantics,
        pint.hpp:770-774)."""
        lanes = np.ascontiguousarray(lanes, dtype=self._lane_dtype)
        out = np.empty(lanes.shape[:-1], dtype=self.layout.word_dtype)
        getattr(self._lib, f"pint_pack_{self._sfx}")(
            self._desc, self._widths, self.layout.num_lanes, lanes.ctypes.data,
            out.ctypes.data, lanes.size // self.layout.num_lanes)
        return out

    def unpack(self, words: np.ndarray, signed: bool = False) -> np.ndarray:
        """(...) packed words -> (..., n_lanes) lanes, every word width;
        ``signed`` sign-extends each lane (get_signed, pint.hpp:809-822)."""
        words = self._words(words)
        out = np.empty(words.shape + (self.layout.num_lanes,), dtype=self._lane_dtype)
        name = "unpack_signed" if signed else "unpack"
        getattr(self._lib, f"pint_{name}_{self._sfx}")(
            self._desc, self._widths, self.layout.num_lanes, words.ctypes.data,
            out.ctypes.data, words.size)
        return out


def _binop_method(name):
    def op(self, a, b):
        return self._binop(name, a, b)

    op.__name__ = name
    return op


def _shift_method(name):
    def op(self, v, amount):
        return self._shift(name, v, amount)

    op.__name__ = name
    return op


for _name in BINOP_NAMES:
    setattr(NativeOps, _name, _binop_method(_name))
for _name in SHIFT_NAMES:
    setattr(NativeOps, _name, _shift_method(_name))
