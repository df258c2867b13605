"""ctypes binding and build at first use of the native OpenPose scanner.

The port's copy of the JAX package's ``runtime/native.py``.  The shared
library is built once with g++ (no network, no pybind11) into
``build/native/`` at the repository root, named by a digest of the source
and the flags, and never into the package directory.  Every call has a
pure-Python fallback (``None`` here, the json path in ``data/openpose``),
since this is a host parser, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "openpose_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library() -> Path:
    """Where the scanner's library is built."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libopenpose_parser-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Build to a process-unique temp file and rename it into place, so that
    concurrent builds from worker processes never hand a partly written
    library to dlopen."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _get_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        out = library()
        if not out.exists() and not _build(out):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            _build_failed = True
            return None
        lib.parse_openpose_frame.restype = ctypes.c_int
        lib.parse_openpose_frame.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def parse_openpose_frame_bytes(buf: bytes):
    """One frame's JSON bytes -> (body (75,), hands (126,)) float64 rows of
    float32 values, or None if the native library is unavailable (the
    caller falls back to the Python json path)."""
    lib = _get_lib()
    if lib is None:
        return None
    body = np.empty(75, np.float32)
    rh = np.empty(63, np.float32)
    lh = np.empty(63, np.float32)
    ptr = ctypes.POINTER(ctypes.c_float)
    rc = lib.parse_openpose_frame(
        buf, len(buf), body.ctypes.data_as(ptr), rh.ctypes.data_as(ptr),
        lh.ctypes.data_as(ptr),
    )
    if rc != 0:
        raise ValueError(f"native OpenPose parse failed with code {rc}")
    # the json path's float64 rows, so that the pickles have one dtype
    # whichever parser ran
    return body.astype(np.float64), np.concatenate([rh, lh]).astype(np.float64)
