"""Native (C++) runtime components, loaded via ctypes.

The analog of the reference's lazy CUDA extension loader
(gsplat/gsplat/cuda/_backend.py:54-98 JIT path; gsplat/setup.py AOT path):
loads a library built earlier from these sources (never a tracked binary),
else compiles the C++ once with g++ under a file lock, caching the .so in the package directory
(falling back to a per-user temp dir when the package is read-only).
Failure to build degrades gracefully: callers check `rans_lib() is None`
and fall back to the numpy implementation in gsvc_tpu/compress/entropy.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_SRC_DIR = Path(__file__).resolve().parent
_LIB_NAME = "libgsvc_rans.so"

_rans = None
_rans_tried = False


def _build_dir() -> Path:
    if os.access(_SRC_DIR, os.W_OK):
        return _SRC_DIR
    d = Path(tempfile.gettempdir()) / f"gsvc_tpu_native_{os.getuid()}"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _compile(src: Path, out: Path) -> bool:
    lock = out.with_suffix(".lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        # Another process is building; wait briefly for the artifact.
        import time

        for _ in range(100):
            if out.exists():
                return True
            time.sleep(0.1)
        return out.exists()
    try:
        tmp = out.with_suffix(".so.tmp")
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            str(src), "-o", str(tmp),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except Exception:
        return False
    finally:
        os.close(fd)
        lock.unlink(missing_ok=True)


def rans_lib() -> Optional[ctypes.CDLL]:
    """The rANS shared library, building it on first use; None if unavailable."""
    global _rans, _rans_tried
    if _rans_tried:
        return _rans
    _rans_tried = True
    if os.environ.get("GSVC_TPU_DISABLE_NATIVE"):
        return None
    src = _SRC_DIR / "rans.cpp"
    for candidate in (_SRC_DIR / _LIB_NAME, _build_dir() / _LIB_NAME):
        if candidate.exists() and candidate.stat().st_mtime >= src.stat().st_mtime:
            lib = _load(candidate)
            if lib is not None:
                _rans = lib
                return _rans
    out = _build_dir() / _LIB_NAME
    if _compile(src, out):
        _rans = _load(out)
    return _rans


_yuv = None
_yuv_tried = False


def yuv_lib() -> Optional[ctypes.CDLL]:
    """The YUV-decode shared library, building on first use; None if
    unavailable (callers fall back to cv2/numpy, gsvc_tpu/io/yuv.py)."""
    global _yuv, _yuv_tried
    if _yuv_tried:
        return _yuv
    _yuv_tried = True
    if os.environ.get("GSVC_TPU_DISABLE_NATIVE"):
        return None
    src = _SRC_DIR / "yuv.cpp"
    name = "libgsvc_yuv.so"
    for candidate in (_SRC_DIR / name, _build_dir() / name):
        if candidate.exists() and candidate.stat().st_mtime >= src.stat().st_mtime:
            lib = _load_yuv(candidate)
            if lib is not None:
                _yuv = lib
                return _yuv
    out = _build_dir() / name
    if _compile(src, out):
        _yuv = _load_yuv(out)
    return _yuv


def _load_yuv(path: Path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
        lib.yuv420_to_rgb.restype = None
        lib.yuv420_to_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        return lib
    except OSError:  # pragma: no cover
        return None


def _load(path: Path) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(path))
        lib.rans_encode.restype = ctypes.c_size_t
        lib.rans_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
        ]
        lib.rans_decode.restype = ctypes.c_int
        lib.rans_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32),
        ]
        return lib
    except OSError:
        return None
