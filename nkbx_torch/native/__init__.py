"""The native data path (counterpart of ``nkbx/native``): ``decode.cpp``, a
copy of nkbx's, decodes a batch of JPEG/PNG files with a C++ thread pool,
crops an optional box per file, applies LongestMaxSize + center pad (or a
stretch resize) and writes straight into a uint8 NHWC numpy batch.

It is built with g++ at first use into ``build/nkbx_torch/`` at the root of
the checkout (against libjpeg and libpng), never loaded from nkbx's
committed library. Where it cannot be built (no compiler, no ``jpeglib.h``
or ``png.h``) it turns itself off, as nkbx's does: :func:`load` returns None
and :func:`unavailable_reason` says why; the loader then decodes in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nkbx_torch"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]
LIBS = ["-ljpeg", "-lpng"]

MODE_LONGEST_PAD = 0
MODE_STRETCH = 1

_state = {"lib": None, "reason": None}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnkbx_data-{h.hexdigest()[:16]}.so"


def _build(so: Path):
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None where it cannot be."""
    if _state["lib"] is not None or _state["reason"] is not None:
        return _state["lib"]
    try:
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _state["reason"] = str(e)
        return None
    lib.nkbx_pool_create.restype = ctypes.c_void_p
    lib.nkbx_pool_create.argtypes = [ctypes.c_int]
    lib.nkbx_pool_destroy.restype = None
    lib.nkbx_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.nkbx_decode_batch.restype = None
    lib.nkbx_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)]
    lib.nkbx_version.restype = ctypes.c_char_p
    lib.nkbx_version.argtypes = []
    _state["lib"] = lib
    return lib


def unavailable_reason() -> Optional[str]:
    """Why :func:`load` returned None (None while it has not failed)."""
    return _state["reason"]


class NativeDecodePool:
    """C++ thread-pool batch decoder; raises RuntimeError where the library
    cannot be built."""

    def __init__(self, n_threads: int = 0):
        lib = load()
        if lib is None:
            raise RuntimeError(f"the native decoder is unavailable: {unavailable_reason()}")
        self._lib = lib
        self._pool = lib.nkbx_pool_create(n_threads)

    def decode_batch(self, paths, out_h: int, out_w: int, crops=None,
                     mode: int = MODE_LONGEST_PAD, out: Optional[np.ndarray] = None):
        """Decode ``paths`` into a (N, out_h, out_w, 3) uint8 batch.

        ``crops``: optional (N, 4) int32 xyxy boxes, a row of -1 for none.
        ``out``: optional preallocated batch. Returns (batch, status), status
        0 where a file decoded."""
        n = len(paths)
        if out is None:
            out = np.zeros((n, out_h, out_w, 3), dtype=np.uint8)
        if out.shape != (n, out_h, out_w, 3) or out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError(f"decode_batch: out must be a C-contiguous uint8 "
                             f"{(n, out_h, out_w, 3)}, got {out.dtype} {out.shape}")
        status = np.zeros(n, dtype=np.int32)
        c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
        c_crops = None
        if crops is not None:
            crops = np.ascontiguousarray(crops, dtype=np.int32)
            if crops.shape != (n, 4):
                raise ValueError(f"decode_batch: crops must be ({n}, 4), got {crops.shape}")
            c_crops = crops.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        self._lib.nkbx_decode_batch(
            self._pool, c_paths, n, c_crops, out_h, out_w, mode,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out, status

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.nkbx_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()


def version() -> Optional[str]:
    lib = load()
    return lib.nkbx_version().decode() if lib else None
