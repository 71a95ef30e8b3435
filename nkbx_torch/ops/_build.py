"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` (Hopper) into its
own shared library with a plain C interface, ``build/nkbx_torch/lib<name>-<hash>.so``
at the root of the checkout. The hash covers the source, the headers of
``csrc/`` and the flags, so an edited source builds anew and an unchanged one
loads at once. No PyTorch header is compiled: a build takes seconds, where
``torch.utils.cpp_extension.load`` takes minutes. Sources in the checkout are
the only input.

Each C entry returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nkbx_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas=-v"]
MAX_SMEM = 232_448  # bytes of shared memory one H100 block may have

_libs: dict = {}


def sources() -> list:
    """Names of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``CUDA_HOME``, ``nvcc``
    on the PATH, or the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every named source that has no library yet, all at once.

    Returns ``{name: (seconds, compiler log)}`` for the sources it compiled;
    the log holds ptxas's register and shared-memory report. Raises with the
    compiler's output when a build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, so, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, so, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent builder sees all or nothing
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return done


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps each
    C entry to its ``argtypes`` (every entry returns an int error code)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def aligned(t):
    """``t`` contiguous at a 16-byte aligned address: the kernels move 16
    bytes at a time (a contiguous view may start at any element)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, what: str):
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")
