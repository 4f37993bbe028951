"""Build and load the native fastmetrics library.

Compiles ``fastmetrics.cpp`` with the system ``g++`` into the package's
``_build/`` directory, under a name keyed by a hash of the source (as
:mod:`..ops.kernel_build` keys the kernels' library), and binds it with
ctypes. Concurrent processes may race to build: each compiles to its own
temp file and publishes it with an atomic rename. A missing toolchain or a
failed build gives ``None``, and the callers then score in pure Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "fastmetrics.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libfastmetrics_{digest}.so"


def _build() -> Optional[Path]:
    try:
        lib = library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        # an unwritable build directory: None, and the callers score in
        # pure Python
        return None
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        Path(tmp).unlink(missing_ok=True)
        return None
    return lib


@functools.lru_cache(maxsize=None)
def load_fastmetrics() -> Optional[ctypes.CDLL]:
    """The library (built on first use), with every entry point's argument
    and result types declared; ``None`` when it cannot be built."""
    lib_path = _build()
    if lib_path is None:
        return None
    lib = ctypes.CDLL(str(lib_path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    corpus = [i32p, i64p, ctypes.c_int64,  # hypotheses: tokens, offsets, count
              i32p, i64p, i64p]            # references: tokens, offsets, group offsets
    signatures = {
        "bleu_stats": corpus + [i64p, i64p, i64p, i64p],  # correct, guess, testlen, reflen
        "cider_scores": corpus + [f64p],
        "rouge_scores": corpus + [f64p],
        "meteor_scores": corpus + [i32p, f64p, f64p],  # stem ids, delta weights, scores
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def native_available() -> bool:
    return load_fastmetrics() is not None
