"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so
a build takes seconds. The library lands in the package's ``_build/``
directory under a name keyed by a hash of the sources and flags: a fresh
checkout builds on first use, an edited source rebuilds, and concurrent
processes share one build behind a file lock. A failed build raises with
nvcc's output.

Nothing here runs at import time; the CPU-only paths never build.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "icrl_greedy_workspace_floats": (ctypes.c_size_t, [_I] * 4),
    "icrl_greedy_decode": (_I, [_I] * 7 + [_P] * 12),
    "icrl_beam_max_beam": (_I, []),
    "icrl_beam_workspace_floats": (ctypes.c_size_t, [_I] * 6),
    "icrl_beam_search": (_I, [_I] * 7 + [_F, _F, _I] + [_P] * 20),
    "icrl_token_gates": (_I, [_I] * 4 + [_P] * 4),
    "icrl_error_string": (ctypes.c_char_p, [_I]),
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "kernels build from source and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libicrl_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the current sources have no library yet."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while we waited
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cu, _ = _sources()
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with every entry point's
    argument and result types declared (pointers and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.icrl_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
