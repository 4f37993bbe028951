"""Build and load the port's CUDA kernels (``csrc/*.cu``), and the rules
every kernel wrapper routes by (:func:`runs_kernel`,
:func:`refuse_forced_kernel`, :func:`kernel_weight_dtype`).

The sources compile with ``nvcc`` for ``sm_90a``, one process per source,
all started together, and link into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds. The library lands in the package's ``_build/``
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    "icrl_decode_workspace_floats": (ctypes.c_size_t, [_I] * 6),
    "icrl_decode": (_I, [_I] * 12 + [_F, _F, _U, _U, _U] + [_I] * 7 + [_P] * 12 + [_I, _P]),
    "icrl_beam_max_beam": (_I, []),
    "icrl_beam_workspace_floats": (ctypes.c_size_t, [_I] * 5),
    "icrl_beam_search": (_I, [_I] * 9 + [_F, _F] + [_I] * 8 + [_P] * 21),
    "icrl_token_gates": (_I, [_I] * 4 + [_P] * 4 + [_I, _P]),
    "icrl_lstm_chain_fwd": (_I, [_I] * 10 + [_P] * 12),
    "icrl_lstm_chain_bwd": (_I, [_I] * 11 + [_P] * 17),
    "icrl_gru_chain_fwd": (_I, [_I] * 10 + [_P] * 11),
    "icrl_gru_chain_bwd": (_I, [_I] * 11 + [_P] * 22),
    "icrl_threefry": (_I, [_I, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_longlong, _I, _P, _P]),
    "icrl_reward_stream_workspace_floats": (ctypes.c_size_t, [_I] * 2),
    "icrl_reward_stream": (_I, [_I] * 10 + [_P] * 13),
    "icrl_rollout_workspace_floats": (ctypes.c_size_t, [_I] * 3),
    "icrl_rollout_fwd": (_I, [_I] * 15 + [_P] * 31 + [_I] + [_P] * 10),
    "icrl_rollout_bwd_workspace_floats": (ctypes.c_size_t, [_I] * 11),
    "icrl_rollout_bwd": (_I, [_I] * 15 + [_P] * 5 + [_I] + [_P] * 35 + [_I, _P]),
    "icrl_conv_epilogue": (_I, [_I] * 6 + [_P] * 4),
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
        nvcc = nvcc_path()
        objs = [lib.with_suffix(f".{os.getpid()}.{src.stem}.o") for src in cu]
        try:
            procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
                     for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                                 for src, obj in zip(cu, objs))]
            failed = []
            for cmd, p in procs:
                out = p.communicate()[0]
                if p.returncode != 0:
                    failed.append((cmd, p.returncode, out))
            if not failed:
                link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
                proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                if proc.returncode != 0:
                    failed = [(link, proc.returncode, proc.stdout)]
            if failed:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"{' '.join(cmd)} (code {code})\n{out}" for cmd, code, out in failed))
            os.replace(tmp, lib)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
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


def runs_kernel(use_fused_kernel, tensor, kernel: str) -> bool:
    """The port's one routing rule: whether a wrapper's call runs its
    kernel (True) or its plain version. ``use_fused_kernel=False`` runs the
    plain version; otherwise a CUDA ``tensor`` runs the kernel, and a CPU
    one the plain version, but ``True`` raises there (``RuntimeError``;
    ``kernel`` names the kernel in the message). Nothing falls back."""
    if use_fused_kernel is False:
        return False
    if tensor.is_cuda:
        return True
    if use_fused_kernel:
        raise RuntimeError(f"use_fused_kernel=True needs CUDA tensors: the {kernel} kernel "
                           "runs only on a CUDA device")
    return False


def refuse_forced_kernel(forced, what: str, why: str) -> None:
    """A kernel forced (``forced`` true) in a mode that no kernel serves
    raises ``ValueError`` rather than quietly running another program (the
    JAX package's rule). ``what`` names the forcing flag, ``why`` the
    mode."""
    if forced:
        raise ValueError(f"{what} was explicitly forced but cannot be honored {why} — the "
                         "fused kernels are unidirectional, non-faithful and non-compat; "
                         "drop the force flag or the conflicting mode")


def kernel_weight_dtype(device, weight_dtype=None):
    """The kernels' weight type: ``weight_dtype`` if given, else bf16 on a
    CUDA device (the TPU kernels' type) and float32 elsewhere, where the
    plain versions then equal the JAX package's float32 decode."""
    if weight_dtype is not None:
        return weight_dtype
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def check_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.icrl_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
