"""JAX's threefry random numbers, drawn as the JAX package draws them.

The port's own copy of what the JAX package takes from ``jax.random`` under
partitionable threefry (the package pins it, ``tests/test_pallas_sample.py``)
and of its helpers ``threefry2x32_bits`` and ``gumbel_from_bits``
(``ops/pallas_sample.py:90-140``):

  * :func:`PRNGKey` — ``jax.random.PRNGKey(seed)``: ``[0, seed]`` as uint32;
  * :func:`split` — ``jax.random.split`` (jax's ``_threefry_split_foldlike``):
    threefry2x32 of the 64-bit counters ``0 .. num - 1`` under the key, both
    output words stacked as the new keys;
  * :func:`sample_step_keys` — the sampling decode's per-step subkeys
    (``pallas_sample.py:282-292``): carry the key, each step
    ``key, sub = split(key)`` (the plain version's; the kernel carries the
    same chain itself from the key's two words, :func:`key_words`);
  * :func:`random_bits` — ``jax.random.bits(key, shape)``: ``y0 ^ y1`` of the
    hash of the flat counter ``(hi 0, lo row * V + col)``;
  * :func:`gumbel` — ``jax.random.gumbel`` in its default mode "low": the
    mantissa-fill uniform in ``[tiny, 1)``, then ``-log(-log(u))``;
  * :func:`categorical` — ``argmax(gumbel + logits)``, the first index on
    ties (``jax.random.categorical``).

Where each part runs: keys are eight bytes, so they stay on the host as
numpy ``uint32[2]`` and are split there (no device sync per minibatch). The
bits and the noise are made on the tensor's device: on a CUDA device by the
kernel ``csrc/threefry.cu`` (:func:`gumbel_noise`, one launch for a stack of
keys), elsewhere by the plain version, which emulates uint32 arithmetic in
int64 tensors (torch has no full uint32 arithmetic on the CPU). The noise
functions run on the card unless the caller asks for ``device="cpu"``.

Counters are 32-bit: one key's draw must hold fewer than 2**32 elements
(JAX's high counter word is then 0).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .kernel_build import check_error, load_library

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _threefry2x32(k0: int, k1: int, x0, x1):
    """The 20-round threefry-2x32 hash of the counter words ``(x0, x1)``
    (Python ints, or int64 numpy arrays or torch tensors holding uint32
    values) under the key ``(k0, k1)`` -> ``(y0, y1)`` of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for d in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << d) | (x1 >> (32 - d))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key_words(key) -> tuple[int, int]:
    """A host key's two uint32 words as Python ints (a kernel's arguments)."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"a key is a uint32 array of shape (2,), got {key.dtype} {key.shape}")
    return int(key[0]), int(key[1])


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & _MASK], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> ``uint32 [num, 2]``, on the host."""
    k0, k1 = key_words(key)
    lo = np.arange(num, dtype=np.int64)
    y0, y1 = _threefry2x32(k0, k1, np.zeros_like(lo), lo)
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def sample_step_keys(key, steps: int) -> np.ndarray:
    """The ``[steps, 2]`` uint32 subkeys a sampling decode draws from
    ``key``: carry the key, each step ``key, sub = split(key)``. On the host
    in Python ints: a chain of single hashes, where numpy's per-call cost
    would take ten times as long (~3 ms for 16 steps)."""
    k0, k1 = key_words(key)
    subs = np.empty((steps, 2), dtype=np.uint32)
    for s in range(steps):
        subs[s] = _threefry2x32(k0, k1, 0, 1)  # split(key)[1]
        k0, k1 = _threefry2x32(k0, k1, 0, 0)   # split(key)[0]
    return subs


def _draw_size(shape) -> int:
    size = math.prod(shape)
    if size >= 2**32:
        raise ValueError(f"a draw of {size} elements needs 64-bit counters (at most 2**32 - 1)")
    return size


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) in the plain version: an
    int64 tensor of ``shape`` holding the uint32 values."""
    k0, k1 = key_words(key)
    lo = torch.arange(_draw_size(shape), dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return (y0 ^ y1).reshape(shape)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 tensor) -> standard Gumbel float32, as
    ``jax.random.gumbel`` maps them: ``u = max(tiny, f * (1 - tiny) + tiny)``
    for the mantissa-fill ``f`` in ``[0, 1)``, then ``-log(-log(u))``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def gumbel_noise_plain(keys, shape, device="cpu") -> torch.Tensor:
    """:func:`gumbel_noise` in the plain version, on any device."""
    return torch.stack([gumbel_from_bits(random_bits(k, shape, device)) for k in keys])


def _launch_threefry(keys: np.ndarray, shape, device: torch.device, gumbel_out: bool
                     ) -> torch.Tensor:
    plane = _draw_size(shape)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    out = torch.empty((len(keys), *shape), device=device,
                      dtype=torch.float32 if gumbel_out else torch.int32)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.icrl_threefry(len(keys), keys.ctypes.data_as(ctypes.c_void_p), plane,
                                int(gumbel_out), out.data_ptr(),
                                torch.cuda.current_stream(device).cuda_stream)
    check_error(lib, "icrl_threefry", err)
    gumbel_noise.launches += 1
    return out


def gumbel_noise(keys, shape, device="cuda") -> torch.Tensor:
    """One Gumbel draw of ``shape`` per key: ``keys uint32 [S, 2]`` ->
    float32 ``[S, *shape]`` on ``device``; row ``s`` is
    ``jax.random.gumbel(keys[s], shape)``. On a CUDA device the kernel
    (``csrc/threefry.cu``) makes all of them in one launch
    (``gumbel_noise.launches`` counts them); on ``device="cpu"`` the plain
    version runs. A missing CUDA device raises."""
    from ..api import resolve_device  # api imports the ops: resolve at call time

    keys = np.asarray(keys)
    if keys.ndim != 2 or keys.shape[1] != 2 or keys.dtype != np.uint32:
        raise ValueError(f"keys must be a uint32 array [S, 2], got {keys.dtype} {keys.shape}")
    device = resolve_device(device)
    shape = tuple(shape)
    if device.type == "cuda":
        return _launch_threefry(keys, shape, device, True)
    return gumbel_noise_plain(keys, shape, device)


gumbel_noise.launches = 0


def threefry_bits_kernel(keys, shape, device) -> torch.Tensor:
    """The kernel's raw bits, ``[S, *shape]`` int32 holding the uint32
    bit patterns, for comparing the kernel with :func:`random_bits` on a
    CUDA device (the training path reads only :func:`gumbel_noise`)."""
    keys = np.asarray(keys, dtype=np.uint32)
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("threefry_bits_kernel runs only on a CUDA device")
    return _launch_threefry(keys, tuple(shape), device, False)


def gumbel(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` float32 on ``device`` (the card
    unless the caller asks for the CPU)."""
    return gumbel_noise(np.asarray(key)[None], shape, device)[0]


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the first
    index of the largest ``gumbel + logits`` (int64)."""
    noise = gumbel(key, logits.shape, logits.device)
    return torch.argmax(noise + logits, dim=-1)
