"""Threefry-2x32 keys and Gumbel noise as ``jax.random`` draws them under
partitionable threefry, written from the Threefry paper (Salmon et al.,
SC 2011, 20 rounds of 2x32) and JAX's ``random.split`` / ``random.bits``
/ ``random.gumbel`` definitions, in plain numpy and PyTorch (uint32 held in
int64 tensors). The A2C trainers draw their actions with this noise, so
the reference draws the same noise from the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0: int, k1: int, x0, x1):
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


def key(seed: int) -> np.ndarray:
    """``PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """``random.split(k, num)``: the hash of the counters ``(0, i)``."""
    k0, k1 = int(k[0]), int(k[1])
    lo = np.arange(num, dtype=np.int64)
    y0, y1 = threefry2x32(k0, k1, np.zeros_like(lo), lo)
    return np.stack([y0, y1], axis=1).astype(np.uint32)


def gumbel(k, shape, device) -> torch.Tensor:
    """``random.gumbel(k, shape)`` float32: the bits ``y0 ^ y1`` of the hash
    of the flat counter, the mantissa-fill uniform in ``[tiny, 1)``, then
    ``-log(-log(u))``."""
    k0, k1 = int(k[0]), int(k[1])
    lo = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    bits = (y0 ^ y1).reshape(shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))
