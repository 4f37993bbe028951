"""Thin linear-algebra helpers (counterpart of the JAX ``ops/linalg.py``).

Every matmul of the port's plain code flows through :func:`matmul`. On a
CUDA tensor it turns TF32 off first, so a float32 product is a float32
product on every device and the plain versions stay exact references for
the kernels.
"""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 (TF32 disabled on CUDA)."""
    if a.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(a, b)


def dense(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """Apply an affine layer ``{'w': [in, out], 'b': [out]}`` (input-major
    weights, the transpose of ``nn.Linear``'s layout)."""
    y = matmul(x, layer["w"])
    if layer.get("b") is not None:
        y = y + layer["b"]
    return y
