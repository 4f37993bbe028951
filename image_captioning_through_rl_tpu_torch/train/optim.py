"""Optimizers (counterpart of the JAX ``train/optim.py``).

Adam with torch's defaults, betas (0.9, 0.999) and eps 1e-8 — the
reference's ``optim.Adam`` at four learning rates. With pretrained word
vectors the reference freezes the embedding tables; here they are left out
of the optimiser and need no gradient, so they never move (the JAX
package zeroes their updates with optax's ``set_to_zero``).
"""

from __future__ import annotations

import torch


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def adam(lr: float, params: dict, freeze_embeddings: bool = False) -> torch.optim.Adam:
    """Adam over the leaves of ``params`` (updated in place by ``step()``).
    Trained leaves get ``requires_grad``; with ``freeze_embeddings`` the
    ``embedding`` tables get none and stay out of the optimiser."""
    trained = []
    for path, leaf in _leaves(params):
        frozen = freeze_embeddings and "embedding" in path
        leaf.requires_grad_(not frozen)
        if not frozen:
            trained.append(leaf)
    return torch.optim.Adam(trained, lr=lr, betas=(0.9, 0.999), eps=1e-8)
