"""Embedding-reward scoring (counterpart of the JAX ``ops/reward_ops.py``)."""

from __future__ import annotations

import torch


def cosine_embedding_reward(visual_embeds: torch.Tensor, semantic_embeds: torch.Tensor,
                            eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity of L2-normalised embedding pairs, the learned
    reward ``r = cos(ve, se)`` per sample: ``[N, D] x [N, D] -> [N]``.
    ``eps`` is torch ``F.normalize``'s clamp, so zero vectors give 0, not
    NaN."""

    def normalize(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)

    return torch.sum(normalize(visual_embeds) * normalize(semantic_embeds), dim=-1)
