"""Reward network: the visual-semantic embedding model (the learned reward).

Counterpart of the JAX ``models/reward.py`` in its batched (per-sample)
mode: token embedding -> GRU caption encoder -> ``semantic_embed``
projection; image feature -> ``visual_embed`` projection. The forward
returns the raw ``(ve, se)`` pair; the cosine reward and the VSE loss are
separate ops (:func:`..ops.reward_ops.cosine_embedding_reward`,
:func:`..ops.losses.visual_semantic_embedding_loss`). Unidirectional only:
the bidirectional encoder and the batch-as-time compat mode (quirk Q1) are
not ported yet (ROADMAP §1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import NetConfig
from ..ops.linalg import dense
from ..ops.reward_ops import cosine_embedding_reward
from ..ops.rnn import gru_cell, gru_scan
from .initializers import gru_init, linear_init
from .policy import check_unidirectional, embedding_table


def init(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None) -> dict:
    check_unidirectional(cfg)
    h = cfg.hidden_dim
    embedding = embedding_table(gen, cfg, pretrained_embeddings)
    return {
        "embedding": embedding,
        "visual_embed": linear_init(gen, cfg.input_dim, h),
        "semantic_embed": linear_init(gen, h, h),
        "gru": gru_init(gen, embedding.shape[1], h),
    }


def encode(params: dict, cfg: NetConfig, captions: torch.Tensor) -> torch.Tensor:
    """Per-sample caption encoding (batched mode). ``[N, T] -> [N, H]``."""
    xs = params["embedding"][captions].transpose(0, 1)  # [T, N, E]
    hs, _ = gru_scan(params["gru"], xs, zero_rnn_state(cfg, captions.shape[0], xs.device))
    return hs[-1]


def embed_pair(params: dict, cfg: NetConfig, features: torch.Tensor, rnn_out: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return dense(features, params["visual_embed"]), dense(rnn_out, params["semantic_embed"])


def forward(params: dict, cfg: NetConfig, features: torch.Tensor, captions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-mode forward -> ``(ve [N, H], se [N, H])``."""
    return embed_pair(params, cfg, features, encode(params, cfg, captions))


def get_rewards(params: dict, cfg: NetConfig, features: torch.Tensor,
                captions: torch.Tensor) -> torch.Tensor:
    """Embedding reward of (image, caption) pairs -> ``[N, 1]``: forward +
    L2-normalised cosine similarity."""
    ve, se = forward(params, cfg, features, captions)
    return cosine_embedding_reward(ve, se)[:, None]


def zero_rnn_state(cfg: NetConfig, batch: int, device=None) -> torch.Tensor:
    check_unidirectional(cfg)
    return torch.zeros((batch, cfg.hidden_dim), dtype=torch.float32, device=device)


def rnn_step(params: dict, cfg: NetConfig, tokens: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
    """Advance the encoder by one token id per sample."""
    check_unidirectional(cfg)
    return gru_cell(params["gru"], params["embedding"][tokens], h)
