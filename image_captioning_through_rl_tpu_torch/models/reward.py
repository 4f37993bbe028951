"""Reward network: the visual-semantic embedding model (the learned reward).

Counterpart of the JAX ``models/reward.py``: token embedding -> GRU
caption encoder -> ``semantic_embed`` projection; image feature ->
``visual_embed`` projection. The forward returns the raw ``(ve, se)`` pair;
the cosine reward and the VSE loss are separate ops
(:func:`..ops.reward_ops.cosine_embedding_reward`,
:func:`..ops.losses.visual_semantic_embedding_loss`). A bidirectional
encoder (``gru_fwd``, ``gru_bwd``) hands ``semantic_embed`` (2H -> H) its
``2H`` encoding; it has no incremental step. :func:`forward_compat` is the
reference's batch-as-time encoding (quirk Q1), with its carried state.
On a vocab-sharded tree the lookups are vocab-parallel
(:func:`..parallel.tensor_parallel.lookup`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import NetConfig
from ..ops.linalg import dense
from ..ops.reward_ops import cosine_embedding_reward
from ..ops.rnn import column_stream_scan_bidi, flat_stream_scan, gru_cell, gru_scan
from ..parallel.tensor_parallel import lookup
from .initializers import gru_init, linear_init
from .policy import embedding_table


def init(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None) -> dict:
    h = cfg.hidden_dim
    embedding = embedding_table(gen, cfg, pretrained_embeddings)
    params = {
        "embedding": embedding,
        "visual_embed": linear_init(gen, cfg.input_dim, h),
        "semantic_embed": linear_init(gen, h * cfg.num_directions, h),
    }
    if cfg.bidirectional:
        params["gru_fwd"] = gru_init(gen, embedding.shape[1], h)
        params["gru_bwd"] = gru_init(gen, embedding.shape[1], h)
    else:
        params["gru"] = gru_init(gen, embedding.shape[1], h)
    return params


def encode(params: dict, cfg: NetConfig, captions: torch.Tensor) -> torch.Tensor:
    """Per-sample caption encoding (batched mode). ``[N, T] -> [N, H * nd]``."""
    xs = lookup(params, captions).transpose(0, 1)  # [T, N, E]
    z = zero_rnn_state(cfg, captions.shape[0], xs.device)
    if cfg.bidirectional:
        hs_f, _ = gru_scan(params["gru_fwd"], xs, z)
        hs_b, _ = gru_scan(params["gru_bwd"], xs, z, reverse=True)
        # [fwd after all T tokens, bwd after only token T-1]: torch's output[-1]
        return torch.cat([hs_f[-1], hs_b[-1]], dim=-1)
    hs, _ = gru_scan(params["gru"], xs, z)
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
    return torch.zeros((batch, cfg.hidden_dim), dtype=torch.float32, device=device)


def rnn_step(params: dict, cfg: NetConfig, tokens: torch.Tensor, h: torch.Tensor
             ) -> torch.Tensor:
    """Advance the (unidirectional) encoder by one token id per sample."""
    if cfg.bidirectional:
        raise ValueError("incremental reward encoding requires unidirectional mode")
    return gru_cell(params["gru"], lookup(params, tokens), h)


def compat_zero_state(cfg: NetConfig, device=None):
    """The persistent hidden at zero: ``h [H]``; bidirectional, ``(fwd,
    bwd)`` (the reference's ``(2, 1, H)``, models.py:217-224)."""
    z = torch.zeros((cfg.hidden_dim,), dtype=torch.float32, device=device)
    return (z, z) if cfg.bidirectional else z


def forward_compat(params: dict, cfg: NetConfig, features: torch.Tensor,
                   captions: torch.Tensor, carry):
    """The reference-exact forward with batch-as-time GRU statefulness (the
    JAX ``models/reward.py:113-150``) -> ``((ve, se), new_carry)``; reset
    the carry per minibatch where the reference calls ``init_hidden()``
    (trainers.py:307, 495)."""
    n, t = captions.shape
    if cfg.bidirectional:
        xs = lookup(params, captions).transpose(0, 1)  # [T, N, E]
        rnn_out, new_carry = column_stream_scan_bidi(
            "gru", params["gru_fwd"], params["gru_bwd"], xs, carry)
        return embed_pair(params, cfg, features, rnn_out), new_carry
    stream = captions.t().reshape(-1)
    outs, new_carry = flat_stream_scan("gru", params["gru"], lookup(params, stream), carry)
    return embed_pair(params, cfg, features, outs[(t - 1) * n:]), new_carry
