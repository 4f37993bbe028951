"""Value network (critic): caption encoder + joint-state MLP.

Counterpart of the JAX ``models/value.py`` in its batched (per-sample)
mode: token embedding -> LSTM caption encoder -> concat with the image
feature -> ``linear1`` (F+H -> H) -> ``linear2`` (H -> 1), with no
nonlinearity between the two linears. The reference-compat batch-as-time
mode (quirk Q1) and the bidirectional critic are not ported yet.
"""

from __future__ import annotations

import torch

from ..config import NetConfig
from ..ops.linalg import dense
from ..ops.rnn import LSTMState, lstm_cell, lstm_scan
from .initializers import embedding_init, linear_init, lstm_init
from .policy import check_unidirectional


def init(gen: torch.Generator, cfg: NetConfig) -> dict:
    check_unidirectional(cfg)
    h = cfg.hidden_dim
    return {
        "embedding": embedding_init(gen, cfg.vocab_size, cfg.wordvec_dim),
        "linear1": linear_init(gen, cfg.input_dim + h, h),
        "linear2": linear_init(gen, h, 1),
        "lstm": lstm_init(gen, cfg.wordvec_dim, h),
    }


def encode(params: dict, cfg: NetConfig, captions: torch.Tensor) -> torch.Tensor:
    """Per-sample caption encoding. ``[N, T] -> [N, H]``."""
    xs = params["embedding"][captions].transpose(0, 1)  # [T, N, E]
    hs, _ = lstm_scan(params["lstm"], xs, zero_rnn_state(cfg, captions.shape[0], xs.device))
    return hs[-1]


def value_head(params: dict, cfg: NetConfig, features: torch.Tensor,
               rnn_out: torch.Tensor) -> torch.Tensor:
    """``linear2(linear1([features; rnn_out]))`` -> ``[..., 1]``."""
    state = torch.cat([features, rnn_out], dim=-1)
    return dense(dense(state, params["linear1"]), params["linear2"])


def forward(params: dict, cfg: NetConfig, features: torch.Tensor,
            captions: torch.Tensor) -> torch.Tensor:
    """``features [N, F]``, ``captions [N, T]`` -> ``[N, 1]``."""
    return value_head(params, cfg, features, encode(params, cfg, captions))


def zero_rnn_state(cfg: NetConfig, batch: int, device=None) -> LSTMState:
    check_unidirectional(cfg)
    z = torch.zeros((batch, cfg.hidden_dim), dtype=torch.float32, device=device)
    return z, z


def rnn_step_emb(params: dict, cfg: NetConfig, x: torch.Tensor, state: LSTMState) -> LSTMState:
    """Advance the encoder by one already-embedded token ``x [..., E]``
    (any leading shape — the beam expands candidates as ``[N, B, B, E]``)."""
    check_unidirectional(cfg)
    return lstm_cell(params["lstm"], x, state)


def rnn_step(params: dict, cfg: NetConfig, tokens: torch.Tensor, state: LSTMState) -> LSTMState:
    """Advance the encoder by one token id per sample."""
    return rnn_step_emb(params, cfg, params["embedding"][tokens], state)


def value_from_state(params: dict, cfg: NetConfig, features: torch.Tensor,
                     state: LSTMState) -> torch.Tensor:
    """Value of the prefix whose encoding is carried in ``state`` -> ``[..., 1]``."""
    return value_head(params, cfg, features, state[0])
