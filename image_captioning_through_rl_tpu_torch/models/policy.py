"""Policy network (actor): feature-conditioned LSTM caption decoder.

Counterpart of the JAX ``models/policy.py``: token embedding -> LSTM
whose initial hidden state is a linear projection of the image feature
(cell state zeros) -> linear vocab head. Parameters are a plain dict in
the JAX layout. Unidirectional only: the bidirectional policy is not
ported yet (ROADMAP §1).

  * :func:`forward` — full-sequence teacher forcing.
  * :func:`init_decode_state` + :func:`step` — incremental stepping that
    carries ``(h, c)``, so decode is O(T).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import NetConfig
from ..ops.linalg import dense
from ..ops.rnn import LSTMState, lstm_cell, lstm_scan
from .initializers import embedding_init, linear_init, lstm_init


def check_unidirectional(cfg: NetConfig) -> None:
    if cfg.bidirectional:
        raise NotImplementedError(
            "bidirectional networks are not ported yet (ROADMAP §1, modules 2-3)")


def embedding_table(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None
                    ) -> torch.Tensor:
    """A fresh N(0, 1) table, or the pretrained word vectors (which then fix
    the word-vector width)."""
    if pretrained_embeddings is not None:
        return torch.as_tensor(pretrained_embeddings, dtype=torch.float32).clone()
    return embedding_init(gen, cfg.vocab_size, cfg.wordvec_dim)


def init(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None) -> dict:
    check_unidirectional(cfg)
    h = cfg.hidden_dim
    embedding = embedding_table(gen, cfg, pretrained_embeddings)
    return {
        "embedding": embedding,
        "cnn2linear": linear_init(gen, cfg.input_dim, h),
        "head": linear_init(gen, h, cfg.vocab_size),
        "lstm": lstm_init(gen, embedding.shape[1], h),
    }


def init_decode_state(params: dict, cfg: NetConfig, features: torch.Tensor) -> LSTMState:
    """Initial carried state ``(h0, c0)``: ``h0 = cnn2linear(features)``,
    ``c0 = 0``."""
    check_unidirectional(cfg)
    h0 = dense(features, params["cnn2linear"])
    return h0, torch.zeros_like(h0)


def forward(params: dict, cfg: NetConfig, features: torch.Tensor,
            captions: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward. ``features [N, F]``, ``captions [N, T]`` -> ``[N, T, V]``."""
    xs = params["embedding"][captions].transpose(0, 1)  # [T, N, E]
    hs, _ = lstm_scan(params["lstm"], xs, init_decode_state(params, cfg, features))
    return dense(hs, params["head"]).transpose(0, 1)


def step(params: dict, cfg: NetConfig, tokens: torch.Tensor, state: LSTMState
         ) -> Tuple[torch.Tensor, LSTMState]:
    """Consume one token per sample: ``tokens [N]`` -> ``(logits [N, V], state)``."""
    check_unidirectional(cfg)
    x = params["embedding"][tokens]
    new_state = lstm_cell(params["lstm"], x, state)
    return dense(new_state[0], params["head"]), new_state
