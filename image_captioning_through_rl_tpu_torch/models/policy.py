"""Policy network (actor): feature-conditioned LSTM caption decoder.

Counterpart of the JAX ``models/policy.py``: token embedding -> LSTM
whose initial hidden state is a linear projection of the image feature
(cell state zeros) -> linear vocab head. Parameters are a plain dict in
the JAX layout. A bidirectional policy projects the feature to ``2H`` and
splits it into per-direction initial states (``lstm_fwd``, ``lstm_bwd``),
and its head reads ``[fwd_h_t, bwd_h_t]``.

  * :func:`forward` — full-sequence teacher forcing.
  * on a vocab-sharded tree (:class:`..parallel.sharding.Sharded`) the
    lookups and the head are vocab-parallel
    (:mod:`..parallel.tensor_parallel`): the logits are the rank's columns;
  * :func:`init_decode_state` + :func:`step` — incremental stepping that
    carries ``(h, c)``, so decode is O(T). It is exact for a bidirectional
    policy too: decoding reads the last position's logits only, and the
    backward direction's state there is the first step of its right-to-left
    scan, one cell applied to the current token from the fixed backward
    initial state. The bidirectional step carries the forward ``(h, c)``
    and recomputes that one backward cell per token.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..config import NetConfig
from ..ops.linalg import dense
from ..ops.rnn import LSTMState, bilstm_scan, lstm_cell, lstm_scan
from ..parallel.tensor_parallel import head, lookup
from .initializers import embedding_init, linear_init, lstm_init

# the carried decode state: ``(h, c)`` unidirectional, ``(fwd (h, c),
# bwd_init (h, c))`` bidirectional
DecodeState = Union[LSTMState, Tuple[LSTMState, LSTMState]]


def embedding_table(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None
                    ) -> torch.Tensor:
    """A fresh N(0, 1) table, or the pretrained word vectors (which then fix
    the word-vector width)."""
    if pretrained_embeddings is not None:
        return torch.as_tensor(pretrained_embeddings, dtype=torch.float32).clone()
    return embedding_init(gen, cfg.vocab_size, cfg.wordvec_dim)


def init(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None) -> dict:
    h, nd = cfg.hidden_dim, cfg.num_directions
    embedding = embedding_table(gen, cfg, pretrained_embeddings)
    params = {
        "embedding": embedding,
        "cnn2linear": linear_init(gen, cfg.input_dim, h * nd),
        "head": linear_init(gen, h * nd, cfg.vocab_size),
    }
    if cfg.bidirectional:
        params["lstm_fwd"] = lstm_init(gen, embedding.shape[1], h)
        params["lstm_bwd"] = lstm_init(gen, embedding.shape[1], h)
    else:
        params["lstm"] = lstm_init(gen, embedding.shape[1], h)
    return params


def init_decode_state(params: dict, cfg: NetConfig, features: torch.Tensor) -> DecodeState:
    """Initial carried state: ``h0 = cnn2linear(features)``, ``c0 = 0``;
    bidirectional, ``h0`` split into the forward and backward halves."""
    h0 = dense(features, params["cnn2linear"])
    if cfg.bidirectional:
        hf, hb = torch.chunk(h0, 2, dim=-1)
        return (hf, torch.zeros_like(hf)), (hb, torch.zeros_like(hb))
    return h0, torch.zeros_like(h0)


def forward(params: dict, cfg: NetConfig, features: torch.Tensor,
            captions: torch.Tensor) -> torch.Tensor:
    """Teacher-forced forward. ``features [N, F]``, ``captions [N, T]`` -> ``[N, T, V]``."""
    xs = lookup(params, captions).transpose(0, 1)  # [T, N, E]
    if cfg.bidirectional:
        init_f, init_b = init_decode_state(params, cfg, features)
        hs, _ = bilstm_scan(params["lstm_fwd"], params["lstm_bwd"], xs, init_f, init_b)
    else:
        hs, _ = lstm_scan(params["lstm"], xs, init_decode_state(params, cfg, features))
    return head(params, hs).transpose(0, 1)


def step(params: dict, cfg: NetConfig, tokens: torch.Tensor, state: DecodeState
         ) -> Tuple[torch.Tensor, DecodeState]:
    """Consume one token per sample: ``tokens [N]`` -> ``(logits [N, V], state)``.
    Bidirectional: the forward state advances, and one backward cell from
    the carried backward initial state gives the backward half."""
    x = lookup(params, tokens)
    if cfg.bidirectional:
        fwd, bwd_init = state
        new_fwd = lstm_cell(params["lstm_fwd"], x, fwd)
        h_bwd, _ = lstm_cell(params["lstm_bwd"], x, bwd_init)
        return head(params, torch.cat([new_fwd[0], h_bwd], dim=-1)), (new_fwd, bwd_init)
    new_state = lstm_cell(params["lstm"], x, state)
    return head(params, new_state[0]), new_state
