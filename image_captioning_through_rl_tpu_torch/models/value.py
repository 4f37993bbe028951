"""Value network (critic): caption encoder + joint-state MLP.

Counterpart of the JAX ``models/value.py``: token embedding -> LSTM
caption encoder -> concat with the image feature -> ``linear1`` (F+H -> H)
-> ``linear2`` (H -> 1), with no nonlinearity between the two linears. A
bidirectional critic maps its ``2H`` encoding through ``rnn_linear`` (2H ->
H) first. Two encodings: the batched (per-sample) one, and the reference's
batch-as-time one (quirk Q1, :func:`forward_compat`): the batch axis fed as
the LSTM's time axis at batch 1 with a persistent hidden state, so sample
``i`` depends on samples ``< i`` and on earlier calls.

Incremental state: ``(h, c)`` unidirectional; bidirectional ``(fwd (h, c),
h_bwd_last)``. On a vocab-sharded tree the lookups are vocab-parallel
(:func:`..parallel.tensor_parallel.lookup`). :func:`encode` reads
``hs[-1]``, whose backward half is the reverse scan's state at the last
position: one backward cell applied to the last token from the zero state,
independent of the rest of the prefix. So stepping is exact for a
bidirectional critic too.
"""

from __future__ import annotations

import torch

from ..config import NetConfig
from ..ops.linalg import dense
from ..ops.rnn import bilstm_scan, column_stream_scan_bidi, flat_stream_scan, lstm_cell, lstm_scan
from ..parallel.tensor_parallel import lookup
from .initializers import linear_init, lstm_init
from .policy import embedding_table


def init(gen: torch.Generator, cfg: NetConfig, pretrained_embeddings=None) -> dict:
    h = cfg.hidden_dim
    embedding = embedding_table(gen, cfg, pretrained_embeddings)
    params = {
        "embedding": embedding,
        "linear1": linear_init(gen, cfg.input_dim + h, h),
        "linear2": linear_init(gen, h, 1),
    }
    if cfg.bidirectional:
        params["lstm_fwd"] = lstm_init(gen, embedding.shape[1], h)
        params["lstm_bwd"] = lstm_init(gen, embedding.shape[1], h)
        params["rnn_linear"] = linear_init(gen, 2 * h, h)
    else:
        params["lstm"] = lstm_init(gen, embedding.shape[1], h)
    return params


def encode(params: dict, cfg: NetConfig, captions: torch.Tensor) -> torch.Tensor:
    """Per-sample caption encoding. ``[N, T] -> [N, H]``."""
    xs = lookup(params, captions).transpose(0, 1)  # [T, N, E]
    z = torch.zeros((captions.shape[0], cfg.hidden_dim), dtype=torch.float32,
                    device=xs.device)
    if cfg.bidirectional:
        hs, _ = bilstm_scan(params["lstm_fwd"], params["lstm_bwd"], xs, (z, z), (z, z))
        # hs[-1] = [fwd after all T tokens, bwd after only token T-1]: torch's
        # output[-1], as the JAX package keeps it for reference alignment
        return dense(hs[-1], params["rnn_linear"])
    hs, _ = lstm_scan(params["lstm"], xs, (z, z))
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


def zero_rnn_state(cfg: NetConfig, batch: int, device=None):
    z = torch.zeros((batch, cfg.hidden_dim), dtype=torch.float32, device=device)
    return ((z, z), z) if cfg.bidirectional else (z, z)


def rnn_step_emb(params: dict, cfg: NetConfig, x: torch.Tensor, state):
    """Advance the encoder by one already-embedded token ``x [..., E]``
    (any leading shape — the beam expands candidates as ``[N, B, B, E]``)."""
    if cfg.bidirectional:
        fwd, _ = state
        z = torch.zeros(x.shape[:-1] + (cfg.hidden_dim,), dtype=x.dtype, device=x.device)
        h_bwd, _ = lstm_cell(params["lstm_bwd"], x, (z, z))
        return lstm_cell(params["lstm_fwd"], x, fwd), h_bwd
    return lstm_cell(params["lstm"], x, state)


def rnn_step(params: dict, cfg: NetConfig, tokens: torch.Tensor, state):
    """Advance the encoder by one token id per sample."""
    return rnn_step_emb(params, cfg, lookup(params, tokens), state)


def value_from_state(params: dict, cfg: NetConfig, features: torch.Tensor,
                     state) -> torch.Tensor:
    """Value of the prefix whose encoding is carried in ``state`` -> ``[..., 1]``."""
    if cfg.bidirectional:
        (h_f, _), h_bwd = state
        rnn_out = dense(torch.cat([h_f, h_bwd], dim=-1), params["rnn_linear"])
        return value_head(params, cfg, features, rnn_out)
    return value_head(params, cfg, features, state[0])


def compat_zero_state(cfg: NetConfig, device=None):
    """The reference's persistent ``hidden_cell`` at zero (reference
    models.py:122-128): ``(h, c)`` each ``[H]``; bidirectional, one such
    pair per direction, ``(fwd, bwd)``."""
    z = torch.zeros((cfg.hidden_dim,), dtype=torch.float32, device=device)
    return ((z, z), (z, z)) if cfg.bidirectional else (z, z)


def forward_compat(params: dict, cfg: NetConfig, features: torch.Tensor,
                   captions: torch.Tensor, carry):
    """The reference-exact value forward with batch-as-time statefulness
    (the JAX ``models/value.py:152-197``) -> ``(values [N, 1], new_carry)``.
    Unidirectional: the captions read column-major as one stream
    (``captions.T.reshape(-1)``), the last column's outputs encoding the
    samples. Bidirectional: one bidirectional call per column
    (:func:`..ops.rnn.column_stream_scan_bidi`), then ``rnn_linear``. Thread
    ``new_carry`` into the next call; reset it where the reference calls
    ``init_hidden()`` (trainers.py:196-197, 495-496, 611-612)."""
    n, t = captions.shape
    if cfg.bidirectional:
        xs = lookup(params, captions).transpose(0, 1)  # [T, N, E]
        rnn_out, new_carry = column_stream_scan_bidi(
            "lstm", params["lstm_fwd"], params["lstm_bwd"], xs, carry)
        rnn_out = dense(rnn_out, params["rnn_linear"])
        return value_head(params, cfg, features, rnn_out), new_carry
    stream = captions.t().reshape(-1)  # column-major [T N]
    outs, new_carry = flat_stream_scan("lstm", params["lstm"], lookup(params, stream), carry)
    return value_head(params, cfg, features, outs[(t - 1) * n:]), new_carry
