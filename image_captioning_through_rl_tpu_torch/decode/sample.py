"""Stochastic sampling decode: temperature, top-k, nucleus (counterpart of
the JAX ``decode/sample.py``).

One carried-state loop over ``policy.step`` (the same O(T) recurrence as
:func:`.greedy.greedy_decode`); each step splits the carried key and draws
the next token of every row with one categorical draw
(:func:`..ops.sampling.sample_categorical`, JAX's threefry Gumbel-max), so
equal keys give the JAX package's tokens. Keys are host ``uint32[2]``
arrays (:func:`..ops.prng.PRNGKey`).

Filtering follows the JAX module: ``temperature`` divides the float32
logits first; ``top_k`` keeps the k highest per row, every tie at the k-th
value included; ``top_p`` keeps the smallest prefix of the
probability-sorted vocabulary whose mass reaches ``top_p``, the crossing
token included. Both on: top-k first, the nucleus over the renormalised
survivors. Both direction modes step through :func:`..models.policy.step`.
"""

from __future__ import annotations

import torch

from ..config import NetConfig
from ..models import policy as policy_mod
from ..ops import prng
from ..ops.sampling import sample_categorical
from ..parallel.sharding import gather_params


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p=None) -> torch.Tensor:
    """Mask ``[N, V]`` logits to the top-k / nucleus set (the rest ``-inf``).

    ``top_k <= 0`` (or ``>= V``) leaves k off; ``top_p=None`` leaves the
    nucleus off. Sort-based, as the JAX package's XLA path."""
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # position i survives iff the mass strictly before it is < top_p, so
        # the crossing token, and always the argmax, stay in
        p = torch.tensor(float(top_p), dtype=torch.float32, device=logits.device)
        n_keep = ((cum - probs) < p).sum(dim=-1, keepdim=True)
        thr = torch.gather(sorted_desc, -1, n_keep - 1)
        logits = torch.where(logits >= thr, logits, -torch.inf)
    return logits


def _scaled(logits: torch.Tensor, temperature) -> torch.Tensor:
    return logits.to(torch.float32) / torch.tensor(float(temperature), dtype=torch.float32,
                                                   device=logits.device)


def sample_decode(params: dict, cfg: NetConfig, features: torch.Tensor,
                  start_tokens: torch.Tensor, key, max_len: int | None = None,
                  temperature=1.0, top_k: int = 0, top_p=None, row0: int = 0) -> torch.Tensor:
    """Ancestral sampling with carried LSTM state: ``[N, max_len]`` int32
    ids starting with ``start_tokens``, the full static length (the text
    decoder trims at <END>). Each step takes ``key, sub = split(key)`` and
    draws from the filtered softmax under ``sub`` (rows ``[row0, row0 + N)``
    of a global batch's draw with ``row0``). A vocab-sharded tree is
    gathered first (a collective over its model group)."""
    params = gather_params(params)
    max_len = max_len or cfg.max_seq_len
    state = policy_mod.init_decode_state(params, cfg, features)
    tok = start_tokens.long()
    toks = [tok]
    for _ in range(max_len - 1):
        logits, state = policy_mod.step(params, cfg, tok, state)
        key, sub = prng.split(key)
        tok = sample_categorical(sub, filter_logits(_scaled(logits, temperature), top_k, top_p),
                                 row0)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)


def sample_decode_full_prefix(params: dict, cfg: NetConfig, features: torch.Tensor,
                              start_tokens: torch.Tensor, key, max_len: int | None = None,
                              temperature=1.0, top_k: int = 0, top_p=None) -> torch.Tensor:
    """Sampling decode that re-encodes the whole prefix each step — the
    O(T^2) oracle for :func:`sample_decode`, with the same key schedule."""
    max_len = max_len or cfg.max_seq_len
    toks = [start_tokens.long()]
    for _ in range(max_len - 1):
        logits = policy_mod.forward(params, cfg, features, torch.stack(toks, dim=1))[:, -1, :]
        key, sub = prng.split(key)
        toks.append(sample_categorical(
            sub, filter_logits(_scaled(logits, temperature), top_k, top_p)))
    return torch.stack(toks, dim=1).to(torch.int32)


def sample_decode_n(params: dict, cfg: NetConfig, features: torch.Tensor,
                    start_tokens: torch.Tensor, key, num_samples: int, **kw) -> torch.Tensor:
    """``num_samples`` captions per image, ``[N, R, T]``: each row tiled
    ``R`` times samples-minor (row ``i``'s drafts are ``out[i]``) and
    decoded in one batch."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    n = features.shape[0]
    toks = sample_decode(params, cfg, features.repeat_interleave(num_samples, dim=0),
                         start_tokens.repeat_interleave(num_samples, dim=0), key, **kw)
    return toks.reshape(n, num_samples, toks.shape[-1])
