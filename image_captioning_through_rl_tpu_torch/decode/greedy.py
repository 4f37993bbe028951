"""Greedy decoding (counterpart of the JAX ``decode/greedy.py``).

Carrying ``(h, c)`` across steps gives the same logits as re-encoding the
whole prefix each step (the reference's O(T^2) loop), with O(T) work, in
both direction modes (:mod:`..models.policy`).
Like the reference, decoding always runs the full ``max_len - 1`` steps
and does not stop at <END>; :func:`..data.coco.decode_captions` trims.
"""

from __future__ import annotations

import torch

from ..config import NetConfig
from ..models import policy as policy_mod
from ..parallel.sharding import gather_params


def greedy_decode(params: dict, cfg: NetConfig, features: torch.Tensor,
                  start_tokens: torch.Tensor, max_len: int | None = None) -> torch.Tensor:
    """Greedy argmax decode with carried LSTM state.

    ``features [N, F]``, ``start_tokens [N]`` -> ``[N, max_len]`` int32
    token ids starting with ``start_tokens``. Ties go to the lowest index
    (``torch.argmax`` returns the first maximal value). A vocab-sharded
    tree is gathered first (a collective over its model group)."""
    params = gather_params(params)
    max_len = max_len or cfg.max_seq_len
    state = policy_mod.init_decode_state(params, cfg, features)
    tok = start_tokens.long()
    toks = [tok]
    for _ in range(max_len - 1):
        logits, state = policy_mod.step(params, cfg, tok, state)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)


def greedy_decode_full_prefix(params: dict, cfg: NetConfig, features: torch.Tensor,
                              start_tokens: torch.Tensor, max_len: int | None = None,
                              margins: bool = False):
    """Greedy decode that re-encodes the whole prefix each step — the
    reference's literal O(T^2) semantics, kept as the oracle for
    :func:`greedy_decode`. ``margins=True`` also returns ``[N, max_len - 1]``:
    each step's top-2 logit gap, how close its pick came to a tie."""
    max_len = max_len or cfg.max_seq_len
    toks, gaps = [start_tokens.long()], []
    for _ in range(max_len - 1):
        logits = policy_mod.forward(params, cfg, features, torch.stack(toks, dim=1))[:, -1, :]
        toks.append(torch.argmax(logits, dim=-1))
        if margins:
            top2 = torch.topk(logits, 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
    out = torch.stack(toks, dim=1).to(torch.int32)
    return (out, torch.stack(gaps, dim=1)) if margins else out
