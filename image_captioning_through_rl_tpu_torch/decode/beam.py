"""Value-guided beam search (counterpart of the JAX ``decode/beam.py`` and
``decode/beam_full.py``).

Per step, expand each of the ``B`` candidates with the policy's top-``B``
next tokens, score each expansion with

    score = parent_score - (0.6 * V(features, candidate + token) + 0.4 * log p)

and keep the ``B`` smallest scores. The policy and critic carry their LSTM
state per candidate (gathered on reorder), so each step costs ``B`` policy
cells and ``B^2`` critic cells instead of the reference's full-prefix
re-encodes. The states are nested tuples of tensors, flat ``(h, c)`` or,
bidirectional, a pair per direction (:mod:`..models.policy`,
:mod:`..models.value`); :func:`_tree_map` tiles and gathers every leaf.
:func:`beam_search_full_prefix` is the reference's literal O(T^2) loop,
kept as the oracle for :func:`beam_search` in either direction mode.

Two modes, as in the JAX package. ``DecodeConfig(per_sample_beams=True)``:
an independent beam per image, log-softmax scoring. ``False``, the
faithful mode, reproduces the reference's quirk Q2 (trainers.py:73-105):
Q2a, one shared selection for the whole batch, the ``B`` smallest of the
candidates' batch-mean scores (``argsort`` ascending, stable, NaN last, as
``jnp.argsort``); Q2b, ``log p`` the log of the raw top-``B`` logit, NaN
for a logit at or below 0. Both modes use the per-sample critic; the
reference's Q1-stateful critic is :mod:`.beam_compat`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import DecodeConfig, NetConfig
from ..models import policy as policy_mod
from ..models import value as value_mod
from ..ops.fused_beam import stable_topk
from ..parallel.sharding import gather_params


def _tree_map(fn, tree):
    """``fn`` on every tensor of a nested tuple of tensors."""
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, x) for x in tree)
    return fn(tree)


def _gather_beam(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the beam axis (axis 1) of an ``[N, B, ...]`` tensor."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _select(flat_scores: torch.Tensor, k: int, per_sample: bool):
    """The ``k`` smallest of ``flat_scores [N, C]`` as ``(scores, index)``,
    each ``[N, k]``: per row, ties to the lowest index; or (Q2a) one shared
    ranking by the batch mean, stable with NaN last, broadcast to every
    row."""
    if per_sample:
        return stable_topk(flat_scores, k, largest=False)
    sel = torch.argsort(flat_scores.mean(dim=0), stable=True)[:k]
    sel = sel[None].expand(flat_scores.shape[0], k)
    return torch.gather(flat_scores, 1, sel), sel


def _logp(logits: torch.Tensor, topv: torch.Tensor, topk_idx: torch.Tensor,
          per_sample: bool) -> torch.Tensor:
    """The expansions' ``log p``: log-softmax, or (Q2b) the log of the raw
    logit."""
    if per_sample:
        return torch.gather(torch.log_softmax(logits, dim=-1), -1, topk_idx)
    return torch.log(topv)


def q2_step_gap(topv: torch.Tensor, flat_scores: torch.Tensor, b: int) -> torch.Tensor:
    """How close one faithful (Q2) step came to another choice: the smallest
    of every candidate's top-``B`` cut gap (``topv [..., B + 1]``) over the
    batch and the gaps between the ``B + 1`` smallest batch-mean scores
    (NaN counted as no tie)."""
    gap = (topv[..., b - 1] - topv[..., b]).min()
    key = torch.sort(flat_scores.mean(dim=0), stable=True).values[:b + 1]
    if key.numel() > 1:
        gap = torch.minimum(gap, torch.nan_to_num(key[1:] - key[:-1], nan=float("inf")).min())
    return gap


def beam_search(policy_params: dict, value_params: dict, cfg: NetConfig,
                dcfg: DecodeConfig, features: torch.Tensor, start_tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run value-guided beam search, per sample or (``per_sample_beams=False``)
    faithful to quirk Q2.

    ``features [N, F]``, ``start_tokens [N]`` -> ``(tokens [N, B, T] int32,
    scores [N, B])``, beam 0 the best-ranked candidate. Top-``B`` choices
    break ties by the lowest index, as ``lax.top_k`` does. Vocab-sharded
    trees are gathered first (a collective over their model group)."""
    policy_params, value_params = gather_params(policy_params), gather_params(value_params)
    per_sample = dcfg.per_sample_beams
    n = features.shape[0]
    b = dcfg.beam_size
    t_max = dcfg.max_seq_len
    start = start_tokens.long()

    def tile_beam(x):  # [N, ...] -> [N, B, ...]
        return x[:, None].expand((n, b) + x.shape[1:])

    tokens = torch.zeros((n, b, t_max), dtype=torch.long, device=features.device)
    tokens[:, :, 0] = start[:, None]

    pol0 = policy_mod.init_decode_state(policy_params, cfg, features)
    logits0, pol1 = policy_mod.step(policy_params, cfg, start, pol0)
    pol_state = _tree_map(tile_beam, pol1)
    last_logits = tile_beam(logits0)
    val_state = value_mod.rnn_step(
        value_params, cfg, start, value_mod.zero_rnn_state(cfg, n, features.device))
    val_state = _tree_map(tile_beam, val_state)

    # only beam 0 is live at step 0; +inf parents keep the clones unselected
    scores = torch.full((n, b), float("inf"), device=features.device)
    scores[:, 0] = 0.0
    feats_exp = features[:, None, None].expand(n, b, b, features.shape[-1])

    for t in range(t_max - 1):
        topv, topk_idx = stable_topk(last_logits, b)  # [N, B, B]
        logp = _logp(last_logits, topv, topk_idx, per_sample)

        def tile_exp(x):  # [N, B, ...] -> [N, B, B, ...]
            return x[:, :, None].expand((n, b, b) + x.shape[2:])

        emb = value_params["embedding"][topk_idx]  # [N, B, B, E]
        vstate_new = value_mod.rnn_step_emb(
            value_params, cfg, emb, _tree_map(tile_exp, val_state))
        values = value_mod.value_from_state(value_params, cfg, feats_exp, vstate_new)[..., 0]

        delta = dcfg.value_weight * values + dcfg.logprob_weight * logp
        flat_scores = (scores[:, :, None] - delta).reshape(n, b * b)
        scores, sel = _select(flat_scores, b, per_sample)
        parent = sel // b

        new_tok = torch.gather(topk_idx.reshape(n, b * b), 1, sel)  # [N, B]
        tokens = _gather_beam(tokens, parent)
        tokens[:, :, t + 1] = new_tok
        val_state = _tree_map(
            lambda x: _gather_beam(x.reshape((n, b * b) + x.shape[3:]), sel), vstate_new)
        pol_parent = _tree_map(lambda x: _gather_beam(x, parent), pol_state)
        # the last step's advance would feed a step that never runs
        if t < t_max - 2:
            logits_new, pol_new = policy_mod.step(
                policy_params, cfg, new_tok.reshape(n * b),
                _tree_map(lambda x: x.reshape(n * b, -1), pol_parent))
            pol_state = _tree_map(lambda x: x.reshape(n, b, -1), pol_new)
            last_logits = logits_new.reshape(n, b, -1)
    return tokens.to(torch.int32), scores


def beam_search_full_prefix(policy_params: dict, value_params: dict, cfg: NetConfig,
                            dcfg: DecodeConfig, features: torch.Tensor,
                            start_tokens: torch.Tensor, margins: bool = False):
    """The beam search that re-encodes every candidate's whole prefix each
    step (the JAX ``decode/beam_full.py``), in either mode: the O(T^2)
    oracle for :func:`beam_search`. Returns ``(tokens [N, B, T] int32,
    scores [N, B])``; ``margins=True`` adds ``[N, T - 1]``: per step, the
    smallest of the top-``B`` cut's logit gap over the sample's candidates
    and the gaps between its ``B + 1`` best candidate scores, how close the
    step's choices came to a tie (as :func:`..ops.fused_beam.beam_search_plain`
    reports them); in the faithful mode the batch's shared
    :func:`q2_step_gap`, the same in every row."""
    per_sample = dcfg.per_sample_beams
    n = features.shape[0]
    b = dcfg.beam_size
    tokens = start_tokens.long()[:, None, None].expand(n, b, 1)
    scores = torch.full((n, b), float("inf"), device=features.device)
    scores[:, 0] = 0.0
    feats_rep = features.repeat_interleave(b, dim=0)  # [N B, F]
    feats_bb = features.repeat_interleave(b * b, dim=0)  # [N B B, F]
    k = b + 1 if margins else b
    gaps = []
    for t in range(dcfg.max_seq_len - 1):
        logits = policy_mod.forward(policy_params, cfg, feats_rep,
                                    tokens.reshape(n * b, t + 1))[:, -1].reshape(n, b, -1)
        topv, topk_idx = stable_topk(logits, k)
        topk_idx = topk_idx[..., :b]  # [N, B, B]
        logp = _logp(logits, topv[..., :b], topk_idx, per_sample)
        ext = torch.cat([tokens[:, :, None].expand(n, b, b, t + 1), topk_idx[..., None]],
                        dim=-1)  # [N, B, B, t + 2]
        values = value_mod.forward(value_params, cfg, feats_bb,
                                   ext.reshape(n * b * b, t + 2)).reshape(n, b, b)
        delta = dcfg.value_weight * values + dcfg.logprob_weight * logp
        flat_scores = (scores[:, :, None] - delta).reshape(n, b * b)
        if not per_sample:
            scores, sel = _select(flat_scores, b, False)
            if margins:
                gaps.append(q2_step_gap(topv, flat_scores, b).expand(n))
        else:
            sorted_scores, order = stable_topk(flat_scores, k, largest=False)
            scores, sel = sorted_scores[:, :b], order[:, :b]
            if margins:
                gap = (topv[..., b - 1] - topv[..., b]).min(dim=1).values
                if b > 1:  # beam 1 keeps its one candidate
                    gap = torch.minimum(gap, (sorted_scores[:, 1:] - sorted_scores[:, :-1])
                                        .min(dim=1).values)
                gaps.append(gap)
        tokens = _gather_beam(ext.reshape(n, b * b, t + 2), sel)
    out = tokens.to(torch.int32), scores
    return out + (torch.stack(gaps, dim=1),) if margins else out
