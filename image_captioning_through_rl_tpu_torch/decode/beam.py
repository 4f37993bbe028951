"""Value-guided beam search (counterpart of the JAX ``decode/beam.py``).

Per step, expand each of the ``B`` candidates with the policy's top-``B``
next tokens, score each expansion with

    score = parent_score - (0.6 * V(features, candidate + token) + 0.4 * log p)

and keep the ``B`` smallest scores per image. The policy and critic carry
their LSTM state per candidate (gathered on reorder), so each step costs
``B`` policy cells and ``B^2`` critic cells instead of the reference's
full-prefix re-encodes.

Only the per-sample mode (``DecodeConfig(per_sample_beams=True)``: an
independent beam per image, log-softmax scoring) is ported. The faithful
Q2 batch-mean mode and ``beam_compat.py`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import DecodeConfig, NetConfig
from ..models import policy as policy_mod
from ..models import value as value_mod
from ..ops.fused_beam import stable_topk


def _gather_beam(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the beam axis (axis 1) of an ``[N, B, ...]`` tensor."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def beam_search(policy_params: dict, value_params: dict, cfg: NetConfig,
                dcfg: DecodeConfig, features: torch.Tensor, start_tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run per-sample value-guided beam search.

    ``features [N, F]``, ``start_tokens [N]`` -> ``(tokens [N, B, T] int32,
    scores [N, B])``, beam 0 the best-ranked candidate. Top-``B`` choices
    break ties by the lowest index, as ``lax.top_k`` does."""
    if not dcfg.per_sample_beams:
        raise NotImplementedError(
            "the faithful (Q2 batch-mean) beam is not ported yet (ROADMAP §1 item 6)")
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
    pol_state = tuple(tile_beam(x) for x in pol1)
    last_logits = tile_beam(logits0)
    val_state = value_mod.rnn_step(
        value_params, cfg, start, value_mod.zero_rnn_state(cfg, n, features.device))
    val_state = tuple(tile_beam(x) for x in val_state)

    # only beam 0 is live at step 0; +inf parents keep the clones unselected
    scores = torch.full((n, b), float("inf"), device=features.device)
    scores[:, 0] = 0.0
    feats_exp = features[:, None, None].expand(n, b, b, features.shape[-1])

    for t in range(t_max - 1):
        _, topk_idx = stable_topk(last_logits, b)  # [N, B, B]
        logp = torch.gather(torch.log_softmax(last_logits, dim=-1), -1, topk_idx)

        def tile_exp(x):  # [N, B, ...] -> [N, B, B, ...]
            return x[:, :, None].expand((n, b, b) + x.shape[2:])

        emb = value_params["embedding"][topk_idx]  # [N, B, B, E]
        vstate_new = value_mod.rnn_step_emb(
            value_params, cfg, emb, tuple(tile_exp(x) for x in val_state))
        values = value_mod.value_from_state(value_params, cfg, feats_exp, vstate_new)[..., 0]

        delta = dcfg.value_weight * values + dcfg.logprob_weight * logp
        flat_scores = (scores[:, :, None] - delta).reshape(n, b * b)
        scores, sel = stable_topk(flat_scores, b, largest=False)
        parent = sel // b

        new_tok = torch.gather(topk_idx.reshape(n, b * b), 1, sel)  # [N, B]
        tokens = _gather_beam(tokens, parent)
        tokens[:, :, t + 1] = new_tok
        val_state = tuple(_gather_beam(x.reshape((n, b * b) + x.shape[3:]), sel)
                          for x in vstate_new)
        pol_parent = tuple(_gather_beam(x, parent) for x in pol_state)
        # the last step's advance would feed a step that never runs
        if t < t_max - 2:
            logits_new, pol_new = policy_mod.step(
                policy_params, cfg, new_tok.reshape(n * b),
                tuple(x.reshape(n * b, -1) for x in pol_parent))
            pol_state = tuple(x.reshape(n, b, -1) for x in pol_new)
            last_logits = logits_new.reshape(n, b, -1)
    return tokens.to(torch.int32), scores


def beam_search_compat(*args, **kwargs):
    """The reference-faithful Q1-stateful beam (JAX ``decode/beam_compat.py``)."""
    raise NotImplementedError(
        "beam_search_compat is not ported yet (ROADMAP §1 item 6)")
