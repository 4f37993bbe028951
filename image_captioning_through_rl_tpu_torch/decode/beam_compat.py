"""Checkpoint-faithful value-guided beam search, quirks Q1 and Q2
(counterpart of the JAX ``decode/beam_compat.py``).

The reference's evaluation beam (trainers.py:73-105) scores every expanded
candidate with a value network whose LSTM encoder is stateful across calls
(quirk Q1): ``ValueNetworkRNN`` keeps a persistent ``hidden_cell``
(reference models.py:122-135) through every value evaluation of a
validation slice, reset only between slices (trainers.py:661), and each
call consumes its captions column-major at batch 1 (models.py:133,
168-169). So the value of sample ``i`` depends on samples ``< i``, on the
sibling candidates evaluated before it in the same step and on every
earlier step of the slice. The ranking is the faithful Q2 one of
:mod:`.beam`: batch-mean scores, ``log`` of the raw top-``B`` logits.

Unidirectional: all value calls of a step form ONE carried stream, in the
reference's call order (candidate-major, expansion-minor, each call
column-major), through :func:`..ops.rnn.flat_stream_scan`. Bidirectional:
the step's calls are chained one :func:`..models.value.forward_compat`
after another, each direction's carry threading through all of them.
Sequential by construction: a 127-row slice at COCO width runs ~477,520
cell steps in sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DecodeConfig, NetConfig
from ..models import policy as policy_mod
from ..models import value as value_mod
from ..ops.fused_beam import stable_topk
from ..ops.rnn import flat_stream_scan
from .beam import _select, q2_step_gap


def beam_search_compat(policy_params: dict, value_params: dict, cfg: NetConfig,
                       dcfg: DecodeConfig, features: torch.Tensor, start_tokens: torch.Tensor,
                       carry: Optional[tuple] = None, margins: bool = False):
    """Reference-exact beam search with the Q1-stateful critic (the JAX
    ``decode/beam_compat.py:46-159``).

    ``features [N, F]`` (one validation slice), ``start_tokens [N]``;
    ``carry``: the value encoder's persistent state entering the slice
    (:func:`..models.value.compat_zero_state` by default, the state of a
    freshly loaded model). Returns ``(tokens [N, B, T] int32, scores [N, B],
    carry_out)``, beam 0 the reference's ``most_likely=True`` candidate;
    ``margins=True`` adds ``[T - 1]``, each step's :func:`.beam.q2_step_gap`.

    The reference starts from ONE candidate (trainers.py:88), so step 0
    makes ``B`` value calls and every later step ``B^2``. NaN scores (Q2b)
    rank last, deterministically; the reference's ``sorted`` under NaN is
    order-dependent, so exactness holds where no NaN enters the top ``B``.
    """
    n = features.shape[0]
    b = dcfg.beam_size
    if carry is None:
        carry = value_mod.compat_zero_state(cfg, features.device)
    tokens = start_tokens.long()[:, None, None]  # [N, C = 1, 1]
    scores = torch.zeros((n, 1), dtype=torch.float32, device=features.device)
    k = b + 1 if margins else b
    gaps = []
    for t in range(dcfg.max_seq_len - 1):
        c = tokens.shape[1]  # candidates this step: 1 at t = 0, B after
        # the stateless policy over every candidate's prefix (trainers.py:92)
        logits = policy_mod.forward(policy_params, cfg, features.repeat_interleave(c, dim=0),
                                    tokens.reshape(n * c, t + 1))[:, -1].reshape(n, c, -1)
        topv, topi = stable_topk(logits, k)
        topi = topi[..., :b]  # [N, C, B]
        logp = torch.log(topv[..., :b])  # Q2b: the log of the raw logit
        ext = torch.cat([tokens[:, :, None].expand(n, c, b, t + 1), topi[..., None]],
                        dim=-1)  # [N, C, B, t + 2]
        if cfg.bidirectional:
            # a carry per direction: the C B calls chained in call order
            calls = []
            for cap in ext.permute(1, 2, 0, 3).reshape(c * b, n, t + 2):
                v, carry = value_mod.forward_compat(value_params, cfg, features, cap, carry)
                calls.append(v[:, 0])
            values = torch.stack(calls).reshape(c, b, n).permute(2, 0, 1)  # [N, C, B]
        else:
            # the C B calls as one carried stream: candidate-major,
            # expansion-minor, each call column-major (models.py:133, 168-169)
            stream = ext.permute(1, 2, 3, 0).reshape(-1)  # [C B (t + 2) N]
            outs, carry = flat_stream_scan("lstm", value_params["lstm"],
                                           value_params["embedding"][stream], carry)
            rnn_out = outs.reshape(c, b, t + 2, n, -1)[:, :, -1]  # each call's final column
            values = value_mod.value_head(value_params, cfg, features.expand(c, b, n, -1),
                                          rnn_out)[..., 0].permute(2, 0, 1)  # [N, C, B]
        delta = dcfg.value_weight * values + dcfg.logprob_weight * logp
        cand = (scores[:, :, None] - delta).reshape(n, c * b)
        if margins:
            gaps.append(q2_step_gap(topv, cand, b))
        scores, sel = _select(cand, b, False)  # Q2a: one shared ranking
        tokens = torch.gather(ext.reshape(n, c * b, t + 2), 1,
                              sel[:, :, None].expand(n, b, t + 2))
    out = tokens.to(torch.int32), scores, carry
    return out + (torch.stack(gaps),) if margins else out
