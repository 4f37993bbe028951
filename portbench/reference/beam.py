"""The reference's value-guided beam search (pratikpv ``trainers.py``
``test_a2c_network``, one beam per image): each step expands every
candidate with its top-``B`` next tokens and keeps the ``B`` smallest of

    score = parent_score - (0.6 * V(features, candidate + token) + 0.4 * log p(token))

with ``log p`` the policy's log-softmax, ties to the lowest index. The
score of a whole sequence is therefore a function of the sequence alone
(:func:`sequence_scores`, which also gives how far each token lies below
its parent's top ``B``: what the check compares).
"""

from __future__ import annotations

import torch

from . import nets
from .nets import F32, Prec

START_ID = 1


def _topk(x: torch.Tensor, k: int, largest: bool = True):
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def _value(val, feats, h, prec):
    state = torch.cat([feats, h], dim=-1)
    return nets.dense(nets.dense(state, val["linear1"], prec), val["linear2"], prec)[..., 0]


def _start(pol, val, feats, prec):
    n = feats.shape[0]
    h0 = nets.dense(feats, pol["cnn2linear"], prec)
    start = torch.full((n,), START_ID, dtype=torch.long, device=feats.device)
    ps = nets.lstm_cell(pol["lstm"], pol["embedding"][start], (h0, torch.zeros_like(h0)), prec)
    zero = torch.zeros_like(h0)
    vs = nets.lstm_cell(val["lstm"], val["embedding"][start], (zero, zero), prec)
    return ps, vs


@torch.no_grad()
def beam_search(pol: dict, val: dict, feats, beam: int, steps: int, vw: float, lw: float,
                prec: Prec = F32):
    """``(tokens [N, B, steps + 1], scores [N, B])``, beam 0 the best."""
    n, b = feats.shape[0], beam
    ps, vs = _start(pol, val, feats, prec)
    logits = nets.dense(ps[0], pol["head"], prec)

    def tile(x):
        return x[:, None].expand((n, b) + x.shape[1:])

    ps, vs = (tile(ps[0]), tile(ps[1])), (tile(vs[0]), tile(vs[1]))
    logits = tile(logits)
    tokens = torch.full((n, b, steps + 1), START_ID, dtype=torch.long, device=feats.device)
    scores = torch.full((n, b), float("inf"), device=feats.device)
    scores[:, 0] = 0.0
    fe = feats[:, None, None].expand(n, b, b, feats.shape[-1])
    for t in range(steps):
        _, top = _topk(logits, b)  # [N, B, B]
        logp = torch.gather(torch.log_softmax(logits, dim=-1), -1, top)
        ex = (vs[0][:, :, None].expand(n, b, b, -1), vs[1][:, :, None].expand(n, b, b, -1))
        vs_new = nets.lstm_cell(val["lstm"], val["embedding"][top], ex, prec)
        delta = vw * _value(val, fe, vs_new[0], prec) + lw * logp
        scores, sel = _topk((scores[:, :, None] - delta).reshape(n, b * b), b, largest=False)
        parent = sel // b
        new = torch.gather(top.reshape(n, b * b), 1, sel)
        tokens = torch.gather(tokens, 1, parent[..., None].expand(n, b, steps + 1)).clone()
        tokens[:, :, t + 1] = new
        vs = tuple(torch.gather(x.reshape(n, b * b, -1), 1,
                                sel[..., None].expand(n, b, x.shape[-1])) for x in vs_new)
        if t < steps - 1:
            pp = tuple(torch.gather(x, 1, parent[..., None].expand(n, b, x.shape[-1])) for x in ps)
            h, c = nets.lstm_cell(pol["lstm"], pol["embedding"][new].reshape(n * b, -1),
                                  (pp[0].reshape(n * b, -1), pp[1].reshape(n * b, -1)), prec)
            ps = (h.reshape(n, b, -1), c.reshape(n, b, -1))
            logits = nets.dense(ps[0], pol["head"], prec)
    return tokens, scores


@torch.no_grad()
def sequence_scores(pol: dict, val: dict, feats, tokens, beam: int, vw: float, lw: float,
                    prec: Prec = F32):
    """Teacher-forced along ``tokens [N, T]`` (column 0 the start token):
    ``(score [N], topb_gap [N, T - 1])``. ``score`` is the beam score the
    sequence ends with; ``topb_gap[:, t]`` is how far the logit of token
    ``t + 1`` lies below its parent's ``B``-th best logit (0 when it is
    among the top ``B``, where the beam must have drawn it from)."""
    tokens = tokens.long()
    ps, vs = _start(pol, val, feats, prec)
    score = torch.zeros(feats.shape[0], device=feats.device)
    gaps = []
    for t in range(tokens.shape[1] - 1):
        logits = nets.dense(ps[0], pol["head"], prec)
        tok = tokens[:, t + 1]
        picked = torch.gather(logits, 1, tok[:, None])[:, 0]
        kth = _topk(logits, beam)[0][:, -1]
        gaps.append(torch.clamp_min(kth - picked, 0.0))
        logp = torch.gather(torch.log_softmax(logits, dim=-1), 1, tok[:, None])[:, 0]
        vs = nets.lstm_cell(val["lstm"], val["embedding"][tok], vs, prec)
        score = score - (vw * _value(val, feats, vs[0], prec) + lw * logp)
        ps = nets.lstm_cell(pol["lstm"], pol["embedding"][tok], ps, prec)
    return score, torch.stack(gaps, dim=1)


def decode(tokens, idx_to_word: dict) -> list:
    """Token rows -> text: ``<NULL>`` skipped, words up to and including
    ``<END>``."""
    out = []
    for row in tokens:
        words = []
        for tok in row:
            w = idx_to_word[int(tok)]
            if w != "<NULL>":
                words.append(w)
            if w == "<END>":
                break
        out.append(" ".join(words))
    return out
