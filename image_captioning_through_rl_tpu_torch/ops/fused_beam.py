"""Value-guided beam search: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of the JAX ``ops/pallas_beam.py`` (``fused_beam_search``, TPU
kernel ``_beam_kernel``). The kernel is ``csrc/beam_search.cu``; its note
lists the eight parts of a beam step and says what bounds it on Hopper.

Routing in :func:`fused_beam_search` is that of
:func:`.fused_decode.fused_greedy_decode`: CUDA tensors run the kernel or
raise, CPU tensors run :func:`beam_search_plain`, and
``use_fused_kernel=False`` selects the plain version explicitly.

Weights are prepared once (:func:`prepare_beam_weights`), padded as the
policy's are when its widths need it (:func:`.fused_decode.pad_greedy_weights`).
Of the TPU kernel's other workarounds none carries over: no one-hot
matmuls, no ``linear2`` padded to 128 columns, no ``(b, n)``-major rows to
de-interleave.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import MAX_SEQ_LEN
from .fused_decode import (
    GreedyWeights,
    check_kernel_inputs,
    check_tile_widths,
    check_weights,
    lstm_cell_plain,
    pad_features,
    round_to,
    token_gate_table,
    wmatmul,
)
from .kernel_build import check_error, load_library
from .padding import pad_dim, pad_gates, pad_split_rows

MAX_BEAM = 8  # the kernel's bound (icrl_beam_max_beam in csrc/beam_search.cu)


class ValueWeights(NamedTuple):
    """Critic weights in the kernel's layout; biases and the x-gate table
    ``xg = emb @ wi`` (CUDA only, as in :class:`.GreedyWeights`) f32, the
    rest in the working type."""

    emb: torch.Tensor  # [V, E]
    w: torch.Tensor    # [E + H, 4H] = [wi; wh]
    b: torch.Tensor    # [4H]
    w1: torch.Tensor   # [F + H, H]
    b1: torch.Tensor   # [H]
    w2: torch.Tensor   # [H]
    b2: torch.Tensor   # [1]
    xg: torch.Tensor | None  # [V, 4H]

    f32_fields = ("b", "b1", "b2", "xg")

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype


class BeamWeights(NamedTuple):
    policy: GreedyWeights
    value: ValueWeights


def prepare_beam_weights(policy: GreedyWeights, value_params: dict) -> BeamWeights:
    """Critic parameters (JAX layout, on the policy's device) joined to the
    prepared policy weights, in the policy's working type, padded to the
    policy's widths when the policy is padded."""
    if "lstm" not in value_params:
        raise ValueError("the fused beam kernel needs a unidirectional critic")
    feat_dim, emb_dim, hidden = policy.widths or (policy.wc.shape[0], policy.emb.shape[1],
                                                  policy.wc.shape[1])
    if (value_params["embedding"].shape[1] != emb_dim
            or value_params["lstm"]["wh"].shape[0] != hidden):
        raise ValueError("the fused beam kernel needs policy and value networks with "
                         "matching embedding and hidden widths")
    wd = policy.dtype
    fp, (ep, hp) = policy.wc.shape[0], (policy.emb.shape[1], policy.wc.shape[1])

    def wt(x):
        return x.to(wd).contiguous()

    def f32(x):
        return x.to(torch.float32).contiguous()

    lstm = value_params["lstm"]
    w = pad_split_rows(pad_gates(torch.cat([lstm["wi"], lstm["wh"]], dim=0), 4, hp), emb_dim, ep,
                       hp)
    emb, w = wt(pad_dim(value_params["embedding"], 1, ep)), wt(w)
    w1 = pad_dim(pad_split_rows(value_params["linear1"]["w"], feat_dim, fp, hp), 1, hp)
    return BeamWeights(policy, ValueWeights(
        emb=emb, w=w, b=f32(pad_gates(lstm["b"], 4, hp)),
        w1=wt(w1), b1=f32(pad_dim(value_params["linear1"]["b"], 0, hp)),
        w2=wt(pad_dim(value_params["linear2"]["w"][:, 0], 0, hp)),
        b2=f32(value_params["linear2"]["b"]),
        xg=token_gate_table(emb, w) if emb.is_cuda else None,
    ))


def stable_topk(x: torch.Tensor, k: int, largest: bool = True):
    """Top-``k`` along the last axis with ties broken by the lowest index,
    as ``lax.top_k`` does (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search_plain(weights: BeamWeights, features: torch.Tensor,
                      start_tokens: torch.Tensor, max_len: int = MAX_SEQ_LEN, beam: int = 5,
                      value_weight: float = 0.6, logprob_weight: float = 0.4,
                      margins: bool = False):
    """The beam kernel's function in eager torch.

    Rounds where the TPU kernel (``pallas_beam.py:_beam_kernel``) does:
    the features are cast to the weight type before the ``h0`` product
    (``pallas_beam.py:121-123``) and inside ``[feats; h_v']``; the
    embedding row ``x`` and ``h`` are in the weight type for every gate
    product, the policy ``h`` for the head and ``linear1``'s output for
    ``linear2``; products accumulate in f32 and the gate math is f32. With
    f32 weights it is the carried per-sample beam search.

    Returns ``(tokens [N, B, T] int32, scores [N, B])``, beam 0 the best;
    with ``margins=True`` also ``[N, T - 1]``: per step, the smallest of
    the top-``B`` cut's logit gap over the sample's candidates and the gaps
    between the ``B + 1`` best candidate scores — how close the step's
    choices came to a tie, which a comparison with the kernel needs.
    """
    if not 1 <= beam <= MAX_BEAM:
        raise ValueError(f"beam must be in [1, {MAX_BEAM}], got {beam}")
    p, v = weights
    features = pad_features(p, features)
    wd = p.dtype
    pemb, vemb = p.emb.to(torch.float32), v.emb.to(torch.float32)
    n, b = features.shape[0], beam
    feats = round_to(features.to(torch.float32), wd)
    start = start_tokens.long()

    h0 = wmatmul(feats, p.wc) + p.bc
    zeros = torch.zeros_like(h0)
    ph, pc = lstm_cell_plain(p.w, p.b, pemb[start], round_to(h0, wd), zeros)
    vh, vc = lstm_cell_plain(v.w, v.b, vemb[start], zeros, zeros)
    ph, pc, vh, vc = (x.repeat_interleave(b, dim=0) for x in (ph, pc, vh, vc))  # [N*B, H]

    hist = torch.zeros((n, b, max_len), dtype=torch.long, device=features.device)
    hist[:, :, 0] = start[:, None]
    scores = torch.full((n, b), float("inf"), device=features.device)
    scores[:, 0] = 0.0
    f_dim = feats.shape[1]
    fproj = (wmatmul(feats, v.w1[:f_dim]) + v.b1).repeat_interleave(b * b, dim=0)  # [N*B*B, H]
    rows = torch.arange(n, device=features.device)[:, None]
    gaps = []
    for t in range(max_len - 1):
        logits = wmatmul(round_to(ph, wd), p.wo) + p.bo  # [N*B, V]
        topv, topi = stable_topk(logits, b + 1 if margins else b)
        m = logits.max(dim=-1, keepdim=True).values
        log_sum = torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
        logp = (topv[:, :b] - m) - log_sum
        topi_b = topi[:, :b].reshape(-1)  # [N*B*B] expansion tokens

        # critic cell of expansion (n, p, e) from candidate (n, p), then the value MLP
        vh2, vc2 = lstm_cell_plain(v.w, v.b, vemb[topi_b],
                                   round_to(vh.repeat_interleave(b, dim=0), wd),
                                   vc.repeat_interleave(b, dim=0))
        # linear1 over [feats; h_v'], split at F as the kernel computes it
        v1 = fproj + wmatmul(round_to(vh2, wd), v.w1[f_dim:])
        values = wmatmul(round_to(v1, wd), v.w2[:, None])[:, 0] + v.b2  # [N*B*B]

        cand = scores[:, :, None] - (value_weight * values.reshape(n, b, b)
                                     + logprob_weight * logp.reshape(n, b, b))
        flat = cand.reshape(n, b * b)
        sorted_scores, order = stable_topk(flat, b + 1 if margins else b, largest=False)
        scores, sel = sorted_scores[:, :b], order[:, :b]
        if margins:
            cut = (topv[:, b - 1] - topv[:, b]).reshape(n, b).min(dim=1).values
            ranks = (sorted_scores[:, 1:] - sorted_scores[:, :-1]).min(dim=1).values
            gaps.append(torch.minimum(cut, ranks))

        parent = (rows * b + sel // b).reshape(-1)  # candidate rows, [N*B]
        exp_rows = (rows * b * b + sel).reshape(-1)  # expansion rows, [N*B]
        new_tok = topi_b[exp_rows]
        hist = hist.reshape(n * b, max_len)[parent].reshape(n, b, max_len)
        hist[:, :, t + 1] = new_tok.reshape(n, b)
        vh, vc = vh2[exp_rows], vc2[exp_rows]
        if t < max_len - 2:  # the last step's advance would feed no step
            ph, pc = lstm_cell_plain(p.w, p.b, pemb[new_tok], round_to(ph[parent], wd),
                                     pc[parent])
    out = hist.to(torch.int32), scores
    return out + (torch.stack(gaps, dim=1),) if margins else out


def _launch_beam(weights: BeamWeights, features: torch.Tensor, start_tokens: torch.Tensor,
                 max_len: int, beam: int, value_weight: float, logprob_weight: float):
    p, v = weights
    features = pad_features(p, features)
    vocab, emb_dim = p.emb.shape
    feat_dim, hidden = p.wc.shape
    check_kernel_inputs(features, start_tokens, vocab)
    check_weights(p, features.device)
    check_weights(v, features.device)
    if v.dtype != p.dtype:
        raise ValueError("policy and value weights must share one working type")
    check_tile_widths(p.dtype, feat_dim=feat_dim, emb_dim=emb_dim, hidden=hidden,
                      vocab=p.wo.shape[1])
    n = features.shape[0]
    if max_len < 2 or vocab <= beam:
        raise ValueError("max_len must be at least 2 and the vocabulary larger than the beam")
    dev = features.device
    tokens = torch.empty((n, beam, max_len), dtype=torch.int32, device=dev)
    scores = torch.empty((n, beam), dtype=torch.float32, device=dev)
    if n == 0:
        return tokens, scores
    lib = load_library()
    ptr = torch.Tensor.data_ptr
    with torch.cuda.device(dev):
        bf16 = int(p.dtype == torch.bfloat16)
        vocab = p.wo.shape[1]  # the head's width: a padded word never makes the cut
        ws = torch.empty(lib.icrl_beam_workspace_floats(n, hidden, vocab, max_len, beam, bf16),
                         dtype=torch.float32, device=dev)
        err = lib.icrl_beam_search(
            n, feat_dim, emb_dim, hidden, vocab, max_len, beam, value_weight, logprob_weight,
            bf16, ptr(features), ptr(start_tokens),
            ptr(p.wc), ptr(p.bc), ptr(p.xg), ptr(p.w), ptr(p.b), ptr(p.wo), ptr(p.bo),
            ptr(v.xg), ptr(v.w), ptr(v.b), ptr(v.w1), ptr(v.b1), ptr(v.w2), ptr(v.b2),
            ptr(tokens), ptr(scores), ptr(ws), torch.cuda.current_stream(dev).cuda_stream)
    check_error(lib, "icrl_beam_search", err)
    fused_beam_search.launches += 1
    return tokens, scores


def fused_beam_search(weights: BeamWeights, features: torch.Tensor,
                      start_tokens: torch.Tensor, max_len: int = MAX_SEQ_LEN, beam: int = 5,
                      value_weight: float = 0.6, logprob_weight: float = 0.4,
                      use_fused_kernel: bool | None = None):
    """Per-sample value-guided beam search: ``features [N, F]`` f32,
    ``start_tokens [N]`` int32 -> ``(tokens [N, beam, max_len] int32,
    scores [N, beam] f32)``, beam 0 the best.

    CUDA tensors run the kernel (``csrc/beam_search.cu``); CPU tensors run
    :func:`beam_search_plain`. ``use_fused_kernel=False`` forces the plain
    version; ``True`` on CPU tensors raises.
    ``fused_beam_search.launches`` counts kernel launches.
    """
    if not 1 <= beam <= MAX_BEAM:
        raise ValueError(f"beam must be in [1, {MAX_BEAM}], got {beam}")
    args = (weights, features, start_tokens, max_len, beam, value_weight, logprob_weight)
    if use_fused_kernel is False:
        return beam_search_plain(*args)
    if features.is_cuda:
        return _launch_beam(*args)
    if use_fused_kernel:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the beam kernel "
                           "runs only on a CUDA device")
    return beam_search_plain(*args)


fused_beam_search.launches = 0
