"""Value-guided beam search: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of the JAX ``ops/pallas_beam.py`` (``fused_beam_search``, TPU
kernel ``_beam_kernel``). The kernel is ``csrc/beam_search.cu``, one
persistent cooperative launch for the whole search; its note lists the eight
parts of a beam step and the four phases a step runs in. :func:`beam_plan`
mirrors its launch plan, and :func:`combine_beam_partials` is a plain model
of how it combines per-slice partials, for the tests.

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

import functools
from typing import NamedTuple

import torch

from .. import MAX_SEQ_LEN
from .fused_decode import (
    GreedyWeights,
    check_clock,
    check_head,
    check_kernel_inputs,
    check_tile_widths,
    check_weights,
    lstm_cell_plain,
    pad_features,
    round_to,
    token_gate_table,
    wmatmul,
)
from .fused_lstm import (_CHAIN_RING, _SLICE_UNITS, CHAIN_ROWS, SMEM_PER_BLOCK, SMEM_PER_SM,
                         SMEM_RESERVED, _chain_smem)
from .kernel_build import check_error, load_library, runs_kernel
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
    """The policy's and the critic's weights, and (CUDA only) the head ``wo``
    with its rows padded to a multiple of 8 columns, which the kernel stages
    in 16-byte chunks (the policy's own ``head``)."""

    policy: GreedyWeights
    value: ValueWeights
    head: torch.Tensor | None = None  # [H, pad8(V)]


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
    ), policy.head)


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
    p, v = weights.policy, weights.value
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
            gaps.append(cut)
            if sorted_scores.shape[1] > 1:  # beam 1 keeps its one candidate
                ranks = (sorted_scores[:, 1:] - sorted_scores[:, :-1]).min(dim=1).values
                gaps[-1] = torch.minimum(cut, ranks)

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


# The relative time of one row tile of a head slice and of a cell slice
# (csrc/beam_search.cu BEAM_TILE_COST), which the plan balances, and per
# weight type the C slices' width (c_cols: linear1's columns stream through
# the ring on every block).
BEAM_TILE_COST = (2, 1)
C_COLS = {torch.bfloat16: 128, torch.float32: 64}


def beam_columns(hidden: int, vocab: int) -> tuple:
    """The columns of each product of a beam step, in slice order: the
    head's V, both cells' 4H (the A slices), linear1's h half H (the C
    slices)."""
    return (vocab, 4 * hidden, 4 * hidden, hidden)


def beam_plan(n: int, beam: int, feat_dim: int, hidden: int, vocab: int,
              weight_dtype: torch.dtype, sm_count: int) -> dict:
    """The beam kernel's cooperative launch, as ``csrc/beam_search.cu:
    beam_plan`` computes it.

    The columns of the A products (:func:`beam_columns`: the head, then both
    cells) are cut, in that order, into slices of ``columns = 4 units``
    consecutive columns: ``units`` is the widest (bf16 32, 16, 8; float32 16,
    8) whose slice of ``max(H, F)`` rows fits shared memory beside the
    chains' staging ring while every A slice gets a block of its own among
    the ``co_resident`` blocks (one per SM); each block then keeps its slice
    for the whole search (``stream`` False). The blocks left over replicate
    the slices as row groups over the ``a_tiles`` row tiles of the ``N B``
    candidate rows: ``h_groups`` copies of each head slice and ``a_groups``
    of each cell slice, the counts that make ``max(ceil(a_tiles / h_groups)
    w_h, ceil(a_tiles / a_groups) w_a)`` least (tile costs
    ``BEAM_TILE_COST``), then the grid largest, then the fewest head copies.
    Block ``b < sh h_groups`` holds head slice ``b % sh`` and takes its tiles
    ``b // sh + k h_groups``; the cell slices' blocks follow likewise. Where
    no width fits, the weights stream through the ring with the A rows every
    step (``stream`` True, the chains' streaming slice width, groups 0):
    every block of ``grid = co_resident`` takes the (slice, tile) items ``b,
    b + grid, ...`` of phase A. Either way the C product (linear1's ``H``
    columns over the ``c_tiles`` tiles of the ``N B^2`` expansion rows)
    streams ``C_COLS`` columns a slice (by weight type) through the ring on
    every block, by items. ``slice_table`` lists each slice as ``(product, first column,
    columns)``, the A slices first."""
    kc = _CHAIN_RING[weight_dtype][0]
    kp = -(-max(hidden, feat_dim) // kc) * kc
    cols = beam_columns(hidden, vocab)

    def co_resident(smem):  # one block per SM
        if smem > SMEM_PER_BLOCK:
            return 0
        return sm_count * min(1, SMEM_PER_SM // (smem + SMEM_RESERVED))

    nn = max(n, 1)
    a_tiles, c_tiles = -(-nn * beam // CHAIN_ROWS), -(-nn * beam * beam // CHAIN_ROWS)
    for units in _SLICE_UNITS[weight_dtype]:
        smem = _chain_smem(weight_dtype, False, 4, units, False, kp)
        if co_resident(smem) >= sum(-(-c // (4 * units)) for c in cols[:3]):
            stream = False
            break
    else:
        stream = True
        units = next(u for u in _CHAIN_RING[weight_dtype][2]
                     if _chain_smem(weight_dtype, False, 4, u, True, kp) <= SMEM_PER_BLOCK)
        smem = _chain_smem(weight_dtype, False, 4, units, True, kp)
    co = co_resident(smem)
    nc = 4 * units
    sh, s_pol, s_val = (-(-c // nc) for c in cols[:3])
    sp = s_pol + s_val
    if stream:
        h_groups = a_groups = 0
        grid = co
    else:
        w_h, w_a = BEAM_TILE_COST
        best = None
        for gh in range(1, a_tiles + 1):
            if sh * gh + sp > co:
                break
            for gp in range(1, a_tiles + 1):
                if sh * gh + sp * gp > co:
                    break
                key = (max(-(-a_tiles // gh) * w_h, -(-a_tiles // gp) * w_a), -(sh * gh + sp * gp))
                if best is None or key < best[0]:
                    best = (key, gh, gp)
        _, h_groups, a_groups = best
        grid = sh * h_groups + sp * a_groups
    cc = C_COLS[weight_dtype]
    table = ([(m, c0, min(nc, c - c0)) for m, c in enumerate(cols[:3]) for c0 in range(0, c, nc)]
             + [(3, c0, min(cc, hidden - c0)) for c0 in range(0, hidden, cc)])
    return {"rows_per_tile": CHAIN_ROWS, "units": units, "columns": nc, "stream": stream,
            "head_slices": sh, "a_slices": sh + sp, "c_slices": -(-hidden // cc),
            "c_columns": cc,
            "slice_table": table, "a_tiles": a_tiles, "c_tiles": c_tiles, "h_groups": h_groups,
            "a_groups": a_groups, "grid": grid, "smem_bytes": smem, "co_resident": co}


@functools.lru_cache(maxsize=None)
def _beam_plan_args(n: int, beam: int, feat_dim: int, hidden: int, vocab: int,
                    weight_dtype: torch.dtype, index: int) -> tuple:
    """The plan's launch arguments for the card ``index`` (cached)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    p = beam_plan(n, beam, feat_dim, hidden, vocab, weight_dtype, sms)
    return (p["rows_per_tile"], p["units"], int(p["stream"]), p["grid"], p["h_groups"],
            p["a_groups"], p["smem_bytes"])


def combine_beam_partials(logits: torch.Tensor, v1w: torch.Tensor, b2: torch.Tensor,
                          columns: int, beam: int):
    """A plain model of the kernel's cross-slice combine (for tests).

    ``logits [R, V]`` cut into slices of ``columns`` columns as the plan
    cuts the head: each slice keeps per row its max, its sum of
    ``exp(l - max)`` and its ``beam`` best ``(value, column)`` (the larger
    value first, the lower column among equal ones); the slices' lists merge
    under the same order, across slices too -> ``logp [R, beam]`` (``topv -
    max - log(sum)``) and ``topi [R, beam]``. ``v1w = rnd(v1) * w2 [R2, H]``
    cut the same way: each slice's sum, the sums added in slice order, + b2
    -> ``values [R2]``."""
    vocab = logits.shape[1]
    ms, ses, vals, idxs = [], [], [], []
    for c0 in range(0, vocab, columns):
        lg = logits[:, c0:c0 + columns]
        m = lg.max(dim=1).values
        ms.append(m)
        ses.append(torch.exp(lg - m[:, None]).sum(dim=1))
        v, i = stable_topk(lg, min(beam, lg.shape[1]))
        vals.append(v)
        idxs.append(i + c0)
    m_rows = torch.stack(ms, dim=1)
    mx = m_rows.max(dim=1).values
    sum_exp = (torch.exp(m_rows - mx[:, None]) * torch.stack(ses, dim=1)).sum(dim=1)
    allv, alli = torch.cat(vals, dim=1), torch.cat(idxs, dim=1)
    by_col = torch.argsort(alli, dim=1, stable=True)  # then by value: columns break ties
    allv, alli = allv.gather(1, by_col), alli.gather(1, by_col)
    order = torch.argsort(allv, dim=1, descending=True, stable=True)[:, :beam]
    logp = (allv.gather(1, order) - mx[:, None]) - torch.log(sum_exp)[:, None]
    values = torch.zeros(v1w.shape[0], dtype=v1w.dtype)
    for c0 in range(0, v1w.shape[1], columns):
        values = values + v1w[:, c0:c0 + columns].sum(dim=1)
    return logp, alli.gather(1, order), values + b2


def select_candidates(cand: torch.Tensor, beam: int) -> torch.Tensor:
    """A plain model of the kernel's selection (for tests): per row of
    ``cand [N, B^2]``, candidate ``q``'s rank is how many score less, or the
    same at a lower flat index; the ``beam`` of rank below ``beam``, in rank
    order -> ``[N, beam]`` flat indices."""
    less = cand[:, None, :] < cand[:, :, None]
    q = torch.arange(cand.shape[1])
    tie = (cand[:, None, :] == cand[:, :, None]) & (q[None, :] < q[:, None])[None]
    rank = (less | tie).sum(dim=2)
    return torch.argsort(rank, dim=1)[:, :beam]


def beam_clock_slots(max_len: int) -> int:
    """The length of the kernel's phase profile (``clock`` of
    :func:`fused_beam_search`) for ``max_len`` columns."""
    return 2 + 8 * (max_len - 1)


def _launch_beam(weights: BeamWeights, features: torch.Tensor, start_tokens: torch.Tensor,
                 max_len: int, beam: int, value_weight: float, logprob_weight: float,
                 clock: torch.Tensor | None = None):
    p, v, head = weights
    features = pad_features(p, features)
    vocab, emb_dim = p.emb.shape
    feat_dim, hidden = p.wc.shape
    check_kernel_inputs(features, start_tokens)  # the C entry asserts their range
    check_weights(p, features.device)
    check_weights(v, features.device)
    if v.dtype != p.dtype:
        raise ValueError("policy and value weights must share one working type")
    check_tile_widths(p.dtype, feat_dim=feat_dim, emb_dim=emb_dim, hidden=hidden,
                      vocab=p.wo.shape[1])
    width = p.wo.shape[1]  # the head's width: a padded word never makes the cut
    check_head(head, p.wo)
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
        ws = torch.empty(lib.icrl_beam_workspace_floats(n, hidden, width, max_len, beam),
                         dtype=torch.float32, device=dev)
        err = lib.icrl_beam_search(
            n, feat_dim, emb_dim, hidden, width, head.shape[1], vocab, max_len, beam, value_weight,
            logprob_weight, int(p.dtype == torch.bfloat16),
            *_beam_plan_args(n, beam, feat_dim, hidden, width, p.dtype, dev.index),
            ptr(features), ptr(start_tokens),
            ptr(p.wc), ptr(p.bc), ptr(p.xg), ptr(p.w), ptr(p.b), ptr(head), ptr(p.bo),
            ptr(v.xg), ptr(v.w), ptr(v.b), ptr(v.w1), ptr(v.b1), ptr(v.w2), ptr(v.b2),
            ptr(tokens), ptr(scores), ptr(ws), 0 if clock is None else ptr(clock),
            torch.cuda.current_stream(dev).cuda_stream)
    check_error(lib, "icrl_beam_search", err)
    fused_beam_search.launches += 1
    return tokens, scores


def fused_beam_search(weights: BeamWeights, features: torch.Tensor,
                      start_tokens: torch.Tensor, max_len: int = MAX_SEQ_LEN, beam: int = 5,
                      value_weight: float = 0.6, logprob_weight: float = 0.4,
                      use_fused_kernel: bool | None = None, clock: torch.Tensor | None = None):
    """Per-sample value-guided beam search: ``features [N, F]`` f32,
    ``start_tokens [N]`` int32 -> ``(tokens [N, beam, max_len] int32,
    scores [N, beam] f32)``, beam 0 the best.

    CUDA tensors run the kernel (``csrc/beam_search.cu``); CPU tensors run
    :func:`beam_search_plain`. ``use_fused_kernel=False`` forces the plain
    version; ``True`` on CPU tensors raises.
    ``fused_beam_search.launches`` counts kernel launches.

    ``clock``, for a profile of the kernel: int64 zeros of
    :func:`beam_clock_slots` on the card, which the launch fills with the
    nanoseconds at which its last block passed each mark: 0 the start, 1
    the set-up done (the first cells), then for step ``t`` and phase ``q``
    (A, B, C, D) ``2 + 8t + 2q`` entered and ``+ 1`` done.
    """
    if not 1 <= beam <= MAX_BEAM:
        raise ValueError(f"beam must be in [1, {MAX_BEAM}], got {beam}")
    args = (weights, features, start_tokens, max_len, beam, value_weight, logprob_weight)
    check_clock(clock, beam_clock_slots(max_len), features, use_fused_kernel)
    if runs_kernel(use_fused_kernel, features, "beam"):
        return _launch_beam(*args, clock=clock)
    return beam_search_plain(*args)


fused_beam_search.launches = 0
