"""The beam kernel's launch plan, its cross-slice combine and its selection,
on the CPU (no GPU needed).

``csrc/beam_search.cu`` runs the whole value-guided beam search as one
cooperative launch: the columns of the head and both cells' recurrent
weights (the A slices) and of the critic's ``linear1`` over ``h_v'`` (the C
slices) are cut into slices, one block (or, streaming, a few in turn) per
slice and row group; each candidate row's top-B tokens and log-probs are
merged from per-slice lists and each expansion's value from per-slice
partial sums. :func:`fused_beam.beam_plan` mirrors the C plan (the entry
point refuses a plan that differs); these tests hold it to its contract at
widths from 8 to 4096, vocabularies to 10000, beams 1 to 8 and batches 1 to
1024, and hold :func:`fused_beam.combine_beam_partials` and
:func:`fused_beam.select_candidates`, plain models of the kernel's combine
and selection, to :func:`fused_beam.stable_topk` and to the arithmetic of
:func:`fused_beam.beam_search_plain`: the same tokens and selections (equal
values on both sides of a slice boundary go to the lower column, equal
candidate scores to the lower flat index) and log-probs and values within
1e-6 of the batch's largest magnitude (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch import START_ID
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.models import a2c
from image_captioning_through_rl_tpu_torch.ops import fused_beam as fb
from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
    lstm_cell_plain,
    prepare_greedy_weights,
    round_to,
    wmatmul,
)

SMS = 132  # H100 SXM
SMEM_PER_BLOCK = 232448
REL = 1e-6


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hidden", [8, 16, 256, 504, 512, 1000, 1024, 2048, 4096])
def test_beam_plan_covers_every_column_and_row_tile(hidden, wd):
    for vocab in (10, 1004, 2000, 10000):
        for beam in (1, 2, 5, 8):
            for n in (1, 37, 127, 1024):
                p = fb.beam_plan(n, beam, hidden, hidden, vocab, wd, SMS)
                cols = fb.beam_columns(hidden, vocab)
                nc = p["columns"]
                assert nc == 4 * p["units"]
                sa, sc = p["a_slices"], p["c_slices"]
                assert len(p["slice_table"]) == sa + sc
                # every column of each product in exactly one slice: the A
                # products at the plan's width, linear1 at c_columns
                for m, width in enumerate(cols):
                    seen = np.zeros(width, dtype=int)
                    for mm, c0, k in p["slice_table"]:
                        if mm == m:
                            step = nc if m < 3 else p["c_columns"]
                            assert c0 % step == 0 and 0 < k <= step
                            seen[c0:c0 + k] += 1
                    assert (seen == 1).all(), (m, width)
                assert all(m < 3 for m, _, _ in p["slice_table"][:sa])
                assert all(m == 3 for m, _, _ in p["slice_table"][sa:])
                assert p["a_tiles"] == -(-n * beam // 64)
                assert p["c_tiles"] == -(-n * beam ** 2 // 64)
                assert p["smem_bytes"] <= SMEM_PER_BLOCK and p["grid"] <= SMS
                if p["stream"]:
                    # every (slice, tile) item of a phase on one block, in turn
                    assert p["grid"] == p["co_resident"]
                    assert p["h_groups"] == p["a_groups"] == 0
                    continue
                sh, sp = p["head_slices"], sa - p["head_slices"]
                gh, gp = p["h_groups"], p["a_groups"]
                assert 1 <= gh <= p["a_tiles"] and 1 <= gp <= p["a_tiles"]
                assert p["grid"] == sh * gh + sp * gp
                # each block holds one A slice; every slice and row tile has a block
                blocks = ([(s, g) for g in range(gh) for s in range(sh)]
                          + [(sh + s, g) for g in range(gp) for s in range(sp)])
                for first, slices, groups in ((0, sh, gh), (sh, sp, gp)):
                    for s in range(first, first + slices):
                        owners = {rt % groups for rt in range(p["a_tiles"])}
                        assert owners == {g for ss, g in blocks if ss == s}
                # no other group counts on the card give phase A less weighted
                # time, or as little with more blocks
                wh, wa = fb.BEAM_TILE_COST
                ta, co = p["a_tiles"], p["co_resident"]

                def key(g1, g2):
                    return max(-(-ta // g1) * wh, -(-ta // g2) * wa), -(sh * g1 + sp * g2)

                for g1 in range(1, ta + 1):
                    for g2 in range(1, ta + 1):
                        if sh * g1 + sp * g2 > co:
                            break
                        assert key(g1, g2) >= key(gh, gp)


@pytest.mark.parametrize("wd,n,want", [
    (torch.bfloat16, 127, {"columns": 128, "stream": False, "head_slices": 8, "a_slices": 40,
                           "c_slices": 4, "h_groups": 8, "a_groups": 2, "grid": 128,
                           "smem_bytes": 226304}),
    (torch.bfloat16, 1024, {"columns": 128, "stream": False, "h_groups": 4, "a_groups": 3,
                            "grid": 128}),
    (torch.float32, 127, {"columns": 64, "stream": False, "head_slices": 16, "a_slices": 80,
                          "c_slices": 8, "h_groups": 4, "a_groups": 1, "grid": 128,
                          "smem_bytes": 176128}),
    (torch.bfloat16, 1, {"columns": 128, "h_groups": 1, "a_groups": 1, "grid": 40}),
])
def test_beam_plan_at_coco_width(wd, n, want):
    """V = 1004, E = H = F = 512, beam 5: 5100 A columns; in bf16 at N = 127
    the 8 head slices of 128 columns 8 times and the 32 cell slices twice
    (each block's 136 KB slice and the staging ring in 226 KB); linear1's 512
    columns stream in 4 slices of 128 (bf16) or 8 of 64 (float32)."""
    p = fb.beam_plan(n, 5, 512, 512, 1004, wd, SMS)
    assert {k: p[k] for k in want} == want
    assert sum(fb.beam_columns(512, 1004)[:3]) == 5100


@pytest.mark.parametrize("wd,units", [(torch.bfloat16, 16), (torch.float32, 8)])
def test_beam_plan_streams_past_what_stays(wd, units):
    """bf16 and float32 stream their weights from H = 1024 (no slice width
    gives every slice a block), at the chains' streaming slice width; F wider
    than H deepens the slices and streams too."""
    assert not fb.beam_plan(127, 5, 512, 512, 1004, wd, SMS)["stream"]
    for n, feat_dim, hidden in ((127, 512, 1024), (1, 512, 2048), (1024, 4096, 512)):
        p = fb.beam_plan(n, 5, feat_dim, hidden, 1004, wd, SMS)
        assert p["stream"] and p["units"] == units and p["grid"] == SMS


def _rel(a, b):
    """Relative to the largest magnitude of the batch."""
    return float((a - b).abs().max() / b.abs().max())


def _one_pass(logits, beam):
    topv, topi = fb.stable_topk(logits, beam)
    m = logits.max(dim=-1, keepdim=True).values
    return (topv - m) - torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)), topi


@pytest.mark.parametrize("beam", [1, 2, 5, 8])
@pytest.mark.parametrize("columns", [32, 64, 128])
@pytest.mark.parametrize("vocab", [10, 1004, 2000])
def test_combine_beam_partials_matches_one_pass(vocab, columns, beam):
    rng = np.random.default_rng(vocab + columns + beam)
    rows, hidden = 48, 96
    logits = torch.from_numpy((3.0 * rng.standard_normal((rows, vocab))).astype(np.float32))
    # equal values among the top B: on both sides of a slice boundary, inside
    # a slice, in two slices far apart, and B + 1 equal values (the cut falls
    # inside the tie); the lower column must win each
    top = float(logits.max()) + 10.0
    plants = [(0, (columns - 1, columns)), (1, (0, 1)), (2, (3, vocab - 1)),
              (3, (columns, 2 * columns)), (4, tuple(range(2, vocab, max(1, vocab // (beam + 1)))))]
    for row, cs in plants:
        for c in cs:
            if c < vocab:
                logits[row, c] = top
    v1w = torch.from_numpy(rng.standard_normal((rows * beam, hidden)).astype(np.float32))
    b2 = torch.from_numpy(rng.standard_normal(1).astype(np.float32))
    logp, topi, values = fb.combine_beam_partials(logits, v1w, b2, columns, beam)
    want_logp, want_topi = _one_pass(logits, beam)
    assert torch.equal(topi, want_topi)
    for row, cs in plants:
        real = sorted(c for c in cs if c < vocab)
        assert topi[row, :min(beam, len(real))].tolist() == real[:beam]
    assert _rel(logp, want_logp) <= REL
    assert _rel(values, v1w.sum(dim=1) + b2) <= REL


@pytest.mark.parametrize("beam", [1, 2, 5, 8])
def test_select_candidates_breaks_ties_by_flat_index(beam):
    """The kernel's rank selection equals ``stable_topk`` (smallest scores
    first, the lower flat index p*B + e among equal ones), also where many
    candidate scores are equal and where the cut falls inside a tie."""
    rng = np.random.default_rng(beam)
    cand = torch.from_numpy(rng.integers(0, 4, size=(64, beam * beam)).astype(np.float32))
    cand[0] = 1.0  # all equal
    cand[1, ::2] = float("inf")  # the +inf clones of step 0
    cand[1, 1::2] = 0.5
    got = fb.select_candidates(cand, beam)
    assert torch.equal(got, fb.stable_topk(cand, beam, largest=False)[1])
    assert got[0].tolist() == list(range(beam))


@pytest.mark.parametrize("wd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("beam", [2, 5])
def test_combine_matches_the_plain_beam_step(wd, beam):
    """The first step of :func:`beam_search_plain`, its own arithmetic: the
    policy logits and the expansions' linear1 outputs, cut at the plan's
    slice width, give through the combine the plain step's tokens, log-probs
    (within 1e-6) and values (within 1e-6), and the selection its picks."""
    cfg = NetConfig(vocab_size=1004, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=6)
    nets = a2c.init(torch.Generator().manual_seed(7), cfg)
    bw = fb.prepare_beam_weights(prepare_greedy_weights(nets["policy"], wd), nets["value"])
    p, v = bw.policy, bw.value
    rng = np.random.default_rng(8)
    n = 12
    feats = round_to(torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32)), wd)
    start = torch.full((n,), START_ID, dtype=torch.long)
    # beam_search_plain's set-up and step 0, as it computes them
    h0 = wmatmul(feats, p.wc) + p.bc
    zeros = torch.zeros_like(h0)
    ph, _ = lstm_cell_plain(p.w, p.b, p.emb.float()[start], round_to(h0, wd), zeros)
    vh, vc = lstm_cell_plain(v.w, v.b, v.emb.float()[start], zeros, zeros)
    ph, vh, vc = (x.repeat_interleave(beam, dim=0) for x in (ph, vh, vc))
    logits = wmatmul(round_to(ph, wd), p.wo) + p.bo
    want_logp, want_topi = _one_pass(logits, beam)
    vh2, _ = lstm_cell_plain(v.w, v.b, v.emb.float()[want_topi.reshape(-1)],
                             round_to(vh.repeat_interleave(beam, dim=0), wd),
                             vc.repeat_interleave(beam, dim=0))
    fproj = (wmatmul(feats, v.w1[:16]) + v.b1).repeat_interleave(beam * beam, dim=0)
    v1 = fproj + wmatmul(round_to(vh2, wd), v.w1[16:])
    want_values = wmatmul(round_to(v1, wd), v.w2[:, None])[:, 0] + v.b2
    plan = fb.beam_plan(n, beam, 16, 16, p.wo.shape[1], wd, SMS)
    assert plan["columns"] < 1004  # the head is cut into several slices
    logp, topi, values = fb.combine_beam_partials(
        logits, round_to(v1, wd) * v.w2.to(torch.float32), v.b2, plan["columns"], beam)
    assert torch.equal(topi, want_topi)
    assert _rel(logp, want_logp) <= REL
    assert _rel(values, want_values) <= REL
    scores = torch.full((n, beam), float("inf"))
    scores[:, 0] = 0.0
    cand = (scores[:, :, None] - (0.6 * values.reshape(n, beam, beam)
                                  + 0.4 * logp.reshape(n, beam, beam))).reshape(n, -1)
    assert torch.equal(fb.select_candidates(cand, beam), fb.stable_topk(cand, beam, False)[1])


def test_beam_weights_carry_no_head_on_the_cpu():
    """The padded head is a CUDA-side copy, like the x-gate tables; the plain
    version reads ``policy.wo`` and never it."""
    cfg = NetConfig(vocab_size=1004, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=6)
    nets = a2c.init(torch.Generator().manual_seed(9), cfg)
    bw = fb.prepare_beam_weights(prepare_greedy_weights(nets["policy"], torch.float32),
                                 nets["value"])
    assert bw.head is None and bw.value.xg is None


@pytest.mark.parametrize("clock", ["float32", "short", "strided"])
def test_beam_search_refuses_a_bad_clock(clock):
    """The kernel's optional phase clock is int64, contiguous and holds
    beam_clock_slots(T) = 2 + 8 (T - 1) marks; anything else is refused
    before any launch (here before the CPU route is ever taken)."""
    slots = fb.beam_clock_slots(6)
    assert slots == 42
    bad = {"float32": torch.zeros(slots),
           "short": torch.zeros(slots - 1, dtype=torch.int64),
           "strided": torch.zeros(2 * slots, dtype=torch.int64)[::2]}[clock]
    cfg = NetConfig(vocab_size=40, input_dim=16, wordvec_dim=16, hidden_dim=16, max_seq_len=6)
    nets = a2c.init(torch.Generator().manual_seed(5), cfg)
    bw = fb.prepare_beam_weights(prepare_greedy_weights(nets["policy"], torch.float32),
                                 nets["value"])
    feats = torch.zeros((2, 16))
    start = torch.full((2,), START_ID, dtype=torch.int32)
    with pytest.raises(ValueError, match="clock"):
        fb.fused_beam_search(bw, feats, start, 6, 3, clock=bad)
