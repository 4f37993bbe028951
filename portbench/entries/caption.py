"""Offline captioning with value-guided beam search through the program's
``api.Captioner``: one caller in a closed loop, each call a group of
feature rows through ``Captioner.caption`` (``caption_tokens`` with
``beam_size``, then ``decode_captions`` to strings, the two halves of
``caption`` called here in turn so that the tokens stay visible to the
check), cycling through the val split as a ring.

The check takes a sample of the window's calls, drawn from the seed among
the first ``check_calls_from`` calls, and holds their tokens against the
reference:

- ``strings_mismatched``: strings that are not their tokens' words;
- ``topb_gap``: the widest gap by which a token's logit lies below its
  parent's ``B``-th best logit (the beam draws its expansions from the top
  ``B``): the policy's half of the search;
- ``score_excess_mean``: the mean, over the checked rows, of the beam score
  of the program's caption (the value-guided score the search minimises,
  worked out again by the reference along its tokens) less the reference
  beam's best score: the critic's half and the weights of the two, which a
  search that drops or misweighs the critic raises for nearly every row;
- ``rows_scored_worse``: the share of checked rows whose caption scores
  worse than the reference beam's best by more than ``SCORE_TOL``: a search
  that returns another beam than its best does so on every row.

With random weights a twentieth to a third of the rows part from the
reference at a near-tie in bf16, about half of them to a caption that
scores better: the mean excess of sound runs sits near 0, better and worse
rows cancelling (each row's excess within about +-0.9), and their share
scored worse near a tenth. A plain bf16 search reads the same.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts, traffic, trainrun
from portbench.reference import beam as ref_beam
from portbench.reference import nets

# a caption whose tokens are the reference beam's best scores the same to
# float32 rounding (~1e-5 on scores near 40); the gaps between a search's
# beams are mostly 1e-3 and up
SCORE_TOL = 1e-4


def _weights(cfg, seed, device):
    leaves = nets.policy_leaves(cfg, ("policy",)) + nets.value_leaves(cfg, ("value",))
    tensors = traffic.draw_weights(traffic.sub_seed(seed, 2), [l[1:] for l in leaves], device)
    return nets.build_tree(leaves, tensors)


def setup(ctx):
    """The inputs and the program's ``Captioner``: ``(one(call) -> (tokens,
    strings), rows(call) -> features, idx_to_word, the calls the check
    samples)``."""
    from image_captioning_through_rl_tpu_torch.api import Captioner
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions

    cfg, tr = ctx.config, ctx.traffic
    group, beam = tr["group_rows"], tr["beam_size"]
    rng = np.random.default_rng(traffic.sub_seed(ctx.seed, 1))
    feats = traffic.feature_table(rng, tr["val_images"], cfg["input_dim"])
    ring = np.concatenate([feats, feats[:group]])  # every group a contiguous slice
    word_to_idx, idx_to_word = traffic.vocab(cfg["vocab_size"])
    net_cfg = NetConfig.for_vocab(word_to_idx, None, input_dim=cfg["input_dim"],
                                  wordvec_dim=cfg["wordvec_dim"], hidden_dim=cfg["hidden_dim"])
    captioner = Captioner(_weights(cfg, ctx.seed, torch.device(ctx.device)), net_cfg,
                          idx_to_word, device=ctx.device)
    n_val = feats.shape[0]

    def rows(call):
        at = (call * group) % n_val
        return ring[at: at + group]

    def one(call):
        toks = captioner.caption_tokens(rows(call), beam_size=beam)
        return toks, decode_captions(toks, idx_to_word)

    sample = set(np.random.default_rng(traffic.sub_seed(ctx.seed, 5)).choice(
        tr["check_calls_from"], size=tr["check_calls"], replace=False).tolist())
    return one, rows, idx_to_word, sample


def sampled_calls(ctx):
    """The program's answers to the calls a run checks, without a window:
    ``(kept, rows, idx_to_word)``."""
    one, rows, idx_to_word, sample = setup(ctx)
    return {call: one(call) for call in sorted(sample)}, rows, idx_to_word


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    group, beam = tr["group_rows"], tr["beam_size"]
    one, rows, idx_to_word, sample = setup(ctx)
    for call in range(tr["warmup_calls"]):
        one(call)
    kept = {}
    t0 = time.perf_counter()
    call = 0
    while True:
        ts = time.perf_counter()
        toks, strs = one(call)
        te = time.perf_counter()
        ctx.spans.add("caption_call", ts, te)
        if call in sample:
            kept[call] = (toks, strs)
        call += 1
        if te - t0 >= ctx.seconds:
            break
    window = te - t0
    calls = call
    if ctx.tracer is not None:
        ctx.tracer.start()
        for j in range(tr["trace_calls"]):
            with ctx.spans.span("traced_call"):
                one(calls + j)
        ctx.tracer.stop()
    trainrun.read_peak(ctx)
    del one
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    limits = ctx.cell.spec["limits"]
    with ctx.spans.span("reference"):
        nums = check(cfg, ctx.seed, kept, rows, idx_to_word, beam, tr, torch.device(ctx.device))
    shape = (cfg["vocab_size"], cfg["wordvec_dim"], cfg["hidden_dim"], cfg["input_dim"],
             cfg["max_seq_len"], beam)
    lat_ms = [(e - s) * 1e3 for s, e in ctx.spans.of("caption_call")]
    return {"end_to_end": {"setup_s": t0 - ctx.t_start,
                           "captions_per_s": calls * group / window,
                           "caption_call_p95_ms": float(np.percentile(lat_ms, 95))},
            "attempted": calls * group, "failed": 0,
            "checks": {k: (nums[k], lim) for k, lim in limits.items()},
            "device": trainrun.device_info(ctx),
            "trace_info": {"group": group, "shape": shape, "window_s": window,
                           "window_flops": calls * counts.beam(group, *shape).flops},
            "notes": {"calls": calls, "window_s": window, "checked_calls": sorted(kept),
                      "rows_diverged": nums["rows_diverged"]}}


def check(cfg, seed, kept, rows, idx_to_word, beam, tr, device) -> dict:
    """The check's numbers over the kept calls (see the module's
    docstring), and, noted, ``rows_diverged``: the share of rows whose tokens
    are not the reference beam's best."""
    nets.tf32_off()
    names = ("strings_mismatched", "topb_gap", "score_excess_mean", "rows_scored_worse",
             "rows_diverged")
    if not kept:
        return dict.fromkeys(names, float("nan"))
    tree = _weights(cfg, seed, device)
    vw, lw = tr["value_weight"], tr["logprob_weight"]
    bad, topb, diverged, excess = 0, 0.0, 0, []
    for call, (toks, strs) in sorted(kept.items()):
        bad += sum(a != b for a, b in zip(strs, ref_beam.decode(toks, idx_to_word)))
        f = torch.from_numpy(rows(call)).to(device)
        t = torch.from_numpy(np.asarray(toks)).to(device)
        score, gaps = ref_beam.sequence_scores(tree["policy"], tree["value"], f, t, beam, vw, lw)
        best, best_score = ref_beam.beam_search(tree["policy"], tree["value"], f, beam,
                                                t.shape[1] - 1, vw, lw)
        topb = max(topb, float(gaps.max()))
        diverged += int((best[:, 0] != t.long()).any(dim=1).sum())
        excess.append((score - best_score[:, 0]).double().cpu())
    excess = torch.cat(excess)
    return dict(zip(names, (float(bad), topb, float(excess.mean()),
                            float((excess > SCORE_TOL).double().mean()),
                            diverged / excess.numel())))
