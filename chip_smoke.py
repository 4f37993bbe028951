"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``image_captioning_through_rl_tpu_torch/csrc``,
holds each against its plain PyTorch version at COCO width, serves a few
caption requests over HTTP through the port's own server, and times each
kernel beside its plain version. Weights are random, made from a seed.
Every phase raises on failure; the run exits 0 only when all pass, and
then prints, last, ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the package beside this file, it exits non-zero and
prints no result.

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build the kernels;
  3. the x-gate table kernel (emb @ wi (+ b), wgmma for bf16 weights) vs
     plain, bf16 and f32: both decode kernels' [V, 4H] tables and a GRU's
     [V, 3H] with its bias; then the greedy kernel (csrc/decode.cu, one
     persistent launch) vs plain: N in {1, 4, 1000, 1024}, bf16 and f32
     weights, every case also run twice, bit-equal;
  4. beam kernel (one persistent launch) vs plain: N in {127, 1024}, B = 5,
     bf16 and f32 weights; B in {1, 2, 8} at small N and an N whose N B and
     N B^2 rows fill no whole row tile; every case also run twice, bit-equal;
  5. main path: a reference-layout a2c .pt and a vocab JSON on disk, the
     server started through ``server.main``, greedy (JSON and binary) and
     beam-5 requests answered, launch counters read;
  6. timings: kernel and plain ms (CUDA events): the x-gate table (its
     kernel through the C entry point, and through its wrapper), greedy
     at N = 1024, 64 and 4 (the median and range of three runs, its device
     time and launches per call from torch.profiler: one decode_kernel beside
     the start-token check, none of the per-step kernels it replaced; its
     phases per step from the kernel's own clock; its bound; the wrapper's
     host us a call) and beam at N = 127 and 1024 (the same, one
     beam_kernel);
  7. LSTM chain kernels (forward and backward) vs plain: N = 512,
     E = H = 512, V = 1004, T = 16 and 17, bf16 and f32 weights: hs and
     every gradient (wi, wh, b, embedding, h0, c0) for a fixed upstream
     gradient, as max abs error and relative Frobenius error;
  8. GRU chain kernels vs plain, the same at T = 17;
  9. training main path: a synthetic COCO-width bundle in memory (4096
     captions over 2048 images), then train_reward_network,
     train_policy_network and train_value_network on the card, one epoch at
     batch 512 each (the value trainer loads the two .pt files the others
     wrote); every logged loss finite, the policy XE loss falling, each .pt
     reloading through the port's converters, and every kernel of the path
     launched; then one minibatch of each step, fused vs plain;
 10. timings (CUDA events): each chain's forward and backward, kernel,
     plain and library (cuDNN's torch.nn.LSTM / GRU with the chain's
     weights), and one training step per trainer, fused and plain; each
     chain's launches per call at T = 8 and 16 (torch.profiler: the forward
     one launch beside the x-gate table's wgmma, the backward as many at
     either T and no view_kernel) with its recurrence's device slope per
     step, and a torch.profiler window over one fused policy step;
 11. the threefry noise kernel vs plain, [16, 512, 1004] for three keys;
 12. the reward stream kernel (one persistent launch, the rollout
     forward's reward-only mode) vs plain, bf16 and f32 weights, N = 512,
     on the actions and tokens of kernel rollouts at curr_seq_len 1 and 8,
     and against the rewards of the stream fused into each rollout; two
     calls bit-equal, one launch a call;
 13. the rollout kernels vs plain, bf16 and f32, N = 512, curr_seq_len 1
     and 8: the forward (and two calls bit-equal), then the backward on the
     kernel forward's tape (and two calls bit-equal, the embedding
     gradient's index_add_ in PyTorch's deterministic mode);
 14. A2C main path: train_a2c_network on the card from phase 9's three .pt
     files, plain A2C one epoch at batch 512 (reward stream fused into the
     rollout), then curriculum [8] (levels 8 and 16, one epoch each) with
     the reward stream as its own kernel; every logged value finite, each
     a2c .pt reloading to the trained weights, the rollout (forward and
     backward) and noise kernels launched once per minibatch; then one
     minibatch fused (bf16 kernels) vs plain (float32 eager);
 15. timings (CUDA events): the noise kernel, the reward stream, the
     rollout forward and backward, kernel and plain, one A2C step fused and
     plain; the reward stream's device time and launches per call
     (torch.profiler: one reward_stream_kernel beside the token check, none
     of the host loop's kernels) and its phases per step from its clock;
     the rollout forward's device time and launches per call
     (torch.profiler: one rollout_fwd_kernel beside the two x-gate tables,
     none of the per-step kernels it replaced); the rollout backward's
     device time and launches per call (its own ten, no view_kernel or
     linear_kernel) and the device time of its parts: the heads (prep,
     softmax gradient, wgmma_group_kernel, column sums and the finishing
     pass), both recurrences (lstm_bwd_pair_kernel) and the chains'
     products (wgmma_gemm_kernel); and a torch.profiler window over three
     fused A2C steps;
 16. the sampling kernel vs plain: bf16 and f32 weights, N in {1, 1024},
     four variants (unfiltered at t = 1.0, top-k 40 at t = 0.7,
     nucleus 0.9, top-k 40 with nucleus 0.9), one key each, every case also
     run twice, bit-equal; column 0 the start token; with f32 weights,
     temperature-0 requests equal greedy;
 17. sampling main path: the server started through ``server.main`` with
     ``--warmup_samples``, sampled requests posted through the port's
     ``CaptionClient`` over JSON and binary headers (num_samples 1 and 3, two
     seeds, one request larger than ``--max_batch``, answered in chunks under
     ``seed + row offset``), each equal to ``Captioner.sample_captions`` at the
     same seeds; beam + sample and num_samples above ``--max_samples``
     answered 400; ``/stats`` with the sampling kernel launched, 0 errors;
 18. timings (CUDA events): the sampling kernel (the greedy decode's launch
     with a sampling pick) and plain at N = 1024, unfiltered and top-k 40 +
     nucleus 0.9, and at the served shape N = 64, R = 4, as phase 6 times
     greedy (median and range, device time, launches, phase clock), with the
     bound of each from the noise entries the filters keep on these inputs;
     the unfiltered case also with its noise hashed in phase B instead of in
     the head's epilogue (the pick not kept); the wrapper's host us a call;
 19. the width faults repaired: train_reward_network and
     train_policy_network at hidden_dim = 1024 (2 minibatches of 512 each,
     chain launches counted, one minibatch of each step fused vs plain as in
     phase 9); both chains at H = E = 2048, whose weights stream through the
     ring, vs plain (phase 7's bounds); greedy, beam and top-k 40 + nucleus
     0.9 sampling at V = 1001, E = H = F = 500 (weights padded by the
     wrappers), and sampling at V = 2000 (rows past what a warp holds in
     registers, walked in L2), vs plain under the near-tie rules, and that
     last one timed at N = 1024; greedy and sampling at hidden_dim = 1024
     (weights streamed), bf16 and f32, vs plain; the beam at
     hidden_dim = 1024 (weights streamed), bf16 and f32, vs plain; the rollout
     forward and backward at hidden_dim = 1024 (weights streamed) and at
     V = 2000, bf16 and f32, vs plain under phase 13's rules; the reward
     stream at hidden_dim = 1024 and at V = 1001, H = 500 (padded), bf16 and
     f32, vs plain under phase 12's rules.
 20. evaluation main path: a synthetic COCO-width bundle with a val split of
     4096 captions whose urls are file:// paths to small files; phase 14's
     policy, value and a2c .pt files through load_a2c_models on the card
     (the tree equal to the a2c .pt's); test_a2c_network at 40504 draws
     (the JAX CLI's --test_size default), 128-row slices (127 kept), eight
     slices a group: 317 slices, 40188 lines, 40 groups of 1016 rows, the
     last padded; on the beam kernel (bf16 weights; one beam_kernel launch a
     group, the two x-gate tables a call, no other decode), clean and with
     the Q13 compat dump (the clean lines' slices joined without a trailing
     newline), and on the plain beam with the same weights (real and url
     dumps byte-identical, generated lines under the near-tie rule below);
     calculate_a2c_network_score on the kernel's dumps through the native
     fastmetrics library (seven finite scores, one results block), equal to
     the pure-Python scorers on the same files to rtol 1e-12; post_process_data
     (five best_scores.txt lines in score order, their five images copied
     from file://); times: test_a2c_network on each route, beam_kernel's
     device time a group (torch.profiler), the host seconds around the
     decode, scoring and post-processing.
 21. CLI main path, in a temporary working directory: a synthetic bundle of
     COCO-2014's full size (82783 train and 40504 val images, 5 captions
     each, V = 1004, F = 512, T = 17) written through the port's
     make_synthetic_coco and read back through load_data (every field held
     against the generator's arrays, dtype for dtype); then cli.main.main
     with --retrain --training_size 2048 --epochs 1 --batch_size 512
     --test_size 4064 --device cuda (numpy's global generator seeded first):
     the three pretrainers (4 minibatches x 50 / 100 / 50 epochs) and one
     A2C epoch on the card, every artifact of the JAX CLI's log directory
     but the .trainstate snapshots, every logged loss finite, seven finite
     scores, the GRU chain's, the rollout's, the noise kernel's and the
     beam's launches as counted from the run's minibatches and groups, the
     LSTM chain, greedy and the x-gate tables launched, and every .ckpt
     written read back bit-equal (the a2c files to the returned parameters,
     the pretrainers' files re-encoded to the same bytes); then a
     --test_model evaluation of the a2c .ckpt at 40504 draws (the log
     directory reused, eval_config.json, a second block of scores, one beam
     launch a 1016-row group and no other kernel but the x-gate tables);
     times: the bundle's write and read (MB/s), each stage's wall seconds.

The last JSON line but two lists every kernel with its launches on its main
paths, by path (serving for greedy; serving and the evaluation for the beam
and the x-gate table; the pretrainers for the chains; A2C for the rest; and
the CLI's two runs of phase 21 for every kernel they launch), its
largest error against plain, its time and its plain version's, and its
bound: the least time an H100 SXM could take
(bytes over 3.35 TB/s or operations over 989 TFLOP/s bf16, 67 TFLOP/s for
the noise kernel's integer and float32 work; the sampling kernel's products
at the first rate plus, at the second, per element the division by t, the
key and one select pass per filter, and the hash and Gumbel map of the
noise entries the filters keep on this run's inputs), counted in
``bounds()`` and ``sample_work()``. Where one PyTorch call computes a
kernel's function it is timed as ``library_ms`` (and never called by the
port): ``torch.mm`` with a float32 output for the x-gate table, cuDNN's
``torch.nn.LSTM`` and ``torch.nn.GRU`` for the chains (phase 10); the
decode, rollout, reward-stream, noise and sampling kernels have none.

Tolerances. Tokens must be equal. A row may differ only where the plain
version came within 1e-4 of a tie, and in at most 1% of rows: the kernel
sums in another order than cuBLAS, so near-ties may break either way. For
greedy the gap is the top-2 logit gap at the first step where the two
part. For beam it is the smallest, over the steps, of the top-B cut's
logit gap and the gaps between the B + 1 best candidate scores: each step
reorders whole histories, so the step where two beam searches part cannot
be read from their outputs. For rows whose tokens agree
the beam scores must agree to 1e-4 with f32 weights and to 1e-3 with bf16
weights. The bf16 bound is wider because both versions round the critic's
h and linear1's output to bf16 after a float32 sum: where the two sum
orders straddle a bf16 rounding boundary, the value moves by about 1e-4,
and such moves add up over the 16 steps (a score is a sum of 16 terms of
size ~3).

The chains (phases 7-8) are held by relative Frobenius error,
||kernel - plain|| / ||plain||, of hs and of each gradient. With float32
weights the two differ only in the order of float32 sums (the kernels add
x @ wi + h @ wh + b from the x-gate table, and sum the backward products
over other tiles than cuBLAS): about 1e-7 relative per product, compounded
over 17 steps (measured at most 2e-6); bound 1e-4. With bf16 weights both
round x, h and the gate gradients to bf16 before each product at the same
points, so only where two float32 sums of another order straddle a bf16
rounding boundary does an operand move, by one bf16 step, and carry
through the rest of the chain (measured at most 2.4e-4, on dh0); bound
2e-3, under the ~1e-3 to 4e-3 relative error that one rounding point more
or less (an operand left in float32, or rounded twice) puts on every
element of a product.

The steps (phase 9) hold the fused step (chain kernels, bf16 weights)
against the plain step (eager float32 autograd) on one minibatch: the loss
within 1e-2 relative (bf16 weights against float32 weights, up to 2^-9
relative per weight; measured at most 4e-4) and every parameter gradient
at cosine >= 0.999 with the plain one (measured at least 0.99992). The
value step's rollout comes from the greedy kernel once and feeds both (a
bf16 greedy rollout may part from the float32 one at near ties, which
phase 3 covers).

The A2C kernels (phases 11-14). Threefry bits must be equal (integer
arithmetic); the Gumbel noise within 4 ulps of max(|g|, 1) of the plain
version, since the two logf calls may each round one ulp apart and the
inner one's error is divided by its result (at most ulp(g) more). The
rollout's actions follow the near-tie rule above, with the gap between the
two largest noisy logits at the step where the two part. On the rows whose
actions agree, values, log-probs and rewards agree to 1e-4 with f32 weights
(sum order over 16 steps) and 2e-3 with bf16 weights (a bf16 rounding of h
or v1 that two sum orders straddle moves a product by ~1e-3 of its size;
values are sums of 512 such terms); the reward stream's kernel against its
plain version the same, and against the rollout's fused-in stream to 1e-6
(the same products, summed in the same order over the same operands; only
the cosine's last sums differ in order). The rollout backward, kernel and
plain fed one tape, is held as the chains are (its recurrences are the LSTM
chain's backward): relative Frobenius error per gradient within 1e-4 (f32)
and 2e-3 (bf16). One A2C minibatch fused (bf16 kernels) vs plain (float32
eager), on the noise of one key, is held as the pretraining steps are, over
the rows whose sampled actions agree: bf16 weights move a logit by ~1e-3,
so a row whose top two noisy logits come that close samples another action
and rolls out differently from then on, which no gradient bound can
absorb (one run with all rows kept: 3 of 512 parted and the policy's
gradient cosines fell to 0.992). Such rows are dropped with their noise, at
most 5% of the batch (measured 6 of 512, then loss 1e-5 relative and every
cosine >= 0.99998).

The sampling kernel (phase 16) is held by the near-tie rule above, with
the plain version's distance to a tie at the first step where the two
part: the smallest of the gap between the two largest noisy filtered
logits; the gap between the k-th and (k+1)-th scaled logits (top-k); for
the nucleus, the gap between the smallest kept and the largest dropped
scaled logit (two tokens that swap places there swap the boundary token,
which a mass margin alone does not see: measured, one row in ~1000 parted
that way) and the distance of p * z from the mass strictly above the
boundary value and from the mass at or above it, over z. The kernel's expf
and warp sums are not torch's exp and sum, and its products sum in another
order than cuBLAS, so a row whose boundary lies within float error of the
budget may keep one token more or fewer and a near-tie may break either
way; such a row may part only where that distance is < 1e-4 with f32
weights and < 5e-4 with bf16 weights, in at most 1% of rows. The bf16 bound
is wider because the kernel's and cuBLAS's bf16 logits differ by up to
1.7e-4 in a row (a bf16 rounding of h that the two sum orders straddle,
measured at COCO width), 2.5e-4 once divided by t = 0.7, so a top-k
boundary 1.7e-4 apart was seen to swap.

The evaluation (phase 20) holds the kernel's generated dump against the
plain beam's by the beam rule above, line by line: a line may differ only
where the plain beam's smallest gap over the steps, for that line's
features, is below 1e-4, in at most 1% of lines. The native scorers must
equal the pure-Python ones to 1e-12 relative (the same float64 arithmetic
in the same order; the JAX package holds its own native scorers so).

The whole run takes about four minutes of command time on the H100, the
build (about 80-110 s), phase 20 (about 25 s) and phase 21 included.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
V, F, E, H, T, BEAM = 1004, 512, 512, 512, 17, 5
NEAR_TIE = 1e-4
SAMPLE_NEAR_TIE = {torch.bfloat16: 5e-4, torch.float32: 1e-4}
MAX_DIFF_SHARE = 0.01
SCORE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
TABLE_TOL = 1e-4
CHAIN_N = 512
CHAIN_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
STEP_LOSS_TOL = 1e-2
GRAD_COS = 0.999
N_CAPTIONS, N_IMAGES, BATCH = 4096, 2048, 512
S, ROLLOUT_N = T - 1, 512
ROLLOUT_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4}
GUMBEL_ULPS = 4
A2C_DIFF_SHARE = 0.05
# phases 16-18: name, temperature, top_k, top_p
SAMPLE_VARIANTS = (("unfiltered", 1.0, 0, None), ("top-k 40", 0.7, 40, None),
                   ("nucleus 0.9", 1.0, 0, 0.9), ("top-k 40 + nucleus 0.9", 1.0, 40, 0.9))
SERVE_BATCH, SERVE_MAX_SAMPLES = 64, 4
H100_BF16, H100_F32, H100_BYTES = 989e12, 67e12, 3.35e12
# phase 19: a hidden width whose chain slices shrink (trainers), a width whose
# chain weights stream, an odd vocabulary and widths the wrappers pad, and a
# vocabulary past one warp per sampled row
WIDE_H, STREAM_H, STREAM_N, STREAM_T = 1024, 2048, 96, 5
ODD_V, ODD_W, WIDE_V = 1001, 500, 2000
# phase 20: the JAX CLI's --test_size default, the reference's 128-row slices
# (127 kept), eight slices a decode group, a val split of 4096 captions
EVAL_DRAWS, EVAL_VBS, EVAL_GROUP, EVAL_VAL = 40504, 128, 8, 4096
SCORE_RTOL = 1e-12
# phase 21: COCO-2014's full size (images and captions per split), the CLI's
# --training_size and --test_size of the training run, and the eval's draws
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_CAPTIONS_PER_IMAGE = 82783, 40504, 5
CLI_TRAINING_SIZE, CLI_TEST_SIZE = 2048, 4064
CLI_ARTIFACTS = {"a2cNetwork.ckpt", "generated_captions.txt", "image_url.txt", "metrics.jsonl",
                 "real_captions.txt", "results.txt", "run_config.json"}


T0 = time.perf_counter()


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def first_divergent_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row of ``[N, T]`` greedy tokens: the first decode step (column - 1)
    where the two differ."""
    return (a != b).int().argmax(dim=1) - 1


def check_rows(kind: str, k_tok, p_tok, gap_of_row, near_tie: float = NEAR_TIE
               ) -> tuple[int, float, float]:
    """Apply the near-tie rule. ``gap_of_row(bad)`` gives the plain
    version's tie gap for the rows that differ. Returns (rows that differ,
    smallest such gap, largest token difference outside them)."""
    n = k_tok.shape[0]
    bad = (k_tok != p_tok).reshape(n, -1).any(dim=1)
    n_bad = int(bad.sum())
    err = float((k_tok - p_tok)[~bad].abs().max()) if n_bad < n else 0.0
    if n_bad == 0:
        return 0, float("nan"), err
    gaps = gap_of_row(bad)
    worst = float(gaps.max())
    if worst >= near_tie:
        raise AssertionError(f"{kind}: a row differs where the plain version's gap "
                             f"{worst:.3g} is not a near-tie (< {near_tie})")
    if n_bad > MAX_DIFF_SHARE * n:
        raise AssertionError(f"{kind}: {n_bad}/{n} rows differ (more than "
                             f"{MAX_DIFF_SHARE:.0%})")
    return n_bad, float(gaps.min()), err


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chain_case(kind: str, steps: int, dev, n: int = CHAIN_N, width: int = H):
    """Random chain inputs from the seed (COCO width unless ``width`` is
    given, E = H): parameters (leaves that need gradients), embedding,
    tokens, initial state and an upstream gradient of hs."""
    from image_captioning_through_rl_tpu_torch.models.initializers import (
        embedding_init, gru_init, lstm_init)

    gen = torch.Generator().manual_seed(SEED + steps)
    params = (lstm_init if kind == "lstm" else gru_init)(gen, width, width)
    params = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    emb = embedding_init(gen, V, width).to(dev).requires_grad_()
    tok = torch.randint(0, V, (n, steps), generator=gen).to(dev)
    states = [(0.5 * torch.randn((n, width), generator=gen)).to(dev).requires_grad_()
              for _ in range(2 if kind == "lstm" else 1)]
    dhs = torch.randn((n, steps, width), generator=gen).to(dev)
    return params, emb, tok, states, dhs


def chain_run(kind: str, case, wd, use_fused_kernel):
    """hs and the gradients of <hs, dhs> with respect to every input."""
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain

    params, emb, tok, states, dhs = case
    chain = fused_lstm_chain if kind == "lstm" else fused_gru_chain
    hs = chain(params, emb, tok, *states, weight_dtype=wd, use_fused_kernel=use_fused_kernel)
    return [hs.detach(), *torch.autograd.grad(hs, [*params.values(), emb, *states], dhs)]


def compare_chains(dev) -> dict:
    """Phases 7-8. Returns the largest max-abs errors in bf16 (the weight
    type of the training path) of hs ("fwd") and of the gradients ("bwd")
    per chain."""
    worst = {}
    for kind, lengths in (("lstm", (16, 17)), ("gru", (17,))):
        for steps in lengths:
            case = chain_case(kind, steps, dev)
            names = ["hs", *case[0], "embedding", "h0", "c0"]
            for wd in (torch.bfloat16, torch.float32):
                got = chain_run(kind, case, wd, None)
                torch.cuda.synchronize()
                want = chain_run(kind, case, wd, False)
                report = []
                for name, a, b in zip(names, got, want):
                    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"{kind} chain {name}: shape {tuple(a.shape)} or "
                                             f"non-finite values")
                    err = float((a - b).abs().max())
                    rel = float((a - b).norm() / b.norm())
                    if not rel <= CHAIN_TOL[wd]:
                        raise AssertionError(f"{kind} chain T={steps} {wd} {name}: relative "
                                             f"error {rel:.3g} > {CHAIN_TOL[wd]}")
                    report.append(f"{name} {err:.3g}/{rel:.3g}")
                    if wd == torch.bfloat16:
                        key = (kind, "fwd" if name == "hs" else "bwd")
                        worst[key] = max(worst.get(key, 0.0), err)
                phase(f"{kind}_chain", f"T={steps} {str(wd)[6:]}: max abs/relative error "
                                       f"(bound {CHAIN_TOL[wd]}): " + ", ".join(report))
    return worst


def synthetic_coco(seed: int, n_captions: int = N_CAPTIONS, n_images: int = N_IMAGES,
                   n_val: int = 64):
    """A COCO-width bundle in memory: vocab 1004 (the four specials, then
    1000 words drawn Zipf-like, so a unigram is there to learn), features
    512, captions <START> body <END> <NULL>* of length 17, two captions per
    image; the val split is the first ``n_val`` captions."""
    from image_captioning_through_rl_tpu_torch import END_ID, START_ID
    from image_captioning_through_rl_tpu_torch.data.coco import CocoData, caption_lengths

    rng = np.random.default_rng(seed)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    p = 1.0 / np.arange(1, V - 3)
    body = 4 + rng.choice(V - 4, size=(n_captions, T), p=p / p.sum())
    lens = rng.integers(6, T + 1, size=n_captions)  # with <START> and <END>
    pos = np.arange(T)[None, :]
    caps = np.where(pos < lens[:, None] - 1, body, 0)
    caps[np.arange(n_captions), lens - 1] = END_ID
    caps[:, 0] = START_ID
    caps = caps.astype(np.int32)
    idxs = rng.permutation(np.repeat(np.arange(n_images), n_captions // n_images))
    feats = rng.standard_normal((n_images, F)).astype(np.float32)
    urls = np.array([f"img{i}.jpg" for i in range(n_images)])
    return CocoData(
        train_captions=caps, train_image_idxs=idxs.astype(np.int32),
        val_captions=caps[:n_val], val_image_idxs=idxs[:n_val].astype(np.int32),
        train_features=feats, val_features=feats, word_to_idx={w: i for i, w in enumerate(words)},
        idx_to_word=dict(enumerate(words)), train_urls=urls, val_urls=urls,
        train_captions_lens=caption_lengths(caps), val_captions_lens=caption_lengths(caps[:n_val]))


def leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def compare_steps(data, rparams, pparams, vparams, dev) -> None:
    """Phase 9, second half: one minibatch of each step, fused vs plain."""
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import prepare_greedy_weights
    from image_captioning_through_rl_tpu_torch.train import loops, steps

    cfg = loops._cfg_for(data, False)
    feats = torch.from_numpy(data.train_features[data.train_image_idxs[:BATCH]]).to(dev)
    caps = torch.from_numpy(data.train_captions[:BATCH]).to(dev).long()
    caplens = steps.batch_caption_lens(caps)
    gen, rewards = steps.value_rollout_rewards(cfg, pparams, rparams, feats, caps, fused=True,
                                               greedy_weights=prepare_greedy_weights(pparams))
    prefix = 9
    cases = {
        "reward": (rparams, lambda p, fused: (steps.reward_loss_fused if fused else
                                              steps.reward_loss)(p, cfg, feats, caps)),
        "policy": (pparams, lambda p, fused: (steps.policy_loss_fused if fused else
                                              steps.policy_loss)(p, cfg, feats, caps, caplens)),
        "value": (vparams, lambda p, fused: steps.value_regression_loss(
            p, cfg, feats, gen, rewards, prefix, fused=fused)),
    }
    for kind, (params, loss_fn) in cases.items():
        out = {}
        for fused in (True, False):
            p = {k: ({kk: vv.detach().clone().requires_grad_() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.detach().clone().requires_grad_())
                 for k, v in params.items()}
            loss = loss_fn(p, fused)
            names, ts = zip(*leaves(p))
            out[fused] = (float(loss.detach()), torch.autograd.grad(loss, ts), names)
        (lf, gf, names), (lp, gp, _) = out[True], out[False]
        rel = abs(lf - lp) / abs(lp)
        cos = {n: float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))
               for n, a, b in zip(names, gf, gp)}
        if not (np.isfinite(lf) and rel <= STEP_LOSS_TOL and min(cos.values()) >= GRAD_COS):
            raise AssertionError(f"{kind} step: fused loss {lf} vs plain {lp} (relative "
                                 f"{rel:.3g}), gradient cosines {cos}")
        phase("step", f"{kind}: fused loss {lf:.6f}, plain {lp:.6f} (relative {rel:.2e}, bound "
                      f"{STEP_LOSS_TOL}); smallest gradient cosine {min(cos.values()):.6f} "
                      f"({min(cos, key=cos.get)}; bound {GRAD_COS})")


def train_main_path(dev, tmp: str) -> tuple:
    """Phase 9. Writes the three networks' .pt files into ``tmp``. Returns
    the kernels' launch counts during the three trainers' run, the data, the
    trained networks and their paths."""
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, token_gate_table)
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import loops

    data = synthetic_coco(SEED)
    counters = {"lstm_chain_fwd": (fused_lstm_chain, "fwd_launches"),
                "lstm_chain_bwd": (fused_lstm_chain, "bwd_launches"),
                "gru_chain_fwd": (fused_gru_chain, "fwd_launches"),
                "gru_chain_bwd": (fused_gru_chain, "bwd_launches"),
                "greedy_decode": (fused_greedy_decode, "launches"),
                "token_gates": (token_gate_table, "launches")}
    paths = {f"{k}_network": os.path.join(tmp, f"{k}Network.pt")
             for k in ("reward", "policy", "value")}
    kw = dict(epochs=1, batch_size=BATCH, seed=SEED, device=dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    nets = {"reward": loops.train_reward_network(data, paths, tmp, False, **kw),
            "policy": loops.train_policy_network(data, paths, tmp, False, **kw),
            "value": loops.train_value_network(data, paths, tmp, False, **kw)}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        log = [json.loads(line) for line in f]
    for kind, params in nets.items():
        back = ckpt.load_network(kind, paths[f"{kind}_network"], dev)
        if [(n, tuple(t.shape)) for n, t in leaves(back)] != [
                (n, tuple(t.shape)) for n, t in leaves(params)]:
            raise AssertionError(f"{kind} checkpoint does not reload to the network's "
                                 f"parameters")
    losses = {}
    for rec in log:
        losses.setdefault(rec["tag"].split()[0].lower(), []).append(rec["value"])
    per_epoch = -(-N_CAPTIONS // BATCH)
    if sorted(losses) != ["policy", "reward", "value"] or any(
            len(v) != per_epoch or not np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"logged losses are missing or not finite: {losses}")
    xe = losses["policy"]
    if not np.mean(xe[-2:]) < np.mean(xe[:2]):
        raise AssertionError(f"the policy XE loss did not fall over the epoch: {xe}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the training path skipped a kernel: launches {launches}")
    phase("train", f"3 trainers x 1 epoch x {per_epoch} minibatches of {BATCH} in "
                   f"{seconds:.1f} s; losses first -> last: " + "; ".join(
                       f"{k} {v[0]:.4f} -> {v[-1]:.4f}" for k, v in sorted(losses.items()))
          + f"; checkpoints reload; launches during the run {launches}")
    return launches, data, nets, paths


def library_chain(kind: str, case, hs_kernel) -> dict:
    """The library yardstick of a chain: ``torch.nn.LSTM`` / ``torch.nn.GRU``
    (cuDNN) loaded with the chain's weights, in bf16 (fp16, the same bytes
    and tensor-core rate, where cuDNN refuses bf16 RNNs). The LSTM's fused
    bias goes to ``bias_ih``, ``bias_hh`` is 0; the GRU's gate order r, z, n
    and ``n = tanh(i_n + r (h @ W_hn + b_hn))`` are the chain's. The
    embedding gather ``emb[tok]`` runs once, outside the timed calls. Times
    the forward under ``no_grad`` and the backward as ``autograd.grad`` of
    the output against ``dhs`` with respect to x, the weights, h0 and c0;
    returns them with the dtype and the relative Frobenius distance of
    cuDNN's hs from the kernel's (the same function, rounded elsewhere)."""
    params, emb, tok, states, dhs = case
    dev = emb.device
    cls = torch.nn.LSTM if kind == "lstm" else torch.nn.GRU
    for dtype in (torch.bfloat16, torch.float16):
        rnn = cls(E, H).to(dev, dtype)
        with torch.no_grad():
            rnn.weight_ih_l0.copy_(params["wi"].t())
            rnn.weight_hh_l0.copy_(params["wh"].t())
            rnn.bias_ih_l0.copy_(params["b"] if kind == "lstm" else params["bi"])
            rnn.bias_hh_l0.copy_(torch.zeros_like(params["b"]) if kind == "lstm"
                                 else params["bh"])
        x = emb.detach()[tok.t()].to(dtype).requires_grad_()  # [T, N, E]
        st = [s.detach()[None].to(dtype).requires_grad_() for s in states]
        try:
            out, _ = rnn(x, tuple(st) if kind == "lstm" else st[0])
            break
        except RuntimeError:
            if dtype == torch.float16:
                raise
    grad_out = dhs.transpose(0, 1).to(dtype).contiguous()
    wrt = [x, *rnn.parameters(), *st]

    def fwd():
        with torch.no_grad():
            rnn(x, tuple(st) if kind == "lstm" else st[0])

    hs = out.detach().transpose(0, 1).float()
    return {"fwd": cuda_ms(fwd, 10),
            "bwd": cuda_ms(lambda: torch.autograd.grad(out, wrt, grad_out, retain_graph=True), 10),
            "dtype": str(dtype)[6:],
            "rel": float((hs - hs_kernel).norm() / hs_kernel.norm())}


def time_training(data, nets, dev) -> dict:
    """Phase 10: chain forward and backward, kernel, plain and library
    (cuDNN, :func:`library_chain`) at bf16, N = 512, and one step per
    trainer, fused and plain (batch 512)."""
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain
    from image_captioning_through_rl_tpu_torch.train import loops, steps
    from image_captioning_through_rl_tpu_torch.train.optim import adam

    times = {}
    for kind, length in (("lstm", 16), ("gru", 17)):
        case = chain_case(kind, length, dev)
        params, emb, tok, states, dhs = case
        inputs = [*params.values(), emb, *states]
        chain = fused_lstm_chain if kind == "lstm" else fused_gru_chain
        for label, flag in (("ms", None), ("plain_ms", False)):

            def fwd():
                with torch.no_grad():
                    chain(params, emb, tok, *states, use_fused_kernel=flag)

            hs = chain(params, emb, tok, *states, use_fused_kernel=flag)
            times[(kind, "fwd", label)] = cuda_ms(fwd, 10)
            times[(kind, "bwd", label)] = cuda_ms(
                lambda: torch.autograd.grad(hs, inputs, dhs, retain_graph=True), 10)
            if flag is None:
                hs_kernel = hs.detach()
        lib = library_chain(kind, case, hs_kernel)
        for d in ("fwd", "bwd"):
            times[(kind, d, "library_ms")] = lib[d]
        times[(kind, "library")] = lib
    times["chain_launches"] = chain_launches(dev)
    cfg = loops._cfg_for(data, False)
    feats = torch.from_numpy(data.train_features[data.train_image_idxs[:BATCH]]).to(dev)
    caps = torch.from_numpy(data.train_captions[:BATCH]).to(dev).long()
    for kind in ("reward", "policy", "value"):
        for label, fused in (("ms", True), ("plain_ms", False)):
            params = {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                          if isinstance(v, dict) else v.detach().clone())
                      for k, v in nets[kind].items()}
            opt = adam(1e-4, params)
            if kind == "value":
                step = steps.make_value_step(cfg, opt, nets["policy"], nets["reward"], fused=fused)
                fn = lambda: step(params, feats, caps, 9)  # noqa: E731
            else:
                make = steps.make_reward_step if kind == "reward" else steps.make_policy_step
                step = make(cfg, opt, fused=fused)
                fn = lambda: step(params, feats, caps)  # noqa: E731
            times[(kind, "step", label)] = cuda_ms(fn, 5)
            if kind == "policy" and fused:
                times["policy_profile"] = profile_window(fn, 3)
    return times


# --------------------------------------------------------------------------
# Phases 11-15: the A2C slice (threefry noise, reward stream, rollout, the
# A2C trainers)
# --------------------------------------------------------------------------

def net_cfg():
    from image_captioning_through_rl_tpu_torch.config import NetConfig

    return NetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=T)


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def compare_threefry(dev) -> float:
    """Phase 11: the noise kernel's bits and Gumbel noise against the plain
    version on the card, [S, N, V] for three keys. Returns the largest
    Gumbel error in ulps."""
    from image_captioning_through_rl_tpu_torch.ops import prng

    worst = 0.0
    shape = (ROLLOUT_N, V)
    for seed in range(3):
        keys = prng.split(prng.PRNGKey(SEED + seed), S)
        bits = prng.threefry_bits_kernel(keys, shape, dev).to(torch.int64) & 0xFFFFFFFF
        want = torch.stack([prng.random_bits(k, shape, dev) for k in keys])
        noise = prng.gumbel_noise(keys, shape, dev)
        plain = prng.gumbel_noise_plain(keys, shape, dev)
        torch.cuda.synchronize()
        if not torch.equal(bits, want):
            raise AssertionError(f"threefry bits differ from the plain version ({seed=})")
        ulp = torch.from_numpy(np.spacing(np.maximum(plain.abs().cpu().numpy(),
                                                     np.float32(1.0)))).to(dev)
        ulps = float(((noise - plain).abs() / ulp).max())
        if not ulps <= GUMBEL_ULPS:
            raise AssertionError(f"Gumbel noise {ulps:.3g} ulps from plain (> {GUMBEL_ULPS})")
        worst = max(worst, ulps)
    phase("threefry", f"[{S}, {ROLLOUT_N}, {V}] x 3 keys: bits equal; Gumbel within "
                      f"{worst:.3g} ulps of plain (bound {GUMBEL_ULPS})")
    return worst


def rollout_case(dev, wd, curr: int, seed: int):
    """Random COCO-width rollout operands: ``(args of the forward, a2c
    params, reward params, features, captions)``; the start states come from
    the start-token cells, as on the training path."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.models import a2c, reward
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
    from image_captioning_through_rl_tpu_torch.ops import prng

    cfg = net_cfg()
    gen = torch.Generator().manual_seed(seed)
    nets, rparams = to_device(a2c.init(gen, cfg), dev), to_device(reward.init(gen, cfg), dev)
    feats = torch.randn((ROLLOUT_N, F), generator=gen).to(dev)
    caps = torch.randint(4, V, (ROLLOUT_N, T), generator=gen).to(dev)
    caps[:, 0] = START_ID
    with torch.no_grad():
        states = fr.start_states(nets, cfg, feats, caps[:, 0])
    rw = fr.prepare_reward_weights(rparams, feats, caps[:, 0], wd)
    noise = prng.gumbel_noise(prng.split(prng.PRNGKey(seed), S), (ROLLOUT_N, V), dev)
    teach = caps[:, 1:].t().to(torch.int32).contiguous()
    args = (curr, teach, noise, rw, feats, *states, fr.prepare_rollout_weights(nets, wd))
    return args, nets, rparams, feats, caps


def check_reward_stream(label: str, rw, act, tok, fused_in=None) -> tuple[float, str]:
    """The reward stream kernel on ``[S, N]`` actions and tokens against its
    plain version (ROLLOUT_TOL), two calls bit-equal and one launch a call,
    and, given, against the rewards of the stream fused into a rollout
    (within 1e-6). Returns the max abs error against plain and a report."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    wd = rw.wh.dtype
    before = fr.fused_reward_stream.launches
    got = fr.reward_stream(rw, act, tok)
    again = fr.reward_stream(rw, act, tok)
    torch.cuda.synchronize()
    launches = fr.fused_reward_stream.launches - before
    want = fr.reward_stream(rw, act, tok, use_fused_kernel=False)
    err = float((got - want).abs().max())
    msg = (f"max abs error vs plain {err:.3g} (bound {ROLLOUT_TOL[wd]}); two calls "
           f"bit-equal, {launches // 2} launch a call")
    ok = (got.shape == act.shape and np.isfinite(err) and err <= ROLLOUT_TOL[wd]
          and torch.equal(got, again) and launches == 2)
    if fused_in is not None:
        same = float((got - fused_in).abs().max())
        msg += (f"; vs the rollout's fused-in stream {same:.3g} (bound 1e-6), bits "
                f"{'equal' if torch.equal(got, fused_in) else 'not equal'}")
        ok = ok and same <= 1e-6
    if not ok:
        raise AssertionError(f"reward stream {label}: {msg}; two calls equal "
                             f"{torch.equal(got, again)}, {launches} launches in two calls")
    return err, msg


def compare_reward_stream(dev) -> float:
    """Phase 12: the reward stream kernel against plain on the actions and
    tokens of kernel rollouts (curr_seq_len 1: every token the action; 8:
    the teacher's tokens on the first seven steps), and against the stream
    fused into each rollout. Returns the largest bf16 max-abs error against
    plain."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    worst = 0.0
    for wd in (torch.bfloat16, torch.float32):
        for curr in (1, 8):
            args, *_ = rollout_case(dev, wd, curr, SEED + 19 + curr)
            _, _, fused_in, tape = fr.rollout_forward_kernel(*args)
            label = f"{str(wd)[6:]} N={ROLLOUT_N} curr={curr}"
            err, msg = check_reward_stream(label, args[3], tape.act, tape.tok, fused_in)
            if wd == torch.bfloat16:
                worst = max(worst, err)
            phase("reward_stream", f"{label}: {msg}")
    return worst


GRAD_NAMES = ("features", "ph1", "pc1", "vh1", "vc1", "p_emb", "p_wi", "p_wh", "p_b", "head_w",
              "head_b", "v_emb", "v_wi", "v_wh", "v_b", "w1", "b1", "w2", "b2")


def compare_rollout(dev) -> dict:
    """Phase 13: the rollout forward against plain (near-tie rule on the
    actions, bounds on values, log-probs and rewards of agreeing rows; two
    calls bit-equal), and the backward against plain on the kernel forward's
    tape. Returns the largest bf16 max-abs errors ("fwd", "bwd")."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    worst = {"fwd": 0.0, "bwd": 0.0}
    for wd in (torch.bfloat16, torch.float32):
        for curr in (1, 8):
            args, _, _, feats, _ = rollout_case(dev, wd, curr, SEED + 30 + curr)
            k_val, k_logp, k_rew, tape = fr.rollout_forward_kernel(*args)
            again = fr.rollout_forward_kernel(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((k_val, k_logp, k_rew, *tape),
                                                         (*again[:3], *again[3]))):
                raise AssertionError(f"rollout forward {wd} curr={curr}: two calls differ")
            p_val, p_logp, p_rew, p_tape, gaps = fr.rollout_forward_plain(*args, margins=True)
            if not torch.equal(tape.tok[:curr - 1], args[1][:curr - 1]):
                raise AssertionError("the teacher-forced tokens were not placed")
            differ = tape.act != p_tape.act  # [S, N]
            first = differ.int().argmax(dim=0)
            n_bad, gap, _ = check_rows(f"rollout {wd} curr={curr}", tape.act.t(), p_tape.act.t(),
                                       lambda bad: gaps.gather(0, first[None])[0][bad])
            ok = ~differ.any(dim=0)
            errs = {name: float((a - b)[:, ok].abs().max()) for name, a, b in (
                ("values", k_val, p_val), ("log_probs", k_logp, p_logp),
                ("rewards", k_rew, p_rew))}
            if not all(np.isfinite(e) and e <= ROLLOUT_TOL[wd] for e in errs.values()):
                raise AssertionError(f"rollout forward {wd} curr={curr}: max abs errors {errs} "
                                     f"(bound {ROLLOUT_TOL[wd]})")
            gen = torch.Generator().manual_seed(SEED + 40)
            dval, dlogp = (torch.randn((S, ROLLOUT_N), generator=gen).to(dev) for _ in range(2))
            w = args[-1]
            # the kernels sum in a fixed order; the embedding gradient's
            # index_add_ (PyTorch's, outside them) needs its deterministic mode
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                got, twice = (fr.rollout_backward_kernel(tape, feats, w, dval, dlogp)
                              for _ in range(2))
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            differ = [name for name, a, b in zip(GRAD_NAMES, got, twice) if not torch.equal(a, b)]
            if differ:
                raise AssertionError(f"rollout backward {wd} curr={curr}: two calls differ in "
                                     f"{differ}")
            want = fr.rollout_backward_plain(tape, feats, w, dval, dlogp)
            rels, abs_err = {}, 0.0
            for name, a, b in zip(GRAD_NAMES, got, want):
                if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"rollout gradient {name}: shape or non-finite values")
                rels[name] = float((a - b).norm() / max(float(b.norm()), 1e-30))
                abs_err = max(abs_err, float((a - b).abs().max()))
            if max(rels.values()) > CHAIN_TOL[wd]:
                raise AssertionError(f"rollout backward {wd} curr={curr}: relative errors {rels} "
                                     f"(bound {CHAIN_TOL[wd]})")
            if wd == torch.bfloat16:
                worst["fwd"] = max(worst["fwd"], *errs.values())
                worst["bwd"] = max(worst["bwd"], abs_err)
            top = max(rels, key=rels.get)
            phase("rollout", f"{str(wd)[6:]} N={ROLLOUT_N} curr={curr}: two forwards and two "
                             f"backwards bit-equal; "
                             f"{n_bad} row(s) differ "
                             f"(smallest gap there {gap:.3g}; smallest gap overall "
                             f"{float(gaps.min()):.3g}); max abs errors "
                             + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                             + f" (bound {ROLLOUT_TOL[wd]}); backward largest relative error "
                               f"{rels[top]:.3g} ({top}; bound {CHAIN_TOL[wd]})")
    return worst


def a2c_main_path(data, paths: dict, tmp: str, dev) -> tuple:
    """Phase 14: train_a2c_network on the card from phase 9's three .pt
    files: plain A2C one epoch (reward stream fused into the rollout, the
    default), then curriculum [8] (levels 8 and 16, one epoch each) with the
    reward stream as its own kernel. Returns the launch counts during the
    two runs and the plain run's networks."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import token_gate_table
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import loops

    counters = {"rollout_fwd": (fr.fused_rollout, "fwd_launches"),
                "rollout_bwd": (fr.fused_rollout, "bwd_launches"),
                "reward_stream": (fr.fused_reward_stream, "launches"),
                "threefry_gumbel": (prng.gumbel_noise, "launches"),
                "token_gates": (token_gate_table, "launches")}
    runs = {"plain": dict(curriculum=None), "curriculum": dict(curriculum=[8], fuse_reward=False)}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    out = {}
    for name, kw in runs.items():
        d = os.path.join(tmp, f"a2c_{name}")
        os.makedirs(d)
        saves = {"model_path": os.path.join(d, "model.pt"),
                 "results_path": os.path.join(d, "results.txt")}
        nets = dict(paths, a2c_network=os.path.join(d, "a2cNetwork.pt"))
        params, rparams, _ = loops.train_a2c_network(data, saves, nets, d, False, epochs=1,
                                                     batch_size=BATCH, seed=SEED, device=dev, **kw)
        out[name] = (params, rparams, [saves["model_path"], nets["a2c_network"]], d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    per_epoch = -(-N_CAPTIONS // BATCH)
    logs = {}
    for name, (params, _, saved, d) in out.items():
        with open(os.path.join(d, "metrics.jsonl")) as f:
            log = [json.loads(line) for line in f]
        levels = 1 if name == "plain" else 2
        values = [r["value"] for r in log]
        if len(log) != 3 * per_epoch * levels or not np.isfinite(values).all():
            raise AssertionError(f"A2C {name}: {len(log)} logged values, finite "
                                 f"{np.isfinite(values).all()}")
        logs[name] = [r["value"] for r in log if r["tag"].endswith("loss")]
        for path in saved:
            back = ckpt.load_network("a2c", path, dev)
            if any(not torch.equal(a, b.detach()) for (_, a), (_, b) in
                   zip(leaves(back), leaves(params))):
                raise AssertionError(f"{path} does not reload to the trained parameters")
    steps_run = per_epoch * 3
    want = {"rollout_fwd": steps_run, "rollout_bwd": steps_run, "threefry_gumbel": steps_run,
            "reward_stream": 2 * per_epoch}
    if any(launches[k] != v for k, v in want.items()) or launches["token_gates"] < 1:
        raise AssertionError(f"A2C launches {launches}, expected {want} (the rollout and the "
                             f"noise once per minibatch)")
    phase("a2c", f"train_a2c_network: plain 1 epoch + curriculum [8, 16] 1 epoch each, "
                 f"{steps_run} minibatches of {BATCH} in {seconds:.1f} s; losses first -> last: "
                 + "; ".join(f"{k} {v[0]:.4f} -> {v[-1]:.4f}" for k, v in logs.items())
                 + f"; a2c .pt files reload; launches during the run {launches}")
    return launches, out["plain"][0], out["plain"][1]


def compare_a2c_step(data, a2c_params, rparams, dev) -> None:
    """Phase 14, second half: one A2C minibatch, fused (bf16 kernels, reward
    stream fused in) against plain (the float32 rollout ``Function`` in
    eager torch), on the same Gumbel noise from one key: loss and gradient
    cosines over the rows whose sampled actions agree. Rows that sample
    another action in bf16 are dropped, with their noise, until none do."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.train import loops, steps

    cfg = loops._cfg_for(data, False)
    feats = torch.from_numpy(data.train_features[data.train_image_idxs[:BATCH]]).to(dev)
    caps = torch.from_numpy(data.train_captions[:BATCH]).to(dev).long()
    caplen = torch.max(steps.batch_caption_lens(caps))
    noise = prng.gumbel_noise(prng.split(prng.PRNGKey(SEED + 50), S), (BATCH, V), dev)
    versions = {True: (torch.bfloat16, None), False: (torch.float32, False)}

    def rollout(params, keep, fused, reward_params=None):
        wd, flag = versions[fused]
        return fr.rollout_from_noise(params, cfg, feats[keep], caps[keep], 1,
                                     noise[:, keep].contiguous(), weight_dtype=wd,
                                     reward_params=reward_params, use_fused_kernel=flag)

    keep = torch.arange(BATCH, device=dev)
    for _ in range(3):
        with torch.no_grad():
            same = ~(rollout(a2c_params, keep, True)[2]
                     != rollout(a2c_params, keep, False)[2]).any(dim=1)
        if bool(same.all()):
            break
        keep = keep[same]
    else:
        raise AssertionError("a2c step: the bf16 and float32 rollouts still part after dropping "
                             "the rows that sampled other actions three times")
    dropped = BATCH - keep.numel()
    if dropped > A2C_DIFF_SHARE * BATCH:
        raise AssertionError(f"a2c step: {dropped}/{BATCH} rows sample other actions in bf16 "
                             f"(more than {A2C_DIFF_SHARE:.0%})")
    out = {}
    for fused in versions:
        p = {net: {k: ({kk: vv.detach().clone().requires_grad_() for kk, vv in v.items()}
                       if isinstance(v, dict) else v.detach().clone().requires_grad_())
                   for k, v in tree.items()} for net, tree in a2c_params.items()}
        values, logp, _, _, rewards = rollout(p, keep, fused, rparams)
        loss, _ = steps._a2c_loss(values, rewards, logp, 1, caplen, False)
        names, ts = zip(*leaves(p))
        out[fused] = (float(loss.detach()), torch.autograd.grad(loss, ts), names)
    (lf, gf, names), (lp, gp, _) = out[True], out[False]
    rel = abs(lf - lp) / abs(lp)
    cos = {n: float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))
           for n, a, b in zip(names, gf, gp)}
    if not (np.isfinite(lf) and rel <= STEP_LOSS_TOL and min(cos.values()) >= GRAD_COS):
        raise AssertionError(f"a2c step: fused loss {lf} vs plain {lp} (relative {rel:.3g}), "
                             f"gradient cosines {cos}")
    phase("step", f"a2c: {dropped}/{BATCH} rows sample other actions in bf16 than in float32 "
                  f"(bound {A2C_DIFF_SHARE:.0%}), dropped; fused loss {lf:.6f}, plain {lp:.6f} "
                  f"(relative {rel:.2e}, bound {STEP_LOSS_TOL}); smallest gradient cosine "
                  f"{min(cos.values()):.6f} ({min(cos, key=cos.get)}; bound {GRAD_COS})")


def short_kernel_name(name: str) -> str:
    found = re.findall(r"[A-Za-z_]\w*_kernel", name)
    return found[0] if found else name[:48]


# How long a torch.profiler window stays idle before its first launch: the
# tracer takes effect some time after the window opens (on the H100 machine
# windows lost their first ~0.01-3.5 ms of launches: one x-gate table of
# ten, the first three kernels of a rollout backward, two of three rollout
# forwards).
TRACER_SETTLE_S = 0.05


def settle_tracer() -> None:
    """The card idle for TRACER_SETTLE_S inside a freshly opened window."""
    torch.cuda.synchronize()
    time.sleep(TRACER_SETTLE_S)


def profile_window(step_fn, iters: int) -> str:
    """torch.profiler over ``iters`` calls of ``step_fn``: device ms per
    call, its busy share of the wall time, and the kernels that take the
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        settle_tracer()
        t0 = time.perf_counter()
        for _ in range(iters):
            step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    by_name, counts = device_ops(prof)
    busy = sum(by_name.values()) / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return (f"wall {wall:.3f} ms/call, device {busy:.3f} ms/call (busy {busy / wall:.0%}), "
            f"{sum(counts.values()) / iters:.0f} device ops/call; top (ms, launches per call): "
            + ", ".join(f"{k} {v / iters:.3f} x{counts[k] / iters:g}" for k, v in top))


def device_ops(prof) -> tuple[dict, dict]:
    """A profile's device time (ms) and launch count by short kernel name."""
    ms, counts = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        key = short_kernel_name(evt.key)
        ms[key] = ms.get(key, 0.0) + us / 1e3
        counts[key] = counts.get(key, 0) + evt.count
    return ms, counts


def device_profile(call, iters: int = 1, complete=None) -> tuple[dict, dict]:
    """:func:`device_ops` of a torch.profiler window over ``iters`` calls of
    ``call``, made once the tracer has settled (:func:`settle_tracer`).
    CUPTI has also handed back, once, a window with no device event at all:
    such a window is taken again, and so is one whose launch counts
    ``complete(counts)`` finds short, up to three windows in all; a count
    that is short in all three is the answer (:func:`per_call` rounds it:
    in a process that has opened many windows, the tracer was seen to miss
    a backward's first launches window after window)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle_tracer()
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        ms, counts = device_ops(prof)
        if counts and (complete is None or complete(counts)):
            return ms, counts
    if counts:
        return ms, counts
    raise AssertionError("torch.profiler recorded no device work in three windows")


def per_call(counts: dict, iters: int) -> dict:
    """Launches per call by name, rounded to whole launches: the true counts
    while fewer than half of a kernel's launches went unrecorded."""
    return {k: round(c / iters) for k, c in counts.items()}


CHAIN_KERNELS = ("lstm_fwd_kernel", "lstm_bwd_kernel", "gru_fwd_kernel", "gru_bwd_kernel",
                 "wgmma_gemm_kernel", "linear_kernel", "colsum_part_kernel",
                 "colsum_finish_kernel", "view_kernel")


def chain_launches(dev) -> dict:
    """Phase 10: the LSTM and GRU chain kernels launched by one fused
    forward and by one backward (bf16, N = 512) at T = 8 and T = 16, from
    the profiler, and the recurrence kernels' device ms at each T. Each
    forward must be one chain launch beside the x-gate table (wgmma), and each
    backward's launches must not depend on T, with no view_kernel. Also each
    call's device time in all (the wrappers' casts and copies, the embedding
    gradient's index_add_ included)."""
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain

    out = {}
    for kind, chain in (("lstm", fused_lstm_chain), ("gru", fused_gru_chain)):
        for steps in (8, 16):
            params, emb, tok, states, dhs = chain_case(kind, steps, dev)
            hs = chain(params, emb, tok, *states)
            torch.cuda.synchronize()
            for d, run in (("fwd", lambda: chain(params, emb, tok, *states)),
                           ("bwd", lambda: torch.autograd.grad(
                               hs, [*params.values(), emb, *states], dhs, retain_graph=True))):
                ms, counts = device_profile(run, complete=lambda c: (
                    c.get(f"{kind}_{d}_kernel", 0) >= 1
                    and c.get("wgmma_gemm_kernel", 0) >= (1 if d == "fwd" else 2)))
                out[(kind, steps, d)] = {k: counts[k] for k in CHAIN_KERNELS if counts.get(k)}
                out[(kind, steps, d, "ms")] = ms.get(f"{kind}_{d}_kernel", 0.0)
                out[(kind, steps, d, "device")] = sum(ms.values())
        fwd8, fwd16 = out[(kind, 8, "fwd")], out[(kind, 16, "fwd")]
        bwd8, bwd16 = out[(kind, 8, "bwd")], out[(kind, 16, "bwd")]
        if (fwd8 != fwd16 or fwd8 != {f"{kind}_fwd_kernel": 1, "wgmma_gemm_kernel": 1}
                or bwd8 != bwd16 or bwd8.get(f"{kind}_bwd_kernel") != 1 or "view_kernel" in bwd8):
            raise AssertionError(f"{kind} chain launches per call by T: {out}")
    return out


ROLLOUT_FWD_GONE = ("rollout_cell_kernel", "value_hidden_kernel", "sample_rows_kernel",
                    "linear_kernel")
# the reward stream's host step loop, before its persistent launch
REWARD_STREAM_GONE = ("gru_pair_kernel", "cosine_rows_kernel", "linear_kernel")


def reward_stream_profile(call, iters: int = 3) -> str:
    """Phase 15: the reward stream's device time and launches per call
    (torch.profiler): one reward_stream_kernel beside the token check's
    small operations, none of the host loop's kernels."""
    call()
    torch.cuda.synchronize()
    ms, counts = device_profile(call, iters, lambda c: c.get("reward_stream_kernel", 0) >= iters)
    launches = per_call(counts, iters)
    if (launches.get("reward_stream_kernel") != 1
            or any(launches.get(k) for k in REWARD_STREAM_GONE)):
        raise AssertionError(f"reward stream launches per call: {launches}")
    kernel = ms["reward_stream_kernel"] / iters
    return (f"device {sum(ms.values()) / iters:.4f} ms per call, reward_stream_kernel "
            f"{kernel:.4f} ms; launches per call "
            + ", ".join(f"{k} x{v:g}" for k, v in sorted(launches.items()) if v))


def rollout_fwd_profile(call, iters: int = 3) -> str:
    """Phase 15: the rollout forward's device time and launches per call
    (torch.profiler): one rollout_fwd_kernel beside the x-gate tables, and
    none of the per-step kernels it replaced."""
    call()
    torch.cuda.synchronize()
    ms, counts = device_profile(call, iters, lambda c: c.get("rollout_fwd_kernel", 0) >= iters)
    launches = per_call(counts, iters)
    if launches.get("rollout_fwd_kernel") != 1 or any(launches.get(k) for k in ROLLOUT_FWD_GONE):
        raise AssertionError(f"rollout forward launches per call: {launches}")
    return (f"device {sum(ms.values()) / iters:.4f} ms per call, rollout_fwd_kernel "
            f"{ms['rollout_fwd_kernel'] / iters:.4f} ms ({ms['rollout_fwd_kernel'] / iters / S * 1e3:.2f}"
            f" us a step); launches per call "
            + ", ".join(f"{k} x{v:g}" for k, v in sorted(launches.items()) if v))


# The rollout backward's kernels (csrc/rollout.cu, bf16) by part.
ROLLOUT_BWD_PARTS = {
    "heads": ("rollout_bwd_prep_kernel", "wgmma_group_kernel", "softmax_grad_rows_kernel",
              "colsum_part_kernel", "rollout_bwd_finish_kernel"),
    "recurrences": ("lstm_bwd_pair_kernel",),
    "chain products": ("wgmma_gemm_kernel",)}
ROLLOUT_BWD_GONE = ("view_kernel", "linear_kernel", "lstm_bwd_kernel", "colsum_finish_kernel")


def rollout_bwd_profile(call, iters: int = 3) -> str:
    """Phase 15: the rollout backward's device time per call, its launches
    (its own kernels, ten, none of the tile products it replaced; and all
    device operations of the call, PyTorch's embedding gradient included)
    and the device time of its parts."""
    call()
    torch.cuda.synchronize()
    ours = [k for names in ROLLOUT_BWD_PARTS.values() for k in names]
    ms, counts = device_profile(call, iters,
                                lambda c: sum(c.get(k, 0) for k in ours) >= 10 * iters)
    launches = per_call(counts, iters)
    own = {k: v for k, v in launches.items() if k in ours}
    if any(launches.get(k) for k in ROLLOUT_BWD_GONE) or sum(own.values()) != 10:
        raise AssertionError(f"rollout backward launches per call: {launches}")
    device = sum(ms.values()) / iters
    parts = {part: sum(ms.get(k, 0.0) for k in names) / iters
             for part, names in ROLLOUT_BWD_PARTS.items()}
    return (f"device {device:.4f} ms per call: "
            + ", ".join(f"{part} {v:.4f}" for part, v in parts.items())
            + f", around them (PyTorch's embedding gradient) {device - sum(parts.values()):.4f};"
              f" launches per call: its own {sum(own.values()):g} ("
            + ", ".join(f"{k} x{v:g}" for k, v in sorted(own.items()))
            + f"), all device operations {sum(launches.values()):g}")


def rollout_fwd_phases(args) -> str:
    """Phase 15: where the rollout forward's time goes, from the kernel's
    own clock over one call (each mark the last block's): the slices' load,
    then per step the means of phase A, phase B and the two grid barriers."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    steps = args[1].shape[0]
    clock = torch.zeros(fr.rollout_clock_slots(steps), dtype=torch.int64, device=args[4].device)
    fr.rollout_forward_kernel(*args, clock=clock)
    return pass_phases("rollout forward", clock.cpu().tolist(), steps + (args[3] is not None))


def reward_stream_phases(rw, act, tok) -> str:
    """Phase 15: the reward stream's phases from its own clock over one
    call, as :func:`rollout_fwd_phases` reads the rollout forward's (S + 1
    passes: the last takes the last step's reward)."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    steps = act.shape[0]
    clock = torch.zeros(fr.rollout_clock_slots(steps), dtype=torch.int64, device=act.device)
    fr.reward_stream(rw, act, tok, clock=clock)
    return pass_phases("reward stream", clock.cpu().tolist(), steps + 1)


def pass_phases(label: str, c: list, passes: int) -> str:
    """A persistent rollout launch's clock (rollout_clock_slots marks): the
    slices' load, then the means over its passes of phase A, phase B and
    the two grid barriers, in us."""
    if min(c[:2 + 4 * passes]) <= 0:
        raise AssertionError(f"the {label}'s clock has unset marks: {c}")

    def mean_us(pairs):
        return sum((c[b] - c[a]) for a, b in pairs) / len(pairs) / 1e3

    at = [2 + 4 * t for t in range(passes)]
    return (f"{passes} passes in {(c[at[-1] + 3] - c[0]) / 1e3:.1f} us from the last block's "
            f"start: slices loaded {(c[1] - c[0]) / 1e3:.1f} us; a pass: phase A "
            f"{mean_us([(k, k + 1) for k in at]):.2f} us, barrier "
            f"{mean_us([(k + 1, k + 2) for k in at]):.2f}, phase B "
            f"{mean_us([(k + 2, k + 3) for k in at]):.2f}, barrier "
            f"{mean_us([(k + 3, k + 4) for k in at[:-1]]) if passes > 1 else 0.0:.2f}")


BEAM_GONE = ("lse_topb_kernel", "lstm_expand_kernel", "value_mlp_kernel",
             "select_reorder_kernel", "linear_kernel", "lstm_kernel", "beam_init_kernel")


def beam_profile(call, iters: int = 3) -> str:
    """Phase 6: the beam's device time and launches per call
    (torch.profiler): one beam_kernel for all T - 1 steps, at most two small
    launches beside it (one asserts the start tokens' range), none of the
    kernels it replaced, and no copy to the host."""
    call()
    torch.cuda.synchronize()
    ms, counts = device_profile(call, iters, lambda c: c.get("beam_kernel", 0) >= iters)
    launches = per_call(counts, iters)
    if (launches.get("beam_kernel") != 1 or sum(launches.values()) > 3
            or any(launches.get(k) for k in BEAM_GONE)
            or any("Memcpy DtoH" in k and v for k, v in launches.items())):
        raise AssertionError(f"beam launches per call: {launches}")
    return (f"device {sum(ms.values()) / iters:.4f} ms per call, beam_kernel "
            f"{ms['beam_kernel'] / iters:.4f} ms ({ms['beam_kernel'] / iters / (T - 1) * 1e3:.2f}"
            f" us a step); launches per call "
            + ", ".join(f"{k} x{v:g}" for k, v in sorted(launches.items()) if v))


def beam_phases(bw, feats, start) -> str:
    """Phase 6: where the beam kernel's time goes, from its own clock over
    one call (each mark the last block's): the set-up (h0, fproj, the first
    cells), then per step the means of phases A-D and of the barriers."""
    from image_captioning_through_rl_tpu_torch.ops import fused_beam as fb

    clock = torch.zeros(fb.beam_clock_slots(T), dtype=torch.int64, device=feats.device)
    fb.fused_beam_search(bw, feats, start, T, BEAM, clock=clock)
    c = clock.cpu().tolist()
    if min(c) <= 0:
        raise AssertionError(f"the beam's clock has unset marks: {c}")
    steps = T - 1

    def mean_us(a, b):  # from mark 2 + 8t + a to 2 + 8t + b, over the steps
        return sum(c[2 + 8 * t + b] - c[2 + 8 * t + a] for t in range(steps)) / steps / 1e3

    return (f"{steps} steps in {(c[-1] - c[0]) / 1e3:.1f} us from the last block's start: "
            f"set-up {(c[1] - c[0]) / 1e3:.1f} us; a step: phase A {mean_us(0, 1):.2f} us, "
            f"B {mean_us(2, 3):.2f}, C {mean_us(4, 5):.2f}, D {mean_us(6, 7):.2f}, the "
            f"three barriers inside it {mean_us(1, 2) + mean_us(3, 4) + mean_us(5, 6):.2f}")


DECODE_GONE = ("lstm_kernel", "linear_kernel", "argmax_rows_kernel", "sample_rows_kernel",
               "sample_wide_kernel", "fill_start_kernel")


def decode_profile(call, iters: int = 3) -> tuple[str, float, int]:
    """Phases 6 and 18: a decode's device time and launches per call
    (torch.profiler): one decode_kernel for all T - 1 steps beside the small
    launch that asserts the start tokens' range, none of the kernels it
    replaced, no copy to the host. Returns the line, the device ms a call
    and the launches a call."""
    call()
    torch.cuda.synchronize()
    ms, counts = device_profile(call, iters, lambda c: c.get("decode_kernel", 0) >= iters)
    launches = per_call(counts, iters)
    if (launches.get("decode_kernel") != 1 or sum(launches.values()) > 2
            or any(launches.get(k) for k in DECODE_GONE)
            or any("Memcpy" in k and v for k, v in launches.items())):
        raise AssertionError(f"decode launches per call: {launches}")
    device = sum(ms.values()) / iters
    return (f"device {device:.4f} ms a call (decode_kernel {ms['decode_kernel'] / iters:.4f}); "
            f"launches a call " + ", ".join(f"{k} x{v:g}" for k, v in sorted(launches.items()) if v),
            device, sum(launches.values()))


def decode_phases(call) -> str:
    """Phases 6 and 18: where a decode's time goes, from the kernel's own
    clock over one call ``call(clock)`` (each mark the last block's): the
    set-up (h0 and the first cell), then per step the means of phases A and
    B and of the two barriers; and the mean clock64 cycles of a head tile and
    of a cell tile in phase A (the ratio the plan's DECODE_TILE_COST
    balances)."""
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import decode_clock_slots

    clock = torch.zeros(decode_clock_slots(T), dtype=torch.int64, device="cuda")
    call(clock)
    c = clock.cpu().tolist()
    if min(c) <= 0:
        raise AssertionError(f"the decode's clock has unset marks: {c}")
    steps = T - 1

    def mean_us(a, b):  # from mark 2 + 4t + a to 2 + 4t + b, over the steps
        return sum(c[2 + 4 * t + b] - c[2 + 4 * t + a] for t in range(steps)) / steps / 1e3

    between = sum(c[6 + 4 * t] - c[5 + 4 * t] for t in range(steps - 1)) / (steps - 1) / 1e3
    head, cell = (c[2 + 4 * steps + i] / c[3 + 4 * steps + i] for i in (0, 2))
    return (f"set-up {(c[1] - c[0]) / 1e3:.1f} us; a step: phase A {mean_us(0, 1):.2f} us, "
            f"B {mean_us(2, 3):.2f}, barriers {mean_us(1, 2) + between:.2f}; phase A's tiles: "
            f"head {head:.0f} cycles, cell {cell:.0f} (head / cell {head / cell:.2f})")


def time_decode(call, timed=None) -> dict:
    """Phases 6 and 18: a decode's time (the median and range of three runs
    of 20 back-to-back calls, CUDA events), its device time, launches a call
    and phase clock; ``timed(clock)`` is the call with a clock."""
    runs = sorted(cuda_ms(call, 20) for _ in range(3))
    prof, device, launches = decode_profile(call)
    return {"ms": runs[1], "min": runs[0], "max": runs[2], "profile": prof, "device": device,
            "launches": launches, "phases": decode_phases(timed)}


def decode_line(label: str, t: dict) -> str:
    return (f"{label}: kernel {t['ms']:.4f} ms (median of 3, {t['min']:.4f}-{t['max']:.4f}), "
            f"{t['profile']} | its clock: {t['phases']}")


def time_greedy(gw, feats, start) -> dict:
    """Phase 6: the greedy decode at N = 1024, 64 and 4 (bf16), its plain
    version at N = 1024 and the wrapper's host microseconds a call."""
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, greedy_decode_plain)

    out = {}
    for n in (1024, 64, 4):
        f, s = feats[:n].contiguous(), start[:n].contiguous()
        out[n] = time_decode(lambda: fused_greedy_decode(gw, f, s, T),
                             lambda c: fused_greedy_decode(gw, f, s, T, clock=c))
    out["plain_ms"] = cuda_ms(lambda: greedy_decode_plain(gw, feats, start, T), 20)
    out["host_us"] = host_us(lambda: fused_greedy_decode(gw, feats, start, T))
    return out


def time_a2c(a2c_params, rparams, data, dev) -> dict:
    """Phase 15: CUDA-event timings at the main path's shapes (bf16, N =
    512): the noise kernel, the reward stream, the rollout forward and
    backward, each beside its plain version, one A2C step fused and plain,
    and a profile of the fused step."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.train import loops, steps
    from image_captioning_through_rl_tpu_torch.train.optim import adam

    times = {}
    keys = prng.split(prng.PRNGKey(SEED), S)
    times[("threefry_gumbel", "ms")] = cuda_ms(
        lambda: prng.gumbel_noise(keys, (ROLLOUT_N, V), dev), 20)
    times[("threefry_gumbel", "plain_ms")] = cuda_ms(
        lambda: prng.gumbel_noise_plain(keys, (ROLLOUT_N, V), dev), 3)
    args, *_, feats, _ = rollout_case(dev, torch.bfloat16, 1, SEED + 60)
    _, _, _, tape = fr.rollout_forward_kernel(*args)
    rw, w = args[3], args[-1]
    times[("reward_stream", "ms")] = cuda_ms(lambda: fr.reward_stream(rw, tape.act, tape.tok), 20)
    times[("reward_stream", "plain_ms")] = cuda_ms(
        lambda: fr.reward_stream(rw, tape.act, tape.tok, use_fused_kernel=False), 3)
    times[("reward_stream", "profile")] = reward_stream_profile(
        lambda: fr.reward_stream(rw, tape.act, tape.tok))
    times[("reward_stream", "phases")] = reward_stream_phases(rw, tape.act, tape.tok)
    times[("rollout_fwd", "ms")] = cuda_ms(lambda: fr.rollout_forward_kernel(*args), 10)
    times[("rollout_fwd", "plain_ms")] = cuda_ms(lambda: fr.rollout_forward_plain(*args), 3)
    times[("rollout_fwd", "profile")] = rollout_fwd_profile(lambda: fr.rollout_forward_kernel(*args))
    times[("rollout_fwd", "phases")] = rollout_fwd_phases(args)
    gen = torch.Generator().manual_seed(SEED + 61)
    dval, dlogp = (torch.randn((S, ROLLOUT_N), generator=gen).to(dev) for _ in range(2))
    times[("rollout_bwd", "ms")] = cuda_ms(
        lambda: fr.rollout_backward_kernel(tape, feats, w, dval, dlogp), 10)
    times[("rollout_bwd", "plain_ms")] = cuda_ms(
        lambda: fr.rollout_backward_plain(tape, feats, w, dval, dlogp), 3)
    times[("rollout_bwd", "profile")] = rollout_bwd_profile(
        lambda: fr.rollout_backward_kernel(tape, feats, w, dval, dlogp))
    cfg = loops._cfg_for(data, False)
    feats = torch.from_numpy(data.train_features[data.train_image_idxs[:BATCH]]).to(dev)
    caps = torch.from_numpy(data.train_captions[:BATCH]).to(dev).long()
    key = prng.PRNGKey(SEED + 62)
    for label, fused in (("ms", True), ("plain_ms", False)):
        params = {net: {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                            if isinstance(v, dict) else v.detach().clone())
                        for k, v in tree.items()} for net, tree in a2c_params.items()}
        step = steps.make_a2c_step(cfg, adam(1e-6, params), fused=fused)

        def one_step():
            return step(params, rparams, feats, caps, 1, key)

        times[("a2c", "step", label)] = cuda_ms(one_step, 5 if fused else 3)
        if fused:
            times[("a2c", "profile")] = profile_window(one_step, 3)
    return times


# ------------------------------------------------------------------------
# Phases 16-18: the sampling slice (the sampling kernel, sampled serving)
# ------------------------------------------------------------------------

def compare_sampling(weights: dict, inputs, params, dev) -> float:
    """Phase 16: the sampling kernel against its plain version under the
    near-tie rule, and temperature-0 requests against greedy (f32 weights).
    Returns the largest token difference outside the rows that part."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.api import Captioner
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import fused_greedy_decode
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
        fused_sample_decode, sample_decode_plain)

    worst = 0.0
    for wd, (gw, _) in weights.items():
        for n in (1, 1024):
            feats, start = inputs(n)
            report = []
            for i, (name, t, k, p) in enumerate(SAMPLE_VARIANTS):
                key = prng.PRNGKey(SEED + 70 + i)
                k_tok = fused_sample_decode(gw, feats, start, key, T, t, k, p)
                if not torch.equal(fused_sample_decode(gw, feats, start, key, T, t, k, p), k_tok):
                    raise AssertionError(f"two sampling calls differ ({name}, {wd}, N={n})")
                p_tok, margins = sample_decode_plain(gw, feats, start, key, T, t, k, p,
                                                     margins=True)
                if k_tok.shape != (n, T) or not bool((k_tok[:, 0] == START_ID).all()):
                    raise AssertionError("sampling kernel output has the wrong shape or start "
                                         "column")
                n_bad, gap, err = check_rows(
                    f"sample {name} {wd} N={n}", k_tok, p_tok,
                    lambda bad: margins[bad].gather(
                        1, first_divergent_step(k_tok[bad], p_tok[bad])[:, None].long())[:, 0],
                    SAMPLE_NEAR_TIE[wd])
                worst = max(worst, err)
                report.append(f"{name}: {n_bad} differ (margin there {gap:.3g}, smallest "
                              f"{float(margins.min()):.3g})")
            phase("sample", f"{str(wd)[6:]} N={n}: " + "; ".join(report)
                  + "; every variant's two calls bit-equal")
    feats, start = inputs(1000)
    cap = Captioner(params, net_cfg(), {i: f"w{i}" for i in range(V)}, device=dev,
                    weight_dtype=torch.float32)
    greedy = fused_greedy_decode(weights[torch.float32][0], feats, start, T).cpu().numpy()
    got = cap.sample_tokens(feats, temperature=0.0, num_samples=2)
    if not (np.array_equal(got[:, 0], greedy) and np.array_equal(got[:, 1], greedy)
            and np.array_equal(cap.sample_tokens(feats, temperature=0.0), greedy)):
        raise AssertionError("temperature-0 sampling differs from greedy")
    phase("sample", "f32 N=1000: temperature 0 (num_samples 1 and 2) equals the greedy kernel")
    return worst


def write_model_files(tmp: str, params: dict) -> tuple[str, str]:
    """A reference-layout a2c .pt and a vocab JSON in ``tmp``."""
    from image_captioning_through_rl_tpu_torch.models import a2c_to_state_dict

    model_pt = os.path.join(tmp, "a2cNetwork.pt")
    vocab_json = os.path.join(tmp, "coco2014_vocab.json")
    torch.save(a2c_to_state_dict(params), model_pt)
    words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
    with open(vocab_json, "w") as f:
        json.dump({"word_to_idx": {w: i for i, w in enumerate(words)}, "idx_to_word": words}, f)
    return model_pt, vocab_json


def sampling_main_path(params: dict) -> dict:
    """Phase 17: sampled requests through ``server.main`` and the port's
    client, each held to ``Captioner.sample_captions`` at the same seeds
    (chunk by chunk under ``seed + row offset`` past ``--max_batch``).
    Returns the kernels' launch counts during the run."""
    from image_captioning_through_rl_tpu_torch import server
    from image_captioning_through_rl_tpu_torch.client import CaptionClient
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import fused_beam_search
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, token_gate_table)
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import fused_sample_decode

    rng = np.random.default_rng(SEED + 80)
    cases = (  # rows, sample config, binary
        (4, {"temperature": 0.7, "top_k": 40, "seed": 1}, False),
        (4, {"top_p": 0.9, "num_samples": 3, "seed": 2}, False),
        (16, {"seed": 1}, True),
        (8, {"top_k": 40, "top_p": 0.9, "num_samples": 3, "seed": 2}, True),
        (100, {"temperature": 0.8, "top_k": 40, "seed": 3}, True),  # > --max_batch
    )
    with tempfile.TemporaryDirectory() as tmp:
        model_pt, vocab_json = write_model_files(tmp, params)
        for fn in (fused_greedy_decode, fused_beam_search, fused_sample_decode, token_gate_table):
            fn.launches = 0
        t0 = time.perf_counter()
        srv = server.main(["--model", model_pt, "--vocab", vocab_json, "--device", "cuda",
                           "--port", "0", "--max_batch", str(SERVE_BATCH), "--max_samples",
                           str(SERVE_MAX_SAMPLES), "--warmup_samples",
                           '{"top_k": 40, "num_samples": 3}'], block=False)
        try:
            client = CaptionClient(f"http://{srv.host}:{srv.port}", timeout=120)
            served = []
            for rows, sample, binary in cases:
                feats = rng.standard_normal((rows, F)).astype(np.float32)
                served.append((client.caption(feats, sample=sample, binary=binary), feats,
                               sample))
            launches = server.kernel_launches()
            seconds = time.perf_counter() - t0
            stats = client.stats()
            for bad in (dict(beam_size=BEAM, sample={"temperature": 1.0}),
                        dict(sample={"num_samples": SERVE_MAX_SAMPLES + 1})):
                for binary in (True, False):
                    try:
                        client.caption(served[0][1], binary=binary, **bad)
                    except urllib.error.HTTPError as e:
                        if e.code != 400:
                            raise
                    else:
                        raise AssertionError(f"request {bad} was answered, not refused with 400")
            cap = srv._cap
            for got, feats, sample in served:
                want = []
                for lo in range(0, len(feats), SERVE_BATCH):
                    want += cap.sample_captions(feats[lo:lo + SERVE_BATCH],
                                                **dict(sample, seed=sample["seed"] + lo))
                if got != want:
                    raise AssertionError(f"served sampled captions ({sample}) differ from "
                                         f"Captioner.sample_captions")
        finally:
            srv.stop()
    if (launches["fused_sample_decode"] < 1 or stats["errors"] != 0
            or stats["kernel_launches"] != launches):
        raise AssertionError(f"sampling main path: launches {launches}, stats {stats}")
    phase("serve_sample", f"server.main with --warmup_samples, {len(cases)} sampled requests "
                          f"(JSON and headers, num_samples 1 and 3, one of 100 rows past "
                          f"--max_batch {SERVE_BATCH}) in {seconds:.2f} s, each equal to "
                          f"Captioner.sample_captions; beam + sample and num_samples > "
                          f"{SERVE_MAX_SAMPLES} answered 400; {stats['requests']} requests, "
                          f"0 errors; launches during the run {launches}; e.g. "
                          f"{served[1][0][0]!r}")
    return launches


def kept_entries(gw, feats, start, key, t, k, p) -> int:
    """Phase 18: the (step, row, column) entries the filters keep over the
    plain sampled decode of these inputs (every column when unfiltered): the
    noise the kernel must hash, which the sampling bound counts. The plain
    version's loop (ops/fused_sample.sample_decode_plain), counting."""
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        lstm_cell_plain, round_to, wmatmul)
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
        _filters, filter_scaled_logits)
    from image_captioning_through_rl_tpu_torch.ops.linalg import matmul

    vocab = gw.emb.shape[0]
    kk, use_k, use_p = _filters(vocab, k, p)
    wd, emb = gw.dtype, gw.emb.to(torch.float32)
    temp = torch.tensor(float(t), dtype=torch.float32, device=feats.device)
    h = matmul(feats, gw.wc.to(torch.float32)) + gw.bc
    c = torch.zeros_like(h)
    tok, kept = start.long(), 0
    for sub in prng.sample_step_keys(key, T - 1):
        h, c = lstm_cell_plain(gw.w, gw.b, emb[tok], round_to(h, wd), c)
        logits = (wmatmul(round_to(h, wd), gw.wo) + gw.bo)[:, :vocab]
        scaled = filter_scaled_logits(logits / temp, kk, p, use_k, use_p)
        kept += int((scaled > -1e30).sum())
        noise = prng.gumbel_noise_plain(sub[None], scaled.shape, feats.device)[0]
        tok = torch.argmax(scaled + noise, dim=-1)
    return kept


SAMPLE_SHAPES = ("N=1024 unfiltered", "N=1024 top-k 40 + nucleus 0.9",
                 "N=64 R=4 top-k 40 + nucleus 0.9")


def time_sampling(gw, inputs) -> dict:
    """Phase 18: the sampling kernel (bf16 weights) at N = 1024, unfiltered
    and top-k 40 + nucleus 0.9, and at the served shape N = 64, R = 4 (256
    rows, top-k 40 + nucleus 0.9): the kernel's median and range of three
    runs, device time, launches a call and phase clock (time_decode), its
    plain version, and the noise entries the filters keep (the bound's
    count); the unfiltered case also with its noise hashed in phase B over
    each row instead of in the head's epilogue (the pick not kept); the
    wrapper's host microseconds a call; a torch.profiler window."""
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import PICK_FILTER, launch_decode
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
        fused_sample_decode, sample_decode_plain)

    feats, start = inputs(1024)
    served = feats[:64].repeat_interleave(4, dim=0).contiguous()
    key = prng.PRNGKey(SEED + 90)
    times = {}
    for label, f, (_, t, k, p) in zip(SAMPLE_SHAPES, (feats, feats, served),
                                      (SAMPLE_VARIANTS[0], SAMPLE_VARIANTS[3],
                                       SAMPLE_VARIANTS[3])):
        s = start[:f.shape[0]].contiguous()
        times[label] = time_decode(
            lambda: fused_sample_decode(gw, f, s, key, T, t, k, p),
            lambda c: fused_sample_decode(gw, f, s, key, T, t, k, p, clock=c))
        times[label].update(
            plain_ms=cuda_ms(lambda: sample_decode_plain(gw, f, s, key, T, t, k, p), 1),
            kept=kept_entries(gw, f, s, key, t, k, p), rows=f.shape[0],
            filters=int(k > 0) + int(p is not None))
    words = prng.key_words(key)
    times["N=1024 unfiltered, noise in phase B"] = time_decode(
        lambda: launch_decode(gw, feats, start, T, PICK_FILTER, 1.0, 0, None, words),
        lambda c: launch_decode(gw, feats, start, T, PICK_FILTER, 1.0, 0, None, words, c))
    _, t, k, p = SAMPLE_VARIANTS[3]
    times["host_us"] = host_us(lambda: fused_sample_decode(gw, feats, start, key, T, t, k, p))
    times["profile"] = profile_window(
        lambda: fused_sample_decode(gw, feats, start, key, T, t, k, p), 5)
    return times


# --------------------------------------------------------------------------
# Phase 19: the width faults repaired (any hidden width, any vocabulary, any
# widths the kernels pad)
# --------------------------------------------------------------------------

def wide_trainers(dev, tmp: str) -> dict:
    """Phase 19a: train_reward_network and train_policy_network on the card
    at hidden_dim = 1024 (whose chain slices shrink to 16 and 8 units), one
    epoch of 2 minibatches each, then one minibatch of each step fused vs
    plain. Returns the chain kernels' launches during the trainers' run."""
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain
    from image_captioning_through_rl_tpu_torch.train import loops, steps

    dims = {"hidden_dim": WIDE_H}
    data = synthetic_coco(SEED + 1, 2 * BATCH, BATCH)
    paths = {f"{k}_network": os.path.join(tmp, f"wide_{k}Network.pt")
             for k in ("reward", "policy")}
    counters = {"lstm_chain_fwd": (fused_lstm_chain, "fwd_launches"),
                "lstm_chain_bwd": (fused_lstm_chain, "bwd_launches"),
                "gru_chain_fwd": (fused_gru_chain, "fwd_launches"),
                "gru_chain_bwd": (fused_gru_chain, "bwd_launches")}
    kw = dict(epochs=1, batch_size=BATCH, seed=SEED, device=dev, net_dims=dims)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    nets = {"reward": loops.train_reward_network(data, paths, tmp, False, **kw),
            "policy": loops.train_policy_network(data, paths, tmp, False, **kw)}
    torch.cuda.synchronize()
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    if min(launches.values()) < 2:
        raise AssertionError(f"the wide trainers skipped a chain kernel: {launches}")
    if nets["policy"]["lstm"]["wh"].shape != (WIDE_H, 4 * WIDE_H):
        raise AssertionError("the policy was not trained at the asked width")
    cfg = loops._cfg_for(data, False, dims)
    feats = torch.from_numpy(data.train_features[data.train_image_idxs[:BATCH]]).to(dev)
    caps = torch.from_numpy(data.train_captions[:BATCH]).to(dev).long()
    caplens = steps.batch_caption_lens(caps)
    report = []
    for kind, loss_fn in (
            ("reward", lambda p, fused: (steps.reward_loss_fused if fused else
                                         steps.reward_loss)(p, cfg, feats, caps)),
            ("policy", lambda p, fused: (steps.policy_loss_fused if fused else
                                         steps.policy_loss)(p, cfg, feats, caps, caplens))):
        out = {}
        for fused in (True, False):
            p = {k: ({kk: vv.detach().clone().requires_grad_() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.detach().clone().requires_grad_())
                 for k, v in nets[kind].items()}
            loss = loss_fn(p, fused)
            names, ts = zip(*leaves(p))
            out[fused] = (float(loss.detach()), torch.autograd.grad(loss, ts), names)
        (lf, gf, names), (lp, gp, _) = out[True], out[False]
        rel = abs(lf - lp) / abs(lp)
        cos = min(float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))
                  for a, b in zip(gf, gp))
        if not (np.isfinite(lf) and rel <= STEP_LOSS_TOL and cos >= GRAD_COS):
            raise AssertionError(f"wide {kind} step: fused loss {lf} vs plain {lp} (relative "
                                 f"{rel:.3g}), smallest gradient cosine {cos}")
        report.append(f"{kind} loss {lf:.6f} vs plain {lp:.6f} (relative {rel:.2e}), "
                      f"smallest gradient cosine {cos:.6f}")
    phase("faults", f"trainers at hidden_dim={WIDE_H}, 2 minibatches of {BATCH} each: "
                    f"chain launches {launches}; " + "; ".join(report))
    return launches


def streamed_chains(dev) -> None:
    """Phase 19b: both chains at a width whose weights stream through the
    ring (H = E = 2048), small N and T, against their plain versions."""
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import gru_chain_plan
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import lstm_chain_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, plan in (("lstm", lstm_chain_plan), ("gru", gru_chain_plan)):
        if not all(plan(STREAM_N, STREAM_H, wd, sms, b)["stream"]
                   for wd in (torch.bfloat16, torch.float32) for b in (False, True)):
            raise AssertionError(f"{kind} chain at H={STREAM_H} does not stream")
        case = chain_case(kind, STREAM_T, dev, STREAM_N, STREAM_H)
        names = ["hs", *case[0], "embedding", "h0", "c0"]
        for wd in (torch.bfloat16, torch.float32):
            got = chain_run(kind, case, wd, None)
            torch.cuda.synchronize()
            want = chain_run(kind, case, wd, False)
            rels = []
            for name, a, b in zip(names, got, want):
                rel = float((a - b).norm() / b.norm())
                if (a.shape != b.shape or not bool(torch.isfinite(a).all())
                        or not rel <= CHAIN_TOL[wd]):
                    raise AssertionError(f"streamed {kind} chain {wd} {name}: relative error "
                                         f"{rel:.3g}")
                rels.append(rel)
            phase("faults", f"{kind} chain H=E={STREAM_H} (streamed weights) N={STREAM_N} "
                            f"T={STREAM_T} {str(wd)[6:]}: largest relative error {max(rels):.3g} "
                            f"(bound {CHAIN_TOL[wd]})")


def compare_beam(label: str, bw, feats, start, beam: int, wd) -> tuple[int, float, float]:
    """The beam kernel against its plain version under the near-tie rule,
    the scores of agreeing rows within SCORE_TOL, and two kernel calls
    bit-equal. Returns (rows that differ, smallest gap there, largest score
    error)."""
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
        beam_search_plain, fused_beam_search)

    n = feats.shape[0]
    k_tok, k_sc = fused_beam_search(bw, feats, start, T, beam)
    again = fused_beam_search(bw, feats, start, T, beam)
    torch.cuda.synchronize()
    if not (torch.equal(again[0], k_tok) and torch.equal(again[1], k_sc)):
        raise AssertionError(f"{label}: two beam kernel calls differ")
    p_tok, p_sc, margins = beam_search_plain(bw, feats, start, T, beam, margins=True)
    if k_tok.shape != (n, beam, T) or not bool(torch.isfinite(k_sc).all()):
        raise AssertionError(f"{label}: beam kernel output has the wrong shape or non-finite "
                             f"scores")
    n_bad, gap, _ = check_rows(label, k_tok, p_tok, lambda bad: margins[bad].min(dim=1).values)
    same = ~(k_tok != p_tok).reshape(n, -1).any(dim=1)
    err = float((k_sc - p_sc)[same].abs().max())
    if err > SCORE_TOL[wd]:
        raise AssertionError(f"{label}: beam scores differ by {err:.3g} > {SCORE_TOL[wd]}")
    return n_bad, gap, err


def padded_decodes(dev) -> None:
    """Phase 19c: greedy, beam and sampling at V = 1001, E = H = F = 500
    (weights padded by the wrappers), bf16 and f32, against their plain
    versions under the near-tie rules."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import prepare_beam_weights
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, greedy_decode_plain, prepare_greedy_weights)
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
        fused_sample_decode, sample_decode_plain)

    cfg = NetConfig(vocab_size=ODD_V, input_dim=ODD_W, wordvec_dim=ODD_W, hidden_dim=ODD_W,
                    max_seq_len=T)
    params = to_device(a2c.init(torch.Generator().manual_seed(SEED + 3), cfg), dev)
    gen = torch.Generator().manual_seed(SEED + 4)
    n = 256
    feats = torch.randn((n, ODD_W), generator=gen).to(dev)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    for wd in (torch.bfloat16, torch.float32):
        gw = prepare_greedy_weights(params["policy"], wd)
        if gw.widths != (ODD_W, ODD_W, ODD_W) or gw.wo.shape[1] != ODD_V + 1:
            raise AssertionError(f"the odd-width policy was not padded: {gw.widths}")
        bw = prepare_beam_weights(gw, params["value"])
        k_tok = fused_greedy_decode(gw, feats, start, T)
        torch.cuda.synchronize()
        p_tok, gaps = greedy_decode_plain(gw, feats, start, T, margins=True)
        g_bad, _, _ = check_rows(
            "padded greedy", k_tok, p_tok,
            lambda bad: gaps[bad].gather(
                1, first_divergent_step(k_tok[bad], p_tok[bad])[:, None].long())[:, 0])
        b_bad, _, _ = compare_beam("padded beam", bw, feats[:64], start[:64], BEAM, wd)
        key = prng.PRNGKey(SEED + 5)
        _, t, k, p = SAMPLE_VARIANTS[3]
        k_tok = fused_sample_decode(gw, feats, start, key, T, t, k, p)
        torch.cuda.synchronize()
        p_tok, margins = sample_decode_plain(gw, feats, start, key, T, t, k, p, margins=True)
        s_bad, _, _ = check_rows(
            "padded sample", k_tok, p_tok,
            lambda bad: margins[bad].gather(
                1, first_divergent_step(k_tok[bad], p_tok[bad])[:, None].long())[:, 0],
            SAMPLE_NEAR_TIE[wd])
        if int(k_tok.max()) >= ODD_V:
            raise AssertionError("a padded word was sampled")
        phase("faults", f"V={ODD_V} E=H=F={ODD_W} {str(wd)[6:]} (padded to {gw.wc.shape[0]}, "
                        f"head {gw.wo.shape[1]}): rows that differ at near-ties: greedy "
                        f"{g_bad}/{n}, beam {b_bad}/64, top-k 40 + nucleus 0.9 {s_bad}/{n}")


def wide_beam(dev) -> None:
    """Phase 19: the beam at hidden_dim = 1024, whose weights stream through
    the ring (no slice width gives every slice a block), bf16 and f32, beam
    5, against plain under phase 4's rules, at N = 512 rows as the wide
    rollouts: at this width most samples come within 1e-4 of a tie
    somewhere in their 16 steps, and the kernel and cuBLAS sum in other
    orders, so a few rows part at near-ties (on an H100 the same rows, with
    the same tokens, as with the per-step kernels this launch replaced); at
    N = 127 the 1% share would allow one row."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
        beam_plan, prepare_beam_weights)
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import prepare_greedy_weights

    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=WIDE_H, max_seq_len=T)
    params = to_device(a2c.init(torch.Generator().manual_seed(SEED + 6), cfg), dev)
    gen = torch.Generator().manual_seed(SEED + 7)
    n = 512
    feats = torch.randn((n, F), generator=gen).to(dev)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for wd in (torch.bfloat16, torch.float32):
        if not beam_plan(n, BEAM, F, WIDE_H, V, wd, sms)["stream"]:
            raise AssertionError(f"the beam at H = {WIDE_H} ({wd}) does not stream its weights")
        bw = prepare_beam_weights(prepare_greedy_weights(params["policy"], wd), params["value"])
        n_bad, gap, err = compare_beam(f"wide beam {str(wd)[6:]}", bw, feats, start, BEAM, wd)
        phase("faults", f"beam at hidden_dim={WIDE_H} (weights streamed) {str(wd)[6:]} N={n}: "
                        f"{n_bad} row(s) differ (smallest gap there {gap:.3g}); score max abs "
                        f"err {err:.3g} (tolerance {SCORE_TOL[wd]}); two calls bit-equal")


def wide_decodes(dev) -> None:
    """Phase 19: greedy and top-k 40 + nucleus 0.9 sampling at hidden_dim =
    1024, whose weights stream through the ring (no slice width gives every
    slice a block), bf16 and f32, against plain under the near-tie rules, at
    N = 512 rows as the wide beam (at this width more rows come within a
    near-tie somewhere in their 16 steps); two calls bit-equal."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        PICK_ARGMAX, PICK_FILTER, decode_plan, fused_greedy_decode, greedy_decode_plain,
        prepare_greedy_weights)
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
        fused_sample_decode, sample_decode_plain)

    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=WIDE_H, max_seq_len=T)
    policy = to_device(a2c.init(torch.Generator().manual_seed(SEED + 6), cfg)["policy"], dev)
    gen = torch.Generator().manual_seed(SEED + 7)
    n = 512
    feats = torch.randn((n, F), generator=gen).to(dev)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, t, k, p = SAMPLE_VARIANTS[3]
    key = prng.PRNGKey(SEED + 8)
    for wd in (torch.bfloat16, torch.float32):
        if not all(decode_plan(n, F, WIDE_H, V, pick, wd, sms)["stream"]
                   for pick in (PICK_ARGMAX, PICK_FILTER)):
            raise AssertionError(f"the decodes at H = {WIDE_H} ({wd}) do not stream")
        gw = prepare_greedy_weights(policy, wd)
        k_tok = fused_greedy_decode(gw, feats, start, T)
        s_tok = fused_sample_decode(gw, feats, start, key, T, t, k, p)
        if not (torch.equal(fused_greedy_decode(gw, feats, start, T), k_tok) and torch.equal(
                fused_sample_decode(gw, feats, start, key, T, t, k, p), s_tok)):
            raise AssertionError(f"two decodes at H = {WIDE_H} ({wd}) differ")
        p_tok, gaps = greedy_decode_plain(gw, feats, start, T, margins=True)
        g_bad, g_gap, _ = check_rows(
            f"greedy H={WIDE_H} {wd}", k_tok, p_tok,
            lambda bad: gaps[bad].gather(
                1, first_divergent_step(k_tok[bad], p_tok[bad])[:, None].long())[:, 0])
        p_tok, margins = sample_decode_plain(gw, feats, start, key, T, t, k, p, margins=True)
        s_bad, s_gap, _ = check_rows(
            f"sample H={WIDE_H} {wd}", s_tok, p_tok,
            lambda bad: margins[bad].gather(
                1, first_divergent_step(s_tok[bad], p_tok[bad])[:, None].long())[:, 0],
            SAMPLE_NEAR_TIE[wd])
        phase("faults", f"greedy and top-k 40 + nucleus 0.9 sampling at hidden_dim={WIDE_H} "
                        f"(weights streamed) {str(wd)[6:]} N={n}: {g_bad} and {s_bad} row(s) "
                        f"differ (smallest gap there {g_gap:.3g}, {s_gap:.3g}); two calls "
                        f"bit-equal")


def wide_vocab_sampling(dev) -> dict:
    """Phase 19d: sampling at V = 2000 (a filtered row walked in L2), COCO widths, top-k
    40 + nucleus 0.9, bf16 and f32, against the plain version under the
    near-tie rule; then its time at N = 1024 (bf16), kernel and plain."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import prepare_greedy_weights
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import (
        WARP_VOCAB, fused_sample_decode, sample_decode_plain)

    cfg = NetConfig(vocab_size=WIDE_V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=T)
    policy = to_device(a2c.init(torch.Generator().manual_seed(SEED + 6), cfg)["policy"], dev)
    gen = torch.Generator().manual_seed(SEED + 7)
    n = 1024
    feats = torch.randn((n, F), generator=gen).to(dev)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    _, t, k, p = SAMPLE_VARIANTS[3]
    key = prng.PRNGKey(SEED + 8)
    assert WIDE_V > WARP_VOCAB
    out = {}
    for wd in (torch.bfloat16, torch.float32):
        gw = prepare_greedy_weights(policy, wd)
        k_tok = fused_sample_decode(gw, feats, start, key, T, t, k, p)
        torch.cuda.synchronize()
        p_tok, margins = sample_decode_plain(gw, feats, start, key, T, t, k, p, margins=True)
        n_bad, gap, err = check_rows(
            f"sample V={WIDE_V} {wd}", k_tok, p_tok,
            lambda bad: margins[bad].gather(
                1, first_divergent_step(k_tok[bad], p_tok[bad])[:, None].long())[:, 0],
            SAMPLE_NEAR_TIE[wd])
        out[("err", wd)] = err
        phase("faults", f"sampling V={WIDE_V} {str(wd)[6:]} N={n}, top-k 40 + nucleus 0.9: "
                        f"{n_bad} row(s) differ (margin there {gap:.3g})")
        if wd == torch.bfloat16:
            out["ms"] = cuda_ms(lambda: fused_sample_decode(gw, feats, start, key, T, t, k, p), 20)
            out["plain_ms"] = cuda_ms(
                lambda: sample_decode_plain(gw, feats, start, key, T, t, k, p), 1)
    return out


def wide_rollouts(dev) -> None:
    """Phase 19e: the rollout forward and backward at hidden_dim = 1024
    (whose weights stream through the ring) with the trainer's N = 512 rows
    (each block walks all eight row tiles), and at V = 2000, bf16 and f32,
    reward stream fused in, against plain under phase 13's rules."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c, reward
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
    from image_captioning_through_rl_tpu_torch.ops import prng

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, width, vocab, steps in ((ROLLOUT_N, WIDE_H, V, 5), (128, H, WIDE_V, 8)):
        cfg = NetConfig(vocab_size=vocab, input_dim=width, wordvec_dim=width, hidden_dim=width,
                        max_seq_len=steps + 1)
        gen = torch.Generator().manual_seed(SEED + width + vocab)
        nets, rparams = to_device(a2c.init(gen, cfg), dev), to_device(reward.init(gen, cfg), dev)
        feats = torch.randn((n, width), generator=gen).to(dev)
        caps = torch.randint(4, vocab, (n, steps + 1), generator=gen).to(dev)
        caps[:, 0] = START_ID
        with torch.no_grad():
            states = fr.start_states(nets, cfg, feats, caps[:, 0])
        noise = prng.gumbel_noise(prng.split(prng.PRNGKey(SEED + 9), steps), (n, vocab), dev)
        teach = caps[:, 1:].t().to(torch.int32).contiguous()
        for wd in (torch.bfloat16, torch.float32):
            plan = fr.rollout_plan(n, width, width, -(-vocab // 8) * 8, wd, sms)
            rw = fr.prepare_reward_weights(rparams, feats, caps[:, 0], wd)
            w = fr.prepare_rollout_weights(nets, wd)
            args = (1, teach, noise, rw, feats, *states, w)
            k_val, k_logp, k_rew, tape = fr.rollout_forward_kernel(*args)
            torch.cuda.synchronize()
            p_val, p_logp, p_rew, p_tape, gaps = fr.rollout_forward_plain(*args, margins=True)
            differ = tape.act != p_tape.act
            first = differ.int().argmax(dim=0)
            n_bad, _, _ = check_rows(f"rollout {width}/{vocab} {wd}", tape.act.t(), p_tape.act.t(),
                                     lambda bad: gaps.gather(0, first[None])[0][bad])
            ok = ~differ.any(dim=0)
            err = max(float((a - b)[:, ok].abs().max()) for a, b in
                      ((k_val, p_val), (k_logp, p_logp), (k_rew, p_rew)))
            gen_d = torch.Generator().manual_seed(SEED + 41)
            dval, dlogp = (torch.randn((steps, n), generator=gen_d).to(dev) for _ in range(2))
            got = fr.rollout_backward_kernel(tape, feats, w, dval, dlogp)
            torch.cuda.synchronize()
            want = fr.rollout_backward_plain(tape, feats, w, dval, dlogp)
            rel = max(float((a - b).norm() / max(float(b.norm()), 1e-30)) for a, b in zip(got, want))
            if not (np.isfinite(err) and err <= ROLLOUT_TOL[wd] and rel <= CHAIN_TOL[wd]):
                raise AssertionError(f"rollout H={width} V={vocab} {wd}: forward max abs error "
                                     f"{err:.3g}, backward relative {rel:.3g}")
            phase("faults", f"rollout H=E=F={width} V={vocab} N={n} S={steps} {str(wd)[6:]} "
                            f"({'streamed' if plan['stream'] else 'stationary'} slices of "
                            f"{plan['columns']} columns, grid {plan['grid']}): {n_bad} row(s) "
                            f"differ at near-ties; forward max abs error {err:.3g} (bound "
                            f"{ROLLOUT_TOL[wd]}), backward largest relative {rel:.3g} (bound "
                            f"{CHAIN_TOL[wd]})")


def reward_stream_case(dev, wd, n: int, width: int, vocab: int, steps: int, seed: int):
    """Random reward-network weights of hidden, embedding and feature width
    ``width``, prepared for the stream, and ``[S, N]`` actions and tokens
    from a seed (half the tokens the action, as after the teacher's steps of
    a curriculum rollout): ``(weights, actions, tokens)``."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import reward
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    cfg = NetConfig(vocab_size=vocab, input_dim=width, wordvec_dim=width, hidden_dim=width,
                    max_seq_len=steps + 1)
    gen = torch.Generator().manual_seed(seed)
    rparams = to_device(reward.init(gen, cfg), dev)
    feats = torch.randn((n, width), generator=gen).to(dev)
    start = torch.full((n,), START_ID, dtype=torch.int32, device=dev)
    act = torch.randint(4, vocab, (steps, n), generator=gen, dtype=torch.int32)
    other = torch.randint(4, vocab, (steps, n), generator=gen, dtype=torch.int32)
    tok = torch.where(torch.rand((steps, n), generator=gen) < 0.5, act, other)
    rw = fr.prepare_reward_weights(rparams, feats, start, wd)
    return rw, act.to(dev).contiguous(), tok.to(dev).contiguous()


def wide_reward_streams(dev) -> None:
    """Phase 19f: the reward stream at hidden_dim = 1024 (N = 512, S = 16)
    and at V = 1001, E = H = F = 500 (padded to 504; N = 100, no whole row
    tile, S = 6), bf16 and f32, under phase 12's rules."""
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, width, vocab, steps in ((ROLLOUT_N, WIDE_H, V, S), (100, ODD_W, ODD_V, 6)):
        for wd in (torch.bfloat16, torch.float32):
            rw, act, tok = reward_stream_case(dev, wd, n, width, vocab, steps, SEED + width)
            hidden = rw.wh.shape[0]
            plan = fr.rollout_plan(n, hidden, hidden, 0, wd, sms, reward_only=True)
            _, msg = check_reward_stream(f"H={width} {wd}", rw, act, tok)
            phase("faults", f"reward stream H=E=F={width} (kernel width {hidden}) V={vocab} N={n} "
                            f"S={steps} {str(wd)[6:]} ({'streamed' if plan['stream'] else 'stationary'}"
                            f" slices of {plan['columns']} columns, grid {plan['grid']}): {msg}")


def eval_bundle(tmp: str):
    """Phase 20's bundle: phase 9's synthetic COCO-width bundle with a val
    split of EVAL_VAL captions, whose urls are file:// paths to small files
    written into ``tmp`` (each holds its image's index)."""
    from pathlib import Path

    data = synthetic_coco(SEED + 20, n_val=EVAL_VAL)
    images = Path(tmp) / "images"
    images.mkdir()
    urls = []
    for i in range(N_IMAGES):
        path = images / f"img{i}.jpg"
        path.write_bytes(f"image {i}\n".encode())
        urls.append(path.as_uri())
    urls = np.array(urls)
    return dataclasses.replace(data, train_urls=urls, val_urls=urls)


def eval_main_path(files: dict, tmp: str, dev, card: str) -> dict:
    """Phase 20: load_a2c_models on the card from phase 14's .pt files, a
    40504-draw test_a2c_network on the beam kernel (clean and Q13 dumps)
    held against the plain beam on the same bf16 weights, the scores of the
    kernel's dumps (native and pure Python) and post-processing with
    file:// images. Returns the kernels' launches during the clean kernel
    run and the times."""
    from image_captioning_through_rl_tpu_torch.data.coco import get_coco_batch
    from image_captioning_through_rl_tpu_torch.metrics import (
        calculate_a2c_network_score, load_textfiles, score)
    from image_captioning_through_rl_tpu_torch.metrics import native as native_metrics
    from image_captioning_through_rl_tpu_torch.metrics.postprocess import post_process_data
    from image_captioning_through_rl_tpu_torch.native import native_available
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
        beam_search_plain, fused_beam_search, prepare_beam_weights)
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, prepare_greedy_weights, token_gate_table)
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import fused_sample_decode
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt
    from image_captioning_through_rl_tpu_torch.train import loops

    data = eval_bundle(tmp)
    params, cfg = loops.load_a2c_models(files["a2c"], data, files, False, device=dev)
    want = ckpt.load_network("a2c", files["a2c"], "cpu")
    got, ref = list(leaves(params)), list(leaves(want))
    if ([n for n, _ in got] != [n for n, _ in ref]
            or any(t.device != dev or not torch.equal(t.cpu(), r) for (_, t), (_, r)
                   in zip(got, ref))):
        raise AssertionError("load_a2c_models does not give the a2c .pt's tree on the card")
    if (cfg.vocab_size, cfg.input_dim, cfg.hidden_dim) != (V, F, H):
        raise AssertionError(f"load_a2c_models: {cfg}")
    phase("eval", f"load_a2c_models on {dev}: {len(got)} tensors equal to {files['a2c']}'s")

    counters = (fused_beam_search, fused_greedy_decode, fused_sample_decode, token_gate_table)
    keys = ("real_captions_path", "generated_captions_path", "image_urls_path")

    def run(name: str, **kw) -> tuple[dict, float, dict]:
        d = os.path.join(tmp, name)
        os.makedirs(d)
        paths = {k: os.path.join(d, f"{k[:-5]}.txt") for k in keys}
        paths.update(best_score_file_path=os.path.join(d, "best_scores.txt"),
                     best_score_images_path=os.path.join(d, "best_images"),
                     results_path=os.path.join(d, "results.txt"))
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        loops.test_a2c_network(params, cfg, data, paths, EVAL_DRAWS, EVAL_VBS, seed=SEED,
                               eval_superbatch=EVAL_GROUP, device=dev, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return paths, seconds, {fn.__name__: fn.launches for fn in counters}

    def lines(paths: dict) -> dict:
        out = {}
        for k in keys:
            with open(paths[k]) as f:
                out[k] = f.read()
        return out

    # the Q9 walk: the draws test_a2c_network keeps, slice by slice (127 of
    # every 128), and the draws themselves with the bf16 weights it decodes with
    slices = [range(i, min(i + EVAL_VBS - 1, EVAL_DRAWS))
              for i in range(0, EVAL_DRAWS, EVAL_VBS)]
    rows = [r for s in slices for r in s]
    groups = -(-len(slices) // EVAL_GROUP)
    caps, feats, _ = get_coco_batch(data, batch_size=EVAL_DRAWS, split="val",
                                    rng=np.random.default_rng(SEED + 5))
    bw = prepare_beam_weights(prepare_greedy_weights(params["policy"], torch.bfloat16),
                              params["value"])
    kernel, k_s, launches = run("kernel")
    if launches != {"fused_beam_search": groups, "fused_greedy_decode": 0,
                    "fused_sample_decode": 0, "token_gate_table": 2}:
        raise AssertionError(f"eval launches {launches}, expected one beam kernel a group "
                             f"({groups}), the two x-gate tables and no other decode")
    plain, p_s, p_launches = run("plain", use_fused_kernel=False)
    if p_launches["fused_beam_search"] != 0:
        raise AssertionError(f"the plain eval launched the beam kernel: {p_launches}")
    compat, _, c_launches = run("compat", compat_dump=True)
    if c_launches["fused_beam_search"] != groups:
        raise AssertionError(f"the compat eval's launches {c_launches}")
    k_text, p_text, c_text = lines(kernel), lines(plain), lines(compat)

    # the plain route: real and url dumps byte-identical, generated lines
    # parted only at near-ties of the plain beam (phase 4's rule)
    for k in ("real_captions_path", "image_urls_path"):
        if k_text[k] != p_text[k]:
            raise AssertionError(f"eval {k}: the kernel's and the plain route's dumps differ")
    k_gen = k_text["generated_captions_path"].splitlines()
    p_gen = p_text["generated_captions_path"].splitlines()
    if len(k_gen) != len(rows) or len(p_gen) != len(rows):
        raise AssertionError(f"eval dumps hold {len(k_gen)} / {len(p_gen)} lines, expected "
                             f"{len(rows)}")
    parted = [i for i, (a, b) in enumerate(zip(k_gen, p_gen)) if a != b]
    gap = float("nan")
    if parted:
        if len(parted) > MAX_DIFF_SHARE * len(rows):
            raise AssertionError(f"eval: {len(parted)}/{len(rows)} generated lines differ "
                                 f"(more than {MAX_DIFF_SHARE:.0%})")
        at = [rows[i] for i in parted]
        _, _, margins = beam_search_plain(
            bw, torch.from_numpy(feats[at]).to(dev),
            torch.from_numpy(caps[at, 0].astype(np.int32)).to(dev), T, BEAM, margins=True)
        gaps = margins.min(dim=1).values
        if float(gaps.max()) >= NEAR_TIE:
            raise AssertionError(f"eval: a generated line differs where the plain beam's gap "
                                 f"{float(gaps.max()):.3g} is not a near-tie (< {NEAR_TIE})")
        gap = float(gaps.min())

    # the Q13 dump: each slice's lines joined with no trailing newline
    widths = [len(s) for s in slices]
    for k in keys:
        clean = k_text[k].splitlines()
        merged, off = [], 0
        for w in widths:
            merged.append("\n".join(clean[off: off + w]))
            off += w
        if c_text[k] != "".join(merged) or len(c_text[k].splitlines()) != len(rows) - len(
                slices) + 1:
            raise AssertionError(f"eval {k}: the compat dump is not the Q13 merge of the "
                                 f"clean one")

    # the beam kernel's device time a group, at the eval's group shape
    first = [r for s in slices[:EVAL_GROUP] for r in s]
    g_feats = torch.from_numpy(feats[first]).to(dev)
    g_start = torch.from_numpy(caps[first, 0].astype(np.int32)).to(dev)
    fused_beam_search(bw, g_feats, g_start, T, BEAM)
    torch.cuda.synchronize()
    ms, counts = device_profile(lambda: fused_beam_search(bw, g_feats, g_start, T, BEAM), 3,
                                lambda c: c.get("beam_kernel", 0) >= 3)
    if per_call(counts, 3).get("beam_kernel") != 1:
        raise AssertionError(f"eval group: beam launches per call {per_call(counts, 3)}")
    group_ms = ms["beam_kernel"] / 3

    # scores of the kernel's dumps: native, then pure Python on the same files
    if not native_available():
        raise AssertionError("the native fastmetrics library did not build or load")
    t0 = time.perf_counter()
    scores = calculate_a2c_network_score(kernel, kernel)
    score_s = time.perf_counter() - t0
    names = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]
    with open(kernel["results_path"]) as f:
        blocks = f.read().count("---------- results ----------")
    if list(scores) != names or not np.isfinite(list(scores.values())).all() or blocks != 2:
        raise AssertionError(f"eval scores {scores}, results blocks {blocks // 2}")
    ref_caps, hyp_caps = load_textfiles(kernel["real_captions_path"],
                                        kernel["generated_captions_path"])
    library = native_metrics.load_fastmetrics
    native_metrics.load_fastmetrics = lambda: None
    try:
        t0 = time.perf_counter()
        python = score(ref_caps, hyp_caps)
        python_s = time.perf_counter() - t0
    finally:
        native_metrics.load_fastmetrics = library
    rel = max(abs(python[k] - scores[k]) / max(abs(scores[k]), 1e-300) for k in names)
    if list(python) != names or rel > SCORE_RTOL:
        raise AssertionError(f"native scores {scores} vs pure Python {python}: relative "
                             f"{rel:.3g} > {SCORE_RTOL}")

    # post-processing: the best five lines and their images, copied from file://
    t0 = time.perf_counter()
    post_process_data(kernel)
    post_s = time.perf_counter() - t0
    with open(kernel["best_score_file_path"]) as f:
        best = f.read().splitlines()
    urls = k_text["image_urls_path"].splitlines()
    ranked = [(int(m.group(1)), float(m.group(2))) for m in
              (re.match(r"item_index\[(\d+)\] score:\[([-0-9.e]+)\]", line) for line in best)
              if m]
    copied = sorted(os.listdir(kernel["best_score_images_path"]))
    if (len(best) != 5 or len(ranked) != 5 or copied != sorted(f"{i}.jpg" for i, _ in ranked)
            or [s for _, s in ranked] != sorted((s for _, s in ranked), reverse=True)):
        raise AssertionError(f"post-processing: best_scores.txt {best}, images {copied}")
    for i, _ in ranked:
        with open(os.path.join(kernel["best_score_images_path"], f"{i}.jpg"), "rb") as a, \
                urllib.request.urlopen(urls[i - 1]) as b:
            if a.read() != b.read():
                raise AssertionError(f"post-processing: image {i} is not {urls[i - 1]}")

    host_s = k_s - groups * group_ms / 1e3
    phase("eval", f"test_a2c_network: {EVAL_DRAWS} draws, {len(slices)} slices, {len(rows)} "
                  f"lines in {groups} groups of {EVAL_GROUP * (EVAL_VBS - 1)} rows; launches "
                  f"{launches}; vs the plain beam (bf16): real and url dumps byte-identical, "
                  f"{len(parted)} generated line(s) differ (smallest gap there {gap:.3g}); the "
                  f"compat dump is the Q13 merge ({len(rows) - len(slices) + 1} lines); scores "
                  f"{ {k: round(v, 6) for k, v in scores.items()} }, native = pure Python "
                  f"(largest relative difference {rel:.3g}, bound {SCORE_RTOL}); best five "
                  f"{[i for i, _ in ranked]} copied from file://")
    phase("timing", f"{card} | eval, {EVAL_DRAWS} draws, bf16 weights: test_a2c_network "
                    f"{k_s:.3f} s on the beam kernel, {p_s:.3f} s plain; beam_kernel device "
                    f"{group_ms:.4f} ms a group of {len(first)} rows (torch.profiler), "
                    f"{groups} groups {groups * group_ms / 1e3:.3f} s; host around the "
                    f"decode {host_s:.3f} s; calculate_a2c_network_score {score_s:.3f} s "
                    f"(native; pure Python {python_s:.3f} s); post_process_data "
                    f"{post_s:.3f} s ({len(rows)} lines)")
    return {"launches": launches}


def cli_bundle(tmp: str) -> tuple[str, dict]:
    """Phase 21, first part: a synthetic bundle of COCO-2014's full size
    written through the port's make_synthetic_coco, read back through
    load_data and held, field for field and dtype for dtype, against the
    generator's arrays (the same seed, drawn again). Returns the bundle's
    directory and its write and read times."""
    from image_captioning_through_rl_tpu_torch.data.coco import caption_lengths, load_data
    from image_captioning_through_rl_tpu_torch.data.synthetic import (
        make_synthetic_coco, make_vocab, random_captions)

    bundle = os.path.join(tmp, "bundle")
    seed = SEED + 21
    t0 = time.perf_counter()
    make_synthetic_coco(bundle, CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_CAPTIONS_PER_IMAGE, V, F,
                        T, seed=seed)
    write_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle)
             if f.endswith(".h5")) / 1e6
    t0 = time.perf_counter()
    data = load_data(bundle)
    read_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)  # make_synthetic_coco's draws, in its order
    k = CLI_CAPTIONS_PER_IMAGE
    caps = {s: random_captions(rng, n * k, V, T)
            for s, n in (("train", CLI_TRAIN_IMAGES), ("val", CLI_VAL_IMAGES))}
    feats = {s: rng.standard_normal((n, F)).astype(np.float32)
             for s, n in (("train", CLI_TRAIN_IMAGES), ("val", CLI_VAL_IMAGES))}
    word_to_idx, words = make_vocab(V)
    want = {}
    for s, n in (("train", CLI_TRAIN_IMAGES), ("val", CLI_VAL_IMAGES)):
        want.update({f"{s}_captions": caps[s], f"{s}_features": feats[s],
                     f"{s}_image_idxs": np.repeat(np.arange(n), k).astype(np.int32),
                     f"{s}_captions_lens": caption_lengths(caps[s]),
                     f"{s}_urls": np.asarray([f"http://example.com/{s}/{i}.jpg"
                                              for i in range(n)])})
    for name, w in want.items():
        got = getattr(data, name)
        if got.dtype != w.dtype or got.shape != w.shape or not np.array_equal(got, w):
            raise AssertionError(f"load_data: {name} is {got.dtype} {got.shape}, the generator "
                                 f"wrote {w.dtype} {w.shape} (or other values)")
    if data.word_to_idx != word_to_idx or data.idx_to_word != dict(enumerate(words)):
        raise AssertionError("load_data: the vocabulary differs from the generator's")
    phase("cli", f"bundle of {CLI_TRAIN_IMAGES} + {CLI_VAL_IMAGES} images x {k} captions, "
                 f"V={V} F={F} T={T}: {mb:.1f} MB of h5 written in {write_s:.3f} s, read "
                 f"through load_data in {read_s:.3f} s ({mb / read_s:.0f} MB/s); every field "
                 f"equal to the generator's arrays, dtype for dtype")
    return bundle, {"write_s": write_s, "read_s": read_s, "mb": mb}


def cli_main_path(dev, card: str) -> dict:
    """Phase 21: the CLI's main path on the card, in a temporary working
    directory (the CLI writes logs/ under it): the full-size bundle, a
    --retrain training run through cli.main.main (the three pretrainers and
    A2C on the card, 4 minibatches of 512 each), then a --test_model
    evaluation of the a2c .ckpt it wrote at 40504 draws. Returns the
    kernels' launches in each run."""
    import ast
    import contextlib
    import importlib

    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr
    from image_captioning_through_rl_tpu_torch.ops import prng
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import fused_beam_search
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, token_gate_table)
    from image_captioning_through_rl_tpu_torch.ops.fused_gru import fused_gru_chain
    from image_captioning_through_rl_tpu_torch.ops.fused_lstm import fused_lstm_chain
    from image_captioning_through_rl_tpu_torch.train import checkpoint as ckpt

    cli = importlib.import_module("image_captioning_through_rl_tpu_torch.cli.main")
    counters = {"gru_chain_fwd": (fused_gru_chain, "fwd_launches"),
                "gru_chain_bwd": (fused_gru_chain, "bwd_launches"),
                "lstm_chain_fwd": (fused_lstm_chain, "fwd_launches"),
                "lstm_chain_bwd": (fused_lstm_chain, "bwd_launches"),
                "greedy_decode": (fused_greedy_decode, "launches"),
                "rollout_fwd": (fr.fused_rollout, "fwd_launches"),
                "rollout_bwd": (fr.fused_rollout, "bwd_launches"),
                "threefry_gumbel": (prng.gumbel_noise, "launches"),
                "reward_stream": (fr.fused_reward_stream, "launches"),
                "beam_search": (fused_beam_search, "launches"),
                "token_gates": (token_gate_table, "launches")}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        bundle, io_times = cli_bundle(tmp)
        pre = os.path.join(tmp, "pretrained")
        log_path = os.path.join(tmp, "cli.log")

        def run(argv: list) -> tuple[dict, dict, float]:
            """cli.main.main on ``argv`` with its output in cli.log; the
            launches during the run."""
            args = cli.parse_args_with_config(cli.build_arg_parser(), argv)
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            t0 = time.perf_counter()
            try:
                with open(log_path, "a") as log, contextlib.redirect_stdout(log):
                    out = cli.main(args)
                torch.cuda.synchronize()
            except BaseException:
                with open(log_path) as log:
                    print("".join(log.readlines()[-40:]), flush=True)
                raise
            seconds = time.perf_counter() - t0
            return out, {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}, seconds

        def score_blocks(path: str) -> list:
            with open(path) as f:
                blocks = f.read().split("---------- results ----------")
            scores = [ast.literal_eval(b.strip()) for b in blocks if b.strip().startswith("{")]
            for sc in scores:
                if len(sc) != 7 or not all(np.isfinite(list(sc.values()))):
                    raise AssertionError(f"results.txt: a block of scores {sc}")
            return scores

        os.chdir(tmp)
        try:
            np.random.seed(SEED)  # the --training_size draw (numpy's global generator)
            train, train_launches, train_s = run(
                ["--data_dir", bundle, "--training_size", str(CLI_TRAINING_SIZE), "--epochs", "1",
                 "--batch_size", str(BATCH), "--test_size", str(CLI_TEST_SIZE), "--retrain",
                 "--pretrained_path", pre, "--seed", str(SEED), "--device", "cuda"])
            log_dir = os.path.join(tmp, train["log_dir"])
            files = set(os.listdir(log_dir))
            if files != CLI_ARTIFACTS:
                raise AssertionError(f"the training run wrote {sorted(files)}, not "
                                     f"{sorted(CLI_ARTIFACTS)}")
            with open(os.path.join(log_dir, "metrics.jsonl")) as f:
                log = [json.loads(line) for line in f]
            minibatches = CLI_TRAINING_SIZE // BATCH
            counts = {}
            for rec in log:
                counts[rec["tag"]] = counts.get(rec["tag"], 0) + 1
            want = {"Reward Network-loss": 50 * minibatches, "Policy Network-loss":
                    100 * minibatches, "Value Network-loss": 50 * minibatches,
                    "A2C Network-episodic-loss": minibatches}
            if (any(counts.get(k) != v for k, v in want.items())
                    or not np.isfinite([r["value"] for r in log]).all()):
                raise AssertionError(f"metrics.jsonl: {counts} (want {want}), finite "
                                     f"{np.isfinite([r['value'] for r in log]).all()}")
            if len(score_blocks(os.path.join(log_dir, "results.txt"))) != 1:
                raise AssertionError("results.txt of the training run holds no single block")
            groups = -(-(-(-CLI_TEST_SIZE // EVAL_VBS)) // EVAL_GROUP)
            steps_run = {"gru_chain_fwd": 50 * minibatches, "gru_chain_bwd": 50 * minibatches,
                         "rollout_fwd": minibatches, "rollout_bwd": minibatches,
                         "threefry_gumbel": minibatches, "beam_search": groups}
            if (any(train_launches[k] != v for k, v in steps_run.items())
                    or min(train_launches[k] for k in ("lstm_chain_fwd", "lstm_chain_bwd",
                                                       "greedy_decode", "token_gates")) < 1):
                raise AssertionError(f"the training run's launches {train_launches}, expected "
                                     f"{steps_run} and the LSTM chain, greedy and the x-gate "
                                     f"tables launched")
            # every .ckpt the run wrote reads back bit-equal: the a2c files to
            # the parameters main returned, the pretrainers' Q12 files to the
            # tensors they hold (loaded, then written again to the same bytes)
            for path in (os.path.join(log_dir, "a2cNetwork.ckpt"),
                         os.path.join(pre, "a2cNetwork.ckpt")):
                back = dict(leaves(ckpt.load_network("a2c", path, dev, train["cfg"])))
                params = dict(leaves(train["params"]))
                if sorted(back) != sorted(params) or any(
                        not torch.equal(back[k], params[k].detach()) for k in params):
                    raise AssertionError(f"{path} does not read back to the trained parameters")
            for kind in ("reward", "policy", "value"):
                path = os.path.join(pre, f"{kind}Network.ckpt")
                again = os.path.join(tmp, f"{kind}.again")
                ckpt.save_pytree(ckpt.load_network(kind, path, dev, train["cfg"]), again)
                with open(path, "rb") as a, open(again, "rb") as b:
                    if a.read() != b.read():
                        raise AssertionError(f"{path} does not read back bit-equal")
            stages = train["seconds"]
            phase("cli", f"training run (--retrain, --training_size {CLI_TRAINING_SIZE}: "
                         f"{minibatches} minibatches of {BATCH} x 50 / 100 / 50 pretraining "
                         f"epochs, 1 A2C epoch; --test_size {CLI_TEST_SIZE}) in {train_s:.1f} s; "
                         f"artifacts {sorted(files)}; {len(log)} finite losses logged; seven "
                         f"finite scores; launches {train_launches}; the four .ckpt files read "
                         f"back bit-equal")

            ev, eval_launches, eval_s = run(
                ["--data_dir", bundle, "--test_model", os.path.join(log_dir, "a2cNetwork.ckpt"),
                 "--test_size", str(EVAL_DRAWS), "--pretrained_path", pre, "--seed", str(SEED),
                 "--device", "cuda"])
            eval_groups = -(-(-(-EVAL_DRAWS // EVAL_VBS)) // EVAL_GROUP)
            if (os.path.join(tmp, ev["log_dir"]) != log_dir
                    or set(os.listdir(log_dir)) != CLI_ARTIFACTS | {"eval_config.json"}
                    or len(score_blocks(os.path.join(log_dir, "results.txt"))) != 2):
                raise AssertionError(f"the evaluation run: log dir {ev['log_dir']}, files "
                                     f"{sorted(os.listdir(log_dir))}")
            if (eval_launches["beam_search"] != eval_groups
                    or any(v for k, v in eval_launches.items()
                           if k not in ("beam_search", "token_gates"))):
                raise AssertionError(f"the evaluation run's launches {eval_launches}, expected "
                                     f"one beam kernel a group ({eval_groups}) and no other "
                                     f"kernel but the x-gate tables")
            phase("cli", f"evaluation run (--test_model {ev['log_dir']}/a2cNetwork.ckpt, "
                         f"--test_size {EVAL_DRAWS}) in {eval_s:.1f} s: eval_config.json "
                         f"written, a second block of seven finite scores; launches "
                         f"{eval_launches}")
        finally:
            os.chdir(cwd)
    phase("timing", f"{card} | CLI at COCO width: bundle write {io_times['write_s']:.3f} s, "
                    f"read {io_times['read_s']:.3f} s ({io_times['mb'] / io_times['read_s']:.0f} "
                    f"MB/s) | training run {train_s:.3f} s: " + ", ".join(
                        f"{k} {v:.3f} s" for k, v in stages.items())
          + f" | evaluation run {eval_s:.3f} s: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in ev["seconds"].items()))
    return {"train": train_launches, "eval": eval_launches}


def host_us(fn, iters: int = 200) -> float:
    """Phase 6: the host's microseconds a call of ``fn`` (back-to-back calls
    that queue faster than the card runs them: the host side alone)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def table_device_ms(emb: torch.Tensor, w: torch.Tensor, iters: int = 10) -> float:
    """Phase 6: the x-gate table's device time per call through its wrapper
    (torch.profiler), beside the CUDA-event time of back-to-back calls."""
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import token_gate_table

    token_gate_table(emb, w)
    torch.cuda.synchronize()
    ms, counts = device_profile(lambda: token_gate_table(emb, w), iters,
                                lambda c: c.get("wgmma_gemm_kernel", 0) >= iters)
    if per_call(counts, iters).get("wgmma_gemm_kernel") != 1:
        raise AssertionError(f"the bf16 table ran {counts}, not wgmma_gemm_kernel once a call")
    return sum(ms.values()) / iters


def work(nbytes: float, flops: float, peak: float = H100_BF16,
         scalar_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: the
    bytes that must move (each input read once, each output written once)
    over the memory rate, or the operations: ``flops`` over ``peak`` plus
    ``scalar_ops`` over the float32 rate outside the tensor cores (NVIDIA's
    H100 SXM data sheet, dense)."""
    t_bytes, t_ops = nbytes / H100_BYTES, flops / peak + scalar_ops / H100_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def decode_work(n: int, scalar_ops: float = 0.0) -> tuple[float, str]:
    """The greedy decode's bound at N = n (bf16, COCO width): its bytes (the
    features, the weights, the x-gate table's inputs, the tokens) and its
    products (h0, the x-gate table, per step the cell's h @ wh and the head),
    with ``scalar_ops`` more at the float32 rate (sampling's pick)."""
    bw, fw, g4 = 2, 4, 4 * H
    lstm_w = (V * E + (E + H) * g4) * bw + g4 * fw
    head_w = H * V * bw + V * fw
    return work(n * F * fw + F * H * bw + lstm_w + head_w + n * T * 4,
                2 * n * F * H + 2 * V * E * g4 + (T - 1) * (2 * n * H * g4 + 2 * n * H * V),
                scalar_ops=scalar_ops)


def sample_work(n: int, filters: int, kept: int) -> tuple[float, str]:
    """The sampling decode's bound at N = n rows: greedy's bytes and products
    (decode_work), and the scalar work the function needs on these inputs:
    per step and element the division by t and, with a filter on, the key
    (3 operations) and one select pass per filter; for each of the ``kept``
    (step, row, column) entries the filters keep (every column when
    unfiltered) the hash and Gumbel map (126, as threefry_gumbel), the noise
    add and the argmax compare."""
    per_element = 1 + (3 + filters if filters else 0)
    return decode_work(n, (T - 1) * n * V * per_element + kept * (126 + 2))


def bounds() -> dict:
    """Each kernel's bound at the shapes its time was taken at (bf16 weights,
    float32 activations), counted from the shapes and the code: the products
    each kernel must do (the x-gate tables counted once, the cells' input
    products as table rows), and its inputs, outputs and tape."""
    bw, fw = 2, 4  # bytes of a bf16 weight, of a float32 value
    g4, g3 = 4 * H, 3 * H
    lstm_w = (V * E + (E + H) * g4) * bw + g4 * fw
    head_w = H * V * bw + V * fw
    out = {}
    steps = T - 1
    out["greedy_decode"] = decode_work(1024)
    n = 127  # beam-5, N = 127: policy cells and heads of N B beams, the critic's
    # h @ wh once per parent and its MLP for every one of the B^2 candidates
    nb = n * BEAM
    out["beam_search"] = work(
        n * F * fw + F * H * bw + 2 * lstm_w + head_w + ((F + H) * H + H) * bw
        + nb * (T + 1) * 4,
        2 * n * F * H * 2 + 2 * 2 * V * E * g4
        + steps * (2 * nb * H * g4 * 2 + 2 * nb * H * V + 2 * nb * BEAM * H * H))
    out["token_gates"] = work((V * E + E * g4) * bw + V * g4 * fw, 2 * V * E * g4)
    n = CHAIN_N
    for kind, g, steps, tape in (("lstm", g4, 16, 2 * H + g4), ("gru", g3, 17, 2 * H + g3)):
        wts = (V * E + (E + H) * g) * bw + 2 * g * fw
        out[f"{kind}_chain_fwd"] = work(wts + n * steps * 4 + 2 * n * H * fw
                                        + steps * n * tape * fw,
                                        2 * V * E * g + steps * 2 * n * H * g)
        out[f"{kind}_chain_bwd"] = work(
            wts + n * steps * 4 + steps * n * (tape + H) * fw + (V * E + (E + H) * g + g) * fw
            + 2 * n * H * fw,
            steps * 2 * n * (g * H + (E + H) * g + g * E))
    n, el = ROLLOUT_N, S * ROLLOUT_N * V
    # the hash and the Gumbel map: 118 integer operations (20 rounds of add,
    # rotate and xor, five key injections) and 8 more (each logf counted as
    # one), at the non-tensor float32 rate
    out["threefry_gumbel"] = work(el * fw, el * 126, H100_F32)
    reward_w = (H * g3 + H * H) * bw + (V * g3 + g3 + H) * fw
    reward_step = 2 * n * H * g3 + 2 * n * H * H + 4 * n * H
    out["reward_stream"] = work(reward_w + 2 * n * H * fw + 3 * S * n * 4, S * reward_step)
    policy_value_w = 2 * lstm_w + head_w + ((F + H) * H + H) * bw
    tape = (5 * S * n * H + 2 * (S - 1) * n * g4) * fw
    out["rollout_fwd"] = work(
        el * fw + n * F * fw + S * n * 4 + policy_value_w + reward_w + 5 * S * n * 4 + tape,
        2 * 2 * V * E * g4 + 2 * n * F * H
        + S * (2 * n * H * V + 2 * n * H * H + 2 * n * H + reward_step)
        + (S - 1) * 2 * 2 * n * H * g4)
    grads = (2 * (V * E + (E + H) * g4 + g4) + H * V + V + (F + H) * H + 2 * H + 1) * fw
    out["rollout_bwd"] = work(
        tape + 4 * S * n * 4 + n * F * fw + policy_value_w + grads + (n * F + 4 * n * H) * fw,
        3 * 2 * S * n * H * V + 2 * 2 * S * n * (F + H) * H
        + 2 * (S - 1) * 2 * n * (g4 * H + (E + H) * g4 + g4 * E))
    return out


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA "
              "device", file=sys.stderr)
        return 1
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
                    f"{torch.cuda.device_count()} device(s)")
    sys.path.insert(0, ROOT)
    from image_captioning_through_rl_tpu_torch import START_ID, server
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c
    from image_captioning_through_rl_tpu_torch.ops import kernel_build
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
        beam_search_plain, fused_beam_search, prepare_beam_weights)
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, greedy_decode_plain, prepare_greedy_weights, token_gate_table,
        token_gate_table_plain)
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import fused_sample_decode

    # phase 2: build
    t0 = time.perf_counter()
    lib = kernel_build.build()
    kernel_build.load_library()
    phase("build", f"{os.path.relpath(lib, ROOT)} ready in {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda", 0)
    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=T)
    gen = torch.Generator().manual_seed(SEED)
    params = a2c.init(gen, cfg)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev)

    params_dev = to_dev(params)
    weights = {}
    for wd in (torch.bfloat16, torch.float32):
        gw = prepare_greedy_weights(params_dev["policy"], wd)
        weights[wd] = (gw, prepare_beam_weights(gw, params_dev["value"]))

    def inputs(n: int):
        feats = torch.randn((n, F), generator=gen).to(dev)
        return feats, torch.full((n,), START_ID, dtype=torch.int32, device=dev)

    # phase 3a: the x-gate tables (emb @ wi (+ b)) that every recurrent kernel
    # reads: both decode kernels' [V, 4H], and a GRU's [V, 3H] with its bias
    # added in the product's epilogue (wgmma for bf16 weights)
    table_err = 0.0
    tab_gen = torch.Generator().manual_seed(SEED + 9)
    gru_w = torch.randn((E + H, 3 * H), generator=tab_gen).to(dev) * 0.05
    gru_b = torch.randn((3 * H,), generator=tab_gen).to(dev)
    for wd, (gw, bw) in weights.items():
        for name, (emb, w, b) in (("policy", (gw.emb, gw.w, None)),
                                  ("value", (bw.value.emb, bw.value.w, None)),
                                  ("gru", (gw.emb, gru_w.to(wd), gru_b))):
            k_tab = token_gate_table(emb, w, b)
            torch.cuda.synchronize()
            err = float((k_tab - token_gate_table_plain(emb, w, b)).abs().max())
            if k_tab.shape != (V, w.shape[1]) or not err <= TABLE_TOL:
                raise AssertionError(f"token gate table ({name}, {wd}) differs by {err:.3g}")
            table_err = max(table_err, err)
            phase("token_gates", f"{str(wd)[6:]} {name} [V, {w.shape[1] // H}H]"
                                 f"{' + b' if b is not None else ''}: max abs err {err:.3g} "
                                 f"(tolerance {TABLE_TOL})")

    # phase 3b: greedy kernel vs plain
    greedy_err = 0.0
    for wd, (gw, _) in weights.items():
        for n in (1, 4, 1000, 1024):
            feats, start = inputs(n)
            k_tok = fused_greedy_decode(gw, feats, start, T)
            if not torch.equal(fused_greedy_decode(gw, feats, start, T), k_tok):
                raise AssertionError(f"two greedy calls differ ({wd}, N={n})")
            p_tok, gaps = greedy_decode_plain(gw, feats, start, T, margins=True)
            if k_tok.shape != (n, T) or not bool((k_tok[:, 0] == START_ID).all()):
                raise AssertionError("greedy kernel output has the wrong shape or start column")
            n_bad, gap, err = check_rows(
                "greedy", k_tok, p_tok,
                lambda bad: gaps[bad].gather(
                    1, first_divergent_step(k_tok[bad], p_tok[bad])[:, None].long())[:, 0])
            greedy_err = max(greedy_err, err)
            phase("greedy", f"{str(wd)[6:]} N={n}: {n_bad} row(s) differ "
                            f"(smallest gap there {gap:.3g}; smallest gap overall "
                            f"{float(gaps.min()):.3g}); two calls bit-equal")

    # phase 4: beam kernel vs plain; B in {1, 2, 8} at small N, and N = 77
    # (385 and 1925 rows: no whole row tile)
    beam_err = 0.0
    for wd, (_, bw) in weights.items():
        for n, beam in ((127, BEAM), (1024, BEAM), (3, 1), (37, 2), (13, 8), (77, BEAM)):
            feats, start = inputs(n)
            n_bad, gap, err = compare_beam("beam", bw, feats, start, beam, wd)
            beam_err = max(beam_err, err)
            phase("beam", f"{str(wd)[6:]} N={n} B={beam}: {n_bad} row(s) differ (smallest gap "
                          f"there {gap:.3g}); score max abs err {err:.3g} (tolerance "
                          f"{SCORE_TOL[wd]}); two calls bit-equal")

    # phase 5: the main path, through the server's entry point
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        model_pt, vocab_json = write_model_files(tmp, params)
        for fn in (fused_greedy_decode, fused_beam_search, fused_sample_decode, token_gate_table):
            fn.launches = 0
        srv = server.main(["--model", model_pt, "--vocab", vocab_json, "--device", "cuda",
                           "--port", "0", "--warmup_beams", "0", str(BEAM)], block=False)
        try:
            url = f"http://{srv.host}:{srv.port}/caption"

            def post(body: bytes, headers: dict) -> list:
                req = urllib.request.Request(url, data=body, headers=headers)
                with urllib.request.urlopen(req, timeout=120) as r:
                    if r.status != 200:
                        raise AssertionError(f"HTTP {r.status}")
                    return json.loads(r.read())["captions"]

            f_json = rng.standard_normal((4, F)).astype(np.float32)
            f_bin = rng.standard_normal((64, F)).astype(np.float32)
            f_beam = rng.standard_normal((8, F)).astype(np.float32)
            got_json = post(json.dumps({"features": f_json.tolist()}).encode(),
                            {"Content-Type": "application/json"})
            got_bin = post(f_bin.astype("<f4").tobytes(),
                           {"Content-Type": "application/octet-stream"})
            got_beam = post(json.dumps({"features": f_beam.tolist(),
                                        "beam_size": BEAM}).encode(),
                            {"Content-Type": "application/json"})
            launches = server.kernel_launches()
            with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/stats",
                                        timeout=30) as r:
                stats = json.loads(r.read())
            with urllib.request.urlopen(f"http://{srv.host}:{srv.port}/healthz",
                                        timeout=30) as r:
                health = json.loads(r.read())
            cap = srv._cap
            for got, feats, beam in ((got_json, f_json, 0), (got_bin, f_bin, 0),
                                     (got_beam, f_beam, BEAM)):
                want = cap.caption(feats, beam_size=beam)
                if got != want:
                    raise AssertionError(f"served captions (beam {beam}) differ from "
                                         f"Captioner.caption")
                if not all(c.startswith("<START>") for c in got):
                    raise AssertionError("a served caption does not start with <START>")
        finally:
            srv.stop()
    if min(v for k, v in launches.items() if k != "fused_sample_decode") < 1:
        raise AssertionError(f"the main path skipped a kernel: launches {launches}")
    if (health.get("platform") != "cuda" or stats["errors"] != 0
            or stats["kernel_launches"] != launches):
        raise AssertionError(f"server health {health}, stats {stats}")
    phase("serve", f"{stats['requests']} requests, {stats['captions']} captions, "
                   f"{stats['batches']} batches, 0 errors; launches during the run "
                   f"{launches}; /healthz {health}; e.g. {got_beam[0]!r}")

    # phase 6: timings (CUDA events over back-to-back calls, bf16 serving weights)
    gw, bw = weights[torch.bfloat16]
    tab_ms = cuda_ms(lambda: token_gate_table(gw.emb, gw.w), 20)
    tab_device = table_device_ms(gw.emb, gw.w)
    tab_plain = cuda_ms(lambda: token_gate_table_plain(gw.emb, gw.w), 20)
    # the library call that computes the table's function
    tab_library = cuda_ms(lambda: torch.mm(gw.emb, gw.w[:E], out_dtype=torch.float32), 20)
    tab_host = (host_us(lambda: token_gate_table(gw.emb, gw.w)),
                host_us(lambda: torch.mm(gw.emb, gw.w[:E], out_dtype=torch.float32)))
    feats, start = inputs(1024)
    tg = time_greedy(gw, feats, start)
    times, beam_prof = {}, {}
    for n in (127, 1024):
        f_n, s_n = feats[:n].contiguous(), start[:n].contiguous()
        runs = sorted(cuda_ms(lambda: fused_beam_search(bw, f_n, s_n, T, BEAM), 5)
                      for _ in range(3))
        times[n] = (runs[1], cuda_ms(lambda: beam_search_plain(bw, f_n, s_n, T, BEAM), 5),
                    runs[0], runs[-1])
        beam_prof[n] = (beam_profile(lambda: fused_beam_search(bw, f_n, s_n, T, BEAM)),
                        beam_phases(bw, f_n, s_n))
    phase("timing", f"{card} | bf16 weights | token gate table [1004, 2048]: kernel "
                    f"{tab_ms:.4f} ms (device {tab_device:.4f} ms a call), plain "
                    f"{tab_plain:.3f} ms, library (torch.mm) {tab_library:.4f} ms (kernel / "
                    f"library {tab_ms / tab_library:.2f}); host us a call: wrapper "
                    f"{tab_host[0]:.1f}, torch.mm {tab_host[1]:.1f} | greedy N=1024: kernel "
                    f"{tg[1024]['ms']:.4f} ms, plain {tg['plain_ms']:.3f} ms, host us a call "
                    f"{tg['host_us']:.1f} | " + " | ".join(
                        f"beam-5 N={n}: kernel {times[n][0]:.3f} ms (median of 3, "
                        f"{times[n][2]:.3f}-{times[n][3]:.3f}), plain {times[n][1]:.3f} ms"
                        for n in (127, 1024)))
    for n in (1024, 64, 4):
        phase("profile", f"{card} | " + decode_line(f"greedy N={n}, bf16", tg[n])
              + " | bound {:.4f} ms ({})".format(*decode_work(n)))
    for n in (127, 1024):
        phase("profile", f"{card} | beam-5 N={n}, bf16: {beam_prof[n][0]} | its clock: "
                         f"{beam_prof[n][1]}")

    # phases 7-8: the LSTM and GRU chains vs their plain versions
    chain_err = compare_chains(dev)

    # phase 9: the training main path, through the three trainers (phase 20
    # evaluates the model that phase 14 trains: its files are kept in eval_tmp)
    eval_tmp = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, data, nets, paths = train_main_path(dev, tmp)
        compare_steps(data, nets["reward"], nets["policy"], nets["value"], dev)

        # phase 10: timings of the chains and of one step per trainer
        tt = time_training(data, nets, dev)
        phase("timing", f"{card} | bf16 weights, N = {CHAIN_N} | " + " | ".join(
            f"{net} chain {d}: kernel {tt[(net, d, 'ms')]:.3f} ms, plain "
            f"{tt[(net, d, 'plain_ms')]:.3f} ms, library "
            f"{tt[(net, d, 'library_ms')]:.3f} ms ({tt[(net, 'library')]['dtype']} cuDNN; "
            f"kernel / library {tt[(net, d, 'ms')] / tt[(net, d, 'library_ms')]:.2f})"
            for net in ("lstm", "gru") for d in ("fwd", "bwd")) + " | " + " | ".join(
            f"{net} cuDNN hs vs kernel hs: relative {tt[(net, 'library')]['rel']:.3g}"
            for net in ("lstm", "gru")) + " | " + " | ".join(
            f"{net} step: fused {tt[(net, 'step', 'ms')]:.3f} ms, plain "
            f"{tt[(net, 'step', 'plain_ms')]:.3f} ms" for net in ("reward", "policy", "value")))
        cl = tt["chain_launches"]
        for net in ("lstm", "gru"):
            phase("profile", f"{card} | {net.upper()} chain launches per call (N = {CHAIN_N}, "
                             f"bf16): " + "; ".join(f"T={k[1]} {k[2]} {v}" for k, v in cl.items()
                                                    if len(k) == 3 and k[0] == net)
                  + " | recurrence kernel device ms at T = 8 / 16 (per step, rest): "
                  + "; ".join(f"{d} {cl[(net, 8, d, 'ms')]:.4f} / {cl[(net, 16, d, 'ms')]:.4f} "
                              f"({(cl[(net, 16, d, 'ms')] - cl[(net, 8, d, 'ms')]) / 8 * 1e3:.2f}"
                              f" us, {2 * cl[(net, 8, d, 'ms')] - cl[(net, 16, d, 'ms')]:.4f} ms)"
                              for d in ("fwd", "bwd"))
                  + " | all device ms per call at T = 16: " + "; ".join(
                      f"{d} {cl[(net, 16, d, 'device')]:.4f}" for d in ("fwd", "bwd")))
        phase("profile", f"{card} | fused policy step, batch {BATCH}: {tt['policy_profile']}")

        # phases 11-13: the noise, reward stream and rollout kernels vs plain
        gumbel_ulps = compare_threefry(dev)
        stream_err = compare_reward_stream(dev)
        rollout_err = compare_rollout(dev)

        # phase 14: the A2C main path, through train_a2c_network
        a2c_launches, a2c_params, rparams = a2c_main_path(data, paths, tmp, dev)
        compare_a2c_step(data, a2c_params, rparams, dev)
        model_files = {k: shutil.copy(paths[k], eval_tmp.name)
                       for k in ("policy_network", "value_network")}
        model_files["a2c"] = shutil.copy(os.path.join(tmp, "a2c_plain", "a2cNetwork.pt"),
                                         eval_tmp.name)

    # phase 15: timings of the A2C kernels and of one A2C step, and a profile
    ta = time_a2c(a2c_params, rparams, data, dev)
    phase("timing", f"{card} | bf16 weights, N = {ROLLOUT_N}, S = {S} | " + " | ".join(
        f"{k}: kernel {ta[(k, 'ms')]:.3f} ms, plain {ta[(k, 'plain_ms')]:.3f} ms"
        for k in ("threefry_gumbel", "reward_stream", "rollout_fwd", "rollout_bwd"))
        + f" | a2c step: fused {ta[('a2c', 'step', 'ms')]:.3f} ms, plain "
          f"{ta[('a2c', 'step', 'plain_ms')]:.3f} ms")
    phase("profile", f"{card} | reward stream, N = {ROLLOUT_N}, S = {S}, bf16: kernel "
                     f"{ta[('reward_stream', 'ms')]:.4f} ms a call through its wrapper (CUDA "
                     f"events), {ta[('reward_stream', 'profile')]} | its clock: "
                     f"{ta[('reward_stream', 'phases')]}")
    phase("profile", f"{card} | rollout forward, N = {ROLLOUT_N}, S = {S}, bf16, reward fused "
                     f"in: {ta[('rollout_fwd', 'profile')]} | its clock: "
                     f"{ta[('rollout_fwd', 'phases')]}")
    phase("profile", f"{card} | rollout backward, N = {ROLLOUT_N}, S = {S}, bf16: kernel "
                     f"{ta[('rollout_bwd', 'ms')]:.4f} ms a call through its wrapper (CUDA "
                     f"events), {ta[('rollout_bwd', 'profile')]}")
    phase("profile", f"{card} | fused A2C step, batch {BATCH}: {ta[('a2c', 'profile')]}")

    # phases 16-18: the sampling kernel vs plain, sampled serving, timings
    sample_err = compare_sampling(weights, inputs, params_dev, dev)
    sample_launches = sampling_main_path(params)
    ts = time_sampling(gw, inputs)
    sample_bound = {label: sample_work(ts[label]["rows"], ts[label]["filters"],
                                       ts[label]["kept"]) for label in SAMPLE_SHAPES}
    phase("timing", f"{card} | bf16 weights | sampling: " + " | ".join(
        f"{label}: kernel {ts[label]['ms']:.4f} ms, plain {ts[label]['plain_ms']:.3f} ms, bound "
        f"{sample_bound[label][0]:.4f} ms ({sample_bound[label][1]}; {ts[label]['kept']} noise "
        f"entries kept)" for label in SAMPLE_SHAPES) + f" | host us a call {ts['host_us']:.1f}")
    for label in (*SAMPLE_SHAPES, "N=1024 unfiltered, noise in phase B"):
        phase("profile", f"{card} | " + decode_line(f"sampling {label}, bf16", ts[label]))
    phase("profile", f"{card} | sampling kernel, N = 1024, top-k 40 + nucleus 0.9: "
                     f"{ts['profile']}")

    # phase 19: the width faults repaired
    with tempfile.TemporaryDirectory() as tmp:
        wide_trainers(dev, tmp)
    streamed_chains(dev)
    padded_decodes(dev)
    wide_beam(dev)
    wide_decodes(dev)
    wv = wide_vocab_sampling(dev)
    wide_rollouts(dev)
    wide_reward_streams(dev)
    phase("timing", f"{card} | bf16 weights | sampling V={WIDE_V} (rows walked in L2), N=1024, "
                    f"top-k 40 + nucleus 0.9: kernel {wv['ms']:.3f} ms, plain "
                    f"{wv['plain_ms']:.3f} ms")

    # phase 20: the evaluation main path, from phase 14's model
    with eval_tmp as tmp:
        ev = eval_main_path(model_files, tmp, dev, card)

    # phase 21: the CLI's main path (a training run, then an evaluation)
    cli_runs = cli_main_path(dev, card)
    cli_launches = {k: cli_runs["train"][k] + cli_runs["eval"][k] for k in cli_runs["train"]}

    bounds_ = bounds()

    def entry(name, source, replaces, launches, err, ms, plain_ms, shape, library_ms=None,
              bound=None):
        """``launches``: a count, or the counts by main path (summed)."""
        bound = bound or bounds_[name]
        by_path = launches if isinstance(launches, dict) else None
        return {"name": name, "route": "cuda",
                "source": f"image_captioning_through_rl_tpu_torch/csrc/{source}",
                "replaces": f"image_captioning_through_rl_tpu/ops/{replaces}",
                "launches": sum(by_path.values()) if by_path else launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms, "shape": shape,
                **({"launches_by_path": by_path} if by_path else {})}

    kernels = [
        entry("greedy_decode", "decode.cu", "pallas_decode.py:176",
              {"serve": launches["fused_greedy_decode"], "cli": cli_launches["greedy_decode"]},
              greedy_err, tg[1024]["ms"], tg["plain_ms"], "N=1024 bf16"),
        entry("beam_search", "beam_search.cu", "pallas_beam.py:362",
              {"serve": launches["fused_beam_search"],
               "eval": ev["launches"]["fused_beam_search"], "cli": cli_launches["beam_search"]},
              beam_err, times[127][0], times[127][1], "N=127 B=5 bf16"),
        entry("token_gates", "token_gates.cu", "pallas_decode.py:99",
              {"serve": launches["token_gate_table"],
               "eval": ev["launches"]["token_gate_table"], "cli": cli_launches["token_gates"]},
              table_err, tab_ms, tab_plain, "V=1004 E=512 4H=2048 bf16", tab_library),
    ]
    for net, line, (fwd_at, bwd_at), length in (
            ("lstm", "pallas_lstm.py", (158, 184), 16), ("gru", "pallas_gru.py", (139, 167), 17)):
        for d, at in (("fwd", fwd_at), ("bwd", bwd_at)):
            kernels.append(entry(
                f"{net}_chain_{d}", f"{net}_chain{'_bwd' if d == 'bwd' else ''}.cu", f"{line}:{at}",
                {"pretrain": train_launches[f"{net}_chain_{d}"],
                 "cli": cli_launches[f"{net}_chain_{d}"]}, chain_err[(net, d)], tt[(net, d, "ms")],
                tt[(net, d, "plain_ms")], f"N={CHAIN_N} T={length} E=H={H} V={V} bf16",
                tt[(net, d, "library_ms")]))
    shape = f"N={ROLLOUT_N} S={S} E=H=F={H} V={V} bf16"
    for name, source, replaces, err in (
            ("threefry_gumbel", "threefry.cu", "pallas_sample.py:90", gumbel_ulps),
            ("reward_stream", "reward_stream.cu", "pallas_rollout.py:1066", stream_err),
            ("rollout_fwd", "rollout_fwd.cu", "pallas_rollout.py:308", rollout_err["fwd"]),
            ("rollout_bwd", "rollout.cu", "pallas_rollout.py:575", rollout_err["bwd"])):
        kernels.append(entry(name, source, replaces,
                             {"a2c": a2c_launches[name], "cli": cli_launches[name]}, err,
                             ta[(name, "ms")],
                             ta[(name, "plain_ms")],
                             f"[{S}, {ROLLOUT_N}, {V}] f32" if name == "threefry_gumbel"
                             else shape))
    label = SAMPLE_SHAPES[1]
    kernels.append(entry("sample_decode", "decode.cu", "pallas_sample.py:350",
                         sample_launches["fused_sample_decode"], sample_err, ts[label]["ms"],
                         ts[label]["plain_ms"], "N=1024 T=17 top-k 40 + top-p 0.9 bf16",
                         bound=sample_bound[label]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
