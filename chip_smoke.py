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
  3. the x-gate table kernel (emb @ wi, read by both decode kernels) vs
     plain, bf16 and f32; then the greedy kernel vs plain: N in
     {1, 1000, 1024}, bf16 and f32 weights;
  4. beam kernel vs plain: N in {127, 1024}, B = 5, bf16 and f32 weights;
  5. main path: a reference-layout a2c .pt and a vocab JSON on disk, the
     server started through ``server.main``, greedy (JSON and binary) and
     beam-5 requests answered, launch counters read;
  6. timings: kernel and plain ms (CUDA events): the x-gate table, greedy
     at N = 1024 and beam at N = 127 and 1024.

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
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
V, F, E, H, T, BEAM = 1004, 512, 512, 512, 17, 5
NEAR_TIE = 1e-4
MAX_DIFF_SHARE = 0.01
SCORE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
TABLE_TOL = 1e-4


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def first_divergent_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row of ``[N, T]`` greedy tokens: the first decode step (column - 1)
    where the two differ."""
    return (a != b).int().argmax(dim=1) - 1


def check_rows(kind: str, k_tok, p_tok, gap_of_row) -> tuple[int, float, float]:
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
    if worst >= NEAR_TIE:
        raise AssertionError(f"{kind}: a row differs where the plain version's gap "
                             f"{worst:.3g} is not a near-tie (< {NEAR_TIE})")
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


def main() -> int:
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA "
              "device", file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
                    f"{torch.cuda.device_count()} device(s)")
    sys.path.insert(0, ROOT)
    from image_captioning_through_rl_tpu_torch import START_ID, server
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c, a2c_to_state_dict
    from image_captioning_through_rl_tpu_torch.ops import kernel_build
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import (
        beam_search_plain, fused_beam_search, prepare_beam_weights)
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import (
        fused_greedy_decode, greedy_decode_plain, prepare_greedy_weights, token_gate_table,
        token_gate_table_plain)

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

    # phase 3a: the x-gate tables (emb @ wi) that both decode kernels read
    table_err = 0.0
    for wd, (gw, bw) in weights.items():
        for name, (emb, w) in (("policy", (gw.emb, gw.w)), ("value", (bw.value.emb, bw.value.w))):
            k_tab = token_gate_table(emb, w)
            torch.cuda.synchronize()
            err = float((k_tab - token_gate_table_plain(emb, w)).abs().max())
            if k_tab.shape != (V, 4 * H) or not err <= TABLE_TOL:
                raise AssertionError(f"token gate table ({name}, {wd}) differs by {err:.3g}")
            table_err = max(table_err, err)
            phase("token_gates", f"{str(wd)[6:]} {name} [V, 4H]: max abs err {err:.3g} "
                                 f"(tolerance {TABLE_TOL})")

    # phase 3b: greedy kernel vs plain
    greedy_err = 0.0
    for wd, (gw, _) in weights.items():
        for n in (1, 1000, 1024):
            feats, start = inputs(n)
            k_tok = fused_greedy_decode(gw, feats, start, T)
            torch.cuda.synchronize()
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
                            f"{float(gaps.min()):.3g})")

    # phase 4: beam kernel vs plain
    beam_err = 0.0
    for wd, (_, bw) in weights.items():
        for n in (127, 1024):
            feats, start = inputs(n)
            k_tok, k_sc = fused_beam_search(bw, feats, start, T, BEAM)
            torch.cuda.synchronize()
            p_tok, p_sc, margins = beam_search_plain(bw, feats, start, T, BEAM, margins=True)
            if k_tok.shape != (n, BEAM, T) or not bool(torch.isfinite(k_sc).all()):
                raise AssertionError("beam kernel output has the wrong shape or non-finite "
                                     "scores")
            n_bad, gap, _ = check_rows("beam", k_tok, p_tok,
                                       lambda bad: margins[bad].min(dim=1).values)
            same = ~(k_tok != p_tok).reshape(n, -1).any(dim=1)
            err = float((k_sc - p_sc)[same].abs().max())
            if err > SCORE_TOL[wd]:
                raise AssertionError(f"beam scores differ by {err:.3g} > {SCORE_TOL[wd]}")
            beam_err = max(beam_err, err)
            phase("beam", f"{str(wd)[6:]} N={n}: {n_bad} row(s) differ (smallest gap "
                          f"there {gap:.3g}); score max abs err {err:.3g} "
                          f"(tolerance {SCORE_TOL[wd]})")

    # phase 5: the main path, through the server's entry point
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        model_pt = os.path.join(tmp, "a2cNetwork.pt")
        vocab_json = os.path.join(tmp, "coco2014_vocab.json")
        torch.save(a2c_to_state_dict(params), model_pt)
        words = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(4, V)]
        with open(vocab_json, "w") as f:
            json.dump({"word_to_idx": {w: i for i, w in enumerate(words)},
                       "idx_to_word": words}, f)
        fused_greedy_decode.launches = 0
        fused_beam_search.launches = 0
        token_gate_table.launches = 0
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
    if min(launches.values()) < 1:
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
    tab_plain = cuda_ms(lambda: token_gate_table_plain(gw.emb, gw.w), 20)
    feats, start = inputs(1024)
    g_ms = cuda_ms(lambda: fused_greedy_decode(gw, feats, start, T), 20)
    g_plain = cuda_ms(lambda: greedy_decode_plain(gw, feats, start, T), 20)
    times = {}
    for n in (127, 1024):
        f_n, s_n = feats[:n].contiguous(), start[:n].contiguous()
        times[n] = (cuda_ms(lambda: fused_beam_search(bw, f_n, s_n, T, BEAM), 5),
                    cuda_ms(lambda: beam_search_plain(bw, f_n, s_n, T, BEAM), 5))
    phase("timing", f"{card} | bf16 weights | token gate table [1004, 2048]: kernel "
                    f"{tab_ms:.3f} ms, plain {tab_plain:.3f} ms | greedy N=1024: kernel "
                    f"{g_ms:.3f} ms, plain "
                    f"{g_plain:.3f} ms | beam-5 N=127: kernel {times[127][0]:.3f} ms, plain "
                    f"{times[127][1]:.3f} ms | beam-5 N=1024: kernel {times[1024][0]:.3f} ms, "
                    f"plain {times[1024][1]:.3f} ms")

    print(json.dumps({"kernels": [
        {"name": "greedy_decode", "route": "cuda",
         "source": "image_captioning_through_rl_tpu_torch/csrc/greedy_decode.cu",
         "replaces": "image_captioning_through_rl_tpu/ops/pallas_decode.py:117",
         "launches": launches["fused_greedy_decode"], "max_abs_err": greedy_err,
         "ms": g_ms, "plain_ms": g_plain, "shape": "N=1024 bf16"},
        {"name": "beam_search", "route": "cuda",
         "source": "image_captioning_through_rl_tpu_torch/csrc/beam_search.cu",
         "replaces": "image_captioning_through_rl_tpu/ops/pallas_beam.py:294",
         "launches": launches["fused_beam_search"], "max_abs_err": beam_err,
         "ms": times[127][0], "plain_ms": times[127][1], "shape": "N=127 B=5 bf16"},
        {"name": "token_gates", "route": "cuda",
         "source": "image_captioning_through_rl_tpu_torch/csrc/token_gates.cu",
         "replaces": "image_captioning_through_rl_tpu/ops/pallas_decode.py:99",
         "launches": launches["token_gate_table"], "max_abs_err": table_err,
         "ms": tab_ms, "plain_ms": tab_plain, "shape": "V=1004 E=512 4H=2048 bf16"},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
