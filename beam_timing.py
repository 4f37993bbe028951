"""Time the port's decodes on one GPU.

    python3 beam_timing.py [ROOT] [--runs K] [--path beam|greedy|sample|reward]

Imports ``image_captioning_through_rl_tpu_torch`` from ``ROOT`` (default:
the directory of this file; another checkout of the repository may be given,
so that two versions are timed on one card in one session, each in its own
process), builds its kernels, and times one decode at COCO width (V = 1004,
E = H = F = 512, T = 17, bf16 weights, random weights from a seed):
``--path beam`` (the default) ``fused_beam_search`` with beam 5 at N = 127
and N = 1024; ``greedy`` ``fused_greedy_decode`` at N = 1024, 64 and 4;
``sample`` ``fused_sample_decode`` at N = 1024 unfiltered, N = 1024 with
top-k 40 + nucleus 0.9, and the served shape N = 64 x R = 4 (256 rows,
top-k 40 + nucleus 0.9); ``reward`` the A2C reward stream alone
(``fused_rollout.reward_stream``) at N = 512, S = 16 on actions made from a
seed, with every token the action (the plain A2C rollout's tokens) and with
the teacher's tokens on the first seven steps (a curriculum rollout at
level 8, whose trainer runs the stream on its own). For each shape:

* ``ms``: K runs (default 5), each the mean of 5 back-to-back calls timed by
  CUDA events; the median and the range are printed;
* a torch.profiler window over 3 calls: device ms per call, the busy share
  of the window's wall time, and device ms and launches per call by kernel;
* where the checkout's kernel has a phase clock (``clock=...``), the mean us
  per step of its phases (the beam's A-D, a decode's A and B, the reward
  stream's A and B over its S + 1 passes) and of the barriers, and the
  set-up's us, from one call;
* the host's microseconds a call (200 back-to-back calls, the host side
  alone).

Prints the card's name and power limit, then one JSON line per shape. Needs
a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

V, F, E, H, T, BEAM, SEED = 1004, 512, 512, 512, 17, 5, 0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def kernel_name(name: str) -> str:
    found = re.findall(r"[A-Za-z_]\w*_kernel", name)
    return found[0] if found else name[:48]


def profile(fn, iters: int = 3) -> dict:
    """Device ms and launches per call by kernel over ``iters`` calls, after
    the card idled 50 ms inside the window (the tracer takes effect late)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    ms, counts = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        key = kernel_name(evt.key)
        ms[key] = ms.get(key, 0.0) + us / 1e3 / iters
        counts[key] = counts.get(key, 0) + evt.count / iters
    device = sum(ms.values())
    return {"device_ms": device, "wall_ms": wall, "busy": device / wall,
            "launches_per_call": sum(counts.values()),
            "kernels": {k: {"ms": ms[k], "launches": counts[k]}
                        for k in sorted(ms, key=lambda k: -ms[k])}}


def host_us(fn, iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def decode_phases(fused_decode, call) -> dict | None:
    """A greedy or sampling decode's own clock over one call: the set-up,
    then per step the means of phases A and B and of the two barriers, in
    us, and phase A's mean head and cell tile in clock64 cycles; None where
    the checkout's kernel has no clock."""
    if not hasattr(fused_decode, "decode_clock_slots"):
        return None
    clock = torch.zeros(fused_decode.decode_clock_slots(T), dtype=torch.int64, device="cuda")
    call(clock)
    c = clock.cpu().tolist()
    steps = T - 1

    def mean_us(a, b):
        return sum(c[2 + 4 * t + b] - c[2 + 4 * t + a] for t in range(steps)) / steps / 1e3

    between = sum(c[6 + 4 * t] - c[5 + 4 * t] for t in range(steps - 1)) / (steps - 1) / 1e3
    return {"setup_us": (c[1] - c[0]) / 1e3, "A_us": mean_us(0, 1), "B_us": mean_us(2, 3),
            "barriers_us": mean_us(1, 2) + between,
            "head_tile_cycles": c[2 + 4 * steps] / c[3 + 4 * steps],
            "cell_tile_cycles": c[4 + 4 * steps] / c[5 + 4 * steps]}


def phases(fused_beam, call) -> dict | None:
    """The kernel's own clock over one call (each mark the last block's):
    the set-up, then per step the means of phases A-D and of the three
    barriers inside a step, in us; None where the kernel has no clock."""
    if not hasattr(fused_beam, "beam_clock_slots"):
        return None
    clock = torch.zeros(fused_beam.beam_clock_slots(T), dtype=torch.int64, device="cuda")
    call(clock)
    c = clock.cpu().tolist()
    steps = T - 1

    def mean_us(a, b):
        return sum(c[2 + 8 * t + b] - c[2 + 8 * t + a] for t in range(steps)) / steps / 1e3

    return {"setup_us": (c[1] - c[0]) / 1e3, "A_us": mean_us(0, 1), "B_us": mean_us(2, 3),
            "C_us": mean_us(4, 5), "D_us": mean_us(6, 7),
            "barriers_us": mean_us(1, 2) + mean_us(3, 4) + mean_us(5, 6)}


def stream_phases(fused_rollout, call) -> dict:
    """The reward stream's own clock over one call: the set-up, then the
    means over its S + 1 passes of phases A and B and of the two barriers,
    in us."""
    clock = torch.zeros(fused_rollout.rollout_clock_slots(T - 1), dtype=torch.int64,
                        device="cuda")
    call(clock)
    c = clock.cpu().tolist()
    passes = T

    def mean_us(a, b):
        return sum(c[2 + 4 * t + b] - c[2 + 4 * t + a] for t in range(passes)) / passes / 1e3

    between = sum(c[6 + 4 * t] - c[5 + 4 * t] for t in range(passes - 1)) / (passes - 1) / 1e3
    return {"setup_us": (c[1] - c[0]) / 1e3, "A_us": mean_us(0, 1), "B_us": mean_us(2, 3),
            "barriers_us": mean_us(1, 2) + between}


def reward_shapes(gen):
    """(label, call, call with a clock, its phases function) for the reward
    stream at N = 512, S = T - 1."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import reward
    from image_captioning_through_rl_tpu_torch.ops import fused_rollout as fr

    n, steps = 512, T - 1
    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=T)
    rparams = {k: ({kk: vv.to("cuda") for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to("cuda")) for k, v in reward.init(gen, cfg).items()}
    feats = torch.randn((n, F), generator=gen).to("cuda")
    start = torch.full((n,), START_ID, dtype=torch.int32, device="cuda")
    rw = fr.prepare_reward_weights(rparams, feats, start, torch.bfloat16)
    act = torch.randint(4, V, (steps, n), generator=gen, dtype=torch.int32).to("cuda")
    teacher = torch.randint(4, V, (steps, n), generator=gen, dtype=torch.int32).to("cuda")
    curriculum = act.clone()
    curriculum[:7] = teacher[:7]
    for label, tok in (("tokens = actions", act), ("teacher tokens on 7 steps", curriculum)):
        yield (f"reward stream N={n} S={steps} {label}",
               lambda tok=tok: fr.reward_stream(rw, act, tok),
               lambda c, tok=tok: fr.reward_stream(rw, act, tok, clock=c),
               lambda call: stream_phases(fr, call))


def shapes(path: str, on_dev: dict, gen):
    """(label, call, call with a clock or None, its phases function) per
    timed shape of the path."""
    from image_captioning_through_rl_tpu_torch import START_ID
    from image_captioning_through_rl_tpu_torch.ops import fused_beam, fused_decode, prng
    from image_captioning_through_rl_tpu_torch.ops.fused_beam import prepare_beam_weights
    from image_captioning_through_rl_tpu_torch.ops.fused_decode import prepare_greedy_weights
    from image_captioning_through_rl_tpu_torch.ops.fused_sample import fused_sample_decode

    if path == "reward":
        yield from reward_shapes(gen)
        return
    gw = prepare_greedy_weights(on_dev["policy"], torch.bfloat16)
    feats = torch.randn((1024, F), generator=gen).to("cuda")
    start = torch.full((1024,), START_ID, dtype=torch.int32, device="cuda")
    if path == "beam":
        bw = prepare_beam_weights(gw, on_dev["value"])
        for n in (127, 1024):
            f, s = feats[:n].contiguous(), start[:n].contiguous()
            yield (f"beam-{BEAM} N={n}", lambda f=f, s=s: fused_beam.fused_beam_search(
                       bw, f, s, T, BEAM),
                   lambda c, f=f, s=s: fused_beam.fused_beam_search(bw, f, s, T, BEAM, clock=c),
                   lambda call: phases(fused_beam, call))
    elif path == "greedy":
        for n in (1024, 64, 4):
            f, s = feats[:n].contiguous(), start[:n].contiguous()
            yield (f"greedy N={n}", lambda f=f, s=s: fused_decode.fused_greedy_decode(gw, f, s, T),
                   lambda c, f=f, s=s: fused_decode.fused_greedy_decode(gw, f, s, T, clock=c),
                   lambda call: decode_phases(fused_decode, call))
    else:
        key = prng.PRNGKey(SEED + 90)
        served = feats[:64].repeat_interleave(4, dim=0).contiguous()
        for label, f, k, p in (("N=1024 unfiltered", feats, 0, None),
                               ("N=1024 top-k 40 + nucleus 0.9", feats, 40, 0.9),
                               ("N=64 R=4 top-k 40 + nucleus 0.9", served, 40, 0.9)):
            s = start[:f.shape[0]].contiguous()
            yield (f"sample {label}", lambda f=f, s=s, k=k, p=p: fused_sample_decode(
                       gw, f, s, key, T, 1.0, k, p),
                   lambda c, f=f, s=s, k=k, p=p: fused_sample_decode(gw, f, s, key, T, 1.0, k, p,
                                                                     clock=c),
                   lambda call: decode_phases(fused_decode, call))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--path", choices=("beam", "greedy", "sample", "reward"), default="beam")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("beam_timing: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.models import a2c
    from image_captioning_through_rl_tpu_torch.ops import kernel_build

    kernel_build.load_library()
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = NetConfig(vocab_size=V, input_dim=F, wordvec_dim=E, hidden_dim=H, max_seq_len=T)
    gen = torch.Generator().manual_seed(SEED)
    params = a2c.init(gen, cfg)
    on_dev = {net: {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                        else v.to(dev)) for k, v in p.items()} for net, p in params.items()}
    for label, call, timed, phases_of in shapes(args.path, on_dev, gen):
        runs = [cuda_ms(call, 5) for _ in range(args.runs)]
        try:  # a parent checkout's wrapper may take no clock
            ph = phases_of(timed)
        except TypeError:
            ph = None
        print(json.dumps({"root": os.path.abspath(args.root), "path": args.path, "shape": label,
                          "ms_median": statistics.median(runs), "ms_min": min(runs),
                          "ms_max": max(runs), "ms_runs": runs, "profile": profile(call),
                          "phases": ph, "host_us": host_us(call)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
