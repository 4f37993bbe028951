"""The readings that a cell's limits are set from, on the card at the
cell's own sizes (not run by the benchmark's runs):

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... --control-seeds 11,12,13

For each seed of ``--seeds``, the program's readings of the cell's checked
numbers (its set-up's first three training steps, or its captions of the
calls a run checks) against the reference: the lower readings. For each
seed of ``--control-seeds``: the control, the reference computed with every
product's operands in float8 (e4m3, one power-of-two scale a tensor), one
precision below the configuration's bf16, put in the program's place; and
the faults the cell can have (training, planted in the reference put in
the program's place: half of each minibatch left out, the mean taken over
the rest; captioning: the tokens of one row altered where they are
produced, and, planted in the program's own call of the beam kernel, the
critic dropped from the score or the second beam returned). A state left
unchanged reads 1 by the training checks' measure and needs no run. One
JSON line a reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import run as bench  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.reference import beam as ref_beam  # noqa: E402
from portbench.reference import nets  # noqa: E402

FP8 = nets.Prec("fp8")


def _ctx(cell, seed, work, device, config_override=None, traffic_override=None):
    ctx = bench.Context(cell, seed, 0, False, device, work, config_override, traffic_override)
    ctx.t_start = time.perf_counter()
    return ctx


def training(cell, entry, seeds, control_seeds, device, emit, **over):
    for seed in seeds:
        with tempfile.TemporaryDirectory() as work:
            ctx = _ctx(cell, seed, work, device, **over)
            st = entry.first_steps(ctx, with_train=False)
            emit({"kind": "program", "seed": seed, **entry.readings(ctx, st)})
    for seed in control_seeds:
        with tempfile.TemporaryDirectory() as work:
            ctx = _ctx(cell, seed, work, device, **over)
            st = entry.first_steps(ctx, with_train=False)
            for kind, kw in (("control", {"prec": FP8}), ("half_batch", {"half": True})):
                prog = _reference(entry, ctx, st, **kw)
                emit({"kind": kind, "seed": seed, **entry.readings(ctx, st, prog)})


def _reference(entry, ctx, st, **kw):
    cfg, tr, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    if "vectors" in st:
        return entry.reference_steps(cfg, st["vectors"], st["checks"], st["tseed"],
                                     tr["batch_size"], dev, **kw)
    return entry.reference_steps(cfg, ctx.seed, st["checks"], st["tseed"], tr["batch_size"],
                                 cfg["a2c_lr"], dev, **kw)


def _no_critic(orig):
    def call(*args, **kw):
        return orig(*args, **dict(kw, value_weight=0.0))
    return call


def _second_beam(orig):
    def call(*args, **kw):
        toks, scores = orig(*args, **kw)
        order = [1, 0] + list(range(2, toks.shape[1]))
        return toks[:, order], scores[:, order]
    return call


# faults planted in the program's beam search: each wraps ``fused_beam_search``
BEAM_FAULTS = {"no_critic": _no_critic, "second_beam": _second_beam}


@contextlib.contextmanager
def beam_fault(kind: str):
    """The program's ``Captioner`` with ``BEAM_FAULTS[kind]`` planted in its
    call of the beam search, while the block runs."""
    from image_captioning_through_rl_tpu_torch import api
    orig = api.fused_beam_search
    api.fused_beam_search = BEAM_FAULTS[kind](orig)
    try:
        yield
    finally:
        api.fused_beam_search = orig


def captioning(cell, entry, seeds, control_seeds, device, emit, **over):
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    for seed in sorted(set(seeds) | set(control_seeds)):
        with tempfile.TemporaryDirectory() as work:
            ctx = _ctx(cell, seed, work, device, **over)
            prog, rows, idx_to_word = entry.sampled_calls(ctx)
            cfg, tr = ctx.config, ctx.traffic
            dev = torch.device(device)
            if seed in seeds:
                emit({"kind": "program", "seed": seed,
                      **entry.check(cfg, seed, prog, rows, idx_to_word, tr["beam_size"], tr, dev)})
            if seed not in control_seeds:
                continue
            tree = entry._weights(cfg, seed, dev)
            control, altered = {}, {}
            for call, (toks, strs) in prog.items():
                f = torch.from_numpy(rows(call)).to(dev)
                t, _ = ref_beam.beam_search(tree["policy"], tree["value"], f, tr["beam_size"],
                                            cfg["max_seq_len"] - 1, tr["value_weight"],
                                            tr["logprob_weight"], FP8)
                t = t[:, 0].cpu().numpy().astype(np.int32)
                control[call] = (t, decode_captions(t, idx_to_word))
                bad = np.array(toks, copy=True)
                bad[0, 1:] = (bad[0, 1:] + cfg["vocab_size"] // 2) % cfg["vocab_size"]
                altered[call] = (bad, decode_captions(bad, idx_to_word))
            for kind, calls in (("control", control), ("altered_token", altered)):
                emit({"kind": kind, "seed": seed,
                      **entry.check(cfg, seed, calls, rows, idx_to_word, tr["beam_size"], tr,
                                    dev)})
            for kind in BEAM_FAULTS:
                with beam_fault(kind):
                    calls, _, _ = entry.sampled_calls(ctx)
                emit({"kind": kind, "seed": seed,
                      **entry.check(cfg, seed, calls, rows, idx_to_word, tr["beam_size"], tr,
                                    dev)})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.cache_env(ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    entry = harness.entry_module(cell.entry)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    run = captioning if cell.entry == "caption" else training
    run(cell, entry, seeds, control_seeds, "cuda", emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
