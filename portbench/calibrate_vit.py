"""The readings that the CLIP image cell's limits are set from, on the card at
the cell's own sizes (not run by the benchmark's runs), by
``calibrate.py``'s method:

    python3 portbench/calibrate_vit.py --workload images-beam5-clipl14-336 --seeds 11,12,... --control-seeds 11,12,13

For each seed of ``--seeds``, the program's readings of the cell's checked
numbers against the reference: the lower readings. For each seed of
``--control-seeds``: the control, the reference computed one precision
below the configuration's bf16 and put in the program's place (its tower
with both operands of every product rounded to float8 e4m3, one
power-of-two scale a tensor, its own PCA fitted to its own float8
embeddings of the set-up's images, then its beam in float8 on those
features); the captioning faults of ``calibrate.py`` (one row's tokens
altered, the critic dropped, the second beam returned); and the faults of
the tower in :data:`VIT_FAULTS`, each planted in the program for the whole
run, its set-up's PCA fit included: the exact erf GELU in place of
``quick_gelu``, the attention's scale 1/32 in place of 1/8, ``ln_pre``
skipped, the positions shifted by one row, ImageNet's mean and std in
place of CLIP's, and (``calibrate_images``') the projection's mean not
subtracted. ``--kinds`` keeps only the readings of the kinds named. One
JSON line a reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "portbench"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.nn import functional as F  # noqa: E402

import calibrate  # noqa: E402
import calibrate_images  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.reference import beam as ref_beam  # noqa: E402
from portbench.reference import vit as ref_vit  # noqa: E402

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _erf_gelu(vit, pca):
    return vit, "quick_gelu", F.gelu


def _scale_1_32(vit, pca):
    orig = vit.attention

    def attention(qkv, heads):
        w = qkv.shape[-1] // 3
        return orig(torch.cat([qkv[..., :w] * 0.25, qkv[..., w:]], dim=-1), heads)
    return vit, "attention", attention


def _swapped(vit, name: str, make):
    """A replacement of ``VisionTransformer.embed`` that runs the program's
    own ``embed`` with the tower's attribute ``name`` swapped for
    ``make(attribute)``."""
    orig = vit.VisionTransformer.embed

    def embed(self, x):
        kept = getattr(self, name)
        setattr(self, name, make(kept))
        try:
            return orig(self, x)
        finally:
            setattr(self, name, kept)
    return vit.VisionTransformer, "embed", embed


def _ln_pre_skipped(vit, pca):
    return _swapped(vit, "ln_pre", lambda ln: torch.nn.Identity())


def _positions_shifted(vit, pca):
    return _swapped(vit, "positional_embedding",
                    lambda pos: torch.nn.Parameter(pos.roll(1, dims=0), requires_grad=False))


def _imagenet_stats(vit, pca):
    orig = vit.preprocess

    def preprocess(images, size=vit.IMAGE_SIZE, device=None):
        x = orig(images, size=size, device=device)

        def col(v):
            return torch.tensor(v, dtype=x.dtype, device=x.device)[:, None, None]
        return (x * col(vit.CLIP_STD) + col(vit.CLIP_MEAN) - col(IMAGENET_MEAN)) \
            / col(IMAGENET_STD)
    return vit, "preprocess", preprocess


# faults planted in the program's CLIP front end: each names what it replaces
VIT_FAULTS = {"erf_gelu": _erf_gelu, "attention_scale_1_32": _scale_1_32,
              "ln_pre_skipped": _ln_pre_skipped, "positions_shifted": _positions_shifted,
              "imagenet_stats": _imagenet_stats,
              "mean_not_subtracted": calibrate_images.VISION_FAULTS["mean_not_subtracted"]}


@contextlib.contextmanager
def vit_fault(kind: str):
    """The program with ``VIT_FAULTS[kind]`` planted while the block runs."""
    from image_captioning_through_rl_tpu_torch.data import pca
    from image_captioning_through_rl_tpu_torch.models import vit
    owner, name, replacement = VIT_FAULTS[kind](vit, pca)
    orig = owner.__dict__[name]
    setattr(owner, name, replacement)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _control(ctx, entry, prog, pixels, idx_to_word, dev):
    """The reference in float8 put in the program's place, over the calls
    of ``prog``: ``(calls, its projection)``, the projection its own fit of
    its float8 embeddings of the set-up's images."""
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    cfg, tr = ctx.config, ctx.traffic
    _, (mean, comps) = entry.reference_fit(cfg, ctx.seed, tr, cfg["input_dim"], dev,
                                           calibrate.FP8)
    projection = (mean.float().cpu(), comps.float().cpu())
    sd = entry.draw_weights(cfg, ctx.seed, dev)
    tree = entry._caption()._weights(cfg, ctx.seed, dev)
    out = {}
    for call in prog:
        f = ref_vit.features(sd, pixels(call), *projection, dev, calibrate.FP8,
                             heads=cfg["num_attention_heads"])
        t, _ = ref_beam.beam_search(tree["policy"], tree["value"], f, tr["beam_size"],
                                    cfg["max_seq_len"] - 1, tr["value_weight"],
                                    tr["logprob_weight"], calibrate.FP8)
        t = t[:, 0].cpu().numpy().astype(np.int32)
        out[call] = (f.cpu().numpy(), t, decode_captions(t, idx_to_word))
    return out, projection


def readings(cell, entry, seeds, control_seeds, device, emit, kinds=None, **over):
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    dev = torch.device(device)

    def wanted(kind):
        return kinds is None or kind in kinds

    for seed in sorted(set(seeds) | set(control_seeds)):
        with tempfile.TemporaryDirectory() as work:
            ctx = calibrate._ctx(cell, seed, work, device, **over)
            cfg, tr = ctx.config, ctx.traffic

            def check(calls, proj):
                return entry.check(cfg, seed, calls, pixels, idx_to_word, proj, tr, dev)

            prog, pixels, idx_to_word, projection = entry.sampled_calls(ctx)
            if seed in seeds and wanted("program"):
                emit({"kind": "program", "seed": seed, **check(prog, projection)})
            if seed not in control_seeds:
                continue
            if wanted("control"):
                emit({"kind": "control", "seed": seed,
                      **check(*_control(ctx, entry, prog, pixels, idx_to_word, dev))})
            if wanted("altered_token"):
                altered = {}
                for call, (feats, toks, _) in prog.items():
                    bad = np.array(toks, copy=True)
                    bad[0, 1:] = (bad[0, 1:] + cfg["vocab_size"] // 2) % cfg["vocab_size"]
                    altered[call] = (feats, bad, decode_captions(bad, idx_to_word))
                emit({"kind": "altered_token", "seed": seed, **check(altered, projection)})
            del prog
            planted = [(k, calibrate.beam_fault) for k in calibrate.BEAM_FAULTS]
            planted += [(k, vit_fault) for k in VIT_FAULTS]
            for kind, fault in planted:
                if wanted(kind):
                    with fault(kind):
                        calls, _, _, proj = entry.sampled_calls(ctx)
                    emit({"kind": kind, "seed": seed, **check(calls, proj)})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--kinds", default="", help="comma-separated kinds of reading to take "
                   "(program, control, altered_token, a fault's name); all by default")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    harness.cache_env(ROOT)
    if not torch.cuda.is_available():
        print("calibrate_vit: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    entry = harness.entry_module(cell.entry)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    readings(cell, entry, [int(s) for s in args.seeds.split(",") if s],
             [int(s) for s in args.control_seeds.split(",") if s], "cuda", emit,
             {k for k in args.kinds.split(",") if k} or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
