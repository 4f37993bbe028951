"""The readings that the image cell's limits are set from, on the card at
the cell's own sizes (not run by the benchmark's runs), by
``calibrate.py``'s method:

    python3 portbench/calibrate_images.py --workload images-beam5-vgg16 --seeds 11,12,... --control-seeds 11,12,13

For each seed of ``--seeds``, the program's readings of the cell's checked
numbers against the reference: the lower readings. For each seed of
``--control-seeds``: the control, the reference computed one precision
below the configuration's bf16 and put in the program's place (its stack
with every layer's weights and input rounded to float8 e4m3, one
power-of-two scale a tensor, then its beam in float8 on those features);
the captioning faults of ``calibrate.py`` (one row's tokens altered, the
critic dropped, the second beam returned); and the faults of the front
end in :data:`VISION_FAULTS`, each planted in the program for the whole
run, its set-up's PCA fit included: a ReLU dropped, fc6 reading an NHWC
flatten, the std skipped, the projection's mean not subtracted, the PCA
fitted to the table uncentred, its components in reverse order. The
control fits its own PCA to its own float8 fc7 of the set-up's images.
``--kinds`` keeps only the readings of the kinds named. One JSON line a
reading.
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

import calibrate  # noqa: E402
from portbench import harness, traffic  # noqa: E402
from portbench.reference import beam as ref_beam  # noqa: E402
from portbench.reference import vgg as ref_vgg  # noqa: E402

# conv5_3's ReLU, before the last pool (torchvision's index)
DROPPED_RELU = 29


def _relu_dropped(vgg, pca):
    def forward(self, x):
        with torch.no_grad():
            vgg._no_tf32(x)
            for k, layer in enumerate(self.features):
                if k != DROPPED_RELU:
                    x = layer(x)
            return self.classifier(torch.flatten(x, 1))
    return vgg.VGG16, "forward", forward


def _nhwc_flatten(vgg, pca):
    def forward(self, x):
        with torch.no_grad():
            vgg._no_tf32(x)
            x = self.features(x)
            return self.classifier(x.permute(0, 2, 3, 1).flatten(1))
    return vgg.VGG16, "forward", forward


def _std_skipped(vgg, pca):
    orig = vgg.preprocess

    def preprocess(images, size=vgg.IMAGE_SIZE, device=None):
        x = orig(images, size=size, device=device)
        return x * torch.tensor(vgg.IMAGENET_STD, dtype=x.dtype, device=x.device)[:, None, None]
    return vgg, "preprocess", preprocess


def _mean_not_subtracted(vgg, pca):
    def apply(self, feats):
        return feats.to(torch.float32) @ self.components.to(feats.device)
    return pca.PCAProjection, "apply", apply


def _uncentred_fit(vgg, pca):
    def fit_pca(features, k=512):
        x = features.to(torch.float32)
        _, _, vt = torch.linalg.svd(x, full_matrices=False)
        return pca.PCAProjection(mean=x.mean(dim=0), components=vt[:k].T.contiguous())
    return pca, "fit_pca", fit_pca


def _components_reversed(vgg, pca):
    orig = pca.fit_pca

    def fit_pca(features, k=512):
        p = orig(features, k)
        return pca.PCAProjection(p.mean, p.components.flip(1).contiguous())
    return pca, "fit_pca", fit_pca


# faults planted in the program's front end: each names what it replaces
VISION_FAULTS = {"relu_dropped": _relu_dropped, "nhwc_flatten": _nhwc_flatten,
                 "std_skipped": _std_skipped, "mean_not_subtracted": _mean_not_subtracted,
                 "uncentred_fit": _uncentred_fit, "components_reversed": _components_reversed}


@contextlib.contextmanager
def vision_fault(kind: str):
    """The program with ``VISION_FAULTS[kind]`` planted while the block
    runs."""
    from image_captioning_through_rl_tpu_torch.data import pca
    from image_captioning_through_rl_tpu_torch.models import vgg
    owner, name, replacement = VISION_FAULTS[kind](vgg, pca)
    orig = owner.__dict__[name]
    setattr(owner, name, replacement)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _control(ctx, entry, prog, pixels, idx_to_word, dev):
    """The reference in float8 put in the program's place, over the calls
    of ``prog``: ``(calls, its projection)``, the projection its own fit of
    its float8 fc7 of the set-up's images."""
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    cfg, tr = ctx.config, ctx.traffic
    _, (mean, comps) = entry.reference_fit(ctx.seed, tr, cfg["input_dim"], dev, calibrate.FP8)
    projection = (mean.float().cpu(), comps.float().cpu())
    sd = ref_vgg.draw_weights(traffic.sub_seed(ctx.seed, 3), dev)
    tree = entry._caption()._weights(cfg, ctx.seed, dev)
    out = {}
    for call in prog:
        f = ref_vgg.features(sd, pixels(call), *projection, dev, calibrate.FP8)
        t, _ = ref_beam.beam_search(tree["policy"], tree["value"], f, tr["beam_size"],
                                    cfg["max_seq_len"] - 1, tr["value_weight"],
                                    tr["logprob_weight"], calibrate.FP8)
        t = t[:, 0].cpu().numpy().astype(np.int32)
        out[call] = (f.cpu().numpy(), t, decode_captions(t, idx_to_word))
    return out, projection


def readings(cell, entry, seeds, control_seeds, device, emit, kinds=None, **over):
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    dev = torch.device(device)
    for seed in sorted(set(seeds) | set(control_seeds)):
        with tempfile.TemporaryDirectory() as work:
            ctx = calibrate._ctx(cell, seed, work, device, **over)
            cfg, tr = ctx.config, ctx.traffic
            prog, pixels, idx_to_word, projection = entry.sampled_calls(ctx)

            def check(calls, proj=projection):
                return entry.check(cfg, seed, calls, pixels, idx_to_word, proj, tr, dev)

            def wanted(kind):
                return kinds is None or kind in kinds

            if seed in seeds and wanted("program"):
                emit({"kind": "program", "seed": seed, **check(prog)})
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
                emit({"kind": "altered_token", "seed": seed, **check(altered)})
            del prog
            for kind in calibrate.BEAM_FAULTS:
                if wanted(kind):
                    with calibrate.beam_fault(kind):
                        calls, _, _, proj = entry.sampled_calls(ctx)
                    emit({"kind": kind, "seed": seed, **check(calls, proj)})
            for kind in VISION_FAULTS:
                if wanted(kind):
                    with vision_fault(kind):
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
        print("calibrate_images: no CUDA device", file=sys.stderr)
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

    kinds = {k for k in args.kinds.split(",") if k} or None
    readings(cell, entry, seeds, control_seeds, "cuda", emit, kinds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
