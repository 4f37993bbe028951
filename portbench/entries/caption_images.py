"""Captioning raw images with value-guided beam search through the
program's visual front end and ``api.Captioner``: one caller in a closed
loop, each call a group of uint8 images ``[N, 224, 224, 3]`` through the
two halves of ``Captioner.caption_images``, called here in its order so
that the check sees the features and the tokens:

    feats = extractor(images, batch_size=extract_batch)  # api.FeatureExtractor
    toks = captioner.caption_tokens(feats, beam_size=5)
    strs = decode_captions(toks, idx_to_word)

The extractor is the program's VGG16 (configuration D) with its stack in
bf16 (``load_feature_extractor(bf16=True)``'s), weights drawn from the seed
by ``portbench/reference/vgg.draw_weights``, and a PCA fitted at set-up by
the program's ``data/pca.fit_pca`` on the stack's fc7 of
``pca_fit_images`` images of their own, as ``cli/extract`` fits one. The
calls cycle through a ring of ``ring_images`` seeded images, already
decoded and centre-cropped to 224 (what ``cli/extract.load_image_batch``
returns; decoding JPEGs is host work left out of the cell). The captioner
is the ``caption`` entry's, with its seeded weights.

The check holds the program's PCA fit against the reference's own fit,
and takes ``check_calls`` calls drawn from the seed among the first
``check_calls_from`` and holds every row of them against the reference:

- ``pca_mean_gap`` and ``pca_variance_gap``: the program's fitted ``mean``
  and ``components`` against those that ``portbench/reference/vgg.py``
  fits, in float64, to its own float32 fc7 of the same seeded images
  (``reference.vgg.pca_gaps``, blind to the components' signs);
- ``feature_gap``: the worst row's distance between the program's feature
  (the timed path's own PCA output) and the reference's (the float32 stack
  of ``portbench/reference/vgg.py`` through the program's fitted ``mean``
  and ``components``, handed over as data: the check of the projection's
  ``apply``), over the reference's norm;
- the beam half's four numbers as the ``caption`` entry defines and takes
  them (``strings_mismatched``, ``topb_gap``, ``score_excess_mean``,
  ``rows_scored_worse``), on the program's own features.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.nn import functional as F

from portbench import counts, counts_vgg, harness, traffic, trainrun
from portbench.reference import vgg as ref_vgg
from portbench.reference.nets import F32, Prec

# the smooth random fields an image mixes, in cells across
SCALES = (3, 9, 28, 112)


def images(seed: int, n: int, device, size: int = ref_vgg.IMAGE_SIZE,
           chunk: int = 256) -> np.ndarray:
    """``[n, size, size, 3]`` uint8 RGB stand-ins for decoded, centre-cropped
    photos, drawn on ``device`` in chunks: each image mixes, in weights of
    its own, smooth random fields of :data:`SCALES` cells across (bicubic up
    to ``size``), at a contrast and a tint of its own. A stack of random
    weights maps white noise to nearly one fc7 row; these part its rows as
    photos do."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = np.empty((n, size, size, 3), np.uint8)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    for at in range(0, n, chunk):
        m = min(chunk, n - at)
        w = rand(m, len(SCALES), 1, 1, 1)
        w = w / w.sum(dim=1, keepdim=True)
        x = sum(w[:, k] * F.interpolate(rand(m, 3, c, c), size=(size, size), mode="bicubic",
                                        align_corners=False)
                for k, c in enumerate(SCALES))
        x = (x - x.mean(dim=(1, 2, 3), keepdim=True)) * (1.0 + 3.0 * rand(m, 1, 1, 1))
        x = (x + rand(m, 3, 1, 1)).clamp(0.0, 1.0)
        out[at:at + m] = (x * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return out


def fit_images(seed: int, tr: dict, device) -> np.ndarray:
    """The ``pca_fit_images`` images that the set-up fits the PCA on."""
    return images(traffic.sub_seed(seed, 4), tr["pca_fit_images"], device)


def _caption():
    return harness.entry_module("caption")


def setup(ctx):
    """The inputs and the program's extractor and ``Captioner``: ``(one(call)
    -> (features, tokens, strings), pixels(call) -> images, idx_to_word,
    the projection's (mean, components), the calls the check samples)``."""
    from image_captioning_through_rl_tpu_torch.api import Captioner, FeatureExtractor
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    from image_captioning_through_rl_tpu_torch.data.pca import fit_pca
    from image_captioning_through_rl_tpu_torch.models.convert import vgg_from_state_dict

    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    group, beam, batch = tr["group_images"], tr["beam_size"], tr["extract_batch"]
    if tr["ring_images"] % group:
        raise ValueError(f"ring_images {tr['ring_images']} is not a whole number of groups "
                         f"of {group}")
    groups = tr["ring_images"] // group
    ring = images(traffic.sub_seed(ctx.seed, 1), tr["ring_images"], dev)
    sd = ref_vgg.draw_weights(traffic.sub_seed(ctx.seed, 3), dev)
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[cfg["vgg_dtype"]]
    stack = FeatureExtractor(vgg_from_state_dict(sd, device=dev), None, compute_dtype=dtype,
                             device=ctx.device)
    del sd
    fit = stack(fit_images(ctx.seed, tr, dev), batch_size=batch)
    proj = fit_pca(torch.from_numpy(fit).to(dev), k=cfg["input_dim"])
    extractor = FeatureExtractor(stack.vgg, proj, compute_dtype=dtype, device=ctx.device)
    word_to_idx, idx_to_word = traffic.vocab(cfg["vocab_size"])
    net_cfg = NetConfig.for_vocab(word_to_idx, None, input_dim=cfg["input_dim"],
                                  wordvec_dim=cfg["wordvec_dim"], hidden_dim=cfg["hidden_dim"])
    captioner = Captioner(_caption()._weights(cfg, ctx.seed, dev), net_cfg, idx_to_word,
                          device=ctx.device)

    def pixels(call):
        at = (call % groups) * group
        return ring[at: at + group]

    def one(call):
        feats = extractor(pixels(call), batch_size=batch)
        toks = captioner.caption_tokens(feats, beam_size=beam)
        return feats, toks, decode_captions(toks, idx_to_word)

    sample = set(np.random.default_rng(traffic.sub_seed(ctx.seed, 5)).choice(
        tr["check_calls_from"], size=tr["check_calls"], replace=False).tolist())
    projection = (proj.mean.detach().cpu(), proj.components.detach().cpu())
    return one, pixels, idx_to_word, projection, sample


def sampled_calls(ctx):
    """The program's answers to the calls a run checks, without a window:
    ``(kept, pixels, idx_to_word, projection)``."""
    one, pixels, idx_to_word, projection, sample = setup(ctx)
    return {call: one(call) for call in sorted(sample)}, pixels, idx_to_word, projection


def run(ctx) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    group, beam, batch = tr["group_images"], tr["beam_size"], tr["extract_batch"]
    one, pixels, idx_to_word, projection, sample = setup(ctx)
    for call in range(tr["warmup_calls"]):
        one(call)
    kept = {}
    t0 = time.perf_counter()
    call = 0
    while True:
        ts = time.perf_counter()
        got = one(call)
        te = time.perf_counter()
        ctx.spans.add("caption_call", ts, te)
        if call in sample:
            kept[call] = got
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
        nums = check(cfg, ctx.seed, kept, pixels, idx_to_word, projection, tr,
                     torch.device(ctx.device))
    shape = (cfg["vocab_size"], cfg["wordvec_dim"], cfg["hidden_dim"], cfg["input_dim"],
             cfg["max_seq_len"], beam)
    batches = -(-group // batch)
    call_flops = (batches * counts_vgg.flops(batch, cfg["input_dim"])
                  + counts.beam(group, *shape).flops)
    lat_ms = [(e - s) * 1e3 for s, e in ctx.spans.of("caption_call")]
    return {"end_to_end": {"setup_s": t0 - ctx.t_start,
                           "captions_per_s": calls * group / window,
                           "caption_call_p95_ms": float(np.percentile(lat_ms, 95))},
            "attempted": calls * group, "failed": 0,
            "checks": {k: (nums[k], lim) for k, lim in limits.items()},
            "device": trainrun.device_info(ctx),
            "trace_info": {"group": group, "shape": shape, "extract_batch": batch,
                           "pca_dim": cfg["input_dim"], "window_s": window,
                           "window_flops": calls * call_flops},
            "notes": {"calls": calls, "window_s": window, "checked_calls": sorted(kept),
                      "rows_diverged": nums["rows_diverged"],
                      "call_ms_quartiles": np.percentile(lat_ms, [0, 25, 50, 75, 100]).tolist()}}


def feature_gap(seed, kept, pixels, projection, device, prec: Prec = F32) -> float:
    """The worst row's ``|program - reference| / |reference|`` over the kept
    calls' features, the reference's stack computed at ``prec``."""
    if not kept:
        return float("nan")
    sd = ref_vgg.draw_weights(traffic.sub_seed(seed, 3), device)
    gap = 0.0
    for call, (feats, _, _) in sorted(kept.items()):
        want = ref_vgg.features(sd, pixels(call), *projection, device, prec)
        got = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
        rel = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)
        gap = max(gap, float(rel.max()))
    return gap


def reference_fit(seed, tr, k: int, device, prec: Prec = F32) -> tuple:
    """The reference's fc7 table of the set-up's fit images, its stack
    computed at ``prec``, and the reference's own fit of it:
    ``(table, (mean, components))``."""
    sd = ref_vgg.draw_weights(traffic.sub_seed(seed, 3), device)
    table = ref_vgg.fc7_table(sd, fit_images(seed, tr, device), device, prec)
    return table, ref_vgg.fit_pca(table, k)


def check(cfg, seed, kept, pixels, idx_to_word, projection, tr, device) -> dict:
    """The check's numbers over the fit and the kept calls (see the module's
    docstring), and, noted, ``rows_diverged`` as the ``caption`` entry's."""
    table, fit = reference_fit(seed, tr, projection[1].shape[1], device)
    pca = ref_vgg.pca_gaps(table, *fit, *projection)
    del table, fit
    gap = feature_gap(seed, kept, pixels, projection, device)
    if device.type != "cpu":
        torch.cuda.empty_cache()
    nums = _caption().check(cfg, seed, {c: (t, s) for c, (_, t, s) in kept.items()},
                            lambda call: kept[call][0], idx_to_word, tr["beam_size"], tr, device)
    return dict(pca, feature_gap=gap, **nums)
