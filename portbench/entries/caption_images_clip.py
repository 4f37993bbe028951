"""Captioning raw images with value-guided beam search through the
program's CLIP front end and ``api.Captioner``: the ``caption_images``
entry's loop and check, with CLIP's ViT-L/14@336px tower in VGG16's place.
One caller in a closed loop, each call a group of uint8 images ``[N, 336,
336, 3]`` through the two halves of ``Captioner.caption_images``, called
here in its order so that the check sees the features and the tokens:

    feats = extractor(images, batch_size=extract_batch)  # api.FeatureExtractor
    toks = captioner.caption_tokens(feats, beam_size=5)
    strs = decode_captions(toks, idx_to_word)

The extractor is the program's ``models/vit.py`` tower in bf16, its weights
drawn from the seed by ``portbench/reference/vit.draw_weights`` in the
``transformers`` layout and loaded by the program's
``convert.clip_vision_from_state_dict``, and a PCA from the embedding's 768
to ``input_dim`` fitted at set-up by the program's ``data/pca.fit_pca`` on
the embeddings of ``pca_fit_images`` images of their own. The calls cycle
through a ring of ``ring_images`` seeded images (``caption_images.images``
at 336: already decoded and centre-cropped; JPEG decoding is host work left
out of the cell). The captioner is the ``caption`` entry's, with its seeded
weights.

The check is ``caption_images``': ``pca_mean_gap`` and
``pca_variance_gap`` (the program's fit against the reference's own float64
fit of its float32 embeddings of the same images, ``reference.vgg.pca_gaps``),
``feature_gap`` (the worst row, over the ``check_calls`` calls drawn from
the seed among the first ``check_calls_from``, of the timed path's own PCA
output against ``portbench/reference/vit.py``'s float32 tower through the
program's fitted ``mean`` and ``components``, over the reference's norm),
and the beam half's four numbers as the ``caption`` entry takes them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import counts, counts_vit, harness, traffic, trainrun
from portbench.reference import vgg as ref_vgg
from portbench.reference import vit as ref_vit
from portbench.reference.nets import F32, Prec


def _images():
    return harness.entry_module("caption_images").images


def _caption():
    return harness.entry_module("caption")


def sizes(cfg: dict) -> dict:
    """The tower's sizes, as ``reference.vit.draw_weights`` takes them."""
    return {"image_size": cfg["image_size"], "patch": cfg["patch_size"],
            "width": cfg["hidden_size"], "layers": cfg["num_hidden_layers"],
            "mlp": cfg["intermediate_size"], "output_dim": cfg["projection_dim"]}


def draw_weights(cfg: dict, seed: int, device) -> dict:
    return ref_vit.draw_weights(traffic.sub_seed(seed, 3), device, **sizes(cfg))


def fit_images(cfg: dict, seed: int, tr: dict, device) -> np.ndarray:
    """The ``pca_fit_images`` images that the set-up fits the PCA on."""
    return _images()(traffic.sub_seed(seed, 4), tr["pca_fit_images"], device,
                     size=cfg["image_size"])


def setup(ctx):
    """The inputs and the program's extractor and ``Captioner``: ``(one(call)
    -> (features, tokens, strings), pixels(call) -> images, idx_to_word,
    the projection's (mean, components), the calls the check samples)``."""
    from image_captioning_through_rl_tpu_torch.api import Captioner, FeatureExtractor
    from image_captioning_through_rl_tpu_torch.config import NetConfig
    from image_captioning_through_rl_tpu_torch.data.coco import decode_captions
    from image_captioning_through_rl_tpu_torch.data.pca import fit_pca
    from image_captioning_through_rl_tpu_torch.models.convert import clip_vision_from_state_dict

    cfg, tr = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    group, beam, batch = tr["group_images"], tr["beam_size"], tr["extract_batch"]
    if tr["ring_images"] % group:
        raise ValueError(f"ring_images {tr['ring_images']} is not a whole number of groups "
                         f"of {group}")
    groups = tr["ring_images"] // group
    ring = _images()(traffic.sub_seed(ctx.seed, 1), tr["ring_images"], dev,
                     size=cfg["image_size"])
    sd = draw_weights(cfg, ctx.seed, dev)
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[cfg["vit_dtype"]]
    tower = clip_vision_from_state_dict(sd, heads=cfg["num_attention_heads"], device=dev)
    del sd
    stack = FeatureExtractor(tower, None, compute_dtype=dtype, device=ctx.device)
    fit = stack(fit_images(cfg, ctx.seed, tr, dev), batch_size=batch)
    proj = fit_pca(torch.from_numpy(fit).to(dev), k=cfg["input_dim"])
    extractor = FeatureExtractor(stack.model, proj, compute_dtype=dtype, device=ctx.device)
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
    tower = counts_vit.tower(cfg)
    call_flops = (batches * counts_vit.flops(batch, cfg["input_dim"], tower)
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
                           "window_flops": calls * call_flops, "tower": tower},
            "notes": {"calls": calls, "window_s": window, "checked_calls": sorted(kept),
                      "rows_diverged": nums["rows_diverged"],
                      "call_ms_quartiles": np.percentile(lat_ms, [0, 25, 50, 75, 100]).tolist()}}


def feature_gap(cfg, seed, kept, pixels, projection, device, prec: Prec = F32) -> float:
    """The worst row's ``|program - reference| / |reference|`` over the kept
    calls' features, the reference's tower computed at ``prec``."""
    if not kept:
        return float("nan")
    sd = draw_weights(cfg, seed, device)
    gap = 0.0
    for call, (feats, _, _) in sorted(kept.items()):
        want = ref_vit.features(sd, pixels(call), *projection, device, prec,
                                heads=cfg["num_attention_heads"])
        got = torch.from_numpy(np.asarray(feats, np.float32)).to(device)
        rel = torch.linalg.vector_norm(got - want, dim=1) / torch.linalg.vector_norm(want, dim=1)
        gap = max(gap, float(rel.max()))
    return gap


def reference_fit(cfg, seed, tr, k: int, device, prec: Prec = F32) -> tuple:
    """The reference's embedding table of the set-up's fit images, its tower
    computed at ``prec``, and the reference's own fit of it: ``(table,
    (mean, components))``."""
    sd = draw_weights(cfg, seed, device)
    table = ref_vit.embedding_table(sd, fit_images(cfg, seed, tr, device), device, prec,
                                    heads=cfg["num_attention_heads"])
    return table, ref_vgg.fit_pca(table, k)


def check(cfg, seed, kept, pixels, idx_to_word, projection, tr, device) -> dict:
    """The check's numbers over the fit and the kept calls (see the module's
    docstring), and, noted, ``rows_diverged`` as the ``caption`` entry's."""
    table, fit = reference_fit(cfg, seed, tr, projection[1].shape[1], device)
    pca = ref_vgg.pca_gaps(table, *fit, *projection)
    del table, fit
    gap = feature_gap(cfg, seed, kept, pixels, projection, device)
    if device.type != "cpu":
        torch.cuda.empty_cache()
    nums = _caption().check(cfg, seed, {c: (t, s) for c, (_, t, s) in kept.items()},
                            lambda call: kept[call][0], idx_to_word, tr["beam_size"], tr, device)
    return dict(pca, feature_gap=gap, **nums)
