"""The port's visual front end against the benchmark's plain reference
(``portbench/reference/vgg.py``: VGG16 configuration D, the PCA projection
in float32 ``torch.nn.functional`` and the PCA fit in float64), and its
spans (``models/vgg.iter_features``), on the CPU.

Tolerances: float32 to 1e-4 of each row's norm, as ``test_torch_vision``
holds fc7 against the JAX package (products of up to 25088 terms summed in
another order); the program's float32 fit of a table to 1e-5 of the
reference's; the bf16 stack and its fit within the image cell's own
limits, the checks its runs on the card must pass.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_captioning_through_rl_tpu_torch.api import Captioner, FeatureExtractor
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data.pca import PCAProjection, fit_pca
from image_captioning_through_rl_tpu_torch.models import convert, policy, value
from image_captioning_through_rl_tpu_torch.models import vgg as tvgg
from image_captioning_through_rl_tpu_torch.utils import profiling
from portbench import harness
from portbench.reference import vgg as ref

torch.set_num_threads(2)

REL = 1e-4
SPANS = ("extract.pixels_in", "extract.stack", "extract.features_out")
CELL = os.path.join(os.path.dirname(__file__), "..", "portbench", "workloads",
                    "images-beam5-vgg16.json")


@functools.lru_cache(maxsize=None)
def _weights():
    return ref.draw_weights(2**31 + 11, "cpu")


@functools.lru_cache(maxsize=None)
def _limits() -> dict:
    with open(CELL) as f:
        return json.load(f)["limits"]


@functools.lru_cache(maxsize=None)
def _vgg():
    return convert.vgg_from_state_dict(_weights(), device="cpu")


def _images(n, seed=3, size=224):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _smooth_images(n, seed):
    """Images the image cell draws (smooth fields, a contrast and a tint
    each), which a random stack parts as it parts photos."""
    return harness.entry_module("caption_images").images(seed, n, "cpu")


def _row_gap(got, want) -> float:
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())


def test_reference_weights_load_into_the_programs_vgg16():
    """The reference's weights are the program's state dict, key for key and
    shape for shape, drawn N(0, 2 / fan_in) with zero biases."""
    sd, model = _weights(), _vgg()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    for i, c_in, _ in ref.conv_layers():
        w = sd[f"features.{i}.weight"]
        assert float(w.std()) == pytest.approx((2.0 / (9 * c_in)) ** 0.5, rel=0.05)
        assert not sd[f"features.{i}.bias"].any()


def test_fc7_matches_the_reference_in_float32():
    imgs = _images(2)
    got = FeatureExtractor(_vgg(), None, device="cpu")(imgs)
    want = ref.fc7(_weights(), ref.preprocess(torch.from_numpy(imgs)))
    assert got.shape == (2, 4096) and got.dtype == np.float32
    assert _row_gap(got, want) < REL


def test_projected_features_match_the_reference_in_float32():
    gen = torch.Generator().manual_seed(4)
    comps, _ = torch.linalg.qr(torch.randn(4096, 8, generator=gen))
    proj = PCAProjection(mean=torch.rand(4096, generator=gen), components=comps.contiguous())
    imgs = _images(2, seed=5)
    got = FeatureExtractor(_vgg(), proj, device="cpu")(imgs, batch_size=2)
    want = ref.features(_weights(), imgs, proj.mean, proj.components, "cpu")
    assert got.shape == (2, 8)
    assert _row_gap(got, want) < REL


@functools.lru_cache(maxsize=None)
def _bf16_fit():
    """The cell's set-up at a small size: the bf16 stack, and a PCA fitted
    on its fc7 of 8 images of their own."""
    stack = FeatureExtractor(convert.vgg_from_state_dict(_weights(), device="cpu"), None,
                             compute_dtype=torch.bfloat16, device="cpu")
    return stack, fit_pca(torch.from_numpy(stack(_smooth_images(8, 21), batch_size=4)), k=8)


def _spread_table(n, d, seed):
    """A table ``[n, d]`` off the origin whose principal variances fall
    apart geometrically, so each component stands clear of the next."""
    gen = torch.Generator().manual_seed(seed)
    basis, _ = torch.linalg.qr(torch.randn(d, min(n, d), generator=gen))
    scale = 0.7 ** torch.arange(min(n, d), dtype=torch.float32)
    return (torch.randn(n, min(n, d), generator=gen) * scale) @ basis.T + torch.rand(d, generator=gen)


@pytest.mark.parametrize("n, d, k, as_array", [(12, 40, 5, False), (40, 12, 12, False),
                                               (64, 256, 16, False), (9, 4096, 8, False),
                                               (64, 256, 16, True)])
def test_fit_pca_matches_the_reference_fit(n, d, k, as_array):
    """The program's fit of a table (a tensor or an array) against the
    reference's float64 fit of it: the same mean, and components that take
    the same variance in the same order, whatever their signs."""
    table = _spread_table(n, d, seed=n + d)
    proj = fit_pca(table.numpy() if as_array else table, k=k)
    assert proj.components.shape == (d, k) and proj.components.dtype == torch.float32
    gaps = ref.pca_gaps(table, *ref.fit_pca(table, k), proj.mean, proj.components)
    assert gaps["pca_mean_gap"] < 1e-5 and gaps["pca_variance_gap"] < 1e-5, gaps


def test_bf16_fit_within_the_cells_pca_limits():
    """The bf16 stack's fit against the reference's own fit of its float32
    fc7 of the same 8 images."""
    _, proj = _bf16_fit()
    table = ref.fc7_table(_weights(), _smooth_images(8, 21), "cpu")
    gaps = ref.pca_gaps(table, *ref.fit_pca(table, 8), proj.mean, proj.components)
    for name, gap in gaps.items():
        assert 0 < gap <= _limits()[name], (name, gap)


def test_bf16_stack_within_the_cells_feature_gap():
    """The cell's pipeline at a small size: a PCA fitted on the bf16 stack's
    fc7 of images of their own, two more images through the bf16 extractor,
    against the float32 reference through the same projection."""
    limit = _limits()["feature_gap"]
    stack, proj = _bf16_fit()
    imgs = _smooth_images(2, 22)
    got = FeatureExtractor(stack.vgg, proj, compute_dtype=torch.bfloat16, device="cpu")(imgs)
    want = ref.features(_weights(), imgs, proj.mean, proj.components, "cpu")
    gap = _row_gap(got, want)
    assert 1e-4 < gap <= limit  # bf16 rounding shows, within the limit


def _extract_ranges(prof) -> list:
    events = prof.profiler.kineto_results.events()
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.name().startswith(("extract.", "caption.")))


def test_extract_spans_are_siblings_in_order_under_a_profiler():
    """Three images at batch 2: each batch's pixels in, then its stack, then
    (every batch still on the device) the two blocks read back and joined."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feats = tvgg.extract_features(_vgg(), _images(3, size=16), batch_size=2)
    assert feats.shape == (3, 4096)
    ranges = _extract_ranges(prof)
    assert [n for _, _, n in ranges] == [
        "extract.pixels_in", "extract.stack", "extract.pixels_in", "extract.stack",
        "extract.features_out", "extract.features_out", "extract.features_out"]
    for (_, end, _), (start, _, _) in zip(ranges, ranges[1:]):
        assert end <= start  # siblings: none inside another


def test_extract_spans_are_the_shared_noop_without_a_profiler(monkeypatch):
    taken = []

    def spy(name):
        taken.append(name)
        return profiling.annotate(name)
    monkeypatch.setattr(tvgg, "annotate", spy)
    tvgg.extract_features(_vgg(), _images(2, size=16), batch_size=2)
    assert taken == ["extract.pixels_in", "extract.stack", "extract.features_out",
                     "extract.features_out"]
    assert all(profiling.annotate(n) is profiling._OFF for n in SPANS)


def test_caption_images_extracts_outside_the_caption_spans():
    """``Captioner.caption_images``: the front end's spans come first, none
    inside a ``caption.*`` span."""
    cfg = NetConfig(vocab_size=20, input_dim=8, wordvec_dim=8, hidden_dim=8, max_seq_len=6)
    gen = torch.Generator().manual_seed(0)
    cap = Captioner({"policy": policy.init(gen, cfg), "value": value.init(gen, cfg)}, cfg,
                    {i: f"w{i}" for i in range(cfg.vocab_size)}, device="cpu")
    comps, _ = torch.linalg.qr(torch.randn(4096, 8, generator=gen))
    extractor = FeatureExtractor(_vgg(), PCAProjection(torch.zeros(4096), comps.contiguous()),
                                 device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = cap.caption_images(_images(2, size=16), extractor, batch_size=2, beam_size=2)
    assert len(out) == 2
    ranges = _extract_ranges(prof)
    names = [n for _, _, n in ranges]
    first_caption = min(i for i, n in enumerate(names) if n.startswith("caption."))
    assert set(names[:first_caption]) == set(SPANS)
    assert not any(n.startswith("extract.") for n in names[first_caption:])
    assert ranges[first_caption - 1][1] <= ranges[first_caption][0]


