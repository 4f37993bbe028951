"""The port's CLIP image tower (``models/vit.py``) against the benchmark's
plain reference (``portbench/reference/vit.py``: the tower written out in
float32 PyTorch, attention as ``softmax(q k^T / sqrt(d)) v``), its
``transformers``-layout loader, the extractor, the loader's CLIP geometry,
the ``vit.*`` spans and ``portbench/counts_vit.py``, on the CPU.

Tolerances: float32 at 1e-5 of each row's norm for the tiny tower (width
64, 4 heads, 2 layers, 56 px: sums of at most 588 terms in another order),
1e-4 for one block at the published widths (sums of 4096 terms); the bf16
tower within the CLIP cell's own ``feature_gap``, the check its runs on the
card must pass.
"""

import functools
import io
import json
import os

import numpy as np
import pytest
import torch
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile

from image_captioning_through_rl_tpu_torch.api import FeatureExtractor, load_feature_extractor
from image_captioning_through_rl_tpu_torch.data.pca import PCAProjection, fit_pca
from image_captioning_through_rl_tpu_torch.models import convert, vit
from image_captioning_through_rl_tpu_torch.models import vgg as tvgg
from image_captioning_through_rl_tpu_torch.utils import profiling
from portbench import counts, counts_vit
from portbench.reference import vgg as ref_vgg
from portbench.reference import vit as ref

torch.set_num_threads(2)

TINY = dict(image_size=56, patch=14, width=64, layers=2, mlp=256, output_dim=32)
HEADS = 4
CELL = os.path.join(os.path.dirname(__file__), "..", "portbench", "workloads",
                    "images-beam5-clipl14-336.json")


@functools.lru_cache(maxsize=None)
def _weights(seed=2**31 + 29):
    return ref.draw_weights(seed, "cpu", **TINY)


@functools.lru_cache(maxsize=None)
def _tower():
    return convert.clip_vision_from_state_dict(_weights(), heads=HEADS, device="cpu")


def _images(n, seed=3, size=56):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _row_gap(got, want) -> float:
    got, want = torch.as_tensor(got, dtype=torch.float32), torch.as_tensor(want)
    return float((torch.linalg.vector_norm(got - want, dim=1)
                  / torch.linalg.vector_norm(want, dim=1)).max())


def _limits() -> dict:
    with open(CELL) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("n", [1, 3])
def test_tiny_tower_matches_the_reference_in_float32(n):
    imgs = _images(n, seed=n)
    got = vit.features(_tower(), imgs)
    want = ref.embedding_table(_weights(), imgs, "cpu", heads=HEADS)
    assert got.shape == (n, 32) and got.dtype == torch.float32
    assert float(want.abs().max()) > 0
    assert _row_gap(got, want) < 1e-5


def test_one_block_at_the_published_widths():
    """A one-layer tower at ViT-L/14@336px's widths (1024, 16 heads of 64,
    MLP 4096, 577 tokens, projection 768) on one image: the program's
    patch product, block and head against the reference's convolution,
    written-out attention, LayerNorms and QuickGELU."""
    sd = ref.draw_weights(7, "cpu", layers=1)
    model = convert.clip_vision_from_state_dict(sd, device="cpu")
    assert len(model.transformer.resblocks) == 1
    assert model.transformer.resblocks[0].heads == 16 and model.image_size == 336
    img = _images(1, seed=9, size=336)
    got = vit.features(model, img)
    want = ref.embedding_table(sd, img, "cpu")
    assert got.shape == (1, 768)
    assert _row_gap(got, want) < 1e-4


def test_transformers_layout_round_trip():
    """A seeded ``CLIPVisionModelWithProjection`` state dict (with a text
    tower's key and ``position_ids``, which are dropped) loads, fuses q, k,
    v in order, and writes back the same tensors, key for key."""
    sd = dict(_weights())
    extra = {"vision_model.embeddings.position_ids": torch.arange(17)[None],
             "text_model.final_layer_norm.weight": torch.ones(8)}
    model = convert.clip_vision_from_state_dict({**sd, **extra}, heads=HEADS)
    blk = model.transformer.resblocks[1]
    w = blk.attn.in_proj_weight
    for k, c in enumerate("qkv"):
        assert torch.equal(w[k * 64:(k + 1) * 64],
                           sd[f"vision_model.encoder.layers.1.self_attn.{c}_proj.weight"])
    assert torch.equal(model.proj, sd["visual_projection.weight"].T)
    back = convert.clip_vision_to_state_dict(model)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    again = convert.clip_vision_from_state_dict(back, heads=HEADS)
    imgs = _images(2)
    assert torch.equal(vit.features(again, imgs), vit.features(model, imgs))


def test_loader_refuses_a_state_dict_that_is_not_clip():
    with pytest.raises(ValueError, match="not a CLIP vision state dict"):
        convert.clip_vision_from_state_dict(tvgg.VGG16(device="meta").state_dict())


def test_extractor_with_a_projection_on_ragged_input():
    """Five images at batch 2 (the last batch padded): the extractor's PCA
    features equal the reference's through the same projection, and its
    backbone, image size and dimension are CLIP's."""
    gen = torch.Generator().manual_seed(4)
    comps, _ = torch.linalg.qr(torch.randn(32, 8, generator=gen))
    proj = PCAProjection(mean=torch.rand(32, generator=gen), components=comps.contiguous())
    ext = FeatureExtractor(_tower(), proj, device="cpu")
    assert (ext.backbone, ext.image_size, ext.dim) == ("clip-vit-l14-336", 56, 8)
    assert ext.vgg is ext.model
    imgs = _images(5, seed=6)
    got = ext(imgs, batch_size=2)
    want = ref.features(_weights(), imgs, proj.mean, proj.components, "cpu", heads=HEADS)
    assert got.shape == (5, 8)
    assert _row_gap(got, want) < 1e-5
    assert tvgg.extract_features(_tower(), imgs[:0], batch_size=2).shape == (0, 32)


def test_bf16_tower_within_the_cells_feature_gap():
    """The cell's pipeline at the tiny size: a PCA fitted on the bf16
    tower's embeddings of 16 images of their own, two more images through
    the bf16 extractor, against the float32 reference through the same
    projection."""
    from portbench import harness
    images = harness.entry_module("caption_images").images
    tower = convert.clip_vision_from_state_dict(_weights(), heads=HEADS)
    stack = FeatureExtractor(tower, None, compute_dtype=torch.bfloat16, device="cpu")
    assert stack.model.proj.dtype == torch.bfloat16
    proj = fit_pca(torch.from_numpy(stack(images(21, 16, "cpu", size=56), batch_size=8)), k=8)
    imgs = images(22, 2, "cpu", size=56)
    got = FeatureExtractor(stack.model, proj, compute_dtype=torch.bfloat16, device="cpu")(imgs)
    want = ref.features(_weights(), imgs, proj.mean, proj.components, "cpu", heads=HEADS)
    assert 1e-4 < _row_gap(got, want) <= _limits()["feature_gap"]


def test_quick_gelu_layer_norm_and_preprocess_against_the_reference():
    x = torch.linspace(-8, 8, 1001)
    torch.testing.assert_close(vit.quick_gelu(x), ref.quick_gelu(x), rtol=1e-6, atol=1e-7)
    ln = torch.nn.LayerNorm(16, eps=ref.EPS)
    with torch.no_grad():
        ln.weight.uniform_(0.5, 1.5)
        ln.bias.uniform_(-0.5, 0.5)
    y = torch.randn(5, 16)
    torch.testing.assert_close(ln(y), ref.layer_norm(y, ln.weight, ln.bias), rtol=1e-5,
                               atol=1e-5)
    imgs = _images(2, size=336)
    got = vit.preprocess(imgs)
    torch.testing.assert_close(got, ref.preprocess(torch.from_numpy(imgs)), rtol=0, atol=1e-6)
    assert vit.preprocess(_images(2, size=100), size=56).shape == (2, 3, 56, 56)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_runs_the_math_backend_on_the_cpu(dtype):
    """The route: the math backend on the CPU, in either type; the result
    equals ``softmax(q k^T / sqrt(d)) v`` per head."""
    qkv = torch.randn(2, 5, 3 * 8, dtype=dtype)
    assert vit.attention_backend(qkv) == torch.nn.attention.SDPBackend.MATH
    got = vit.attention(qkv, heads=2).float()
    q, k, v = (t.float().view(2, 5, 2, 4).transpose(1, 2) for t in qkv.split(8, dim=-1))
    want = (torch.softmax(q @ k.transpose(2, 3) / 2.0, dim=-1) @ v).transpose(1, 2)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want.reshape(2, 5, 8), rtol=tol, atol=tol)


def _png(path, h, w, seed):
    from PIL import Image
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    Image.fromarray(px).save(path)
    return px


def test_load_image_batch_clip_geometry(tmp_path):
    """CLIP's transform on a 400 x 350 (w x h) file: the shorter side
    bicubic to 336 (the longer to 384), a centre crop from column 24; the
    extractor's loader takes it; VGG's default geometry stays bilinear 256
    then 224."""
    from PIL import Image

    from image_captioning_through_rl_tpu_torch.cli.extract import load_image_batch

    path = str(tmp_path / "a.png")
    px = _png(path, 350, 400, 1)
    got = load_image_batch([path], resize=336, crop=336, resample="bicubic")
    want = np.asarray(Image.fromarray(px).resize((384, 336), resample=Image.BICUBIC))
    np.testing.assert_array_equal(got[0], want[:, 24:24 + 336])
    np.testing.assert_array_equal(FeatureExtractor(vit.init(torch.Generator().manual_seed(0),
                                                            **TINY), device="cpu")
                                  .load_images([path]), load_image_batch(
                                      [path], resize=56, crop=56, resample="bicubic"))
    vgg = np.asarray(Image.fromarray(px).resize((293, 256), resample=Image.BILINEAR))
    np.testing.assert_array_equal(load_image_batch([path])[0], vgg[16:240, 34:258])
    with open(path, "rb") as f:
        np.testing.assert_array_equal(load_image_batch([io.BytesIO(f.read())])[0],
                                      vgg[16:240, 34:258])


def test_load_feature_extractor_reads_a_transformers_state_dict(tmp_path):
    path = str(tmp_path / "clip.pt")
    torch.save(dict(_weights()), path)
    ext = load_feature_extractor(path, device="cpu", backbone="clip-vit-l14-336")
    assert (ext.backbone, ext.dim, ext.image_size) == ("clip-vit-l14-336", 32, 56)
    imgs = _images(2)
    # heads are not in a state dict: the loader takes CLIP's width / 64,
    # so a tower of width 64 loads with one head
    assert ext.model.transformer.resblocks[0].heads == 1
    one_head = convert.clip_vision_from_state_dict(_weights(), heads=1)
    np.testing.assert_array_equal(ext(imgs), vit.features(one_head, imgs).numpy())
    with pytest.raises(ValueError, match="unknown backbone"):
        load_feature_extractor(path, device="cpu", backbone="resnet50")


def _attention_and_mlp_spans(prof):
    events = prof.profiler.kineto_results.events()
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.name().startswith(("extract.", "vit.")))


def test_vit_spans_nest_in_extract_stack_under_a_profiler():
    """Three images at batch 2: each batch's ``extract.stack`` holds one
    ``vit.attention`` and one ``vit.mlp`` a block, in order, and no other
    range holds them."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tvgg.extract_features(_tower(), _images(3), batch_size=2)
    ranges = _attention_and_mlp_spans(prof)
    stacks = [(s, e) for s, e, n in ranges if n == "extract.stack"]
    inner = [(s, e, n) for s, e, n in ranges if n.startswith("vit.")]
    assert len(stacks) == 2
    assert [n for _, _, n in inner] == ["vit.attention", "vit.mlp"] * 2 * TINY["layers"]
    for s, e, _ in inner:
        assert sum(a <= s and e <= b for a, b in stacks) == 1
    for (_, e, _), (s, _, _) in zip(inner, inner[1:]):
        assert e <= s  # siblings among themselves


def test_vit_spans_are_the_shared_noop_without_a_profiler(monkeypatch):
    taken = []

    def spy(name):
        taken.append(name)
        return profiling.annotate(name)
    monkeypatch.setattr(vit, "annotate", spy)
    vit.features(_tower(), _images(1))
    assert taken == ["vit.attention", "vit.mlp"] * TINY["layers"]
    assert all(profiling.annotate(n) is profiling._OFF for n in ("vit.attention", "vit.mlp"))


def _module_products(n: int, **sizes) -> float:
    """2 x the multiply-adds of every product of the program's tower at its
    shapes (a meta-device forward: ``F.linear``'s and the attention's)."""
    model = vit.VisionTransformer(device="meta", **sizes)
    total = [0.0]
    linear, sdpa = F.linear, F.scaled_dot_product_attention

    def count_linear(x, w, b=None):
        total[0] += 2.0 * x.numel() // x.shape[-1] * w.shape[0] * w.shape[1]
        return linear(x, w, b)

    def count_sdpa(q, k, v, **kw):
        total[0] += 4.0 * q.numel() * k.shape[-2]
        return sdpa(q, k, v, **kw)
    mp = pytest.MonkeyPatch()
    mp.setattr(F, "linear", count_linear)
    mp.setattr(F, "scaled_dot_product_attention", count_sdpa)
    try:
        x = torch.empty(n, 3, model.image_size, model.image_size, device="meta")
        out = model.embed(x)
        for block in model.transformer.resblocks:
            out = block(out)
        total[0] += 2.0 * n * model.width * model.feature_dim  # ln_post(x[:, 0]) @ proj
    finally:
        mp.undo()
    return total[0]


def test_counts_vit_products_are_the_modules():
    """ViT-L/14@336px: 381.92 GFLOP an image (the projection to 512 adds
    2 x 768 x 512), as the program's products at its shapes count them;
    each block 14.52 GFLOP of products beside 1.36 of attention core."""
    assert counts_vit.flops(1, 512) == pytest.approx(381.920575488e9)
    assert counts_vit.flops(2, 512) == pytest.approx(_module_products(2) + 2 * 2 * 768 * 512)
    work = dict(counts_vit.layers(1, 512))
    block = sum(w.flops for k, w in work.items() if k.endswith(".0") and "attention" not in k)
    assert block == pytest.approx(14.52e9, rel=1e-3)
    assert work["attention.0"].flops == pytest.approx(1.3636e9, rel=1e-3)
    tiny = counts_vit.tower({"image_size": 56, "patch_size": 14, "hidden_size": 64,
                             "num_hidden_layers": 2, "num_attention_heads": 4,
                             "intermediate_size": 256, "projection_dim": 32})
    assert counts_vit.flops(3, 8, tiny) == pytest.approx(
        _module_products(3, **TINY, heads=4) + 2 * 3 * 32 * 8)


def test_counts_vit_bounds_at_the_cells_batch():
    """At batch 64: the attention core 0.0903 ms a block (its bytes), each
    MLP product 0.313 ms (its operations), the tower 27.54 ms, above the
    24.7 ms its products alone take at the bf16 peak."""
    assert counts_vit.attention(64).bound_ms() == (pytest.approx(0.0903027, rel=1e-5), "bytes")
    assert [w.bound_ms()[1] for _, w in counts_vit.mlp(64)] == ["operations"] * 2
    assert counts_vit.bound_s(64, 512) == pytest.approx(27.539375e-3, rel=1e-6)
    assert counts_vit.bound_s(64, 512) > counts_vit.flops(64, 512) / counts.PEAK_BF16


def test_reference_pca_numbers_reused_for_clip_embeddings():
    """The CLIP cell holds its fit with ``reference/vgg.py``'s float64 fit
    and gaps: a float32 program fit of reference embeddings reads near 0."""
    table = ref.embedding_table(_weights(), _images(12, seed=8), "cpu", heads=HEADS)
    proj = fit_pca(table, k=8)
    gaps = ref_vgg.pca_gaps(table, *ref_vgg.fit_pca(table, 8), proj.mean, proj.components)
    assert gaps["pca_mean_gap"] < 1e-5 and gaps["pca_variance_gap"] < 1e-5, gaps
