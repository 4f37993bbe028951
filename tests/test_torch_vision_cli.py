"""The port's raw-image paths against the JAX package's, on the CPU:
``cli/extract``, ``FeatureExtractor`` / ``load_feature_extractor``,
``Captioner.caption_images`` / ``sample_images`` and ``cli/caption``, and the
``cli/build_data``'s hint that names the port's extractor.

Both packages load one torchvision-layout VGG16 ``.pt`` (the JAX
initialiser's weights) and read PNGs of five sizes written from a seeded
numpy generator; the models are JAX-initialised ``.ckpt`` files for 8-d
(PCA) input. The JAX side decodes through its XLA paths
(``use_fused_kernel=False``); the port's plain decodes on the CPU equal them
(``test_torch_server.py``, ``test_torch_sample.py``).

Tolerances: fc7 tables to rtol 1e-4, atol 1e-6 (``test_torch_vision.py``
says why). A PCA fitted by each CLI on its own fc7 table: the components
agree up to a sign each, within the Davis-Kahan bound ``2 |E| / gap_j`` on
the sine of their angle, E the difference of the two centred tables and
gap_j component j's distance to the nearest other singular value of the
JAX table (a random-weight VGG16 maps random images to nearly equal
features, so the centred table's singular values are ~1e-5 and close
together: the bound, not a fixed tolerance, says how far two fits of
tables ~1e-8 apart may turn).
"""

import functools
import io
import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_captioning_through_rl_tpu import api as japi
from image_captioning_through_rl_tpu.cli import caption as jcaption_cli
from image_captioning_through_rl_tpu.cli import extract as jextract_cli
from image_captioning_through_rl_tpu.config import NetConfig as JNetConfig
from image_captioning_through_rl_tpu.models import a2c as ja2c
from image_captioning_through_rl_tpu.models import vgg as jvgg
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu_torch import api as tapi
from image_captioning_through_rl_tpu_torch.cli import caption as tcaption_cli
from image_captioning_through_rl_tpu_torch.cli import extract as textract_cli
from image_captioning_through_rl_tpu_torch.config import NetConfig
from image_captioning_through_rl_tpu_torch.data import pca as tpca
from image_captioning_through_rl_tpu_torch.data.hdf5 import read_h5
from image_captioning_through_rl_tpu_torch.models import convert as tconvert
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.models import vgg as tvgg
from image_captioning_through_rl_tpu_torch.parallel import make_mesh

torch.set_num_threads(2)

FC7_RTOL, FC7_ATOL = 1e-4, 1e-6
VOCAB = ["<NULL>", "<START>", "<END>", "<UNK>"] + [f"w{i}" for i in range(26)]
WORD_TO_IDX = {w: i for i, w in enumerate(VOCAB)}
PCA_DIM = 8
IMAGE_SHAPES = ((40, 60), (64, 48), (300, 200), (100, 100), (224, 224))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX VGG16 as a torchvision-layout ``.pt``, PNGs of five sizes, a
    PCA to 8 components, a vocabulary and a2c / policy / value ``.ckpt``
    files for 8-d input."""
    d = tmp_path_factory.mktemp("vision_cli")
    rng = np.random.default_rng(0)
    host = jax.tree.map(np.asarray, jvgg.init(jax.random.PRNGKey(0)))
    torch.save(tconvert.vgg_from_jax(from_jax_params(host)).state_dict(), d / "vgg16.pt")
    del host
    img_dir = d / "images"
    img_dir.mkdir()
    for i, (h, w) in enumerate(IMAGE_SHAPES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i:03d}.png")
    tpca.PCAProjection(torch.zeros(4096), torch.from_numpy(
        rng.standard_normal((4096, PCA_DIM)).astype(np.float32) * 0.01)).save(str(d / "pca"))
    (d / "coco2014_vocab.json").write_text(json.dumps(
        {"word_to_idx": WORD_TO_IDX, "idx_to_word": VOCAB}))
    params = ja2c.init(jax.random.PRNGKey(0), JNetConfig.for_vocab(WORD_TO_IDX,
                                                                   input_dim=PCA_DIM))
    jckpt.save_pytree(params["policy"], str(d / "policyNetwork.ckpt"))
    jckpt.save_pytree(params["value"], str(d / "valueNetwork.ckpt"))
    jckpt.save_pytree(params, str(d / "a2cNetwork.ckpt"))
    return d


def _paths(files):
    return textract_cli.list_images(str(files / "images"), None)


@pytest.fixture(scope="module")
def extractors(files):
    """Both packages' extractors on the ``.pt`` and the PCA (loaded once)."""
    return (japi.load_feature_extractor(str(files / "vgg16.pt"), str(files / "pca.npz")),
            tapi.load_feature_extractor(str(files / "vgg16.pt"), str(files / "pca.npz"),
                                        device="cpu"))


# ---- cli/extract ----


def _h5(path):
    with h5py.File(path) as f:
        return np.asarray(f["features"])


def _check_fits(got_npz, want_npz, got_raw, want_raw):
    """Two PCA fits of two fc7 tables: the means to the tables' tolerance,
    each component within the Davis-Kahan bound of the other's, up to its
    sign."""
    np.testing.assert_allclose(got_npz["mean"], want_npz["mean"], rtol=FC7_RTOL, atol=FC7_ATOL)
    xc = (want_raw - want_raw.mean(0)).astype(np.float64)
    err = np.linalg.norm((got_raw - got_raw.mean(0)).astype(np.float64) - xc, 2)
    sv = np.linalg.svd(xc, compute_uv=False)
    a, b = (np.asarray(z["components"], np.float64) for z in (got_npz, want_npz))
    for j in range(a.shape[1]):
        gap = np.min(np.abs(np.delete(sv, j) - sv[j]))
        cos = abs(a[:, j] @ b[:, j]) / (np.linalg.norm(a[:, j]) * np.linalg.norm(b[:, j]))
        sin = np.sqrt(max(0.0, 1.0 - cos * cos))
        assert sin <= 2 * err / gap + 1e-4, (j, sin, 2 * err / gap)


def test_extract_cli_matches_jax(files, tmp_path, capsys):
    """Without PCA, with a fit (``--pca_components``), with ``--pca_from``
    and ``--file_list`` (streamed block by block), and the refit refusal:
    the port's tables equal the JAX CLI's."""
    images, weights = str(files / "images"), str(files / "vgg16.pt")
    common = ["--images_dir", images, "--split", "val", "--weights", weights, "--batch_size", "2"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jextract_cli.main(common + ["--out_dir", jdir, "--pca_components", "4"])
    textract_cli.main(common + ["--out_dir", tdir, "--pca_components", "4", "--device", "cpu"])
    raw = _h5(os.path.join(jdir, "val2014_vgg16_fc7.h5"))
    assert raw.shape == (len(IMAGE_SHAPES), 4096)
    got_raw = read_h5(os.path.join(tdir, "val2014_vgg16_fc7.h5"))["features"]
    np.testing.assert_allclose(got_raw, raw, rtol=FC7_RTOL, atol=FC7_ATOL)
    tz = np.load(os.path.join(tdir, "vgg16_fc7_pca.npz"))
    _check_fits(tz, np.load(os.path.join(jdir, "vgg16_fc7_pca.npz")), got_raw, raw)
    # the port's projected table is its projection of its table
    np.testing.assert_allclose(
        read_h5(os.path.join(tdir, "val2014_vgg16_fc7_pca.h5"))["features"],
        (got_raw - tz["mean"]) @ tz["components"], rtol=1e-5, atol=1e-9)
    assert _h5(os.path.join(jdir, "val2014_vgg16_fc7_pca.h5")).shape == (len(IMAGE_SHAPES), 4)
    # another split must reuse the basis: a refit without --pca_refit is refused
    with pytest.raises(SystemExit, match="already exists"):
        textract_cli.main(common + ["--out_dir", tdir, "--pca_components", "4",
                                    "--device", "cpu"])
    # --pca_from the JAX fit and --file_list (two images, reversed)
    names = sorted(os.listdir(images))[:2][::-1]
    order = tmp_path / "order.txt"
    order.write_text("\n".join(names) + "\n")
    extra = ["--file_list", str(order), "--split", "train", "--pca_from",
             os.path.join(jdir, "vgg16_fc7_pca.npz")]
    jextract_cli.main(common + ["--out_dir", jdir] + extra)
    textract_cli.main(common + ["--out_dir", tdir, "--device", "cpu"] + extra)
    for name in ("train2014_vgg16_fc7.h5", "train2014_vgg16_fc7_pca.h5"):
        want = _h5(os.path.join(jdir, name))
        got = read_h5(os.path.join(tdir, name))["features"]
        assert got.shape == want.shape and got.shape[0] == 2
        np.testing.assert_allclose(got, want, rtol=FC7_RTOL, atol=FC7_ATOL, err_msg=name)
    np.testing.assert_array_equal(read_h5(os.path.join(tdir, "train2014_vgg16_fc7.h5"))["features"],
                                  got_raw[[1, 0]])
    capsys.readouterr()


def test_extract_cli_spmd_and_mesh_raise(files, tmp_path):
    """``--spmd`` (each batch split over the process's devices: the CPU's
    one) writes the table one device writes, and an extractor over a mesh
    of three CPU entries (each padded batch split in three) gives one
    device's features, within the fc7 tolerance of a batch computed in
    other shapes; a mesh that spans processes is refused."""
    common = ["--images_dir", str(files / "images"), "--weights", str(files / "vgg16.pt"),
              "--batch_size", "2", "--device", "cpu"]
    textract_cli.main(common + ["--out_dir", str(tmp_path / "one")])
    textract_cli.main(common + ["--out_dir", str(tmp_path / "spmd"), "--spmd"])
    name = "val2014_vgg16_fc7.h5"
    np.testing.assert_array_equal(read_h5(str(tmp_path / "spmd" / name))["features"],
                                  read_h5(str(tmp_path / "one" / name))["features"])
    one = tapi.load_feature_extractor(str(files / "vgg16.pt"), str(files / "pca.npz"),
                                      device="cpu")
    three = tapi.load_feature_extractor(str(files / "vgg16.pt"), str(files / "pca.npz"),
                                        mesh=make_mesh(devices=["cpu"] * 3), device="cpu")
    paths = _paths(files)
    for batch in (1, 2, 4):
        np.testing.assert_allclose(three(paths, batch_size=batch), one(paths, batch_size=2),
                                   rtol=FC7_RTOL, atol=FC7_ATOL)

    class Spanning:
        spans_processes = True

    with pytest.raises(ValueError, match="one process"):
        tvgg.extract_features(one.vgg, textract_cli.load_image_batch(paths), mesh=Spanning())


def test_build_data_hint_names_the_port(tmp_path, capsys):
    """``cli/build_data``'s "next: extract features" hint runs the port's
    ``cli.extract``, not the JAX package's."""
    from image_captioning_through_rl_tpu_torch.cli import build_data

    paths = {}
    for split, n in (("train", 3), ("val", 2)):
        paths[split] = tmp_path / f"captions_{split}2014.json"
        paths[split].write_text(json.dumps({
            "images": [{"id": i, "file_name": f"COCO_{split}2014_{i:012d}.jpg"}
                       for i in range(n)],
            "annotations": [{"image_id": i, "caption": f"a photo of thing {i}"}
                            for i in range(n)]}))
    build_data.main(["--train_annotations", str(paths["train"]), "--val_annotations",
                     str(paths["val"]), "--out_dir", str(tmp_path / "out"), "--min_count", "1"])
    out = capsys.readouterr().out
    assert "python -m image_captioning_through_rl_tpu_torch.cli.extract" in out
    assert "image_captioning_through_rl_tpu.cli.extract" not in out


# ---- FeatureExtractor, Captioner ----


def test_feature_extractor_paths_and_arrays(files, extractors):
    _, ext = extractors
    assert ext.dim == PCA_DIM and ext.compute_dtype is None
    paths = _paths(files)
    by_path = ext(paths, batch_size=2)
    pixels = textract_cli.load_image_batch(paths)
    np.testing.assert_array_equal(pixels, jextract_cli.load_image_batch(paths))
    assert by_path.shape == (len(paths), PCA_DIM)
    np.testing.assert_array_equal(by_path, ext(pixels, batch_size=2))
    sharded = tapi.FeatureExtractor(ext.vgg, ext.projection, mesh=make_mesh(devices=["cpu"] * 2),
                                    device="cpu")
    assert sharded.device == torch.device("cpu") and sharded.dim == PCA_DIM
    np.testing.assert_allclose(sharded(pixels, batch_size=2), by_path, rtol=FC7_RTOL,
                               atol=FC7_ATOL)


@functools.lru_cache(maxsize=None)
def _captioners():
    """Both Captioners on one JAX-initialised a2c at a narrow width (the
    CLIs' tests take the default width their files need)."""
    widths = dict(input_dim=PCA_DIM, wordvec_dim=32, hidden_dim=32)
    cfg = JNetConfig.for_vocab(WORD_TO_IDX, precision="highest", **widths)
    params = ja2c.init(jax.random.PRNGKey(1), cfg)
    jcap = japi.Captioner(params, cfg, dict(enumerate(VOCAB)))
    tcap = tapi.Captioner(from_jax_params(jax.tree.map(np.asarray, params)),
                          NetConfig.for_vocab(WORD_TO_IDX, **widths), dict(enumerate(VOCAB)),
                          device="cpu")
    return jcap, tcap


def test_caption_and_sample_images_match_jax(files, extractors):
    jext, text = extractors
    jcap, tcap = _captioners()
    paths = _paths(files)[1:3]  # one batch of two images a call
    for beam in (0, 5):
        assert (tcap.caption_images(paths, text, batch_size=2, beam_size=beam)
                == jcap.caption_images(paths, jext, batch_size=2, beam_size=beam,
                                       use_fused_kernel=False)), beam
    kw = dict(temperature=0.8, num_samples=2, seed=3)
    got = tcap.sample_images(paths, text, batch_size=2, **kw)
    assert got == jcap.sample_images(paths, jext, batch_size=2, use_fused_kernel=False, **kw)
    assert len(got) == 2 and all(len(row) == 2 for row in got)
    # an extractor without the PCA: the JAX package's mismatch error
    with pytest.raises(ValueError) as ours:
        tcap.caption_images(paths[:1], tapi.FeatureExtractor(text.vgg, device="cpu"),
                            batch_size=1)
    with pytest.raises(ValueError) as theirs:
        jcap.caption_images(paths[:1], japi.FeatureExtractor(jext.vgg_params), batch_size=1)
    assert str(ours.value) == str(theirs.value)


def test_random_weights_warn_on_stderr(capsys):
    ext = tapi.load_feature_extractor(device="cpu")
    assert ext.dim == 4096 and ext.compute_dtype is None
    assert "random VGG16 weights" in capsys.readouterr().err


def test_bf16_extractor_casts_once(files):
    ext = tapi.load_feature_extractor(str(files / "vgg16.pt"), bf16=True, device="cpu")
    assert ext.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in ext.vgg.parameters())


# ---- cli/caption ----


@pytest.mark.parametrize("mode", [["--beam_size", "0"], ["--beam_size", "5"],
                                  ["--beam_size", "3", "--faithful_beam"],
                                  ["--sample", "--temperature", "0.8", "--num_samples", "2",
                                   "--sample_seed", "4"]],
                         ids=["greedy", "beam", "faithful_beam", "sampled"])
def test_caption_cli_matches_jax(files, tmp_path, capsys, mode):
    argv = [*_paths(files)[1:3], "--model", str(files / "a2cNetwork.ckpt"),
            "--vocab", str(files), "--vgg_weights", str(files / "vgg16.pt"),
            "--pca", str(files / "pca.npz"), "--batch_size", "2", *mode]
    jcaption_cli.main(argv + ["--out", str(tmp_path / "jax.txt")])
    tcaption_cli.main(argv + ["--out", str(tmp_path / "port.txt"), "--device", "cpu"])
    want = (tmp_path / "jax.txt").read_text()
    assert (tmp_path / "port.txt").read_text() == want
    assert len(want.splitlines()) == 2 * (2 if "--sample" in mode else 1)
    capsys.readouterr()


def test_caption_cli_images_dir_to_stdout(files, capsys):
    tcaption_cli.main(["--images_dir", str(files / "images"), "--model",
                       str(files / "a2cNetwork.ckpt"), "--vocab",
                       str(files / "coco2014_vocab.json"), "--vgg_weights",
                       str(files / "vgg16.pt"), "--pca", str(files / "pca.npz"), "--device", "cpu",
                       "--batch_size", "4"])
    lines = [line for line in capsys.readouterr().out.splitlines() if "\t" in line]
    assert [line.split("\t")[0] for line in lines] == _paths(files)
    with pytest.raises(SystemExit):
        tcaption_cli.main(["--model", "m.ckpt", "--vocab", "v.json", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcaption_cli.main([_paths(files)[0], "--model", "m.ckpt", "--vocab", "v.json",
                           "--sample", "--beam_size", "2", "--device", "cpu"])


def test_load_image_batch_takes_file_objects(files):
    path = _paths(files)[2]
    with open(path, "rb") as f:
        blob = io.BytesIO(f.read())
    np.testing.assert_array_equal(textract_cli.load_image_batch([blob]),
                                  textract_cli.load_image_batch([path]))
