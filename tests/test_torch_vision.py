"""The port's visual front end against the JAX package's, on the CPU:
VGG16 (``models/vgg``), its converters and ``.ckpt`` files, PCA
(``data/pca``) and the streaming HDF5 writer. (``cli/extract``,
``FeatureExtractor``, the ``Captioner``'s image paths and ``cli/caption``
are ``test_torch_vision_cli.py``'s.) Weights are the JAX initialiser's,
carried over (``vgg_from_jax``) or written as a torchvision-layout ``.pt``
that both packages load.

Tolerances: fc7 to rtol 1e-4, atol 1e-6 (float32 convolutions and products
of up to 25088 terms, summed in another order; measured ~3e-6 relative);
``preprocess`` to atol 1e-4 after the normalisation (both frameworks
compute the same antialiased bilinear filter, which the float64 form of
either reproduces to 1e-13; in float32 the sample positions round by up to
~n 2^-24 pixels, ~1.2e-5 of the [0, 1] range at 300 -> 224); bf16 against
float32 by the JAX package's own bound (mean absolute difference under 10%
of the mean magnitude). PCA components agree up to a sign per component
(an SVD's signs are arbitrary in both frameworks), to atol 1e-4.
"""

import functools
import hashlib
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.data import pca as jpca
from image_captioning_through_rl_tpu.models import vgg as jvgg
from image_captioning_through_rl_tpu.models.convert import vgg_from_torch
from image_captioning_through_rl_tpu.train import checkpoint as jckpt
from image_captioning_through_rl_tpu_torch.data import pca as tpca
from image_captioning_through_rl_tpu_torch.data.hdf5 import H5Writer, read_h5
from image_captioning_through_rl_tpu_torch.models import convert as tconvert
from image_captioning_through_rl_tpu_torch.models import from_jax_params
from image_captioning_through_rl_tpu_torch.models import vgg as tvgg

torch.set_num_threads(2)

FC7_RTOL, FC7_ATOL, PRE_ATOL, PCA_ATOL = 1e-4, 1e-6, 1e-4, 1e-4


@functools.lru_cache(maxsize=None)
def _jax_vgg():
    return jvgg.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_vgg():
    return tconvert.vgg_from_jax(from_jax_params(jax.tree.map(np.asarray, _jax_vgg())))


# ---- VGG16 ----


def test_conv_stack_matches_jax_at_32():
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvgg._conv_stack(_jax_vgg(), jnp.asarray(x), precision="highest"))
    got = _port_vgg().features(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 1, 1, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=FC7_RTOL, atol=FC7_ATOL)


def test_channels_last_stack_matches_jax_at_32():
    """The card's route (convolutions without their bias, then the bias,
    ReLU and pool epilogue; its plain version here) in channels-last memory."""
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvgg._conv_stack(_jax_vgg(), jnp.asarray(x), precision="highest"))
    got = _port_vgg().channels_last_stack(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 1, 1, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=FC7_RTOL, atol=FC7_ATOL)


@functools.lru_cache(maxsize=None)
def _images_224():
    return np.random.default_rng(2).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_fc7_224():
    return np.asarray(jvgg.features_fc7(_jax_vgg(), jnp.asarray(_images_224()),
                                        precision="highest"))


def test_fc7_matches_jax_at_224():
    got = tvgg.features_fc7(_port_vgg(), _images_224())
    assert got.dtype == torch.float32 and got.shape == (2, 4096)
    np.testing.assert_allclose(got.numpy(), _jax_fc7_224(), rtol=FC7_RTOL, atol=FC7_ATOL)


@pytest.mark.parametrize("shape", [(300, 200), (100, 100), (224, 224)])
def test_preprocess_matches_jax(shape):
    """A downscale (300 rows), an upscale (100), the identity (224)."""
    x = np.random.default_rng(3).integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    want = np.asarray(jvgg.preprocess(jnp.asarray(x)))
    got = tvgg.preprocess(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PRE_ATOL)
    if shape == (224, 224):  # no resize at 224: the normalisation alone
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_bf16_stack_close_to_float32():
    model = _port_vgg()
    f32 = tvgg.features_fc7(model, _images_224())
    b16_model = tvgg.cast_params(tconvert.vgg_from_jax(tconvert.vgg_to_jax(model)),
                                 torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in b16_model.parameters())
    b16 = tvgg.features_fc7(b16_model, _images_224(), compute_dtype=torch.bfloat16)
    assert b16.dtype == torch.float32 and b16.shape == f32.shape
    assert float((b16 - f32).abs().mean() / (f32.abs().mean() + 1e-6)) < 0.1


def test_extract_pads_ragged_batches_and_takes_empty_input():
    model = _port_vgg()
    x = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    whole = tvgg.extract_features(model, x, batch_size=3)
    ragged = tvgg.extract_features(model, x, batch_size=2)  # the last batch padded
    seen = []
    blocks = list(tvgg.iter_features(model, x, batch_size=2,
                                     progress=lambda s: (seen.append(i) or i for i in s)))
    assert [b.shape[0] for b in blocks] == [2, 1] and seen == [0, 2]
    np.testing.assert_allclose(ragged, whole, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.concatenate(blocks), ragged)
    assert tvgg.extract_features(model, x[:0]).shape == (0, 4096)
    proj = tpca.PCAProjection(torch.zeros(4096), torch.ones(4096, 3))
    assert tvgg.extract_features(model, x[:0], projection=proj).shape == (0, 3)


# ---- converters and checkpoints ----


def test_vgg_from_state_dict_and_carry_over_match_vgg_from_torch(tmp_path):
    """A torchvision-layout ``.pt`` (fc8 included, which both converters
    drop) through the JAX ``vgg_from_torch`` and the port's
    ``vgg_from_state_dict``, and the JAX tree carried over: the same
    weights; ``vgg_to_jax`` gives the JAX converter's tree back."""
    sd = dict(_port_vgg().state_dict())
    sd["classifier.6.weight"] = torch.ones(1000, 4096)
    sd["classifier.6.bias"] = torch.zeros(1000)
    torch.save(sd, tmp_path / "vgg16.pt")
    sd = torch.load(tmp_path / "vgg16.pt", weights_only=True)
    jtree = jax.tree.map(np.asarray, vgg_from_torch({k: v.numpy() for k, v in sd.items()}))
    from_pt = tconvert.vgg_from_state_dict(sd).state_dict()
    carried = tconvert.vgg_from_jax(from_jax_params(jtree)).state_dict()
    want = _port_vgg().state_dict()
    assert set(from_pt) == set(carried) == set(want)
    assert not any(k.startswith("classifier.6") for k in from_pt)
    for k in want:
        assert torch.equal(from_pt[k], want[k]) and torch.equal(carried[k], want[k]), k
    back = tconvert.vgg_to_jax(_port_vgg())
    assert set(back) == set(jtree)
    for name, leaf in jtree.items():
        for part, v in leaf.items():
            np.testing.assert_array_equal(back[name][part].numpy(), v, err_msg=f"{name}/{part}")
    with pytest.raises(ValueError, match="not a VGG16 state dict"):
        tconvert.vgg_from_state_dict({"features.0.weight": torch.zeros(1)})


def _sha(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def test_vgg_ckpt_bytes_equal_both_ways(tmp_path):
    jpath, tpath = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.save_pytree(_jax_vgg(), jpath)
    tconvert.save_vgg_ckpt(_port_vgg(), tpath)
    assert _sha(jpath) == _sha(tpath)
    back = tconvert.load_vgg_ckpt(jpath).state_dict()
    for k, v in _port_vgg().state_dict().items():
        assert torch.equal(back[k], v), k
    restored = jckpt.load_pytree(_jax_vgg(), tpath)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(_jax_vgg())):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- PCA ----


def _align(a, b):
    """``a``'s columns flipped to ``b``'s signs."""
    return a * np.sign(np.sum(a * b, axis=0, keepdims=True))


def test_fit_pca_apply_and_files_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((20, 12)) @ rng.standard_normal((12, 12))).astype(np.float32)
    want = jpca.fit_pca(jnp.asarray(x), k=5)
    got = tpca.fit_pca(torch.from_numpy(x), k=5)
    assert got.dim == 5 and got.components.shape == (12, 5)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=0, atol=1e-6)
    wc = np.asarray(want.components)
    np.testing.assert_allclose(_align(got.components.numpy(), wc), wc, rtol=0, atol=PCA_ATOL)
    aligned = tpca.PCAProjection(got.mean, torch.from_numpy(_align(got.components.numpy(), wc)))
    np.testing.assert_allclose(aligned.apply(x), np.asarray(want.apply(jnp.asarray(x))),
                               rtol=0, atol=1e-4)
    assert isinstance(got.apply(torch.from_numpy(x)), torch.Tensor)
    # save / load both ways, bare paths included
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "jax"))
    assert os.path.exists(tmp_path / "port.npz") and os.path.exists(tmp_path / "jax.npz")
    theirs = tpca.PCAProjection.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(theirs.components.numpy(), wc)
    ours = jpca.PCAProjection.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(ours.components), got.components.numpy())
    for fit in (jpca.fit_pca, tpca.fit_pca):
        with pytest.raises(ValueError, match="cannot fit 21 principal components from 20"):
            fit(x, k=21)


# ---- the streaming HDF5 writer ----


def test_streaming_h5_writer_reads_back(tmp_path):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((10, 7)).astype(np.float32)
    ids = np.arange(10, dtype=np.int64)
    path = str(tmp_path / "stream.h5")
    with H5Writer(path, {"features": ((10, 7), "f4"), "ids": ((10,), np.int64),
                         "empty": ((0, 3), "f4")}) as w:
        for row in (6, 0, 3):  # any order of blocks
            w.write("features", row, table[row:row + (4 if row == 6 else 3)])
        w.write("ids", 0, ids)
        with pytest.raises(ValueError, match="do not fit"):
            w.write("features", 9, table[:2])
    got = read_h5(path)
    np.testing.assert_array_equal(got["features"], table)
    np.testing.assert_array_equal(got["ids"], ids)
    assert got["empty"].shape == (0, 3)
    with h5py.File(path) as f:
        np.testing.assert_array_equal(np.asarray(f["features"]), table)
        assert "ids" in f and f["empty"].shape == (0, 3)
    # a block that raises publishes nothing
    with pytest.raises(RuntimeError):
        with H5Writer(str(tmp_path / "never.h5"), {"x": ((2,), "f4")}):
            raise RuntimeError
    assert not os.path.exists(tmp_path / "never.h5")


def test_front_end_imports_without_jax_or_pil():
    """The visual front end's modules import neither jax, the JAX package
    nor PIL (PIL is imported where an image is decoded)."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import image_captioning_through_rl_tpu_torch.models.vgg\n"
        "import image_captioning_through_rl_tpu_torch.data.pca\n"
        "import image_captioning_through_rl_tpu_torch.cli.extract\n"
        "import image_captioning_through_rl_tpu_torch.cli.caption\n"
        "import image_captioning_through_rl_tpu_torch.api\n"
        "import image_captioning_through_rl_tpu_torch.server\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'PIL', 'image_captioning_through_rl_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
