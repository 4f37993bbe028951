"""The port's device-resident tables (``data/device.py``) against the host
iterators and the JAX package's tables, on the CPU.

Mirrors the JAX package's ``tests/test_device_data.py`` where a case
applies (its mesh cases wait for the multi-GPU port): a gather equals host
indexing, and an epoch of minibatches covers the split, here also
minibatch for minibatch equal to ``get_coco_minibatches`` and to the JAX
package's ``DeviceCocoTables`` under the same seed.
"""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.data import DeviceCocoTables as JTables
from image_captioning_through_rl_tpu.data import load_data as jload_data
from image_captioning_through_rl_tpu.data import make_synthetic_coco
from image_captioning_through_rl_tpu_torch.data import DeviceCocoTables, load_data
from image_captioning_through_rl_tpu_torch.data.coco import get_coco_minibatches


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), seed=3)


@pytest.fixture(scope="module")
def data(bundle):
    return load_data(bundle)


def test_gather_matches_host_indexing(data):
    tables = DeviceCocoTables(data, split="train", device="cpu")
    mask = np.array([3, 0, 7, 3, 11])
    caps_b, feats_b = tables.gather(mask)
    assert caps_b.dtype == torch.int64 and feats_b.dtype == torch.float32
    np.testing.assert_array_equal(caps_b.numpy(), data.train_captions[mask])
    np.testing.assert_array_equal(feats_b.numpy(),
                                  data.train_features[data.train_image_idxs[mask]])


def test_gather_into_buffers(data):
    """``out=``: a chunk gathered into preallocated ``[k, n, ...]`` buffers
    (a captured chunk's static inputs) viewed flat."""
    tables = DeviceCocoTables(data, split="train", device="cpu")
    mask = np.arange(12)[::-1].copy()
    caps_buf = torch.empty((3, 4, data.train_captions.shape[1]), dtype=torch.int64)
    feats_buf = torch.empty((3, 4, data.train_features.shape[1]))
    caps_b, feats_b = tables.gather(mask, out=(caps_buf.view(12, -1), feats_buf.view(12, -1)))
    assert caps_b.data_ptr() == caps_buf.data_ptr()
    np.testing.assert_array_equal(caps_buf.reshape(12, -1).numpy(), data.train_captions[mask])
    np.testing.assert_array_equal(feats_buf.reshape(12, -1).numpy(),
                                  data.train_features[data.train_image_idxs[mask]])


def test_minibatches_cover_epoch(data):
    tables = DeviceCocoTables(data, split="train", device="cpu")
    seen = 0
    for caps_b, feats_b in tables.minibatches(16, rng=np.random.default_rng(0)):
        assert caps_b.shape[0] == feats_b.shape[0]
        seen += caps_b.shape[0]
    assert seen == data.train_captions.shape[0] == tables.num_captions


def test_minibatches_match_host_iterator_and_jax_tables(bundle, data):
    """The same seed walks the same minibatches, ragged tail included, as
    ``get_coco_minibatches`` and the JAX package's tables."""
    n = data.train_captions.shape[0]
    batch = 16 if n % 16 else 15
    ours = list(DeviceCocoTables(data, device="cpu").minibatches(batch, np.random.default_rng(5)))
    host = list(get_coco_minibatches(data, batch_size=batch, rng=np.random.default_rng(5)))
    jax_side = list(JTables(jload_data(bundle)).minibatches(batch, rng=np.random.default_rng(5)))
    assert len(ours) == len(host) == len(jax_side) == -(-n // batch)
    assert ours[-1][0].shape[0] == n % batch
    for (c, f), (hc, hf, _), (jc, jf) in zip(ours, host, jax_side):
        np.testing.assert_array_equal(c.numpy(), hc)
        np.testing.assert_array_equal(f.numpy(), hf)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def test_default_device_is_the_card(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceCocoTables(data)
