"""The port's device-resident tables (``data/device.py``) against the host
iterators and the JAX package's tables, on the CPU.

Mirrors the JAX package's ``tests/test_device_data.py``: a gather equals
host indexing, and an epoch of minibatches covers the split, here also
minibatch for minibatch equal to ``get_coco_minibatches`` and to the JAX
package's ``DeviceCocoTables`` under the same seed. Its mesh cases: on a
mesh of ranks each rank's tables (device and host) gather its own
contiguous block of every minibatch, the blocks together the JAX package's
sharded gather; a ragged minibatch is every rank's whole minibatch, as the
JAX package replicates it; a mesh of one process gathers every row.
"""

import jax
import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu.data import DeviceCocoTables as JTables
from image_captioning_through_rl_tpu.data import load_data as jload_data
from image_captioning_through_rl_tpu.data import make_synthetic_coco
from image_captioning_through_rl_tpu.parallel import make_mesh as jmake_mesh
from image_captioning_through_rl_tpu_torch.data import DeviceCocoTables, load_data
from image_captioning_through_rl_tpu_torch.data.coco import get_coco_minibatches
from image_captioning_through_rl_tpu_torch.data.device import HostCocoTables
from image_captioning_through_rl_tpu_torch.parallel import hostbatch, make_mesh
from image_captioning_through_rl_tpu_torch.parallel.mesh import Mesh


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


def _rank_mesh(size):
    """A mesh of ``size`` ranks, one CPU entry each (the rank is patched in)."""
    devs = np.empty(size, dtype=object)
    devs[:] = [torch.device("cpu")] * size
    return Mesh(devs, ("data",), np.arange(size))


@pytest.mark.parametrize("tables_cls", [DeviceCocoTables, HostCocoTables])
@pytest.mark.parametrize("size", [2, 4])
def test_sharded_gather(bundle, data, tables_cls, size, monkeypatch):
    mask = np.arange(16)[::-1].copy()
    jmesh = jmake_mesh((size,), ("data",), devices=jax.devices()[:size])
    jcaps, jfeats = JTables(jload_data(bundle), mesh=jmesh).gather(mask)
    assert len(jcaps.sharding.device_set) == size
    caps, feats = [], []
    for rank in range(size):
        monkeypatch.setattr(hostbatch, "world", lambda rank=rank: (rank, size))
        tables = tables_cls(data, split="train", mesh=_rank_mesh(size))
        c, f = tables.gather(mask)
        assert c.shape[0] == 16 // size and c.dtype == torch.int64
        caps.append(c.numpy())
        feats.append(f.numpy())
        # two minibatches back to back (a chunk): the rank's block of each
        c2, _ = tables.gather(np.concatenate([mask, mask[::-1]]), k=2)
        np.testing.assert_array_equal(
            c2.numpy(), np.concatenate([caps[-1], data.train_captions[mask[::-1]][
                rank * 16 // size: (rank + 1) * 16 // size]]))
    np.testing.assert_array_equal(np.concatenate(caps), np.asarray(jcaps))
    np.testing.assert_array_equal(np.concatenate(feats), np.asarray(jfeats))


@pytest.mark.parametrize("tables_cls", [DeviceCocoTables, HostCocoTables])
def test_sharded_gather_ragged_batch_replicates(data, tables_cls, monkeypatch):
    mask = np.arange(7)
    for rank in range(2):
        monkeypatch.setattr(hostbatch, "world", lambda rank=rank: (rank, 2))
        caps, feats = tables_cls(data, split="train", mesh=_rank_mesh(2)).gather(mask)
        np.testing.assert_array_equal(caps.numpy(), data.train_captions[mask])
        np.testing.assert_array_equal(feats.numpy(),
                                      data.train_features[data.train_image_idxs[mask]])


def test_one_process_mesh_gathers_every_row(data):
    tables = DeviceCocoTables(data, split="train", mesh=make_mesh(devices=["cpu"]))
    caps, _ = tables.gather(np.arange(6))
    assert tables.device == torch.device("cpu")
    np.testing.assert_array_equal(caps.numpy(), data.train_captions[:6])
    seen = sum(c.shape[0] for c, _ in tables.minibatches(16, np.random.default_rng(0)))
    assert seen == tables.num_captions
