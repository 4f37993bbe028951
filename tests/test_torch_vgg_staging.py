"""How a batch's pixels reach the stack in ``models/vgg.iter_features``, on
the CPU: input order, the last batch padded by repeating its last item, the
padding cut off each block, with and without a ``loader`` and on a mesh of
CPU entries, and the counters that say which path a batch took (on the CPU
the host's own array, never page-locked memory; the card's path is
``test_torch_cuda.py``'s).

The stack is replaced by one that returns each row's pixels flattened, so
that a block shows exactly which rows, in which order, the stack was given;
the real stack's features are ``test_torch_vision.py``'s.
"""

import numpy as np
import pytest
import torch

from image_captioning_through_rl_tpu_torch.models import vgg as tvgg
from image_captioning_through_rl_tpu_torch.parallel import make_mesh

BATCH = 4


def _pixels(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 2, 2, 3), dtype=np.uint8)


@pytest.fixture
def seen(monkeypatch):
    """The batches the stack was given, as numpy arrays; its features are
    each row's pixels flattened, in float32."""
    got = []

    def stack(model, x, compute_dtype=None):
        got.append(x.numpy().copy())
        return x.reshape(x.shape[0], -1).to(torch.float32)

    monkeypatch.setattr(tvgg, "features_fc7", stack)
    return got


def _counts():
    return tvgg.iter_features.pinned_batches, tvgg.iter_features.pageable_batches


@pytest.mark.parametrize("via", ["array", "loader", "mesh"])
@pytest.mark.parametrize("n", [2 * BATCH, 2 * BATCH + 3, 1, 0])
def test_blocks_keep_order_padding_and_cut(seen, n, via):
    """``n`` a multiple of the batch, ragged, one and none: the blocks, in
    order, are the input's rows; each batch the stack saw is whole, its
    padding the last row repeated; every batch counts as pageable."""
    pixels = _pixels(n)
    model = torch.nn.Linear(1, 1)
    kwargs = {}
    images = pixels
    batch = BATCH
    if via == "loader":
        images = list(range(n))
        kwargs["loader"] = lambda keys: pixels[np.asarray(keys, dtype=np.int64)]
    elif via == "mesh":  # three entries round the batch up to 6
        kwargs["mesh"] = make_mesh(devices=["cpu"] * 3)
        batch = 6
    before = _counts()
    blocks = list(tvgg.iter_features(model, images, batch_size=BATCH, **kwargs))
    batches = -(-n // batch)
    assert [b.shape[0] for b in blocks] == [min(batch, n - i) for i in range(0, n, batch)]
    if n:
        np.testing.assert_array_equal(np.concatenate(blocks), pixels.reshape(n, -1))
    mesh_blocks = 3 if via == "mesh" else 1
    assert len(seen) == batches * mesh_blocks
    fed = [np.concatenate(seen[k:k + mesh_blocks]) for k in range(0, len(seen), mesh_blocks)]
    for k, x in enumerate(fed):
        rows = pixels[k * batch:(k + 1) * batch]
        want = np.concatenate([rows, np.repeat(rows[-1:], batch - len(rows), axis=0)])
        np.testing.assert_array_equal(x, want)
    pinned, pageable = _counts()
    assert (pinned, pageable) == (before[0], before[1] + batches)
    seen.clear()
    table = tvgg.extract_features(model, images, batch_size=BATCH, **kwargs)
    assert table.shape == ((n, 12) if n else (0, tvgg.FC7_DIM))
    if n:
        np.testing.assert_array_equal(table, pixels.reshape(n, -1))


@pytest.mark.parametrize("real", [BATCH, BATCH - 1, 1])
def test_staged_batch_is_the_concatenated_padding(real):
    """The staged host batch holds the bytes ``np.concatenate`` pads with;
    a whole batch off the card is the array itself, not a copy."""
    batch = _pixels(real, seed=real)
    want = np.concatenate([batch, np.repeat(batch[-1:], BATCH - real, axis=0)])
    x = tvgg._staged(batch, BATCH, pinned=False)
    assert x.dtype == torch.uint8 and x.shape == (BATCH, 2, 2, 3) and not x.is_pinned()
    np.testing.assert_array_equal(x.numpy(), want)
    assert (x.data_ptr() == batch.ctypes.data) == (real == BATCH)


def test_preprocess_statistics_are_made_once_and_unchanged():
    """ImageNet's mean and std are made once a device and type, and the
    normalisation is the one written out in full, bit for bit."""
    x = _pixels(3, seed=7)
    got = tvgg.preprocess(x, size=2)
    t = torch.from_numpy(x).to(torch.float32).div(255.0).permute(0, 3, 1, 2)
    mean = torch.tensor(tvgg.IMAGENET_MEAN, dtype=torch.float32)[:, None, None]
    std = torch.tensor(tvgg.IMAGENET_STD, dtype=torch.float32)[:, None, None]
    assert torch.equal(got, ((t - mean) / std).contiguous())
    cpu = torch.device("cpu")
    first = tvgg._imagenet_stats(cpu, torch.float32)
    assert all(a is b for a, b in zip(first, tvgg._imagenet_stats(cpu, torch.float32)))
    assert torch.equal(first[0], mean) and torch.equal(first[1], std)
