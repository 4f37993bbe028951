"""Dataset tables with minibatch gathers on the device (counterpart of the
JAX ``data/device.py``).

The train split of a COCO bundle is small beside the card's memory
(82,783 x 512 float32 features, 170 MB; 414k x 17 caption ids), so the
tables live on the run's device and each minibatch ships only its index
vector: the per-caption feature gather through ``image_idxs``
(utilities.py:174-176) becomes one ``index_select`` on the device. The
index vector crosses from pinned host memory without a stream sync, so a
chunk of minibatches is gathered without the host waiting on the card.

On a mesh (``mesh=``, :mod:`..parallel`) each rank keeps the whole tables
on its own device and gathers only its rows of each minibatch
(:class:`..parallel.hostbatch.GlobalBatcher`; a ragged minibatch whole, as
the JAX package replicates it). :class:`HostCocoTables` is the host-memory
twin: the tables stay in host memory and each gather uploads the rank's
rows. Both consume the same :func:`.coco.epoch_minibatch_indices` stream
(:class:`_MinibatchMixin`), so every rank draws the same global minibatch
from the same host generator.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .coco import CocoData, epoch_minibatch_indices


class _MinibatchMixin:
    """The epoch walk shared by both tables: the subclass supplies
    ``gather`` and ``num_captions``."""

    def minibatches(self, batch_size: int, rng: Optional[np.random.Generator] = None
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The epoch walk of :func:`.coco.get_coco_minibatches` (one
        permutation from ``rng``, sliced in order, the last minibatch
        ragged), each minibatch gathered (this rank's rows on a mesh)."""
        for mask in epoch_minibatch_indices(self.num_captions, batch_size, rng):
            yield self.gather(mask)

    def _local(self, mask: np.ndarray, k: int) -> np.ndarray:
        """This rank's rows of each of the ``k`` minibatches in ``mask``."""
        mask = np.ascontiguousarray(mask, np.int64)
        if self.batcher is None:
            return mask
        return np.ascontiguousarray(self.batcher.shard_stacked(mask.reshape(k, -1)).reshape(-1))


def _mesh_device(mesh, device):
    from ..api import resolve_device  # api imports data: resolve at call time

    if mesh is None:
        return resolve_device(device), None
    from ..parallel.hostbatch import GlobalBatcher

    return resolve_device(mesh.first_device), GlobalBatcher(mesh)


class DeviceCocoTables(_MinibatchMixin):
    """One split's captions (int64), features (float32) and caption-to-image
    indices on ``device`` (the card unless the caller asks for the CPU), or
    on this rank's device of ``mesh``."""

    def __init__(self, data: CocoData, split: str = "train", device="cuda", mesh=None):
        caps, idxs, feats, _ = data.split(split)
        self.device, self.batcher = _mesh_device(mesh, device)
        self.captions = torch.from_numpy(np.asarray(caps, np.int64)).to(self.device)
        self.features = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)
        self.image_idxs = torch.from_numpy(np.asarray(idxs, np.int64)).to(self.device)
        self.num_captions = int(caps.shape[0])

    def gather(self, mask: np.ndarray, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(captions [n, T] int64, features [n, F] float32)`` of the rows
        ``mask`` (host ints; ``k`` minibatches back to back) on the device,
        this rank's rows of each on a mesh; ``out``, when given, receives
        them (the static buffers of a captured chunk, viewed as ``[n,
        ...]``). On a CUDA device the index crosses from pinned memory, so
        the copy does not sync the stream."""
        idx = torch.from_numpy(self._local(mask, k))
        if self.device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(self.device, non_blocking=True)
        if out is None:
            return (torch.index_select(self.captions, 0, idx),
                    torch.index_select(self.features, 0, self.image_idxs[idx]))
        caps_out, feats_out = out
        torch.index_select(self.captions, 0, idx, out=caps_out)
        torch.index_select(self.features, 0, self.image_idxs[idx], out=feats_out)
        return caps_out, feats_out


class HostCocoTables(_MinibatchMixin):
    """The host-memory twin of :class:`DeviceCocoTables` (the same
    ``num_captions`` / ``gather`` / ``minibatches``): the tables stay in host
    memory, each gather runs on the host and uploads only this rank's rows
    to its device."""

    def __init__(self, data: CocoData, split: str = "train", device="cuda", mesh=None):
        caps, idxs, feats, _ = data.split(split)
        self.device, self.batcher = _mesh_device(mesh, device)
        self.captions = np.asarray(caps, np.int64)
        self.image_idxs = np.asarray(idxs, np.int64)
        self.features = np.ascontiguousarray(feats, np.float32)
        self.num_captions = int(caps.shape[0])

    def gather(self, mask: np.ndarray, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = self._local(mask, k)
        caps = torch.from_numpy(self.captions[mask]).to(self.device)
        feats = torch.from_numpy(self.features[self.image_idxs[mask]]).to(self.device)
        if out is None:
            return caps, feats
        out[0].copy_(caps)
        out[1].copy_(feats)
        return out
