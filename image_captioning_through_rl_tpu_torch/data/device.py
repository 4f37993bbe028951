"""Device-resident dataset tables with on-device minibatch gathers
(counterpart of the JAX ``data/device.py``).

The train split of a COCO bundle is small beside the card's memory
(82,783 x 512 float32 features, 170 MB; 414k x 17 caption ids), so the
tables live on the run's device and each minibatch ships only its index
vector: the per-caption feature gather through ``image_idxs``
(utilities.py:174-176) becomes one ``index_select`` on the device. The
index vector crosses from pinned host memory without a stream sync, so a
chunk of minibatches is gathered without the host waiting on the card.

The host tables and the mesh layout of the JAX package wait for the
multi-GPU port (ROADMAP §1 item 8).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .coco import CocoData, epoch_minibatch_indices


class DeviceCocoTables:
    """One split's captions (int64), features (float32) and caption-to-image
    indices on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, data: CocoData, split: str = "train", device="cuda"):
        from ..api import resolve_device  # api imports data: resolve at call time

        caps, idxs, feats, _ = data.split(split)
        self.device = resolve_device(device)
        self.captions = torch.from_numpy(np.asarray(caps, np.int64)).to(self.device)
        self.features = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(self.device)
        self.image_idxs = torch.from_numpy(np.asarray(idxs, np.int64)).to(self.device)
        self.num_captions = int(caps.shape[0])

    def gather(self, mask: np.ndarray, out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(captions [n, T] int64, features [n, F] float32)`` of the rows
        ``mask`` (host ints) on the device; ``out``, when given, receives
        them (the static buffers of a captured chunk, viewed as ``[n,
        ...]``). On a CUDA device the index crosses from pinned memory, so
        the copy does not sync the stream."""
        idx = torch.from_numpy(np.ascontiguousarray(mask, np.int64))
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

    def minibatches(self, batch_size: int, rng: Optional[np.random.Generator] = None
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """The epoch walk of :func:`.coco.get_coco_minibatches` (one
        permutation from ``rng``, sliced in order, the last minibatch
        ragged), each minibatch gathered on the device."""
        for mask in epoch_minibatch_indices(self.num_captions, batch_size, rng):
            yield self.gather(mask)
