"""PCA projection of visual features (counterpart of the JAX
``data/pca.py``).

The COCO bundle ships raw 4096-d fc7 features and a 512-d PCA variant
(``*_vgg16_fc7_pca.h5``); this reproduces that reduction: :func:`fit_pca`
on a feature table (``torch.linalg.svd`` on the table's device) and
:meth:`PCAProjection.apply` as one product. The ``.npz`` it saves holds
``mean`` and ``components`` as the JAX package's does, so either package
reads the other's. An SVD's component signs are arbitrary in both
frameworks: two fits of one table agree up to a sign per component.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops.linalg import matmul
from ..utils.io import atomic_write


@dataclasses.dataclass
class PCAProjection:
    mean: torch.Tensor        # [D] float32
    components: torch.Tensor  # [D, k] float32

    @property
    def dim(self) -> int:
        """The projected dimension k."""
        return int(self.components.shape[1])

    def to(self, device) -> "PCAProjection":
        return PCAProjection(self.mean.to(device), self.components.to(device))

    def apply(self, feats):
        """``(feats - mean) @ components`` in float32: a tensor gives a
        tensor (on its device: the projection moves there), an array an
        array."""
        if isinstance(feats, torch.Tensor):
            dev = feats.device
            return matmul(feats.to(torch.float32) - self.mean.to(dev), self.components.to(dev))
        return self.apply(torch.from_numpy(np.asarray(feats, np.float32))).numpy()

    def save(self, path: str) -> None:
        """``mean`` and ``components`` as an ``.npz`` (``.npz`` appended to a
        bare path, as ``np.savez`` appends it), published atomically."""
        if not path.endswith(".npz"):
            path += ".npz"
        with atomic_write(path) as f:
            np.savez(f, mean=self.mean.detach().cpu().numpy(),
                     components=self.components.detach().cpu().numpy())

    @staticmethod
    def load(path: str, device="cpu") -> "PCAProjection":
        """A saved projection; a bare path that does not exist reads
        ``path + ".npz"``, so ``save(p)`` then ``load(p)`` round-trips."""
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        with np.load(path) as z:
            mean, comps = z["mean"], z["components"]
        return PCAProjection(torch.from_numpy(np.asarray(mean, np.float32)).to(device),
                             torch.from_numpy(np.asarray(comps, np.float32)).to(device))


def fit_pca(features, k: int = 512) -> PCAProjection:
    """The first ``k`` principal components of a feature table ``[N, D]``
    (a tensor, on its device, or an array) -> ``components [D, k]``.
    ``k > min(N, D)`` raises: the SVD gives only ``min(N, D)``."""
    if isinstance(features, torch.Tensor):
        x = features.to(torch.float32)
    else:
        x = torch.from_numpy(np.asarray(features, np.float32))
    n, d = x.shape
    if k > min(n, d):
        raise ValueError(f"cannot fit {k} principal components from {n} samples of dim {d}; "
                         f"need at least k samples")
    mean = torch.mean(x, dim=0)
    _, _, vt = torch.linalg.svd(x - mean, full_matrices=False)
    return PCAProjection(mean=mean, components=vt[:k].T.contiguous())
