"""Each rank's rows of the global batch (counterpart of the JAX
``parallel/hostbatch.py``).

Every rank draws the same host-RNG stream (same seed, same epoch
permutation, same global minibatch) and keeps only its own rows: the ranks
of the mesh's ``data`` axis own contiguous, equal blocks, in rank order. A
batch whose rows do not divide over the data axis (a ragged epoch tail) is
kept whole on every rank and computed whole there, as the JAX package
replicates it: every rank then takes the same step with no collective.

On a 2-D ``("data", "model")`` mesh the rows go by the rank's ``data``
coordinate, so the ``model`` ranks of a data block hold the same rows (the
JAX ``local_rows`` de-duplicates the model axis' equal slices); a mesh with
no ``data`` axis gives every rank the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .collectives import RowShard, broadcast_tree, equal_blocks
from .mesh import Mesh, world


class GlobalBatcher:
    """This process's rows of host batches on ``mesh``.

    ``shard(*arrays)`` keeps the rows of axis 0 this process owns (numpy
    stays numpy, tensors keep their device); ``shard_stacked`` does so on
    axis 1 of ``[k, N, ...]`` chunks; ``replicate(tree)`` broadcasts rank
    0's parameter tree into every rank's (every rank holds the same tree:
    same init seed). ``row_shard(n)`` is the :class:`.collectives.RowShard`
    a training step of a batch of ``n`` rows takes, None for a ragged one.
    On a single-process mesh this process owns every row."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis

    @property
    def _data_size(self) -> int:
        """The data axis' size; 1 on a mesh without one (every rank holds
        every row)."""
        return int(self.mesh.shape.get(self.axis, 1))

    @property
    def _index(self) -> Optional[int]:
        """This process's position on the data axis (0 on a mesh without
        one); None when the mesh is one process's (it owns every row)."""
        if self.mesh.ranks is None:
            return None
        if self.axis not in self.mesh.shape:
            return 0
        where = np.argwhere(self.mesh.ranks == world()[0])
        if len(where) != 1:
            raise ValueError("a distributed mesh holds one entry a rank")
        return int(where[0][self.mesh.axis_names.index(self.axis)])

    def local_rows(self, n: int) -> Tuple[int, int]:
        """This process's contiguous ``[lo, hi)`` of a batch of ``n`` rows:
        its equal block, or every row when they do not divide (or the mesh
        is one process's)."""
        index = self._index
        block = None if index is None else equal_blocks(n, self._data_size, index)
        return (0, n) if block is None else block

    def row_shard(self, n: int) -> Optional[RowShard]:
        """The step's :class:`.collectives.RowShard` for a batch of ``n``
        rows over the data group, or None when it is ragged or the mesh has
        no data axis (computed whole on every rank)."""
        block = equal_blocks(n, self._data_size, self._index or 0)
        if block is None or self.axis not in self.mesh.shape:
            return None
        return RowShard(block[0], block[1], n, self._data_size, self.mesh.group(self.axis))

    def shard(self, *arrays):
        """Each array's rows of this process (axis 0)."""
        out = tuple(a[slice(*self.local_rows(a.shape[0]))] for a in arrays)
        return out if len(out) > 1 else out[0]

    def shard_stacked(self, *arrays):
        """Each ``[k, N, ...]`` chunk's rows of this process on axis 1."""
        out = tuple(a[:, slice(*self.local_rows(a.shape[1]))] for a in arrays)
        return out if len(out) > 1 else out[0]

    def replicate(self, tree: dict) -> dict:
        """Rank 0's values of ``tree`` on every rank, in place."""
        return broadcast_tree(tree)
