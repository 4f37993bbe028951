"""The collectives the data-parallel paths use, on every backend.

Gloo carries CUDA tensors for ``all_reduce`` and ``broadcast`` only (no
``all_gather``), and the ranks that share one card on purpose talk gloo, so
every collective here is one of those two: a gather of row blocks is an
``all_reduce`` of a zero buffer into which each rank wrote its rows (``x +
0`` is exact, so the result is the rows bit for bit). Without a process
group each collective is the identity (a world of one). ``group``: the
process group a collective runs over (a mesh axis's,
:meth:`.mesh.Mesh.group`); None is the whole world.

A :class:`RowShard` is one rank's rows ``[lo, hi)`` of a global batch of
``n`` rows split over the ``size`` ranks of its ``data`` group; the
training steps take it to reduce their gradients and losses
(:func:`reduce_gradients`) and to gather the reward network's embeddings
(:func:`gather_rows`, differentiable), over that group only: on a 2-D
mesh the ``model`` ranks of a data block hold the same rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.distributed as dist


def active() -> bool:
    """Whether a process group exists (collectives run)."""
    return dist.is_available() and dist.is_initialized()


def comm_device() -> torch.device:
    """Where a control tensor for a collective lives: the current card under
    NCCL, the CPU under gloo."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (or its ``op``, a
    ``dist.ReduceOp``: MAX, MIN), in place."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if active():
        dist.broadcast(t, src)
    return t


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank ``src``'s integer on every rank."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=comm_device())
    return int(broadcast_(t, src).item())


def broadcast_bytes(data, src: int = 0) -> bytes:
    """Rank ``src``'s bytes on every rank (length first, then the buffer);
    the other ranks pass anything (None)."""
    from .mesh import world

    mine = world()[0] == src
    n = broadcast_int(len(data) if mine else 0, src)
    buf = torch.zeros(n, dtype=torch.uint8, device=comm_device())
    if mine and n:
        buf.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return bytes(broadcast_(buf, src).cpu().numpy().tobytes())


def broadcast_tree(tree: dict, src: int = 0) -> dict:
    """Rank ``src``'s leaves into every rank's ``tree`` (same structure and
    shapes), in place, in sorted key order; returns ``tree``."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            broadcast_tree(tree[k], src)
        else:
            with torch.no_grad():
                broadcast_(tree[k], src)
    return tree


def gather_blocks(x: torch.Tensor, lo: int, n: int, group=None) -> torch.Tensor:
    """Rows ``[lo, lo + len(x))`` from each rank of ``group`` into ``[n,
    ...]`` on every rank (no gradient): the ``all_reduce`` of a zero
    buffer."""
    buf = x.new_zeros((n,) + tuple(x.shape[1:]))
    buf[lo: lo + x.shape[0]] = x
    return all_reduce_(buf, group)


class RowShard(NamedTuple):
    """One rank's rows ``[lo, hi)`` of a global batch of ``n`` rows over
    the ``size`` ranks of ``group`` (equal blocks; the mesh's ``data``
    group, None for the whole world)."""
    lo: int
    hi: int
    n: int
    size: int
    group: object = None

    @property
    def rows(self) -> int:
        return self.hi - self.lo


class _GatherRows(torch.autograd.Function):
    """All ranks' row blocks, with the gradient back to the owning rank: the
    backward sums every rank's gradient of the gathered rows and keeps this
    rank's block."""

    @staticmethod
    def forward(ctx, x, lo, n, group):
        ctx.lo, ctx.hi, ctx.group = lo, lo + x.shape[0], group
        return gather_blocks(x, lo, n, group)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_(grad.contiguous().clone(), ctx.group)
        return grad[ctx.lo: ctx.hi], None, None, None


def gather_rows(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """``[shard.n, ...]``: every rank's rows of ``x`` (this rank's ``x`` at
    ``[shard.lo, shard.hi)``) over the shard's group, differentiable."""
    return _GatherRows.apply(x, shard.lo, shard.n, shard.group)


def _param_leaves(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def reduce_gradients(optimizer: torch.optim.Optimizer, scalars: Sequence[torch.Tensor],
                     shard: RowShard, mean: bool = True) -> List[torch.Tensor]:
    """Sum every gradient of ``optimizer``'s parameters and the 0-d
    ``scalars`` (the loss, the stats) over the ranks of the shard's
    ``data`` group in one flattened bucket, one ``all_reduce`` a step (on a
    2-D mesh the ``model`` ranks already hold equal gradients of the
    replicated leaves, and a vocab block's gradient is its own), laid out in the optimiser's leaf
    order (:func:`..train.optim.adam`'s sorted paths, the same on every
    rank however its tree was built); divided by the ranks for ``mean``
    (a loss that is a mean over rows: equal shards make the mean of the
    rank means the global mean). Writes the gradients back in place and
    returns the reduced scalars. A parameter without a gradient (the same on
    every rank: one program) stays without one, as Adam then skips it.
    Capturable in a CUDA graph under NCCL (no host sync)."""
    grads = [p.grad for p in _param_leaves(optimizer) if p.grad is not None]
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads]
                     + [s.reshape(1).to(torch.float32) for s in scalars])
    all_reduce_(flat, shard.group)
    if mean and shard.size > 1:
        flat.div_(shard.size)
    parts = torch.split(flat, [g.numel() for g in grads] + [1] * len(scalars))
    with torch.no_grad():
        for g, part in zip(grads, parts):
            g.copy_(part.view_as(g))
    return [part.reshape(()).to(s.dtype) for part, s in zip(parts[len(grads):], scalars)]


def equal_blocks(n: int, size: int, index: int):
    """Rows ``[lo, hi)`` of block ``index`` when ``n`` rows split into
    ``size`` equal blocks, or None when they do not divide."""
    if size < 1 or n % size:
        return None
    b = n // size
    return index * b, (index + 1) * b
