"""Tensor parallelism over the vocabulary (ROADMAP §1 item 8b; the JAX
package's ``model`` mesh axis, where GSPMD inserts the collectives).

A vocab-sharded parameter tree (:class:`.sharding.Sharded`) holds this
rank's block of every vocabulary-sized leaf: rows ``[lo, hi)`` of the
embedding table ``[V, E]`` and columns ``[lo, hi)`` of the policy head
``[E, V]``, ``[V]``. Its :class:`VocabShard` names the block and the
``model`` group. Here the collectives are written out, each as a
``torch.autograd.Function`` where it needs its own backward:

  * :func:`lookup` — the embedding lookup: each rank looks up the tokens its
    block holds (zeros elsewhere) and the rows are summed over ``model``
    (``x + 0`` is exact: the rows of the whole table bit for bit); the
    backward is the identity, each rank's block taking its tokens' rows;
  * :func:`head` — the policy head: its input goes through an op that is the
    identity forward and sums the gradient over ``model`` backward (each
    block's product sees only its columns' share of ``dh``), and the
    logits are the rank's block of columns;
  * :func:`log_prob` — ``log_softmax(logits)[target]`` over the whole
    vocabulary: the row max by a MAX all-reduce, the sum of exponentials
    and the target's logit (from the rank that holds it) by one SUM
    all-reduce; its backward needs no collective. The policy's XE and
    A2C's log-probability of its pick both take it;
  * :func:`sample` — A2C's Gumbel-max pick: each rank draws its columns of
    the global noise (:func:`..ops.prng.gumbel` at ``col0 = lo`` of width
    ``V``), takes its best ``logit + noise``, and the ranks combine by a
    MAX of the value, then a MIN of the global index among the ranks that
    hold it: ``argmax``'s first index at ties, as ``jax.random.categorical``;
  * :func:`table` — the whole table, for the chain kernels that read rows by
    token inside the launch: an all-reduce of a zero buffer holding the
    block. Its backward keeps the rank's rows of the gradient and does not
    sum over ``model``: every model rank computed the same rows, so each
    already holds the whole table's gradient.

Gloo carries CUDA tensors for ``all_reduce`` and ``broadcast`` only, so
every collective here is an ``all_reduce`` (SUM, MAX or MIN). A tree
without a :class:`VocabShard` takes the plain single-device forms.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..ops.linalg import dense
from ..ops.prng import gumbel
from ..ops.sampling import sample_categorical
from .collectives import active, all_reduce_


class VocabShard(NamedTuple):
    """This rank's block ``[lo, hi)`` of a vocabulary of ``vocab`` entries,
    split over the ``size`` ranks of ``group`` (the mesh's ``model``
    group)."""
    lo: int
    hi: int
    vocab: int
    size: int
    group: object = None

    @property
    def cols(self) -> int:
        return self.hi - self.lo


def _names_model(spec) -> bool:
    if isinstance(spec, dict):
        return any(_names_model(v) for v in spec.values())
    return "model" in tuple(spec)


def vocab_of(tree, leaf: Optional[str] = None) -> Optional[VocabShard]:
    """The :class:`VocabShard` of a vocab-sharded tree (of its ``leaf``,
    when given: None if that leaf is whole), None for any other tree. A
    block of a one-process mesh has no group to combine over and raises:
    gather it first (:func:`.sharding.gather_params`)."""
    vs = getattr(tree, "vocab", None)
    if vs is None or (leaf is not None and not _names_model(tree.specs[leaf])):
        return None
    if vs.size > 1 and (vs.group is None or not active()):
        raise ValueError("a vocab block of a one-process mesh has no model group to combine "
                         "its logits over: gather the tree (parallel.gather_params) or run one "
                         "process per mesh entry")
    return vs


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum over the model group; backward: the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over the model
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def embed(block: torch.Tensor, tokens: torch.Tensor, vs: VocabShard) -> torch.Tensor:
    """Rows of the whole table ``[V, E]`` at ``tokens`` from this rank's
    ``block`` (rows ``[vs.lo, vs.hi)``): a masked lookup, summed over the
    model group."""
    local = tokens - vs.lo
    inside = (local >= 0) & (local < vs.cols)
    rows = torch.where(inside[..., None], block[local.clamp(0, vs.cols - 1)], 0.0)
    return _SumOverModel.apply(rows, vs.group)


def lookup(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``params["embedding"][tokens]``, vocab-parallel on a sharded tree."""
    vs = vocab_of(params, "embedding")
    if vs is None:
        return params["embedding"][tokens]
    return embed(params["embedding"], tokens, vs)


def head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The policy head's logits: ``[..., V]``, or on a sharded tree this
    rank's columns ``[..., V/M]``."""
    vs = vocab_of(params, "head")
    if vs is None:
        return dense(h, params["head"])
    return dense(_CopyToModel.apply(h, vs.group), params["head"])


class _GatherTable(torch.autograd.Function):
    """The whole ``[V, E]`` table from each rank's block; backward: this
    rank's rows of the table's gradient (each model rank holds all of it)."""

    @staticmethod
    def forward(ctx, block, lo, vocab, group):
        ctx.lo, ctx.hi = lo, lo + block.shape[0]
        buf = block.new_zeros((vocab,) + tuple(block.shape[1:]))
        buf[ctx.lo: ctx.hi] = block
        return all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo: ctx.hi], None, None, None


def table(params: dict) -> torch.Tensor:
    """The whole embedding table of ``params``: gathered over the model
    group on a sharded tree (differentiable)."""
    vs = vocab_of(params, "embedding")
    if vs is None:
        return params["embedding"]
    return _GatherTable.apply(params["embedding"], vs.lo, vs.vocab, vs.group)


class _LogProb(torch.autograd.Function):
    """``log_softmax(logits)[target]`` over the columns of every model rank.
    Forward: the row max (MAX), then the sum of ``exp(logit - max)`` and the
    target's ``logit - max`` (SUM, one all-reduce). Backward, on this rank's
    columns: ``g (onehot(target) - softmax)``."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        cols = logits.shape[-1]
        m = logits.detach().amax(dim=-1)
        all_reduce_(m, group, dist.ReduceOp.MAX)
        z = logits - m[..., None]
        e = torch.exp(z)
        local = targets.long() - lo
        inside = (local >= 0) & (local < cols)
        idx = local.clamp(0, cols - 1)
        zt = torch.where(inside, torch.gather(z, -1, idx[..., None])[..., 0], 0.0)
        parts = all_reduce_(torch.stack([e.sum(dim=-1), zt]), group)
        ctx.save_for_backward(e, parts[0], idx, inside)
        return parts[1] - torch.log(parts[0])

    @staticmethod
    def backward(ctx, grad):
        e, s, idx, inside = ctx.saved_tensors
        out = e * (-grad / s)[..., None]
        out.scatter_add_(-1, idx[..., None], torch.where(inside, grad, 0.0)[..., None])
        return out, None, None, None


def log_prob(logits: torch.Tensor, targets: torch.Tensor,
             vs: Optional[VocabShard]) -> torch.Tensor:
    """``log_softmax(logits, -1)`` at ``targets`` (global ids), ``[...]``;
    with ``vs`` the logits are this rank's columns of the whole row."""
    if vs is None:
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return _LogProb.apply(logits, targets, vs.lo, vs.group)


def sample(key, logits: torch.Tensor, vs: Optional[VocabShard], row0: int = 0) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` for rows ``[row0, row0 + N)``
    of a batch (int64 ``[N]``); with ``vs`` the logits ``[N, V/M]`` are this
    rank's columns, and the pick is the global one."""
    if vs is None:
        return sample_categorical(key, logits, row0)
    noise = gumbel(key, tuple(logits.shape), logits.device, row0, col0=vs.lo, width=vs.vocab)
    z = noise.add_(logits)
    idx = torch.argmax(z, dim=-1)
    val = torch.gather(z, -1, idx[:, None])[:, 0]
    best = all_reduce_(val.clone(), vs.group, dist.ReduceOp.MAX)
    pick = torch.where(val == best, idx + vs.lo, vs.vocab)
    return all_reduce_(pick, vs.group, dist.ReduceOp.MIN)
