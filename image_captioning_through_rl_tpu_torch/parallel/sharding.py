"""Placement helpers and parameter partition specs (counterpart of the JAX
``parallel/sharding.py``).

In the JAX package placement is the whole story: commit the batch to a
``data``-sharded layout and the parameters to a replicated one, and GSPMD
partitions the step. Here the program is written rank by rank
(:mod:`..train.steps` takes each rank's rows and reduces its gradients), so
placement means: :func:`shard_batch` gives each mesh entry of this process
its rows, :func:`replicate` puts the same parameters on each of them.

Tensor-parallel specs shard the vocabulary axis (the embedding table ``[V,
E]`` and the head ``[E, V]``, ``[V]`` over ``model``), in the JAX layout (a
spec is a tuple of axis names or None per dimension; ``()`` replicates).
:func:`shard_params` places a tree by them: on a mesh that spans processes
each rank keeps its block of every sharded leaf (a :class:`Sharded` tree,
which the models and steps compute on vocab-parallel,
:mod:`.tensor_parallel`); on one process's mesh each ``model`` entry gets
its block (:class:`LocalBlocks`, for placement and decoding: a decode
gathers it). :func:`gather_params` returns the whole tree, as JAX's
``device_get`` does.
"""

from __future__ import annotations

import torch

from .collectives import all_reduce_, broadcast_tree
from .hostbatch import GlobalBatcher
from .mesh import Mesh
from .tensor_parallel import VocabShard


def _spans_processes(mesh: Mesh) -> bool:
    """True when ``mesh`` holds entries of other ranks: each process then
    places only its own rows (:class:`.hostbatch.GlobalBatcher`)."""
    return mesh.spans_processes


def shard_batch(mesh: Mesh, *arrays, axis: str = "data"):
    """Each array's rows per mesh entry of this process: on a mesh that
    spans processes, this rank's rows on its device (one tensor an array);
    on one process's mesh, a list of equal row blocks, block ``j`` on the
    device of entry ``j`` of the ``axis`` (the rows must divide over the
    ``axis`` size, as a JAX sharded layout requires)."""
    if _spans_processes(mesh):
        local = GlobalBatcher(mesh, axis).shard(*arrays)
        local = local if len(arrays) > 1 else (local,)
        out = tuple(torch.as_tensor(a).to(mesh.first_device) for a in local)
    else:
        devices = mesh.entries(axis)  # a 2-D mesh's model entries hold the same rows
        out = []
        for a in arrays:
            a = torch.as_tensor(a)
            if a.shape[0] % len(devices):
                raise ValueError(f"{a.shape[0]} rows do not divide over the mesh's "
                                 f"{len(devices)} '{axis}' entries")
            out.append([blk.to(d) for blk, d in zip(torch.chunk(a, len(devices)), devices)])
        out = tuple(out)
    return out if len(out) > 1 else out[0]


class Replicated(dict):
    """A parameter tree committed to a mesh: device -> the tree on that
    device, one copy a distinct device of this process. ``cache`` holds
    what a caller derives from a copy once (the kernels' weight layouts)."""

    def __init__(self, mesh: Mesh, copies: dict):
        super().__init__(copies)
        self.mesh = mesh
        self.cache = {}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def replicate(mesh: Mesh, tree):
    """``tree`` on every device of ``mesh`` this process holds, as a
    :class:`Replicated`; on a mesh that spans processes, rank 0's values
    broadcast into every rank's copy. A tree already replicated on this
    mesh passes through untouched (serving replicates the same parameters
    per request); a vocab-sharded one is gathered first."""
    if isinstance(tree, Replicated) and tree.mesh is mesh:
        return tree
    tree = gather_params(tree)
    if _spans_processes(mesh):
        local = _clone(_to(tree, mesh.first_device))  # the caller's tree stays as it is
        return Replicated(mesh, {mesh.first_device: broadcast_tree(local)})
    return Replicated(mesh, {d: _to(tree, d) for d in dict.fromkeys(mesh.local_devices)})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


class Sharded(dict):
    """A vocab-sharded parameter tree: this rank's block of each leaf whose
    spec names ``model`` (the leaf cut into ``M`` equal blocks on that
    dimension), the other leaves whole. Every sub-tree that holds a sharded
    leaf is a :class:`Sharded` too. ``specs``: the sub-tree's specs;
    ``vocab``: the :class:`.tensor_parallel.VocabShard` (the block, the
    global vocabulary, the model group); ``mesh``: where it was placed."""

    def __init__(self, tree: dict, mesh: Mesh, specs: dict, vocab: VocabShard):
        super().__init__(tree)
        self.mesh = mesh
        self.specs = specs
        self.vocab = vocab


class LocalBlocks(dict):
    """One process's placement of a vocab-sharded tree: model index ->
    that entry's :class:`Sharded` block tree, on the device of the mesh's
    entry ``(0, m)``. For placement and decoding; a step on it raises (no
    process group combines its blocks)."""

    def __init__(self, mesh: Mesh, blocks: dict):
        super().__init__(blocks)
        self.mesh = mesh


def _model_dim(spec):
    """The dimension a leaf's spec shards over ``model`` (None: whole)."""
    spec = tuple(spec)
    if any(name not in (None, "model") for name in spec):
        raise ValueError(f"a parameter spec shards over 'model' only, got {spec}")
    return spec.index("model") if "model" in spec else None


def _names_model(spec) -> bool:
    if isinstance(spec, dict):
        return any(_names_model(v) for v in spec.values())
    return _model_dim(spec) is not None


def _vocab(params, spec, size: int):
    """The size of the sharded dimension (one for every sharded leaf),
    checked to divide over ``size`` ranks."""
    found = set()

    def walk(tree, sp):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], sp[k])
        elif _model_dim(sp) is not None:
            found.add(int(tree.shape[_model_dim(sp)]))

    walk(params, spec)
    for v in sorted(found):
        if v % size:
            raise ValueError(f"One of shard_params's leaves has a sharded dimension of size {v}: "
                             f"sharded over the 'model' axis of size {size}, it should be "
                             f"divisible by {size}, but it is equal to {v}")
    if len(found) != 1:
        raise ValueError(f"the sharded leaves must share one vocabulary, got sizes {sorted(found)}")
    return found.pop()


def _cut(tree, spec, mesh: Mesh, vs: VocabShard, m: int, device):
    if isinstance(tree, dict):
        out = {k: _cut(tree[k], spec[k], mesh, vs, m, device) for k in tree}
        return Sharded(out, mesh, spec, vs) if _names_model(spec) else out
    t = torch.as_tensor(tree).to(device)
    dim = _model_dim(spec)
    if dim is None:
        return t.detach().clone()
    return torch.chunk(t, vs.size, dim=dim)[m].detach().contiguous().clone()


def shard_params(mesh: Mesh, params, spec_tree):
    """``params`` placed by ``spec_tree`` (the JAX ``shard_params``): a tree
    whose specs name no ``model`` axis, or a mesh whose ``model`` axis is
    one entry, is replicated (a spec that names an axis the mesh lacks
    raises ``ValueError``) (:func:`replicate`); otherwise each sharded
    leaf is cut into ``M`` equal blocks on its ``model`` dimension (``V %
    M`` must be 0, else ``ValueError``, in the JAX words "should be
    divisible by"). On a mesh that spans processes this rank keeps block
    ``m`` (its ``model`` coordinate) of rank 0's broadcast tree, a
    :class:`Sharded`; on one process's mesh each model entry gets its
    block, a :class:`LocalBlocks`."""
    params = gather_params(params)
    if _names_model(spec_tree) and "model" not in mesh.shape:
        raise ValueError(f"a spec names the 'model' axis, which {mesh} does not have")
    if not _names_model(spec_tree) or mesh.shape["model"] == 1:
        return replicate(mesh, params)
    size = int(mesh.shape["model"])
    vocab = _vocab(params, spec_tree, size)
    cols = vocab // size

    def shard(m):
        return VocabShard(m * cols, (m + 1) * cols, vocab, size, mesh.group("model"))

    if mesh.spans_processes:
        m = mesh.coords["model"]
        whole = broadcast_tree(_clone(_to(params, mesh.first_device)))
        return _cut(whole, spec_tree, mesh, shard(m), m, mesh.first_device)
    return LocalBlocks(mesh, {m: _cut(params, spec_tree, mesh, shard(m), m, dev)
                              for m, dev in enumerate(mesh.entries("model"))})


def _gather_sharded(tree, spec, vs: VocabShard):
    """The whole tree of a rank's :class:`Sharded` blocks: each sharded leaf
    gathered over the model group (sorted keys: one collective order)."""
    if isinstance(tree, dict):
        whole = {k: _gather_sharded(tree[k], spec[k], vs) for k in sorted(tree)}
        return {k: whole[k] for k in tree}
    dim = _model_dim(spec)
    if dim is None:
        return tree.detach().clone()
    shape = list(tree.shape)
    shape[dim] = vs.vocab
    buf = tree.new_zeros(shape)
    buf.narrow(dim, vs.lo, vs.cols).copy_(tree.detach())
    return all_reduce_(buf, vs.group)


def _concat(blocks: list, spec):
    if isinstance(blocks[0], dict):
        return {k: _concat([b[k] for b in blocks], spec[k]) for k in blocks[0]}
    dim = _model_dim(spec)
    if dim is None:
        return blocks[0].detach().clone()
    return torch.cat([b.detach().to(blocks[0].device) for b in blocks], dim=dim)


def gather_params(tree):
    """The whole parameter tree (JAX's ``device_get``): a :class:`Sharded`
    tree gathered over its model group (a collective: every rank of the
    group calls it), a :class:`LocalBlocks` placement concatenated, a
    :class:`Replicated` one's first copy, a dict of networks each gathered;
    any other tree as it is (the same object)."""
    if isinstance(tree, Sharded):
        return _gather_sharded(tree, tree.specs, tree.vocab)
    if isinstance(tree, LocalBlocks):
        blocks = [tree[m] for m in sorted(tree)]
        return _concat(blocks, blocks[0].specs)
    if isinstance(tree, Replicated):
        return next(iter(tree.values()))
    if isinstance(tree, dict) and any(isinstance(v, (Sharded, LocalBlocks))
                                      for v in tree.values()):
        return {k: gather_params(v) for k, v in tree.items()}  # {"policy": ..., "value": ...}
    return tree


def _rep(tree):
    return {k: _rep(v) if isinstance(v, dict) else () for k, v in tree.items()}


def policy_param_spec(params, model_axis: str = "model"):
    """TP spec for the policy net: vocab-sharded embedding and head."""
    spec = _rep(params)
    spec["embedding"] = (model_axis, None)
    spec["head"] = {"w": (None, model_axis), "b": (model_axis,)}
    return spec


def value_param_spec(params, model_axis: str = "model"):
    spec = _rep(params)
    spec["embedding"] = (model_axis, None)
    return spec


def reward_param_spec(params, model_axis: str = "model"):
    spec = _rep(params)
    spec["embedding"] = (model_axis, None)
    return spec


def a2c_param_spec(params, model_axis: str = "model"):
    return {
        "policy": policy_param_spec(params["policy"], model_axis),
        "value": value_param_spec(params["value"], model_axis),
    }
