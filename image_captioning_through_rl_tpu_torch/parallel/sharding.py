"""Placement helpers and parameter partition specs (counterpart of the JAX
``parallel/sharding.py``).

In the JAX package placement is the whole story: commit the batch to a
``data``-sharded layout and the parameters to a replicated one, and GSPMD
partitions the step. Here the program is written rank by rank
(:mod:`..train.steps` takes each rank's rows and reduces its gradients), so
placement means: :func:`shard_batch` gives each mesh entry of this process
its rows, :func:`replicate` puts the same parameters on each of them.

Tensor-parallel specs shard the vocabulary axis (the embedding table ``[V,
E]`` and the head ``[E, V]`` over ``model``). They are kept as data, in the
JAX layout (a spec is a tuple of axis names or None per dimension; ``()``
replicates), and :func:`shard_params` with a ``model`` axis in a spec raises
``NotImplementedError``: ROADMAP §1 item 8b.
"""

from __future__ import annotations

import torch

from .collectives import broadcast_tree
from .hostbatch import GlobalBatcher
from .mesh import TENSOR_PARALLEL, Mesh


def _spans_processes(mesh: Mesh) -> bool:
    """True when ``mesh`` holds entries of other ranks: each process then
    places only its own rows (:class:`.hostbatch.GlobalBatcher`)."""
    return mesh.spans_processes


def shard_batch(mesh: Mesh, *arrays, axis: str = "data"):
    """Each array's rows per mesh entry of this process: on a mesh that
    spans processes, this rank's rows on its device (one tensor an array);
    on one process's mesh, a list of equal row blocks, block ``j`` on entry
    ``j``'s device (the rows must divide over the ``axis`` size, as a JAX
    sharded layout requires)."""
    if _spans_processes(mesh):
        local = GlobalBatcher(mesh, axis).shard(*arrays)
        local = local if len(arrays) > 1 else (local,)
        out = tuple(torch.as_tensor(a).to(mesh.first_device) for a in local)
    else:
        devices = mesh.local_devices
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
    per request)."""
    if isinstance(tree, Replicated) and tree.mesh is mesh:
        return tree
    if isinstance(tree, Replicated):
        tree = next(iter(tree.values()))
    if _spans_processes(mesh):
        local = _clone(_to(tree, mesh.first_device))  # the caller's tree stays as it is
        return Replicated(mesh, {mesh.first_device: broadcast_tree(local)})
    return Replicated(mesh, {d: _to(tree, d) for d in dict.fromkeys(mesh.local_devices)})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def shard_params(mesh: Mesh, params, spec_tree):
    """``params`` placed by ``spec_tree``: every spec replicated (``()``)
    replicates the tree; a spec that names the ``model`` axis raises
    ``NotImplementedError`` (ROADMAP §1 item 8b)."""

    def walk(spec):
        if isinstance(spec, dict):
            return any(walk(v) for v in spec.values())
        return "model" in tuple(spec)

    if walk(spec_tree):
        raise NotImplementedError(TENSOR_PARALLEL)
    return replicate(mesh, params)


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
