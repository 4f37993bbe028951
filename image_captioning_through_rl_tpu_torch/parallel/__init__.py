"""Data and tensor parallelism over cards and processes (counterpart of the
JAX ``parallel/``).

The JAX package scales by placement: GSPMD partitions the single-device
program over a mesh and inserts the collectives. Here the program is
written rank by rank, in PyTorch's idiom:

  * one process per card, launched by ``torchrun``; NCCL between cards,
    gloo on the CPU and where ranks share one card on purpose
    (:mod:`.mesh`);
  * a :class:`.mesh.Mesh` of ``torch.device`` entries with a ``data`` axis
    and, for tensor parallelism, a ``model`` axis: the ranks in a
    distributed world (rank ``r`` of a ``(D, M)`` mesh at ``(r // M, r %
    M)``, each axis a process group), local devices (repeats allowed) in one
    process;
  * each rank keeps its rows of the global minibatch, by its ``data``
    coordinate (:class:`.hostbatch.GlobalBatcher`), and runs its hand
    kernels on them; the training steps reduce their gradients over the
    ``data`` group in one bucket a step (:mod:`.collectives`,
    :mod:`..train.steps`);
  * tensor parallelism over the vocabulary: :func:`.sharding.shard_params`
    with the ``*_param_spec`` specs gives each ``model`` rank its block of
    the embedding tables and the policy head, and the models and steps
    compute on it with explicit collectives (:mod:`.tensor_parallel`);
  * batch-sharded decoding for serving and evaluation (:mod:`.serve`), and
    the explicit per-rank A2C step (:mod:`.shard_map_step`).

The names below load on first use, so that the models can import
:mod:`.tensor_parallel` while this package's decoding half imports them.
"""

import importlib

_EXPORTS = {
    "GlobalBatcher": "hostbatch",
    "Mesh": "mesh",
    "make_mesh": "mesh",
    "local_device_count": "mesh",
    "is_main_process": "mesh",
    "maybe_init_distributed": "mesh",
    "make_shard_map_a2c_step": "shard_map_step",
    "sharded_greedy_tokens": "serve",
    "sharded_beam_tokens": "serve",
    "sharded_sample_tokens": "serve",
    "replicate": "sharding",
    "shard_batch": "sharding",
    "shard_params": "sharding",
    "gather_params": "sharding",
    "Sharded": "sharding",
    "LocalBlocks": "sharding",
    "policy_param_spec": "sharding",
    "value_param_spec": "sharding",
    "reward_param_spec": "sharding",
    "a2c_param_spec": "sharding",
    "VocabShard": "tensor_parallel",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
