"""Data parallelism over cards and processes (counterpart of the JAX
``parallel/``).

The JAX package scales by placement: GSPMD partitions the single-device
program over a mesh and inserts the collectives. Here the program is
written rank by rank, in PyTorch's idiom:

  * one process per card, launched by ``torchrun``; NCCL between cards,
    gloo on the CPU and where ranks share one card on purpose
    (:mod:`.mesh`);
  * a :class:`.mesh.Mesh` of ``torch.device`` entries with a ``data`` axis:
    the ranks in a distributed world, local devices (repeats allowed) in
    one process;
  * each rank keeps its rows of the global minibatch
    (:class:`.hostbatch.GlobalBatcher`) and runs its hand kernels on them;
    the training steps reduce their gradients in one bucket a step
    (:mod:`.collectives`, :mod:`..train.steps`);
  * batch-sharded decoding for serving and evaluation (:mod:`.serve`), and
    the explicit per-rank A2C step (:mod:`.shard_map_step`).

Tensor parallelism over the vocabulary (a ``model`` axis) is ROADMAP §1
item 8b: its specs are here as data, and using them raises.
"""

from .hostbatch import GlobalBatcher
from .mesh import (Mesh, is_main_process, local_device_count, make_mesh,
                   maybe_init_distributed)
from .serve import sharded_beam_tokens, sharded_greedy_tokens, sharded_sample_tokens
from .shard_map_step import make_shard_map_a2c_step
from .sharding import (a2c_param_spec, policy_param_spec, replicate, reward_param_spec,
                       shard_batch, shard_params, value_param_spec)

__all__ = [
    "GlobalBatcher",
    "Mesh",
    "make_mesh",
    "local_device_count",
    "is_main_process",
    "maybe_init_distributed",
    "make_shard_map_a2c_step",
    "sharded_greedy_tokens",
    "sharded_beam_tokens",
    "sharded_sample_tokens",
    "replicate",
    "shard_batch",
    "shard_params",
    "policy_param_spec",
    "value_param_spec",
    "reward_param_spec",
    "a2c_param_spec",
]
