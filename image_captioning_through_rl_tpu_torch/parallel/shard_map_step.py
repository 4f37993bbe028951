"""The explicit per-rank A2C step (counterpart of the JAX
``parallel/shard_map_step.py``).

The default data-parallel path (:mod:`..train.steps` with a row shard)
draws each rank's rows of the global minibatch's noise, so it takes the
single-device step's trajectory. This is the JAX package's explicit
alternative: each rank runs the per-device program on its rows as a batch
of their own, under its own key ``fold_in(rng, index)`` (``index`` its
position on the ``data`` axis) with its noise drawn from row 0, and the
gradients and stats are averaged over the ranks by hand. Its sampling stream
therefore differs from the default path's and changes with the number of
ranks, as in the JAX package (``tests/test_shard_map_step.py`` compares the
two on a sampling-free window); the step's numbers equal the JAX
``shard_map`` program's on a mesh of as many devices.
"""

from __future__ import annotations

import torch

from ..config import NetConfig
from ..ops.prng import fold_in
from .collectives import reduce_gradients
from .hostbatch import GlobalBatcher
from .mesh import Mesh


def make_shard_map_a2c_step(cfg: NetConfig, optimizer: torch.optim.Optimizer, mesh: Mesh,
                            per_step_mean: bool = False, fused: bool = False,
                            fuse_reward: bool = True):
    """``step(a2c_params, reward_params, features, captions, curr_seq_len,
    rng) -> RolloutStats``: one A2C update with the global minibatch
    (``features [N, F]``, ``captions [N, T]``, the same on every rank) split
    over ``mesh``'s data axis, one block a rank. ``caplen`` comes from the
    global captions. ``fused=True`` runs each rank's rollout through the
    rollout kernels (kernel 6) on its rows. A ragged N raises: the explicit
    program needs equal blocks."""
    from ..train import steps  # the steps import the parallel layer

    if fused and cfg.bidirectional:
        raise ValueError("fused rollout is unidirectional only")
    if not mesh.spans_processes and len(mesh.local_devices) > 1:
        raise ValueError("the explicit step runs one rank a data entry: launch one process "
                         "per device (torchrun) for a mesh of more than one")
    batcher = GlobalBatcher(mesh)
    if fused:
        rollout = steps.a2c_rollout_loss_fused
    else:
        rollout = steps.a2c_rollout_loss_full if cfg.bidirectional else steps.a2c_rollout_loss

    def step(a2c_params, reward_params, features, captions, curr_seq_len, rng):
        n = captions.shape[0]
        shard = batcher.row_shard(n)
        if shard is None:
            raise ValueError(f"{n} rows do not divide over the {mesh.shape['data']} ranks")
        caplen = int(torch.max(steps.batch_caption_lens(captions)))
        feats, caps = features[shard.lo: shard.hi], captions[shard.lo: shard.hi]
        key = fold_in(rng, shard.lo // shard.rows)
        kw = {"fuse_reward": fuse_reward} if fused else {}
        optimizer.zero_grad(set_to_none=True)
        loss, stats = rollout(a2c_params, cfg, reward_params, feats, caps, int(curr_seq_len),
                              caplen, key, per_step_mean=per_step_mean, **kw)
        loss.backward()
        # the explicit pmean of gradients and stats over the data axis
        stats = reduce_gradients(optimizer, [x.detach() for x in stats], shard)
        optimizer.step()
        return steps.RolloutStats(*stats)

    return step
