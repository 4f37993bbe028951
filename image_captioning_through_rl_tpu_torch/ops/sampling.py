"""Categorical sampling on the device (counterpart of the JAX
``ops/sampling.py``).

The reference samples rollout actions on the host, one
``np.random.choice`` per row (trainers.py:445-450). Here a draw is the
Gumbel-max trick with JAX's threefry noise (:mod:`.prng`), so a key gives
the JAX package's tokens exactly.
"""

from __future__ import annotations

import torch

from .prng import categorical


def sample_categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """Token ids ``[N]`` (int64) from unnormalised ``logits [N, V]`` under
    the host key ``key`` (uint32 ``[2]``): ``jax.random.categorical``."""
    return categorical(key, logits)


def log_prob_of(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[action]`` per row: ``[N, V], [N] -> [N]``
    (the stable form of the reference's ``log(softmax(...)[action])``,
    trainers.py:458)."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions[:, None].long())[:, 0]
