"""Advantage actor-critic agent: the (value, policy) pair.

Counterpart of the JAX ``models/a2c.py``. Parameters are
``{"value": ..., "policy": ...}``, matching the reference checkpoint's
``value_network.* / policy_network.*`` key prefixes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import NetConfig
from . import policy as policy_mod
from . import value as value_mod


def init(gen: torch.Generator, cfg: NetConfig) -> dict:
    return {"value": value_mod.init(gen, cfg), "policy": policy_mod.init(gen, cfg)}


def forward(params: dict, cfg: NetConfig, features: torch.Tensor,
            captions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values [N, 1], last-step logits [N, V])`` for the current prefix."""
    values = value_mod.forward(params["value"], cfg, features, captions)
    logits = policy_mod.forward(params["policy"], cfg, features, captions)[:, -1, :]
    return values, logits
