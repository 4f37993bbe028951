"""Parameter initializers with torch's default distributions, drawn from an
explicit ``torch.Generator`` (counterpart of the JAX ``initializers.py``):

  * ``nn.Embedding``: N(0, 1)
  * ``nn.Linear``:    U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for both w and b
  * ``nn.LSTM``:      U(-1/sqrt(H), +1/sqrt(H)) for every tensor; the fused
    bias is the sum of torch's two bias vectors
  * ``nn.GRU``:       U(-1/sqrt(H), +1/sqrt(H)) for every tensor, both
    biases kept

The two frameworks draw different numbers from the same seed; tests that
compare them carry weights across with :func:`.convert.from_jax_params`.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen: torch.Generator, shape, k: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(-k, k, generator=gen)


def embedding_init(gen: torch.Generator, vocab: int, dim: int) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, dtype=torch.float32)


def linear_init(gen: torch.Generator, fan_in: int, fan_out: int) -> dict:
    k = 1.0 / math.sqrt(fan_in)
    return {"w": _uniform(gen, (fan_in, fan_out), k), "b": _uniform(gen, (fan_out,), k)}


def lstm_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    k = 1.0 / math.sqrt(hidden)
    return {
        "wi": _uniform(gen, (in_dim, 4 * hidden), k),
        "wh": _uniform(gen, (hidden, 4 * hidden), k),
        "b": _uniform(gen, (4 * hidden,), k) + _uniform(gen, (4 * hidden,), k),
    }


def gru_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    k = 1.0 / math.sqrt(hidden)
    return {
        "wi": _uniform(gen, (in_dim, 3 * hidden), k),
        "wh": _uniform(gen, (hidden, 3 * hidden), k),
        "bi": _uniform(gen, (3 * hidden,), k),
        "bh": _uniform(gen, (3 * hidden,), k),
    }
