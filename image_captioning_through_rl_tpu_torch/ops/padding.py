"""Zero padding to the widths the CUDA kernels stage in whole 16-byte chunks.

The kernels move their operands in 16-byte chunks (8 bf16 or 4 float32
values along a row), so every reduction width (E, F, H, and with it the gate
widths 3H and 4H) must be a multiple of 8 and a vocabulary read in bf16
pairs even. The wrappers pad a model whose widths are not so, instead of
refusing it, in ways that leave every output unchanged:

- reduction widths E and F: zero rows of the weights, zero columns of the
  inputs (each product gains terms 0 * 0);
- the hidden width H: units with zero weights, zero bias and zero initial
  state, which stay exactly zero through both cells (LSTM: i = f = o = 1/2,
  g = 0, so c and h stay 0; GRU: n = 0, so h' = h / 2 stays 0) and feed
  nothing through their zero weight rows;
- the vocabulary: zero head columns with a -1e30 bias, which never win an
  argmax, a top-k cut or a softmax share (as the TPU kernels pad theirs).

Outputs and gradients are sliced back to the true widths. The helpers are
differentiable (``torch.nn.functional.pad``), so a gradient reaches the
unpadded parameters through them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30  # a padded vocabulary column's bias, as in the TPU kernels


def pad8(width: int) -> int:
    return -(-width // 8) * 8


def needs_padding(*widths: int, vocab: int | None = None) -> bool:
    """Whether any reduction width is not a multiple of 8, or the
    vocabulary odd."""
    return any(w % 8 for w in widths) or (vocab is not None and vocab % 2 == 1)


def pad_dim(t: torch.Tensor, dim: int, size: int, value: float = 0.0) -> torch.Tensor:
    """``t`` with dimension ``dim`` padded at its end to ``size``."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    pads = [0, 0] * (t.dim() - dim % t.dim() - 1) + [0, extra]
    return F.pad(t, pads, value=value)


def pad_gates(t: torch.Tensor, gates: int, hidden_p: int) -> torch.Tensor:
    """A gate-major last dimension ``[..., gates H]`` padded per gate to
    ``[..., gates Hp]`` (each gate's units followed by its zero units)."""
    shape = t.shape[:-1]
    split = t.reshape(*shape, gates, t.shape[-1] // gates)
    return pad_dim(split, -1, hidden_p).reshape(*shape, gates * hidden_p)


def pad_cell(params: dict, gates: int, emb_p: int, hidden_p: int) -> dict:
    """A recurrent cell's ``{"wi": [E, gH], "wh": [H, gH], bias [gH]...}``
    padded to ``[Ep, gHp]``, ``[Hp, gHp]`` and ``[gHp]``."""
    out = {}
    for k, v in params.items():
        v = pad_gates(v, gates, hidden_p)
        if k == "wi":
            v = pad_dim(v, 0, emb_p)
        elif k == "wh":
            v = pad_dim(v, 0, hidden_p)
        out[k] = v
    return out


def pad_split_rows(w: torch.Tensor, first: int, first_p: int, rest_p: int) -> torch.Tensor:
    """Rows ``[A; B]`` split at ``first`` padded to ``[A (first_p rows); B
    (rest_p rows)]``: a weight that multiplies a concatenation, such as
    ``[wi; wh]`` or ``linear1`` over ``[features; h]``."""
    return torch.cat([pad_dim(w[:first], 0, first_p), pad_dim(w[first:], 0, rest_p)])
