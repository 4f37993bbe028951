"""Recurrent cells and scans (counterpart of the JAX ``ops/rnn.py``).

LSTM cell parameters: ``{"wi": [E, 4H], "wh": [H, 4H], "b": [4H]}``, gate
order input, forget, cell (g), output along the 4H axis — torch's order,
so reference ``.pt`` checkpoints convert by transposition. Scans run over
a time-major ``[T, N, E]`` layout. The GRU and bidirectional scans are
not ported yet (ROADMAP §1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .linalg import matmul

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [..., H]


def lstm_cell(params: dict, x: torch.Tensor, state: LSTMState) -> LSTMState:
    """One LSTM step as ONE ``[x; h] @ [wi; wh]`` product.
    ``x: [..., E]``, ``state: ([..., H], [..., H])``."""
    h, c = state
    xh = torch.cat([x, h], dim=-1)
    w = torch.cat([params["wi"], params["wh"]], dim=0)
    gates = matmul(xh, w) + params["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_scan(params: dict, xs: torch.Tensor, init: LSTMState
              ) -> Tuple[torch.Tensor, LSTMState]:
    """Run an LSTM over time-major inputs ``xs: [T, N, E]``.
    Returns ``(hs: [T, N, H], final_state)``."""
    state = init
    hs = []
    for x in xs:
        state = lstm_cell(params, x, state)
        hs.append(state[0])
    return torch.stack(hs), state
