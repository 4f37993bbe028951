"""Recurrent cells and scans (counterpart of the JAX ``ops/rnn.py``).

LSTM cell parameters: ``{"wi": [E, 4H], "wh": [H, 4H], "b": [4H]}``, gate
order input, forget, cell (g), output along the 4H axis — torch's order,
so reference ``.pt`` checkpoints convert by transposition. GRU cell
parameters: ``{"wi": [E, 3H], "wh": [H, 3H], "bi": [3H], "bh": [3H]}``,
gate order reset, update, new; the two biases stay separate because the
candidate gate applies ``r`` to the recurrent term alone. Scans run over
a time-major ``[T, N, E]`` layout; ``reverse=True`` consumes the sequence
right to left and returns ``hs`` in the inputs' order, as ``lax.scan``
does.
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


def _order(n: int, reverse: bool) -> range:
    return range(n - 1, -1, -1) if reverse else range(n)


def lstm_scan(params: dict, xs: torch.Tensor, init: LSTMState, reverse: bool = False
              ) -> Tuple[torch.Tensor, LSTMState]:
    """Run an LSTM over time-major inputs ``xs: [T, N, E]``.
    Returns ``(hs: [T, N, H], final_state)``; ``hs[t]`` is the state after
    ``xs[t]`` in either direction."""
    state = init
    hs = [None] * xs.shape[0]
    for t in _order(xs.shape[0], reverse):
        state = lstm_cell(params, xs[t], state)
        hs[t] = state[0]
    return torch.stack(hs), state


def gru_cell(params: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step. ``x: [..., E]``, ``h: [..., H]`` -> new ``h``."""
    gi = matmul(x, params["wi"]) + params["bi"]
    gh = matmul(h, params["wh"]) + params["bh"]
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru_scan(params: dict, xs: torch.Tensor, init: torch.Tensor, reverse: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU over time-major inputs ``xs: [T, N, E]``.
    Returns ``(hs: [T, N, H], final_h)``, ``hs`` in the inputs' order."""
    h = init
    hs = [None] * xs.shape[0]
    for t in _order(xs.shape[0], reverse):
        h = gru_cell(params, xs[t], h)
        hs[t] = h
    return torch.stack(hs), h


def bilstm_scan(fwd_params: dict, bwd_params: dict, xs: torch.Tensor, fwd_init: LSTMState,
                bwd_init: LSTMState) -> Tuple[torch.Tensor, Tuple[LSTMState, LSTMState]]:
    """Bidirectional LSTM: a forward and a time-reversed scan. Returns
    ``(hs [T, N, 2H], (final_f, final_b))``, each step's last axis
    ``[fwd_h_t, bwd_h_t]`` (cuDNN's bidirectional layout), ``bwd_h_t`` the
    right-to-left scan's state after ``xs[t]``."""
    hs_f, final_f = lstm_scan(fwd_params, xs, fwd_init)
    hs_b, final_b = lstm_scan(bwd_params, xs, bwd_init, reverse=True)
    return torch.cat([hs_f, hs_b], dim=-1), (final_f, final_b)
