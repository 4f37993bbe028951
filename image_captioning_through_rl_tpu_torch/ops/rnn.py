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

The reference-compat scans of the batch-as-time encoders (quirk Q1),
:func:`flat_stream_scan` and :func:`column_stream_scan_bidi`, are one
carried batch-1 recurrence over a long token stream (tens of thousands of
steps per call). They run through PyTorch's own recurrent op, the
``torch.lstm``/``torch.gru`` that ``nn.LSTM``/``nn.GRU`` call, on the
port's weights (transposed copies, through which gradients reach
``wi``/``wh``/``b``; cuDNN packs them into its own layout each call), on
either device: the JAX package computes them with ``lax.scan`` in XLA, not
with a Pallas kernel. On CUDA tensors cuDNN's TF32 is turned off first, as
:func:`.linalg.matmul` does for products, so the streams stay float32.
"""

from __future__ import annotations

import warnings
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


def _stream_weights(cell_kind: str, params: dict) -> list:
    """The port's cell parameters in torch's order and layout,
    ``[weight_ih, weight_hh, bias_ih, bias_hh]``: ``wi [E, G]`` is
    ``weight_ih [G, E]`` transposed (copied contiguous: cuDNN refuses
    strided weights; the copy passes gradients back), ``wh`` likewise; the
    LSTM's single bias is ``bias_ih`` beside a zero ``bias_hh``, the GRU's
    two map one to one."""
    w = [params["wi"].t().contiguous(), params["wh"].t().contiguous()]
    if cell_kind == "lstm":
        return w + [params["b"], torch.zeros_like(params["b"])]
    return w + [params["bi"], params["bh"]]


def _run_stream(cell_kind: str, weights: list, xs: torch.Tensor, hx, bidirectional: bool):
    """One ``torch.lstm``/``torch.gru`` call (one layer, no dropout) over
    ``xs [L, 1, E]`` from ``hx``: LSTM ``(out, h_n, c_n)``, GRU ``(out,
    h_n)``. cuDNN's backward needs its forward in training mode, which
    changes nothing else without dropout: so it is while gradients are
    recorded."""
    if xs.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
    op = torch.lstm if cell_kind == "lstm" else torch.gru
    with warnings.catch_warnings():
        # the weights are views, not one flat chunk: cuDNN compacts them each call
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        return op(xs, hx, weights, True, 1, 0.0, torch.is_grad_enabled(), bidirectional, False)


def flat_stream_scan(cell_kind: str, params: dict, tokens_te: torch.Tensor, init_state):
    """The reference's batch-as-time RNN (quirk Q1) as one carried stream
    (the JAX ``ops/rnn.py:126-174``): the reference feeds a batch of N
    tokens as a length-N sequence at batch 1 and keeps the hidden state
    across its per-column loop and across calls (reference models.py:133,
    168-169, 226, 254-255), so the caption matrix is consumed column-major
    as one flat stream.

    ``tokens_te [L, E]``: the embedded stream; ``init_state``: the carried
    state, ``(h, c)`` each ``[H]`` for ``"lstm"``, ``h [H]`` for ``"gru"``.
    Returns ``(outputs [L, H], final_state)`` in the carry's structure."""
    if cell_kind not in ("lstm", "gru"):
        raise ValueError(f"unknown cell kind: {cell_kind!r}")
    weights = _stream_weights(cell_kind, params)
    xs = tokens_te[:, None]
    if cell_kind == "lstm":
        h, c = init_state
        out, h_n, c_n = _run_stream(cell_kind, weights, xs, (h[None, None], c[None, None]),
                                    False)
        return out[:, 0], (h_n[0, 0], c_n[0, 0])
    out, h_n = _run_stream(cell_kind, weights, xs, init_state[None, None], False)
    return out[:, 0], h_n[0, 0]


def column_stream_scan_bidi(cell_kind: str, fwd_params: dict, bwd_params: dict,
                            xs_tne: torch.Tensor, carry):
    """The bidirectional batch-as-time scan (quirk Q1; the JAX
    ``ops/rnn.py:177-214``): each caption column ``xs_tne[t] [N, E]`` is one
    bidirectional call at batch 1 with a ``(2, 1, H)`` state, the forward
    direction consuming samples 0..N-1 and the backward N-1..0, each from
    its own carried state, the carries threading across the T columns
    (reference models.py:120-135). ``carry``: ``(fwd_state, bwd_state)``,
    each the cell's state with ``[H]`` leaves. Returns ``(the last column's
    outputs [N, 2H], new_carry)``, position ``i`` holding ``[fwd after
    sample i, bwd after samples N-1..i]``."""
    if cell_kind not in ("lstm", "gru"):
        raise ValueError(f"unknown cell kind: {cell_kind!r}")
    weights = _stream_weights(cell_kind, fwd_params) + _stream_weights(cell_kind, bwd_params)
    cf, cb = carry
    if cell_kind == "lstm":
        hx = (torch.stack([cf[0], cb[0]])[:, None], torch.stack([cf[1], cb[1]])[:, None])
    else:
        hx = torch.stack([cf, cb])[:, None]
    out = None
    for t in range(xs_tne.shape[0]):
        out, *hx = _run_stream(cell_kind, weights, xs_tne[t][:, None], hx, True)
        hx = tuple(hx) if cell_kind == "lstm" else hx[0]
    if cell_kind == "lstm":
        new_carry = ((hx[0][0, 0], hx[1][0, 0]), (hx[0][1, 0], hx[1][1, 0]))
    else:
        new_carry = (hx[0, 0], hx[1, 0])
    return out[:, 0], new_carry
