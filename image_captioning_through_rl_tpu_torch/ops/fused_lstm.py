"""Teacher-forced LSTM chain: hand-written CUDA kernels (forward and
backward) and the plain PyTorch version.

Counterpart of the JAX ``ops/pallas_lstm.py`` (``fused_lstm_chain``, TPU
kernels ``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``). The
kernels are ``csrc/lstm_chain.cu``; its note says what bounds them on
Hopper and what their design does about that.

Both versions are ``torch.autograd.Function``s over the same arguments,
differentiable with respect to ``wi``, ``wh``, ``b``, the embedding table,
``h0`` and ``c0``. Their backward mirrors the TPU kernel's step by step:
the gate gradients are rounded to the weight type before the products
(plain autograd would not round them), the bias gradient sums them
unrounded, and the embedding gradient is the per-token sum of ``dx``
(``index_add_``, as JAX's ``segment_sum`` outside the kernel).

Routing in :func:`fused_lstm_chain`: a CUDA tensor goes to the kernels (or
the call raises), a CPU tensor to :func:`lstm_chain_plain`, and
``use_fused_kernel=False`` selects the plain version explicitly. No path
catches a kernel error and falls back.
"""

from __future__ import annotations

import torch

from .fused_decode import check_tile_widths, round_to, token_gate_table, wmatmul
from .kernel_build import check_error, load_library


def _step_major(tokens: torch.Tensor) -> torch.Tensor:
    """``[N, T]`` tokens -> ``[T, N]`` contiguous int32: row ``t N + r`` of
    every per-step stream is sample ``r`` at step ``t``."""
    return tokens.t().to(torch.int32).contiguous()


def embedding_grad(dx: torch.Tensor, tok_sm: torch.Tensor, vocab: int) -> torch.Tensor:
    """The embedding table's gradient: the per-step ``dx [T N, E]`` summed
    onto the rows of their tokens."""
    out = torch.zeros((vocab, dx.shape[-1]), dtype=torch.float32, device=dx.device)
    return out.index_add_(0, tok_sm.reshape(-1).long(), dx)


class _LstmChainPlain(torch.autograd.Function):
    """The chain in eager torch, rounding where the TPU kernel does: the
    embedding row and ``h`` in the weight type for the gate products, the
    gate gradients for the backward products; sums and gate math f32. The
    gates add up as ``x @ wi + h @ wh + b``, as the CUDA kernel adds them."""

    @staticmethod
    def forward(ctx, wi, wh, b, embedding, h0, c0, tokens, weight_dtype):
        wd = weight_dtype
        wi_w, wh_w = wi.detach().to(wd), wh.detach().to(wd)
        emb_w = embedding.detach().to(wd)
        tok_sm = _step_major(tokens)
        xs = emb_w[tok_sm.long()].to(torch.float32)  # [T, N, E]
        h, c = h0.detach().to(torch.float32), c0.detach().to(torch.float32)
        hs, cs, gs = [], [], []
        for x in xs:
            gates = wmatmul(x, wi_w) + wmatmul(round_to(h, wd), wh_w) + b.detach()
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            c = f * c + i * g
            h = o * torch.tanh(c)
            hs.append(h)
            cs.append(c)
            gs.append(torch.cat([i, f, g, o], dim=-1))
        hs_sm = torch.stack(hs)
        ctx.save_for_backward(tok_sm, xs, h0, c0, hs_sm, torch.stack(cs), torch.stack(gs),
                              wi_w, wh_w)
        ctx.vocab = embedding.shape[0]
        return hs_sm.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, dhs):
        tok_sm, xs, h0, c0, hs, cs, gs, wi_w, wh_w = ctx.saved_tensors
        dhs_sm = dhs.transpose(0, 1).to(torch.float32)  # [T, N, H]
        dwi, dwh, db, demb, dh, dc = lstm_chain_backward_plain(
            dhs_sm, tok_sm, xs, h0, c0, hs, cs, gs, wi_w, wh_w, ctx.vocab,
            ctx.needs_input_grad[3])
        return dwi, dwh, db, demb, dh, dc, None, None


def lstm_chain_backward_plain(dhs: torch.Tensor, tok_sm: torch.Tensor, xs: torch.Tensor,
                              h0: torch.Tensor, c0: torch.Tensor, hs: torch.Tensor,
                              cs: torch.Tensor, gs: torch.Tensor, wi_w: torch.Tensor,
                              wh_w: torch.Tensor, vocab: int, embedding_grad_needed: bool = True):
    """The chain's backward in eager torch (the plain twin of
    ``lstm_bwd`` in ``csrc/lstm_chain.cuh``), from step-major ``dhs [T, N,
    H]``, the tokens ``tok_sm [T, N]``, their embedding rows ``xs [T, N, E]``
    (f32 values of the weight type), ``(h0, c0)``, the taped ``hs``, ``cs``
    ``[T, N, H]`` and post-activation gates ``gs [T, N, 4H]``, and ``wi``,
    ``wh`` in the weight type -> ``(dwi, dwh, db, demb or None, dh0, dc0)``.
    Shared with the A2C rollout's plain backward (:mod:`.fused_rollout`)."""
    wd = wi_w.dtype
    steps, n, hidden = hs.shape
    h_prev = torch.cat([h0[None].to(torch.float32), hs[:-1]])
    c_prev = torch.cat([c0[None].to(torch.float32), cs[:-1]])
    dh = torch.zeros_like(h_prev[0])
    dc = torch.zeros_like(dh)
    dgs = [None] * steps
    for t in reversed(range(steps)):
        i, f, g, o = torch.chunk(gs[t], 4, dim=-1)
        tc = torch.tanh(cs[t])
        dhv = dh + dhs[t]
        d_o = dhv * tc
        dct = dhv * o * (1.0 - tc * tc) + dc
        di, dg, df = dct * g, dct * i, dct * c_prev[t]
        dc = dct * f
        dgs[t] = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f), dg * (1.0 - g * g),
                            d_o * o * (1.0 - o)], dim=-1)
        dh = wmatmul(round_to(dgs[t], wd), wh_w.t())
    dg_all = torch.stack(dgs).reshape(steps * n, -1)
    dg_w = dg_all.to(wd)
    dwi = wmatmul(xs.reshape(steps * n, -1).t(), dg_w)
    dwh = wmatmul(round_to(h_prev.reshape(steps * n, hidden), wd).t(), dg_w)
    db = dg_all.sum(dim=0)
    demb = None
    if embedding_grad_needed:
        dx = wmatmul(round_to(dg_all, wd), wi_w.t())
        demb = embedding_grad(dx, tok_sm, vocab)
    return dwi, dwh, db, demb, dh, dc


def _check_chain_inputs(name: str, params: dict, embedding: torch.Tensor, tokens: torch.Tensor,
                        states: tuple, gates: int, weight_dtype: torch.dtype) -> None:
    """Device, type, shape and range checks of a chain kernel's inputs
    (shared with :mod:`.fused_gru`)."""
    dev = states[0].device
    tensors = [embedding, *states, *params.values()]
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: parameters, embedding and initial state must be float32 "
                         f"tensors on one device")
    if weight_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: weight_dtype must be bfloat16 or float32, got "
                         f"{weight_dtype}")
    vocab, emb_dim = embedding.shape
    n, hidden = states[0].shape
    if tokens.dim() != 2 or tokens.shape[0] != n or tokens.device != dev:
        raise ValueError(f"{name}: tokens must be an [N, T] tensor on the state's device")
    if tokens.dtype.is_floating_point or tokens.dtype == torch.bool:
        raise ValueError(f"{name}: tokens must be integers")
    if any(s.shape != (n, hidden) for s in states):
        raise ValueError(f"{name}: initial states must be [N, H]")
    want = {"wi": (emb_dim, gates * hidden), "wh": (hidden, gates * hidden)}
    if any(p.shape != want.get(k, (gates * hidden,)) for k, p in params.items()):
        raise ValueError(f"{name}: wi must be [E, {gates}H], wh [H, {gates}H] and each "
                         f"bias [{gates}H]")
    check_tile_widths(weight_dtype, emb_dim=emb_dim, hidden=hidden)
    if tokens.numel() and bool(((tokens < 0) | (tokens >= vocab)).any()):
        raise ValueError(f"{name}: tokens must lie in [0, {vocab})")


class _LstmChainKernel(torch.autograd.Function):
    """The chain through ``csrc/lstm_chain.cu``: one C call forward, one
    backward. The x-gate table is rebuilt each call (the weights change
    every optimiser step)."""

    @staticmethod
    def forward(ctx, wi, wh, b, embedding, h0, c0, tokens, weight_dtype):
        _check_chain_inputs("fused_lstm_chain", {"wi": wi, "wh": wh, "b": b}, embedding, tokens,
                            (h0, c0), 4, weight_dtype)
        n, steps = tokens.shape
        hidden = h0.shape[1]
        dev = h0.device
        emb_w = embedding.detach().to(weight_dtype).contiguous()
        w = torch.cat([wi.detach(), wh.detach()]).to(weight_dtype).contiguous()
        b32 = b.detach().contiguous()
        tok_sm = _step_major(tokens)
        xg = token_gate_table(emb_w, w)
        hbuf = torch.empty(((steps + 1) * n, hidden), dtype=torch.float32, device=dev)
        cbuf = torch.empty_like(hbuf)
        hbuf[:n] = h0.detach()
        cbuf[:n] = c0.detach()
        gates = torch.empty((steps * n, 4 * hidden), dtype=torch.float32, device=dev)
        lib = load_library()
        ptr = torch.Tensor.data_ptr
        with torch.cuda.device(dev):
            err = lib.icrl_lstm_chain_fwd(
                n, steps, hidden, int(weight_dtype == torch.bfloat16), ptr(tok_sm), ptr(xg),
                ptr(w[embedding.shape[1]:]), ptr(b32), ptr(hbuf), ptr(cbuf), ptr(gates),
                torch.cuda.current_stream(dev).cuda_stream)
        check_error(lib, "icrl_lstm_chain_fwd", err)
        fused_lstm_chain.fwd_launches += 1
        ctx.save_for_backward(tok_sm, hbuf, cbuf, gates, emb_w, w)
        return hbuf[n:].view(steps, n, hidden).transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, dhs):
        tok_sm, hbuf, cbuf, gates, emb_w, w = ctx.saved_tensors
        steps, n = tok_sm.shape
        vocab, emb_dim = emb_w.shape
        hidden = hbuf.shape[1]
        dev = hbuf.device
        dhs_sm = dhs.transpose(0, 1).to(torch.float32).contiguous()  # [T, N, H]

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        dg, part = f32(steps * n, 4 * hidden), f32(16, 4 * hidden)
        dh = torch.zeros((n, hidden), dtype=torch.float32, device=dev)
        dc = torch.zeros_like(dh)
        dw, db, dx = f32(emb_dim + hidden, 4 * hidden), f32(4 * hidden), f32(steps * n, emb_dim)
        lib = load_library()
        ptr = torch.Tensor.data_ptr
        with torch.cuda.device(dev):
            err = lib.icrl_lstm_chain_bwd(
                n, steps, emb_dim, hidden, int(w.dtype == torch.bfloat16), ptr(tok_sm),
                ptr(dhs_sm), ptr(hbuf), ptr(cbuf), ptr(gates), ptr(emb_w), ptr(w), ptr(dg),
                ptr(dh), ptr(dc), ptr(part), ptr(dw), ptr(db), ptr(dx),
                torch.cuda.current_stream(dev).cuda_stream)
        check_error(lib, "icrl_lstm_chain_bwd", err)
        fused_lstm_chain.bwd_launches += 1
        demb = embedding_grad(dx, tok_sm, vocab) if ctx.needs_input_grad[3] else None
        return dw[:emb_dim], dw[emb_dim:], db, demb, dh, dc, None, None


def lstm_chain_plain(lstm_params: dict, embedding: torch.Tensor, tokens: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor,
                     weight_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The chain's plain PyTorch version (any device): ``hs [N, T, H]``."""
    return _LstmChainPlain.apply(lstm_params["wi"], lstm_params["wh"], lstm_params["b"],
                                 embedding, h0, c0, tokens, weight_dtype)


def fused_lstm_chain(lstm_params: dict, embedding: torch.Tensor, tokens: torch.Tensor,
                     h0: torch.Tensor, c0: torch.Tensor,
                     weight_dtype: torch.dtype = torch.bfloat16,
                     use_fused_kernel: bool | None = None) -> torch.Tensor:
    """Teacher-forced LSTM over ``tokens [N, T]`` from ``(h0, c0) [N, H]``
    -> ``hs [N, T, H]`` f32, differentiable with respect to
    ``lstm_params`` (``{"wi": [E, 4H], "wh": [H, 4H], "b": [4H]}``), the
    embedding table and the initial state. Weights act in
    ``weight_dtype`` (bf16 by default, as the TPU kernel).

    CUDA tensors run the kernels (``csrc/lstm_chain.cu``); CPU tensors run
    :func:`lstm_chain_plain`. ``use_fused_kernel=False`` forces the plain
    version; ``True`` on CPU tensors raises. ``fused_lstm_chain.fwd_launches``
    and ``.bwd_launches`` count kernel launches of each direction."""
    if use_fused_kernel is False or (not h0.is_cuda and not use_fused_kernel):
        return lstm_chain_plain(lstm_params, embedding, tokens, h0, c0, weight_dtype)
    if not h0.is_cuda:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the LSTM chain kernels "
                           "run only on a CUDA device")
    return _LstmChainKernel.apply(lstm_params["wi"], lstm_params["wh"], lstm_params["b"],
                                  embedding, h0, c0, tokens, weight_dtype)


fused_lstm_chain.fwd_launches = 0
fused_lstm_chain.bwd_launches = 0
