"""Teacher-forced GRU chain: hand-written CUDA kernels (forward and
backward) and the plain PyTorch version.

Counterpart of the JAX ``ops/pallas_gru.py`` (``fused_gru_chain``, TPU
kernels ``_fwd_kernel`` and ``_bwd_kernel`` under a ``custom_vjp``), the
reward network's caption encoder in the VSE step. The kernels are
``csrc/gru_chain.cu`` (forward) and ``csrc/gru_chain_bwd.cu`` (backward);
the first's note says what bounds them on Hopper and what their design
does about that.

As in :mod:`.fused_lstm`, both versions are ``torch.autograd.Function``s,
differentiable with respect to ``wi``, ``wh``, ``bi``, ``bh``, the
embedding table and ``h0``, with a backward that mirrors the TPU kernel's:
gate gradients rounded to the weight type before the products, bias
gradients summed unrounded, the embedding gradient summed per token.
Routing is by the tensors' device, with no fallback. As the LSTM chain's,
each direction's recurrence is one cooperative launch planned by
:func:`gru_chain_plan`, and widths the kernels cannot stage are padded
(:func:`.fused_lstm.padded_chain`).
"""

from __future__ import annotations

import torch

from .fused_decode import round_to, token_gate_table, wmatmul
from .fused_lstm import (
    _bf16_scratch,
    _check_chain_inputs,
    _step_major,
    chain_plan,
    embedding_grad,
    padded_chain,
    plan_args,
)
from .kernel_build import check_error, load_library, runs_kernel


def gru_chain_plan(n: int, hidden: int, weight_dtype: torch.dtype, sm_count: int,
                   backward: bool = False) -> dict:
    """The GRU chain's launch plan (:func:`.fused_lstm.chain_plan` with three
    gates)."""
    return chain_plan(n, hidden, weight_dtype, sm_count, backward, gates=3)


class _GruChainPlain(torch.autograd.Function):
    """The chain in eager torch, rounding where the TPU kernel does:
    ``gi = x @ wi + bi`` on the embedding row in the weight type,
    ``gh = rnd(h) @ wh + bh``; sums and gate math f32."""

    @staticmethod
    def forward(ctx, wi, wh, bi, bh, embedding, h0, tokens, weight_dtype):
        wd = weight_dtype
        wi_w, wh_w = wi.detach().to(wd), wh.detach().to(wd)
        emb_w = embedding.detach().to(wd)
        tok_sm = _step_major(tokens)
        xs = emb_w[tok_sm.long()].to(torch.float32)  # [T, N, E]
        h = h0.detach().to(torch.float32)
        hs, gs, ghns = [], [], []
        for x in xs:
            gi = wmatmul(x, wi_w) + bi.detach()
            gh = wmatmul(round_to(h, wd), wh_w) + bh.detach()
            i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
            h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
            hs.append(h)
            gs.append(torch.cat([r, z, n], dim=-1))
            ghns.append(h_n)
        hs_sm = torch.stack(hs)
        ctx.save_for_backward(tok_sm, xs, h0, hs_sm, torch.stack(gs), torch.stack(ghns),
                              wi_w, wh_w)
        ctx.vocab = embedding.shape[0]
        return hs_sm.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, dhs):
        tok_sm, xs, h0, hs, gs, ghns, wi_w, wh_w = ctx.saved_tensors
        wd = wi_w.dtype
        steps, n, hidden = hs.shape
        dhs = dhs.transpose(0, 1).to(torch.float32)
        h_prev = torch.cat([h0[None].to(torch.float32), hs[:-1]])
        dh = torch.zeros_like(h_prev[0])
        dgis, dghs = [None] * steps, [None] * steps
        for t in reversed(range(steps)):
            r, z, nn = torch.chunk(gs[t], 3, dim=-1)
            dhv = dh + dhs[t]
            dz = dhv * (h_prev[t] - nn)
            dn_pre = dhv * (1.0 - z) * (1.0 - nn * nn)
            dr_pre = dn_pre * ghns[t] * r * (1.0 - r)
            dz_pre = dz * z * (1.0 - z)
            dgis[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
            dghs[t] = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
            dh = wmatmul(round_to(dghs[t], wd), wh_w.t()) + dhv * z
        dgi = torch.stack(dgis).reshape(steps * n, -1)
        dgh = torch.stack(dghs).reshape(steps * n, -1)
        dwi = wmatmul(xs.reshape(steps * n, -1).t(), dgi.to(wd))
        dwh = wmatmul(round_to(h_prev.reshape(steps * n, hidden), wd).t(), dgh.to(wd))
        demb = None
        if ctx.needs_input_grad[4]:
            dx = wmatmul(round_to(dgi, wd), wi_w.t())
            demb = embedding_grad(dx, tok_sm, ctx.vocab)
        return dwi, dwh, dgi.sum(dim=0), dgh.sum(dim=0), demb, dh, None, None


class _GruChainKernel(torch.autograd.Function):
    """The chain through ``csrc/gru_chain.cu`` and ``gru_chain_bwd.cu``: one
    C call forward (one kernel launch beside the table ``emb @ wi + bi``,
    rebuilt each call), one backward (seven launches, whatever T is)."""

    @staticmethod
    def forward(ctx, wi, wh, bi, bh, embedding, h0, tokens, weight_dtype):
        n, steps = tokens.shape
        hidden = h0.shape[1]
        dev = h0.device
        emb_w = embedding.detach().to(weight_dtype).contiguous()
        w = torch.empty((wi.shape[0] + hidden, 3 * hidden), dtype=weight_dtype, device=dev)
        torch.cat([wi.detach(), wh.detach()], out=w)  # [wi; wh] cast as it is copied
        wi_w, wh_w = w[:wi.shape[0]], w[wi.shape[0]:]
        tok_sm = _step_major(tokens)
        xg = token_gate_table(emb_w, wi_w, bi.detach().contiguous())

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        # the tape (h entering every step, r z n, gh_n) and hs, written by the kernel
        hbuf, gates = f32((steps + 1) * n, hidden), f32(steps * n, 3 * hidden)
        ghn, hs = f32(steps * n, hidden), f32(n, steps, hidden)
        h16 = _bf16_scratch(weight_dtype, dev, (steps + 1) * n, hidden)
        lib = load_library()
        ptr = torch.Tensor.data_ptr
        with torch.cuda.device(dev):
            err = lib.icrl_gru_chain_fwd(
                n, steps, hidden, int(weight_dtype == torch.bfloat16),
                *plan_args(n, hidden, weight_dtype, dev.index, False, 3), ptr(tok_sm), ptr(xg),
                ptr(wh_w), ptr(bh.detach().contiguous()), ptr(h0.detach().contiguous()),
                ptr(hbuf), ptr(gates), ptr(ghn), ptr(hs), ptr(h16),
                torch.cuda.current_stream(dev).cuda_stream)
        check_error(lib, "icrl_gru_chain_fwd", err)
        fused_gru_chain.fwd_launches += 1
        ctx.save_for_backward(tok_sm, hbuf, gates, ghn, h16, emb_w, w)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        tok_sm, hbuf, gates, ghn, h16, emb_w, w = ctx.saved_tensors
        steps, n = tok_sm.shape
        vocab, emb_dim = emb_w.shape
        wi_w, wh_w = w[:emb_dim], w[emb_dim:]
        hidden = hbuf.shape[1]
        dev = hbuf.device
        wd = wi_w.dtype
        dhs = dhs.to(torch.float32).contiguous()  # [N, T, H], read in place

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        dgi, dgh, part = f32(steps * n, 3 * hidden), f32(steps * n, 3 * hidden), f32(16, 3 * hidden)
        dgi16 = _bf16_scratch(wd, dev, steps * n, 3 * hidden)
        dgh16 = _bf16_scratch(wd, dev, steps * n, 3 * hidden)
        dhz, dh = f32(n, hidden), f32(n, hidden)
        dwi, dwh = f32(emb_dim, 3 * hidden), f32(hidden, 3 * hidden)
        dbi, dbh, dx = f32(3 * hidden), f32(3 * hidden), f32(steps * n, emb_dim)
        lib = load_library()
        ptr = torch.Tensor.data_ptr
        with torch.cuda.device(dev):
            err = lib.icrl_gru_chain_bwd(
                n, steps, emb_dim, hidden, int(wd == torch.bfloat16),
                *plan_args(n, hidden, wd, dev.index, True, 3), ptr(tok_sm), ptr(dhs), ptr(hbuf),
                ptr(gates), ptr(ghn), ptr(h16), ptr(emb_w), ptr(wi_w), ptr(wh_w), ptr(dgi),
                ptr(dgh), ptr(dgi16), ptr(dgh16), ptr(dhz), ptr(dh), ptr(part), ptr(dwi),
                ptr(dwh), ptr(dbi), ptr(dbh), ptr(dx), torch.cuda.current_stream(dev).cuda_stream)
        check_error(lib, "icrl_gru_chain_bwd", err)
        fused_gru_chain.bwd_launches += 1
        demb = embedding_grad(dx, tok_sm, vocab) if ctx.needs_input_grad[4] else None
        return dwi, dwh, dbi, dbh, demb, dh, None, None


def gru_chain_plain(gru_params: dict, embedding: torch.Tensor, tokens: torch.Tensor,
                    h0: torch.Tensor, weight_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The chain's plain PyTorch version (any device): ``hs [N, T, H]``."""
    return _GruChainPlain.apply(gru_params["wi"], gru_params["wh"], gru_params["bi"],
                                gru_params["bh"], embedding, h0, tokens, weight_dtype)


def fused_gru_chain(gru_params: dict, embedding: torch.Tensor, tokens: torch.Tensor,
                    h0: torch.Tensor, weight_dtype: torch.dtype = torch.bfloat16,
                    use_fused_kernel: bool | None = None) -> torch.Tensor:
    """Teacher-forced GRU over ``tokens [N, T]`` from ``h0 [N, H]`` ->
    ``hs [N, T, H]`` f32, differentiable with respect to ``gru_params``
    (``{"wi": [E, 3H], "wh": [H, 3H], "bi": [3H], "bh": [3H]}``), the
    embedding table and ``h0``. Weights act in ``weight_dtype`` (bf16 by
    default, as the TPU kernel).

    CUDA tensors run the kernels (``csrc/gru_chain*.cu``); CPU tensors run
    :func:`gru_chain_plain`. ``use_fused_kernel=False`` forces the plain
    version; ``True`` on CPU tensors raises. ``fused_gru_chain.fwd_launches``
    and ``.bwd_launches`` count kernel launches of each direction."""
    if not runs_kernel(use_fused_kernel, h0, "GRU chain"):
        return gru_chain_plain(gru_params, embedding, tokens, h0, weight_dtype)
    _check_chain_inputs("fused_gru_chain", gru_params, embedding, tokens, (h0,), 3, weight_dtype)

    def kernel(p, emb, tok, h):
        return _GruChainKernel.apply(p["wi"], p["wh"], p["bi"], p["bh"], emb, h, tok,
                                     weight_dtype)

    return padded_chain(kernel, gru_params, embedding, tokens, (h0,), 3)


fused_gru_chain.fwd_launches = 0
fused_gru_chain.bwd_launches = 0
