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
(as JAX's ``segment_sum``, outside the kernel: ``index_add_`` on the CPU, a
one-hot product on the card, :func:`embedding_grad`).

Routing in :func:`fused_lstm_chain`: a CUDA tensor goes to the kernels (or
the call raises), a CPU tensor to :func:`lstm_chain_plain`, and
``use_fused_kernel=False`` selects the plain version explicitly. No path
catches a kernel error and falls back.

Each direction's recurrence is one cooperative launch of a persistent
kernel whose blocks must all be resident at once: :func:`lstm_chain_plan`
sizes it (rows per tile, hidden units per block, stationary or streamed
weights, the grid, the shared memory each block opts in to beyond 48 KB)
and the C entry points check the plan against their own. Every width
plans; widths the kernels cannot stage are padded (:func:`padded_chain`).
"""

from __future__ import annotations

import functools

import torch

from .fused_decode import round_to, token_gate_table, wmatmul
from .kernel_build import check_error, load_library
from .linalg import matmul
from .padding import needs_padding, pad8, pad_cell, pad_dim


def _step_major(tokens: torch.Tensor) -> torch.Tensor:
    """``[N, T]`` tokens -> ``[T, N]`` contiguous int32: row ``t N + r`` of
    every per-step stream is sample ``r`` at step ``t`` (one copy)."""
    n, steps = tokens.shape
    return torch.empty((steps, n), dtype=torch.int32, device=tokens.device).copy_(tokens.t())


# The chain kernels' ring (csrc/chain.cuh ChainRing), per weight type: the
# depth of a staged slice, the slots of the ring, and the hidden units per
# block the plan tries, widest first.
_CHAIN_RING = {torch.bfloat16: (128, 5, (32, 16, 8)), torch.float32: (32, 4, (8,))}
# Per weight type, the units (a slice is 4U consecutive columns) that a plan
# dealing several weights' columns out as slices tries, widest first, before
# it streams (csrc/chain.cuh SliceUnits: the rollout forward's and the beam's).
_SLICE_UNITS = {torch.bfloat16: (32, 16, 8), torch.float32: (16, 8)}
CHAIN_ROWS, CHAIN_THREADS = 64, 256  # rows per tile, threads per block
# H100 shared memory: per SM, the most one block may opt in to, and what the
# runtime reserves per block.
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024


def _chain_smem(weight_dtype: torch.dtype, backward: bool, gates: int, units: int,
                stream: bool, kp: int) -> int:
    """A block's shared memory (csrc/chain.cuh chain_smem): the stationary
    weight slice and the ring, or the streaming ring of A rows and weight
    rows."""
    depth, stages, _ = _CHAIN_RING[weight_dtype]
    elem = 2 if weight_dtype == torch.bfloat16 else 4
    pad = 16 // elem
    cols = units if backward else gates * units
    a = CHAIN_ROWS * (depth + pad)
    if stream:
        return stages * (a + (cols * (depth + pad) if backward else depth * (cols + pad))) * elem
    return ((cols * (kp + pad) if backward else kp * (cols + pad)) + stages * a) * elem


def chain_plan(n: int, hidden: int, weight_dtype: torch.dtype, sm_count: int,
               backward: bool = False, gates: int = 4) -> dict:
    """The cooperative launch of one direction of a chain with ``gates``
    gates (4: LSTM, 3: GRU), as ``csrc/chain.cuh:chain_plan`` computes it.

    The block's ``units`` (32, 16 or 8 with bf16 weights; 8 with float32)
    are the widest whose slice of ``wh`` fits shared memory beside
    the staging ring while every slice still gets a block of its own among
    the ``co_resident`` blocks the card holds at once: then each block keeps
    its slice for the whole chain (``stream`` False). Otherwise the weights
    stream through the ring with the A rows at every step (``stream``
    True), with the widest slice whose streaming ring fits. Blocks ``(x,
    group)`` over ``grid = (grid_x, row_groups)``: block ``(x, g)`` owns the
    slices ``x, x + grid_x, ...`` (units ``[s units, s units + units)``)
    and the row tiles ``g, g + row_groups, ...`` of ``rows_per_tile`` rows,
    and opts in to ``smem_bytes`` of shared memory. The grid never exceeds
    ``co_resident``; no width is refused."""
    depth, _, unit_choices = _CHAIN_RING[weight_dtype]
    k = gates * hidden if backward else hidden
    kp = -(-k // depth) * depth

    def co_resident(smem):  # one block per SM: the kernels may take every register
        if smem > SMEM_PER_BLOCK:
            return 0
        return sm_count * min(1, SMEM_PER_SM // (smem + SMEM_RESERVED))

    for units in unit_choices:
        smem = _chain_smem(weight_dtype, backward, gates, units, False, kp)
        if co_resident(smem) >= -(-hidden // units):
            stream = False
            break
    else:
        stream = True
        units = next(u for u in unit_choices
                     if _chain_smem(weight_dtype, backward, gates, u, True, kp) <= SMEM_PER_BLOCK)
        smem = _chain_smem(weight_dtype, backward, gates, units, True, kp)
    co = co_resident(smem)
    slices = -(-hidden // units)
    grid_x = min(slices, co)
    row_groups = max(1, min(-(-max(n, 1) // CHAIN_ROWS), co // max(grid_x, 1)))
    return {"rows_per_tile": CHAIN_ROWS, "units": units, "stream": stream, "slices": slices,
            "row_groups": row_groups, "grid": (grid_x, row_groups), "smem_bytes": smem,
            "co_resident": co}


def lstm_chain_plan(n: int, hidden: int, weight_dtype: torch.dtype, sm_count: int,
                    backward: bool = False) -> dict:
    """The LSTM chain's launch plan (:func:`chain_plan` with four gates)."""
    return chain_plan(n, hidden, weight_dtype, sm_count, backward, gates=4)


@functools.lru_cache(maxsize=None)
def plan_args(n: int, hidden: int, weight_dtype: torch.dtype, index: int, backward: bool,
              gates: int) -> tuple:
    """The plan's launch arguments for the card ``index`` (cached: the host
    time around a chain call is part of a training step's)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    p = chain_plan(n, hidden, weight_dtype, sms, backward, gates)
    return (p["rows_per_tile"], p["units"], int(p["stream"]), p["grid"][0], p["row_groups"],
            p["smem_bytes"])


def _bf16_scratch(weight_dtype: torch.dtype, dev: torch.device, *shape) -> torch.Tensor:
    """bf16 scratch of the chain kernels (none with float32 weights)."""
    if weight_dtype != torch.bfloat16:
        return torch.empty((0,), dtype=torch.bfloat16, device=dev)
    return torch.empty(shape, dtype=torch.bfloat16, device=dev)


def embedding_grad(dx: torch.Tensor, tok_sm: torch.Tensor, vocab: int) -> torch.Tensor:
    """The embedding table's gradient: the per-step ``dx [T N, E]`` summed
    onto the rows of their tokens. On the CPU ``index_add_`` adds each row's
    terms in the order they come. On a CUDA device it is one product,
    ``onehot(tokens)^T @ dx`` in float32 (:func:`embedding_grad_onehot`):
    ``index_add_`` adds with atomics there, so two calls differ in the last
    bits, and the sorted accumulating ``index_put_`` sums a frequent token's
    thousands of rows one after another; the product sums in a fixed order
    and makes no host sync (a CUDA graph captures it). Its price against
    ``index_add_`` is in ``chip_smoke.py``'s timing lines."""
    if dx.is_cuda:
        return embedding_grad_onehot(dx, tok_sm, vocab)
    out = torch.zeros((vocab, dx.shape[-1]), dtype=torch.float32, device=dx.device)
    return out.index_add_(0, tok_sm.reshape(-1).long(), dx)


def embedding_grad_onehot(dx: torch.Tensor, tok_sm: torch.Tensor, vocab: int) -> torch.Tensor:
    """:func:`embedding_grad` as the product ``onehot(tokens)^T @ dx`` (any
    device; the one-hot matrix is ``[T N, V]`` float32, the product in full
    float32: :func:`.linalg.matmul` turns TF32 off)."""
    tok = tok_sm.reshape(-1).long()
    onehot = (tok[:, None] == torch.arange(vocab, device=dx.device)[None, :]).to(torch.float32)
    return matmul(onehot.t(), dx.to(torch.float32))


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
    """Device, type and shape checks of a chain kernel's inputs (shared with
    :mod:`.fused_gru`; any widths, which :func:`padded_chain` pads), and the
    token range, checked on the device without a host sync: a token outside
    ``[0, V)`` fails the assertion (on the CPU at once; on a CUDA device at
    the next synchronisation, which ends the process's CUDA context)."""
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
    if tokens.numel():  # floor(token / V) is 0 exactly for a token in [0, V)
        torch._assert_async(torch.floor_divide(tokens, vocab).eq(0).all(),
                            f"{name}: tokens must lie in [0, {vocab})")


class _LstmChainKernel(torch.autograd.Function):
    """The chain through ``csrc/lstm_chain.cu``: one C call forward (one
    kernel launch beside the x-gate table), one backward (five launches,
    whatever T is). The x-gate table is rebuilt each call (the weights
    change every optimiser step)."""

    @staticmethod
    def forward(ctx, wi, wh, b, embedding, h0, c0, tokens, weight_dtype):
        n, steps = tokens.shape
        hidden = h0.shape[1]
        dev = h0.device
        emb_w = embedding.detach().to(weight_dtype).contiguous()
        w = torch.empty((wi.shape[0] + hidden, 4 * hidden), dtype=weight_dtype, device=dev)
        torch.cat([wi.detach(), wh.detach()], out=w)  # [wi; wh] cast as it is copied
        tok_sm = _step_major(tokens)
        xg = token_gate_table(emb_w, w)

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        # the tape (h, c entering every step; gates) and hs, written by the kernel
        hbuf, cbuf = f32((steps + 1) * n, hidden), f32((steps + 1) * n, hidden)
        gates, hs = f32(steps * n, 4 * hidden), f32(n, steps, hidden)
        h16 = _bf16_scratch(weight_dtype, dev, 2, n, hidden)
        lib = load_library()
        ptr = torch.Tensor.data_ptr
        with torch.cuda.device(dev):
            err = lib.icrl_lstm_chain_fwd(
                n, steps, hidden, int(weight_dtype == torch.bfloat16),
                *plan_args(n, hidden, weight_dtype, dev.index, False, 4), ptr(tok_sm), ptr(xg),
                ptr(w[embedding.shape[1]:]), ptr(b.detach().contiguous()),
                ptr(h0.detach().contiguous()), ptr(c0.detach().contiguous()), ptr(hbuf), ptr(cbuf),
                ptr(gates), ptr(hs), ptr(h16), torch.cuda.current_stream(dev).cuda_stream)
        check_error(lib, "icrl_lstm_chain_fwd", err)
        fused_lstm_chain.fwd_launches += 1
        ctx.save_for_backward(tok_sm, hbuf, cbuf, gates, emb_w, w)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        tok_sm, hbuf, cbuf, gates, emb_w, w = ctx.saved_tensors
        steps, n = tok_sm.shape
        vocab, emb_dim = emb_w.shape
        hidden = hbuf.shape[1]
        dev = hbuf.device
        dhs = dhs.to(torch.float32).contiguous()  # [N, T, H], read in place

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device=dev)

        dg, part = f32(steps * n, 4 * hidden), f32(16, 4 * hidden)
        dh, dc = f32(n, hidden), torch.zeros((n, hidden), dtype=torch.float32, device=dev)
        dw, db, dx = f32(emb_dim + hidden, 4 * hidden), f32(4 * hidden), f32(steps * n, emb_dim)
        dg16 = _bf16_scratch(w.dtype, dev, steps * n, 4 * hidden)
        h16 = _bf16_scratch(w.dtype, dev, steps * n, hidden)
        lib = load_library()
        ptr = torch.Tensor.data_ptr
        with torch.cuda.device(dev):
            err = lib.icrl_lstm_chain_bwd(
                n, steps, emb_dim, hidden, int(w.dtype == torch.bfloat16),
                *plan_args(n, hidden, w.dtype, dev.index, True, 4), ptr(tok_sm), ptr(dhs),
                ptr(hbuf), ptr(cbuf), ptr(gates), ptr(emb_w), ptr(w), ptr(dg), ptr(dg16),
                ptr(h16), ptr(dh), ptr(dc), ptr(part), ptr(dw), ptr(db), ptr(dx),
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
    _check_chain_inputs("fused_lstm_chain", lstm_params, embedding, tokens, (h0, c0), 4,
                        weight_dtype)

    def kernel(p, emb, tok, h, c):
        return _LstmChainKernel.apply(p["wi"], p["wh"], p["b"], emb, h, c, tok, weight_dtype)

    return padded_chain(kernel, lstm_params, embedding, tokens, (h0, c0), 4)


def padded_chain(chain, params: dict, embedding: torch.Tensor, tokens: torch.Tensor,
                 states: tuple, gates: int) -> torch.Tensor:
    """``chain(params, embedding, tokens, *states) -> hs [N, T, H]`` run on
    inputs padded to the kernels' widths (:mod:`.padding`): E and H to
    multiples of 8, the padded units with zero weights and zero initial
    state, which stay zero. ``hs`` is sliced back to H; the gradients reach
    the unpadded inputs through the padding, unchanged."""
    emb_dim, hidden = embedding.shape[1], states[0].shape[1]
    if not needs_padding(emb_dim, hidden):
        return chain(params, embedding, tokens, *states)
    ep, hp = pad8(emb_dim), pad8(hidden)
    hs = chain(pad_cell(params, gates, ep, hp), pad_dim(embedding, 1, ep), tokens,
               *(pad_dim(s, 1, hp) for s in states))
    return hs[..., :hidden]


fused_lstm_chain.fwd_launches = 0
fused_lstm_chain.bwd_launches = 0
