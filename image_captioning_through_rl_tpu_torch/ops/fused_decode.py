"""Greedy decode: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of the JAX ``ops/pallas_decode.py`` (``fused_greedy_decode``,
TPU kernel ``_kernel``). The kernel is ``csrc/greedy_decode.cu``; its note
says what bounds it on Hopper and what its design does about that.

Routing in :func:`fused_greedy_decode`: a CUDA tensor goes to the kernel
(or the call raises), a CPU tensor goes to :func:`greedy_decode_plain`,
and ``use_fused_kernel=False`` selects the plain version explicitly. No
path catches a kernel error and falls back.

Weights are prepared once (:func:`prepare_greedy_weights`): cast to the
working type, ``[wi; wh]`` concatenated and, on CUDA, the x-gate table
``emb @ wi`` built by :func:`token_gate_table`. A model whose widths the
kernels cannot stage (:mod:`.padding`: E, F or H not a multiple of 8, or an
odd vocabulary) is padded there once, as the TPU kernel pads its vocabulary;
the features are padded per call. None of the TPU kernel's other
workarounds carry over: no one-hot matmuls, no batch padding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import MAX_SEQ_LEN
from .kernel_build import check_error, load_library
from .linalg import matmul
from .padding import NEG, needs_padding, pad8, pad_dim, pad_gates, pad_split_rows


class GreedyWeights(NamedTuple):
    """Policy weights in the kernels' layout. ``wc``, ``emb``, ``w`` and
    ``wo`` are in the working type (bf16 or f32); biases and ``xg`` are
    f32. ``xg`` is the x-gate table ``emb @ wi``, which the kernels read
    instead of multiplying the embedding row each step; it is built on a
    CUDA device only (None on the CPU, where the plain versions run).
    ``widths`` is ``(F, E, H)`` of the model when :func:`pad_greedy_weights`
    padded it (then the shapes below are padded: F, E, H to multiples of 8,
    the head's V to an even width; the embedding keeps its V rows), else
    None."""

    wc: torch.Tensor   # [F, H]
    bc: torch.Tensor   # [H]
    emb: torch.Tensor  # [V, E]
    w: torch.Tensor    # [E + H, 4H] = [wi; wh]
    b: torch.Tensor    # [4H]
    wo: torch.Tensor   # [H, V]
    bo: torch.Tensor   # [V]
    xg: torch.Tensor | None  # [V, 4H]
    widths: tuple | None = None

    f32_fields = ("bc", "b", "bo", "xg")

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def feat_dim(self) -> int:
        """The width of the features the model takes (before padding)."""
        return self.widths[0] if self.widths else self.wc.shape[0]


def prepare_greedy_weights(params: dict, weight_dtype: torch.dtype = torch.bfloat16
                           ) -> GreedyWeights:
    """Policy parameters (JAX layout, on the target device) -> kernel weights."""
    if "lstm" not in params:
        raise ValueError("the fused decode kernels need a unidirectional policy")
    if weight_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"weight_dtype must be bfloat16 or float32, got {weight_dtype}")

    def wt(x):
        return x.to(weight_dtype).contiguous()

    def f32(x):
        return x.to(torch.float32).contiguous()

    lstm = params["lstm"]
    emb, w = wt(params["embedding"]), wt(torch.cat([lstm["wi"], lstm["wh"]], dim=0))
    weights = GreedyWeights(
        wc=wt(params["cnn2linear"]["w"]), bc=f32(params["cnn2linear"]["b"]), emb=emb, w=w,
        b=f32(lstm["b"]), wo=wt(params["head"]["w"]), bo=f32(params["head"]["b"]), xg=None)
    (feat_dim, hidden), (vocab, emb_dim) = weights.wc.shape, emb.shape
    if needs_padding(feat_dim, emb_dim, hidden, vocab=vocab):
        return pad_greedy_weights(weights)
    return weights._replace(xg=token_gate_table(emb, w) if emb.is_cuda else None)


def pad_greedy_weights(weights: GreedyWeights) -> GreedyWeights:
    """Unpadded weights padded for the kernels (:mod:`.padding`): F, E and H
    to multiples of 8, the head to an even vocabulary with a -1e30 bias on
    the padded word; the x-gate table rebuilt on CUDA. Every decode gives
    the same tokens on the padded weights (with features padded by
    :func:`pad_features`)."""
    (feat_dim, hidden), emb_dim = weights.wc.shape, weights.emb.shape[1]
    vocab = weights.wo.shape[1]
    fp, ep, hp, vp = pad8(feat_dim), pad8(emb_dim), pad8(hidden), vocab + vocab % 2
    emb = pad_dim(weights.emb, 1, ep).contiguous()
    w = pad_split_rows(pad_gates(weights.w, 4, hp), emb_dim, ep, hp).contiguous()
    return GreedyWeights(
        wc=pad_dim(pad_dim(weights.wc, 0, fp), 1, hp).contiguous(),
        bc=pad_dim(weights.bc, 0, hp).contiguous(), emb=emb, w=w,
        b=pad_gates(weights.b, 4, hp).contiguous(),
        wo=pad_dim(pad_dim(weights.wo, 0, hp), 1, vp).contiguous(),
        bo=pad_dim(weights.bo, 0, vp, NEG).contiguous(),
        xg=token_gate_table(emb, w) if emb.is_cuda else None,
        widths=(feat_dim, emb_dim, hidden))


def pad_features(weights, features: torch.Tensor) -> torch.Tensor:
    """``features [N, F]`` checked against the model's F and padded with
    zero columns to the weights' padded F (as they are, when unpadded)."""
    if features.dim() != 2 or features.shape[1] != weights.feat_dim:
        raise ValueError(f"features must be [N, {weights.feat_dim}], got "
                         f"{tuple(features.shape)}")
    return pad_dim(features, 1, weights.wc.shape[0])


def token_gate_table_plain(emb: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor | None = None) -> torch.Tensor:
    """``emb @ wi (+ bias)`` in eager torch: f32 ``[V, G]`` from ``emb [V, E]``
    and ``w`` whose first E rows are ``wi`` (``[wi; wh]`` or ``wi`` alone),
    products of working-type values, f32 sums, the bias added after them."""
    out = wmatmul(emb.to(torch.float32), w[: emb.shape[1]])
    return out if bias is None else out + bias


def check_tile_widths(dtype: torch.dtype, **widths: int) -> None:
    """The bf16 kernels stage their tensor-core operands in 16-byte chunks
    (``csrc/common.cuh``, ``gemm_tile_tc``): every reduction width must be a
    multiple of 8, and an output width read in bf16 pairs (the vocabulary, a
    gate table's columns) even. The wrappers pad (:mod:`.padding`) before
    they check, so this guards the kernels and refuses no caller."""
    if dtype != torch.bfloat16:
        return
    bad = {k: v for k, v in widths.items() if v % (2 if k in ("vocab", "columns") else 8)}
    if bad:
        raise ValueError(f"the bf16 kernels need widths that are multiples of 8 and an even "
                         f"vocabulary, got {bad}")


def _launch_token_gates(emb: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor | None) -> torch.Tensor:
    # every call of a decode, a chain or a rollout makes its tables here, and
    # the kernel takes ~11 us: the host work stays under it (device indices
    # as ints, the raw stream, the device set in C only where it differs)
    vocab, emb_dim = emb.shape
    width = w.shape[1]
    dtype, index = emb.dtype, emb.get_device()
    bf16 = dtype == torch.bfloat16
    if (w.dtype != dtype or not (bf16 or dtype == torch.float32) or w.get_device() != index
            or w.dim() != 2 or w.shape[0] < emb_dim
            or not (emb.is_contiguous() and w.is_contiguous())):
        raise ValueError("token_gate_table needs contiguous emb [V, E] and w [>= E, G] "
                         "of one type (bf16 or f32) on one device")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (width,)
                             or bias.get_device() != index or not bias.is_contiguous()):
        raise ValueError("token_gate_table's bias must be a contiguous float32 [G] tensor "
                         "on the embedding's device")
    # zero columns of emb, zero rows and columns of w: both products need E a
    # multiple of 8 and G even, and wgmma (bf16), which reads w's rows in
    # 16-byte chunks, G a multiple of 8
    if emb_dim % 8 or width % (8 if bf16 else 2):
        ep, gp = pad8(emb_dim), pad8(width) if bf16 else width + width % 2
        out = _launch_token_gates(pad_dim(emb, 1, ep).contiguous(),
                                  pad_dim(pad_dim(w[:emb_dim], 0, ep), 1, gp).contiguous(),
                                  None if bias is None else pad_dim(bias, 0, gp).contiguous())
        return out[:, :width].contiguous()
    out = torch.empty((vocab, width), dtype=torch.float32, device=emb.device)
    lib = load_library()
    err = lib.icrl_token_gates(vocab, emb_dim, width, int(bf16), emb.data_ptr(), w.data_ptr(),
                               None if bias is None else bias.data_ptr(), out.data_ptr(), index,
                               torch._C._cuda_getCurrentRawStream(index))
    check_error(lib, "icrl_token_gates", err)
    token_gate_table.launches += 1
    return out


def token_gate_table(emb: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """The x-gate table ``emb @ wi (+ bias)``, f32 ``[V, G]``: the input
    half of every gate product of a recurrent cell, one row per token
    (``w``'s first E rows are ``wi``: pass ``[wi; wh]`` or ``wi``). CUDA
    tensors run the kernel (``csrc/token_gates.cu``), CPU tensors
    :func:`token_gate_table_plain`. ``token_gate_table.launches`` counts
    kernel launches."""
    if emb.is_cuda:
        return _launch_token_gates(emb, w, bias)
    return token_gate_table_plain(emb, w, bias)


token_gate_table.launches = 0


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to f32: the TPU kernels'
    ``x.astype(wdtype)`` before a product."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def wmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 output, for ``x`` already rounded to ``w``'s type
    (f32 values) and ``w`` in the working type: products of working-type
    values, f32 sums. With bf16 weights on CUDA this is the bf16 GEMM with
    f32 output (the tensor cores, like the kernels); elsewhere an f32
    matmul of the same values."""
    if w.dtype == torch.bfloat16 and x.is_cuda:
        out = torch.mm(x.reshape(-1, x.shape[-1]).to(w.dtype), w, out_dtype=torch.float32)
        return out.reshape(x.shape[:-1] + w.shape[1:])
    return matmul(x, w.to(torch.float32))


def lstm_cell_plain(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor):
    """One LSTM cell on already-rounded ``x`` and ``h`` (f32 values),
    ``w = [wi; wh]`` in the working type: the kernels' cell, in eager
    torch. The gates add up as in the TPU kernels, ``x @ wi + h @ wh + b``."""
    e = x.shape[-1]
    gates = wmatmul(x, w[:e]) + wmatmul(h, w[e:]) + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def greedy_decode_plain(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, max_len: int = MAX_SEQ_LEN,
                        margins: bool = False):
    """The greedy kernel's function in eager torch.

    Rounds where the TPU kernel (``pallas_decode.py:_kernel``) does: the
    ``h0`` product takes the f32 features (``pallas_decode.py:83``); the
    gathered embedding row ``x`` and ``h`` are in the weight type for every
    gate product, and ``h`` for the head; products accumulate in f32 and
    the gate math is f32. With f32 weights it is the carried greedy decode.

    Returns ``[N, max_len]`` int32 tokens; with ``margins=True`` also the
    top-2 logit gap of every step, ``[N, max_len - 1]`` — how close each
    argmax came to a tie, which a comparison with the kernel needs.
    """
    features = pad_features(weights, features)
    wd = weights.dtype
    emb = weights.emb.to(torch.float32)
    h = matmul(features.to(torch.float32), weights.wc.to(torch.float32)) + weights.bc
    c = torch.zeros_like(h)
    tok = start_tokens.long()
    toks, gaps = [tok], []
    for _ in range(max_len - 1):
        h, c = lstm_cell_plain(weights.w, weights.b, emb[tok], round_to(h, wd), c)
        logits = wmatmul(round_to(h, wd), weights.wo) + weights.bo
        tok = torch.argmax(logits, dim=-1)  # first maximal index on ties
        toks.append(tok)
        if margins:
            top2 = torch.topk(logits, 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
    out = torch.stack(toks, dim=1).to(torch.int32)
    return (out, torch.stack(gaps, dim=1)) if margins else out


def check_weights(weights, device: torch.device) -> None:
    """Every tensor of a weights tuple present and contiguous on ``device``,
    its ``f32_fields`` f32 and the rest in the tuple's working type."""
    for name, t in weights._asdict().items():
        if name == "widths":
            continue
        want = torch.float32 if name in weights.f32_fields else weights.dtype
        if t is None or t.device != device or not t.is_contiguous() or t.dtype != want:
            raise ValueError(f"weight {name!r} must be a contiguous {want} tensor on {device}")


def assert_tokens(msg: str, vocab: int, *tokens: torch.Tensor) -> None:
    """The token range, checked on the device without a host sync, as the
    chains check theirs (:func:`.fused_lstm._check_chain_inputs`): a token
    outside ``[0, V)`` fails the assertion (on the CPU at once; on a CUDA
    device at the next synchronisation, which ends the process's CUDA
    context). No sync, so a decode can be captured in a CUDA graph."""
    for t in tokens:
        if t.numel():  # floor(token / V) is 0 exactly for a token in [0, V)
            torch._assert_async(torch.floor_divide(t, vocab).eq(0).all(), msg)


def check_kernel_inputs(features: torch.Tensor, start_tokens: torch.Tensor,
                        vocab: int | None) -> None:
    """Device, type and shape checks of a kernel wrapper's inputs, and the
    start tokens' range by :func:`assert_tokens` (``vocab`` None: the C
    entry asserts the range itself, as the beam's does, in one launch where
    this takes four)."""
    dev = features.device
    if features.dtype != torch.float32 or features.dim() != 2 or not features.is_contiguous():
        raise ValueError("features must be a contiguous float32 [N, F] tensor")
    if features.data_ptr() % 16:
        raise ValueError("features must start on a 16-byte boundary (the kernels read them "
                         "in 16-byte chunks)")
    n = features.shape[0]
    if (start_tokens.dtype != torch.int32 or start_tokens.shape != (n,)
            or not start_tokens.is_contiguous() or start_tokens.device != dev):
        raise ValueError("start_tokens must be a contiguous int32 [N] tensor on the "
                         "features' device")
    if vocab is not None:
        assert_tokens(f"start tokens must lie in [0, {vocab})", vocab, start_tokens)


def check_decode_inputs(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, max_len: int) -> None:
    """The checks of a decode kernel's call (greedy, sampling): inputs
    (``features`` already padded by :func:`pad_features`), weights, tile
    widths and ``max_len``."""
    vocab, emb_dim = weights.emb.shape
    feat_dim, hidden = weights.wc.shape
    check_kernel_inputs(features, start_tokens, vocab)
    check_weights(weights, features.device)
    check_tile_widths(weights.dtype, feat_dim=feat_dim, emb_dim=emb_dim, hidden=hidden,
                      vocab=weights.wo.shape[1])
    if max_len < 2:
        raise ValueError("max_len must be at least 2")


def _launch_greedy(weights: GreedyWeights, features: torch.Tensor,
                   start_tokens: torch.Tensor, max_len: int) -> torch.Tensor:
    features = pad_features(weights, features)
    check_decode_inputs(weights, features, start_tokens, max_len)
    emb_dim, (feat_dim, hidden) = weights.emb.shape[1], weights.wc.shape
    vocab = weights.wo.shape[1]  # the head's width: the kernel never picks a padded word
    n = features.shape[0]
    dev = features.device
    out = torch.empty((n, max_len), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    ptr = torch.Tensor.data_ptr
    with torch.cuda.device(dev):
        bf16 = int(weights.dtype == torch.bfloat16)
        ws = torch.empty(lib.icrl_greedy_workspace_floats(n, hidden, vocab, bf16),
                         dtype=torch.float32, device=dev)
        err = lib.icrl_greedy_decode(
            n, feat_dim, emb_dim, hidden, vocab, max_len, bf16,
            ptr(features), ptr(start_tokens), ptr(weights.wc), ptr(weights.bc),
            ptr(weights.xg), ptr(weights.w), ptr(weights.b), ptr(weights.wo),
            ptr(weights.bo), ptr(out), ptr(ws), torch.cuda.current_stream(dev).cuda_stream)
    check_error(lib, "icrl_greedy_decode", err)
    fused_greedy_decode.launches += 1
    return out


def fused_greedy_decode(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, max_len: int = MAX_SEQ_LEN,
                        use_fused_kernel: bool | None = None) -> torch.Tensor:
    """Greedy decode: ``features [N, F]`` f32, ``start_tokens [N]`` int32 ->
    ``[N, max_len]`` int32 tokens on the features' device.

    CUDA tensors run the kernel (``csrc/greedy_decode.cu``); CPU tensors
    run :func:`greedy_decode_plain`. ``use_fused_kernel=False`` forces the
    plain version; ``True`` on CPU tensors raises.
    ``fused_greedy_decode.launches`` counts kernel launches.
    """
    if use_fused_kernel is False:
        return greedy_decode_plain(weights, features, start_tokens, max_len)
    if features.is_cuda:
        return _launch_greedy(weights, features, start_tokens, max_len)
    if use_fused_kernel:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the greedy kernel "
                           "runs only on a CUDA device")
    return greedy_decode_plain(weights, features, start_tokens, max_len)


fused_greedy_decode.launches = 0
