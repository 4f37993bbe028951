"""Greedy decode: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of the JAX ``ops/pallas_decode.py`` (``fused_greedy_decode``,
TPU kernel ``_kernel``). The kernel is ``csrc/decode.cu``, one persistent
cooperative launch for the whole decode, shared with the sampling decode
(:mod:`.fused_sample`); its note says what bounds it on Hopper and what its
design does about that. :func:`decode_plan` mirrors its launch plan, and
:func:`merge_argmax_partials` is a plain model of how it merges per-slice
argmaxes, for the tests.

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

import functools
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
    None. ``head`` (CUDA only, like ``xg``) is ``wo`` with its rows padded to
    a multiple of 8 columns, which the decode and beam kernels stage in
    16-byte chunks (``wo`` itself where its width is one)."""

    wc: torch.Tensor   # [F, H]
    bc: torch.Tensor   # [H]
    emb: torch.Tensor  # [V, E]
    w: torch.Tensor    # [E + H, 4H] = [wi; wh]
    b: torch.Tensor    # [4H]
    wo: torch.Tensor   # [H, V]
    bo: torch.Tensor   # [V]
    xg: torch.Tensor | None  # [V, 4H]
    widths: tuple | None = None
    head: torch.Tensor | None = None  # [H, pad8(V)]

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
    return _with_tables(weights)


def _with_tables(weights: GreedyWeights) -> GreedyWeights:
    """The weights with what the kernels read beside them, on CUDA: the
    x-gate table and the head padded to a multiple of 8 columns."""
    if not weights.emb.is_cuda:
        return weights
    wo = weights.wo
    head = wo if wo.shape[1] % 8 == 0 else pad_dim(wo, 1, pad8(wo.shape[1])).contiguous()
    return weights._replace(xg=token_gate_table(weights.emb, weights.w), head=head)


def pad_greedy_weights(weights: GreedyWeights) -> GreedyWeights:
    """Unpadded weights padded for the kernels (:mod:`.padding`): F, E and H
    to multiples of 8, the head to an even vocabulary with a -1e30 bias on
    the padded word; the x-gate table and the padded head rebuilt on CUDA.
    Every decode gives
    the same tokens on the padded weights (with features padded by
    :func:`pad_features`)."""
    (feat_dim, hidden), emb_dim = weights.wc.shape, weights.emb.shape[1]
    vocab = weights.wo.shape[1]
    fp, ep, hp, vp = pad8(feat_dim), pad8(emb_dim), pad8(hidden), vocab + vocab % 2
    emb = pad_dim(weights.emb, 1, ep).contiguous()
    w = pad_split_rows(pad_gates(weights.w, 4, hp), emb_dim, ep, hp).contiguous()
    return _with_tables(GreedyWeights(
        wc=pad_dim(pad_dim(weights.wc, 0, fp), 1, hp).contiguous(),
        bc=pad_dim(weights.bc, 0, hp).contiguous(), emb=emb, w=w,
        b=pad_gates(weights.b, 4, hp).contiguous(),
        wo=pad_dim(pad_dim(weights.wo, 0, hp), 1, vp).contiguous(),
        bo=pad_dim(weights.bo, 0, vp, NEG).contiguous(), xg=None,
        widths=(feat_dim, emb_dim, hidden)))


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


def check_kernel_inputs(features: torch.Tensor, start_tokens: torch.Tensor) -> None:
    """Device, type and shape checks of a decode kernel wrapper's inputs. The
    start tokens' range is asserted on the device by the C entry, in one
    small launch, without a host sync."""
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


def check_head(head: torch.Tensor | None, wo: torch.Tensor) -> None:
    """``head`` must be ``wo`` with its rows padded to a multiple of 8
    columns, as :func:`prepare_greedy_weights` makes it on CUDA."""
    width = wo.shape[1]
    if (head is None or head.dtype != wo.dtype or head.device != wo.device
            or not head.is_contiguous() or head.shape[0] != wo.shape[0] or head.shape[1] % 8
            or not width <= head.shape[1] < width + 8):
        raise ValueError("the head must be wo with rows padded to a multiple of 8 columns, as "
                         "prepare_greedy_weights makes it")


def check_decode_inputs(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, max_len: int) -> None:
    """The checks of a decode kernel's call (greedy, sampling): inputs
    (``features`` already padded by :func:`pad_features`), weights, tile
    widths and ``max_len``."""
    vocab, emb_dim = weights.emb.shape
    feat_dim, hidden = weights.wc.shape
    check_kernel_inputs(features, start_tokens)
    check_weights(weights, features.device)
    check_tile_widths(weights.dtype, feat_dim=feat_dim, emb_dim=emb_dim, hidden=hidden,
                      vocab=weights.wo.shape[1])
    check_head(weights.head, weights.wo)
    if max_len < 2:
        raise ValueError("max_len must be at least 2")


def check_clock(clock: torch.Tensor | None, slots: int, features: torch.Tensor,
                use_fused_kernel) -> None:
    """A kernel's optional phase clock: ``slots`` contiguous int64 zeros on
    the features' CUDA device, for a call that runs the kernel."""
    if clock is not None and (clock.dtype != torch.int64 or not clock.is_cuda
                              or clock.device != features.device or not clock.is_contiguous()
                              or clock.numel() < slots or use_fused_kernel is False):
        raise ValueError(f"clock must be {slots} contiguous int64 zeros on the features' CUDA "
                         f"device, for the kernel")


# The decode kernel's picks (csrc/decode.cu DecodePick): greedy's argmax, the
# Gumbel-max of an unfiltered sample, the filtered sample. Per pick, the
# relative time of one row tile of a head slice and of a cell slice
# (DECODE_TILE_COST, measured by the kernel's tile counters), which the plan
# balances.
PICK_ARGMAX, PICK_GUMBEL, PICK_FILTER = 0, 1, 2
DECODE_TILE_COST = ((9, 8), (5, 2), (3, 2))


def decode_columns(hidden: int, vocab: int) -> tuple:
    """The columns of each product of a decode step, in slice order: the
    head's V, the cell's recurrent 4H."""
    return (vocab, 4 * hidden)


def decode_plan(n: int, feat_dim: int, hidden: int, vocab: int, pick: int,
                weight_dtype: torch.dtype, sm_count: int) -> dict:
    """The decode kernel's cooperative launch, as ``csrc/decode.cu:
    decode_plan`` computes it.

    The columns of the head and the cell's ``wh`` (:func:`decode_columns`)
    are cut, in that order, into slices of ``columns = 4 units`` consecutive
    columns: ``units`` is the widest (bf16 32, 16, 8; float32 16, 8) whose
    slice of ``max(H, F)`` rows fits shared memory beside the chains' staging
    ring while every slice gets a block of its own among the ``co_resident``
    blocks (one per SM); each block then keeps its slice for the whole
    decode (``stream`` False). The blocks left over replicate the slices as
    row groups over the ``tiles`` row tiles of the N rows: ``h_groups``
    copies of each head slice and ``a_groups`` of each cell slice, the counts
    that make ``max(ceil(tiles / h_groups) w_h, ceil(tiles / a_groups) w_a)``
    least (tile costs ``DECODE_TILE_COST[pick]``), then the grid largest,
    then the fewest head copies. Block ``b < sh h_groups`` holds head slice
    ``b % sh`` and takes its tiles ``b // sh + k h_groups``; the cell
    slices' blocks follow likewise. Where no width fits, the weights stream
    through the ring with the rows every step (``stream`` True, the chains'
    streaming slice width, groups 0): every block of ``grid = co_resident``
    takes the (slice, tile) items ``b, b + grid, ...``. ``slice_table``
    lists each slice as ``(product, first column, columns)``."""
    from .fused_lstm import (_CHAIN_RING, _SLICE_UNITS, CHAIN_ROWS, SMEM_PER_BLOCK, SMEM_PER_SM,
                             SMEM_RESERVED, _chain_smem)

    kc = _CHAIN_RING[weight_dtype][0]
    kp = -(-max(hidden, feat_dim) // kc) * kc
    cols = decode_columns(hidden, vocab)

    def co_resident(smem):  # one block per SM
        if smem > SMEM_PER_BLOCK:
            return 0
        return sm_count * min(1, SMEM_PER_SM // (smem + SMEM_RESERVED))

    tiles = -(-max(n, 1) // CHAIN_ROWS)
    for units in _SLICE_UNITS[weight_dtype]:
        smem = _chain_smem(weight_dtype, False, 4, units, False, kp)
        if co_resident(smem) >= sum(-(-c // (4 * units)) for c in cols):
            stream = False
            break
    else:
        stream = True
        units = next(u for u in _CHAIN_RING[weight_dtype][2]
                     if _chain_smem(weight_dtype, False, 4, u, True, kp) <= SMEM_PER_BLOCK)
        smem = _chain_smem(weight_dtype, False, 4, units, True, kp)
    co = co_resident(smem)
    nc = 4 * units
    sh, sp = (-(-c // nc) for c in cols)
    if stream:
        h_groups = a_groups = 0
        grid = co
    else:
        w_h, w_a = DECODE_TILE_COST[pick]
        best = None
        for gh in range(1, tiles + 1):
            if sh * gh + sp > co:
                break
            for gp in range(1, tiles + 1):
                if sh * gh + sp * gp > co:
                    break
                key = (max(-(-tiles // gh) * w_h, -(-tiles // gp) * w_a), -(sh * gh + sp * gp))
                if best is None or key < best[0]:
                    best = (key, gh, gp)
        _, h_groups, a_groups = best
        grid = sh * h_groups + sp * a_groups
    table = [(m, c0, min(nc, c - c0)) for m, c in enumerate(cols) for c0 in range(0, c, nc)]
    return {"rows_per_tile": CHAIN_ROWS, "units": units, "columns": nc, "stream": stream,
            "head_slices": sh, "slices": sh + sp, "slice_table": table, "tiles": tiles,
            "h_groups": h_groups, "a_groups": a_groups, "grid": grid, "smem_bytes": smem,
            "co_resident": co}


@functools.lru_cache(maxsize=None)
def _decode_plan_args(n: int, feat_dim: int, hidden: int, vocab: int, pick: int,
                      weight_dtype: torch.dtype, index: int) -> tuple:
    """The plan's launch arguments for the card ``index`` (cached)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    p = decode_plan(n, feat_dim, hidden, vocab, pick, weight_dtype, sms)
    return (p["rows_per_tile"], p["units"], int(p["stream"]), p["grid"], p["h_groups"],
            p["a_groups"], p["smem_bytes"])


def merge_argmax_partials(logits: torch.Tensor, columns: int) -> torch.Tensor:
    """A plain model of the kernel's argmax pick (for tests): ``logits
    [R, V]`` cut into slices of ``columns`` columns as the plan cuts the
    head; each slice keeps per row its largest value and the first column
    holding it; the slices' pairs merge under the same order (the larger
    value, the lower column among equal ones) -> ``[R]`` columns."""
    vals, cols = [], []
    for c0 in range(0, logits.shape[1], columns):
        lg = logits[:, c0:c0 + columns]
        i = torch.argmax(lg, dim=1)  # the first maximal index
        vals.append(lg.gather(1, i[:, None])[:, 0])
        cols.append(i + c0)
    vals, cols = torch.stack(vals, dim=1), torch.stack(cols, dim=1)
    top = vals.max(dim=1, keepdim=True).values
    return torch.where(vals == top, cols, logits.shape[1]).min(dim=1).values


def decode_clock_slots(max_len: int) -> int:
    """The length of the decode kernel's phase profile (``clock`` of
    :func:`fused_greedy_decode` and :func:`.fused_sample.fused_sample_decode`)
    for ``max_len`` columns: the phases' marks, then phase A's tile counters."""
    return 6 + 4 * (max_len - 1)


def launch_decode(weights: GreedyWeights, features: torch.Tensor, start_tokens: torch.Tensor,
                  max_len: int, pick: int, temperature: float = 1.0, top_k: int = 0,
                  top_p=None, key_words: tuple = (0, 0),
                  clock: torch.Tensor | None = None) -> torch.Tensor:
    """One call of the decode kernel (``csrc/decode.cu``) for greedy
    (``PICK_ARGMAX``) or a sample (``PICK_GUMBEL``; ``PICK_FILTER`` with
    ``top_k`` > 0 and / or ``top_p`` given), the host key's two words
    ``key_words``, on the features' CUDA device: ``[N, max_len]`` int32. The
    wrappers' shared launch; it counts nothing."""
    features = pad_features(weights, features)
    check_decode_inputs(weights, features, start_tokens, max_len)
    vocab, emb_dim = weights.emb.shape  # the picks never reach a padded head's extra word
    feat_dim, hidden = weights.wc.shape
    n = features.shape[0]
    index = features.get_device()
    out = torch.empty((n, max_len), dtype=torch.int32, device=features.device)
    if n == 0:
        return out
    lib = load_library()
    bf16 = int(weights.dtype == torch.bfloat16)
    ws = torch.empty(lib.icrl_decode_workspace_floats(n, feat_dim, hidden, vocab, bf16, pick),
                     dtype=torch.float32, device=features.device)
    ptr = torch.Tensor.data_ptr
    err = lib.icrl_decode(
        n, feat_dim, emb_dim, hidden, vocab, weights.head.shape[1], vocab, max_len, bf16, pick,
        int(top_k), int(top_p is not None), float(temperature),
        1.0 if top_p is None else float(top_p), *key_words,
        *_decode_plan_args(n, feat_dim, hidden, vocab, pick, weights.dtype, index),
        ptr(features), ptr(start_tokens), ptr(weights.wc), ptr(weights.bc), ptr(weights.xg),
        ptr(weights.w), ptr(weights.b), ptr(weights.head), ptr(weights.bo), ptr(out), ptr(ws),
        None if clock is None else ptr(clock), index, torch._C._cuda_getCurrentRawStream(index))
    check_error(lib, "icrl_decode", err)
    return out


def fused_greedy_decode(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, max_len: int = MAX_SEQ_LEN,
                        use_fused_kernel: bool | None = None,
                        clock: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy decode: ``features [N, F]`` f32, ``start_tokens [N]`` int32 ->
    ``[N, max_len]`` int32 tokens on the features' device.

    CUDA tensors run the kernel (``csrc/decode.cu``, one launch for all
    steps beside one that asserts the start tokens' range); CPU tensors run
    :func:`greedy_decode_plain`. ``use_fused_kernel=False`` forces the plain
    version; ``True`` on CPU tensors raises.
    ``fused_greedy_decode.launches`` counts kernel calls.

    ``clock``, for a profile of the kernel: int64 zeros of
    :func:`decode_clock_slots` on the card, which the launch fills with the
    nanoseconds at which its last block passed each mark: 0 the start, 1
    the set-up done (h0 and the first cell), then for step ``t`` ``2 + 4t``
    phase A entered, ``+ 1`` done, ``+ 2`` phase B entered, ``+ 3`` done;
    after them phase A's head tiles' summed ``clock64`` cycles and their
    count, then the cell tiles' (what ``DECODE_TILE_COST`` balances).
    """
    check_clock(clock, decode_clock_slots(max_len), features, use_fused_kernel)
    if use_fused_kernel is False:
        return greedy_decode_plain(weights, features, start_tokens, max_len)
    if features.is_cuda:
        out = launch_decode(weights, features, start_tokens, max_len, PICK_ARGMAX, clock=clock)
        fused_greedy_decode.launches += 1
        return out
    if use_fused_kernel:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the greedy kernel "
                           "runs only on a CUDA device")
    return greedy_decode_plain(weights, features, start_tokens, max_len)


fused_greedy_decode.launches = 0
