"""Sampled decode: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of the JAX ``ops/pallas_sample.py`` (``fused_sample_decode``,
TPU kernel ``_kernel``). The kernel is ``csrc/sample_decode.cu``; its note
says what bounds it on Hopper and what its design does about that. It
reads the greedy decode's weights (:class:`.fused_decode.GreedyWeights`,
x-gate table included): there is no second copy of them.

Each step draws ``argmax(filter(logits / t) + gumbel)``, which is
``jax.random.categorical`` under the step's subkey
(:func:`.prng.sample_step_keys`). The filters work without a sort, as the
TPU kernel's do: :func:`monotone_keys` maps floats to order-preserving
int32 keys, :func:`keyspace_threshold` bisects that key space for the
smallest key whose strict tail weighs less than a budget, and
:func:`filter_scaled_logits` keeps everything at or above it (top-k first,
then the nucleus over the renormalised survivors), masking the rest to
``-1e30``. The keep sets equal :func:`..decode.sample.filter_logits`'s.

Routing in :func:`fused_sample_decode` is that of
:func:`.fused_decode.fused_greedy_decode`: CUDA tensors run the kernel (or
the call raises), CPU tensors run :func:`sample_decode_plain`,
``use_fused_kernel=False`` selects the plain version and ``True`` on CPU
tensors raises. The noise counters are uint32 ``row * V + col``, so a
batch needs ``rows * V < 2**32`` (:func:`fused_rows_ok`); a larger one
raises on every route.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import MAX_SEQ_LEN
from . import prng
from .fused_decode import (
    GreedyWeights,
    check_decode_inputs,
    lstm_cell_plain,
    round_to,
    wmatmul,
)
from .kernel_build import check_error, load_library
from .linalg import matmul

MAX_VOCAB = 1024  # the kernel's bound: one warp holds a row (csrc/sample_decode.cu PER_LANE)
_NEG = -1e30  # a filtered-out logit, as in the TPU kernels


def fused_rows_ok(rows: int, vocab: int) -> bool:
    """Whether ``rows`` rows fit the noise's uint32 counters ``row * V +
    col``: ``rows * vocab < 2**32`` (about 4.3 M rows at COCO's 1004 words)."""
    return max(int(rows), 1) * vocab < 2**32


def check_counter_space(rows: int, vocab: int) -> None:
    if not fused_rows_ok(rows, vocab):
        raise ValueError(f"sampling {rows} rows x {vocab} vocab exceeds the uint32 threefry "
                         f"counter space (rows * vocab must stay < 2**32): split the batch")


def monotone_keys(x: torch.Tensor) -> torch.Tensor:
    """Total-order-preserving float32 -> int32 map: ``a < b`` iff
    ``key(a) < key(b)``, with ``-0.0`` made ``+0.0`` by the ``+ 0.0``.
    Non-negative floats keep their bits; negative ones flip their low 31."""
    i = (x + 0.0).view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def keyspace_threshold(keys: torch.Tensor, w: torch.Tensor, budget: torch.Tensor
                       ) -> torch.Tensor:
    """Per row, the smallest int32 ``j`` with ``sum(w * (keys > j)) < budget``
    (``keys [N, V]`` int32, ``w [N, V]`` float32, ``budget`` broadcastable to
    ``[N, 1]``), by 32 bisection steps from ``rowmin - 1`` and ``rowmax``;
    converged rows stall. In int64, where ``(lo >> 1) + (hi >> 1) + (lo & hi
    & 1)`` is the TPU kernel's overflow-free ``floor((lo + hi) / 2)``.
    Returns ``[N, 1]`` int32; ``keys >= j`` is the keep set."""
    keys = keys.to(torch.int64)
    lo = keys.amin(dim=-1, keepdim=True) - 1
    hi = keys.amax(dim=-1, keepdim=True)
    for _ in range(32):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        mass = torch.where(keys > mid, w, 0.0).sum(dim=-1, keepdim=True)
        below = mass < budget
        lo = torch.where(below, lo, mid)
        hi = torch.where(below, mid, hi)
    return hi.to(torch.int32)


def filter_scaled_logits(scaled: torch.Tensor, k: int, p, use_top_k: bool, use_top_p: bool,
                         margins: bool = False):
    """Temperature-scaled logits ``[N, V]`` masked to the top-k / nucleus
    keep set (the rest ``-1e30``) by :func:`keyspace_threshold`: top-k first
    (budget ``k``), then the nucleus over the survivors (weights
    ``exp(x - rowmax)``, budget ``p * z``).

    With ``margins=True`` also returns, per row, how near the filters came
    to another keep set (``+inf`` with no filter on): the gap between the
    k-th and (k+1)-th scaled logits; for the nucleus, the gap between the
    smallest kept and the largest dropped survivor of top-k (two values that
    swap places swap the boundary token), and the distance of ``p * z`` from
    the mass strictly above the boundary value and from the mass at or above
    it, over ``z``."""
    margin = torch.full(scaled.shape[:-1], float("inf"), device=scaled.device)
    if use_top_k or use_top_p:
        f32 = dict(dtype=torch.float32, device=scaled.device)
        keys = monotone_keys(scaled)
        if use_top_k:
            thr = keyspace_threshold(keys, torch.ones_like(scaled), torch.tensor(float(k), **f32))
            if margins:
                top = torch.topk(scaled, k + 1, dim=-1).values
                margin = torch.minimum(margin, top[:, k - 1] - top[:, k])
            scaled = torch.where(keys >= thr, scaled, _NEG)
            keys = monotone_keys(scaled)
        if use_top_p:
            e = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))  # masked entries: 0
            z = e.sum(dim=-1, keepdim=True)
            budget = torch.tensor(float(p), **f32) * z
            thr = keyspace_threshold(keys, e, budget)
            kept = keys >= thr
            if margins:
                above = torch.where(keys > thr, e, 0.0).sum(dim=-1, keepdim=True)
                at = torch.where(kept, e, 0.0).sum(dim=-1, keepdim=True)
                dropped = ~kept & (scaled > _NEG)
                value_gap = (torch.where(kept, scaled, torch.inf).amin(dim=-1)
                             - torch.where(dropped, scaled, -torch.inf).amax(dim=-1))
                mass_gap = (torch.minimum(budget - above, at - budget) / z)[:, 0]
                margin = torch.minimum(margin, torch.minimum(value_gap, mass_gap))
            scaled = torch.where(kept, scaled, _NEG)
    return (scaled, margin) if margins else scaled


def _filters(vocab: int, top_k, top_p) -> tuple[int, bool, bool]:
    """The JAX function's switches: top-k when ``0 < k < V``, the nucleus
    when ``top_p`` is given."""
    k = int(top_k)
    use_top_k = 0 < k < vocab
    return (k if use_top_k else 0), use_top_k, top_p is not None


def sample_decode_plain(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, key, max_len: int = MAX_SEQ_LEN,
                        temperature=1.0, top_k: int = 0, top_p=None, margins: bool = False):
    """The sampling kernel's function in eager torch.

    The cell and head round where the greedy kernel's plain version does
    (:func:`.fused_decode.greedy_decode_plain`); the logits are divided by
    the float32 temperature (not multiplied by ``1/t``, which rounds
    otherwise), filtered by :func:`filter_scaled_logits` and drawn with
    Gumbel noise from :func:`.prng.gumbel_noise_plain` (not the noise
    kernel), under the subkeys :func:`.prng.sample_step_keys` makes from the
    host key ``key``. With float32 weights it is the JAX package's sampling
    decode, token for token.

    Returns ``[N, max_len]`` int32 tokens; with ``margins=True`` also, per
    step, the smallest distance to a tie ``[N, max_len - 1]``: the gap
    between the two largest noisy filtered logits and the filter margins of
    :func:`filter_scaled_logits`.
    """
    vocab = weights.emb.shape[0]
    k, use_top_k, use_top_p = _filters(vocab, top_k, top_p)
    dev, wd = features.device, weights.dtype
    n = features.shape[0]
    emb = weights.emb.to(torch.float32)
    t = torch.tensor(float(temperature), dtype=torch.float32, device=dev)
    h = matmul(features.to(torch.float32), weights.wc.to(torch.float32)) + weights.bc
    c = torch.zeros_like(h)
    tok = start_tokens.long()
    toks, gaps = [tok], []
    for sub in prng.sample_step_keys(key, max_len - 1):
        h, c = lstm_cell_plain(weights.w, weights.b, emb[tok], round_to(h, wd), c)
        logits = wmatmul(round_to(h, wd), weights.wo) + weights.bo
        scaled = filter_scaled_logits(logits / t, k, top_p, use_top_k, use_top_p, margins)
        if margins:
            scaled, margin = scaled
        noisy = scaled + prng.gumbel_noise_plain(sub[None], (n, vocab), dev)[0]
        tok = torch.argmax(noisy, dim=-1)  # first maximal index on ties
        toks.append(tok)
        if margins:
            top2 = torch.topk(noisy, min(2, vocab), dim=-1).values
            gaps.append(torch.minimum(margin, top2[:, 0] - top2[:, -1]))
    out = torch.stack(toks, dim=1).to(torch.int32)
    return (out, torch.stack(gaps, dim=1)) if margins else out


def _launch_sample(weights: GreedyWeights, features: torch.Tensor, start_tokens: torch.Tensor,
                   key, max_len: int, temperature: float, top_k, top_p) -> torch.Tensor:
    # the host work first: the input checks wait for the device (token range)
    keys = np.ascontiguousarray(prng.sample_step_keys(key, max_len - 1))
    check_decode_inputs(weights, features, start_tokens, max_len)
    vocab, emb_dim = weights.emb.shape
    feat_dim, hidden = weights.wc.shape
    if vocab > MAX_VOCAB:
        raise ValueError(f"the sampling kernel takes a vocabulary of at most {MAX_VOCAB} "
                         f"words, got {vocab}")
    k, use_top_k, use_top_p = _filters(vocab, top_k, top_p)
    n = features.shape[0]
    dev = features.device
    out = torch.empty((n, max_len), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load_library()
    ptr = torch.Tensor.data_ptr
    with torch.cuda.device(dev):
        bf16 = int(weights.dtype == torch.bfloat16)
        # the greedy decode's workspace: h, c and the logits
        ws = torch.empty(lib.icrl_greedy_workspace_floats(n, hidden, vocab, bf16),
                         dtype=torch.float32, device=dev)
        err = lib.icrl_sample_decode(
            n, feat_dim, emb_dim, hidden, vocab, max_len, bf16, int(use_top_k), int(use_top_p),
            k, float(temperature), float(top_p) if use_top_p else 1.0,
            keys.ctypes.data_as(ctypes.c_void_p), ptr(features), ptr(start_tokens),
            ptr(weights.wc), ptr(weights.bc), ptr(weights.xg), ptr(weights.w), ptr(weights.b),
            ptr(weights.wo), ptr(weights.bo), ptr(out), ptr(ws),
            torch.cuda.current_stream(dev).cuda_stream)
    check_error(lib, "icrl_sample_decode", err)
    fused_sample_decode.launches += 1
    return out


def fused_sample_decode(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, key, max_len: int = MAX_SEQ_LEN,
                        temperature=1.0, top_k: int = 0, top_p=None,
                        use_fused_kernel: bool | None = None) -> torch.Tensor:
    """Sampled decode: ``features [N, F]`` f32, ``start_tokens [N]`` int32
    and the host key ``key`` (uint32 ``[2]``, :func:`.prng.PRNGKey`) ->
    ``[N, max_len]`` int32 tokens on the features' device. ``temperature``
    must be positive; top-k runs when ``0 < top_k < V``, the nucleus when
    ``top_p`` is given.

    CUDA tensors run the kernel (``csrc/sample_decode.cu``); CPU tensors
    run :func:`sample_decode_plain`. ``use_fused_kernel=False`` forces the
    plain version; ``True`` on CPU tensors raises. A batch with ``N * V >=
    2**32`` raises on every route. ``fused_sample_decode.launches`` counts
    kernel launches.
    """
    check_counter_space(features.shape[0], weights.emb.shape[0])
    if not float(temperature) > 0:
        raise ValueError(f"temperature must be positive, got {temperature} (0 is greedy)")
    args = (weights, features, start_tokens, key, max_len, temperature, top_k, top_p)
    if use_fused_kernel is False:
        return sample_decode_plain(*args)
    if features.is_cuda:
        return _launch_sample(*args)
    if use_fused_kernel:
        raise RuntimeError("use_fused_kernel=True needs CUDA tensors: the sampling kernel "
                           "runs only on a CUDA device")
    return sample_decode_plain(*args)


fused_sample_decode.launches = 0
