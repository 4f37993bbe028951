"""Sampled decode: the hand-written CUDA kernel and its plain PyTorch version.

Counterpart of the JAX ``ops/pallas_sample.py`` (``fused_sample_decode``,
TPU kernel ``_kernel``). The kernel is the greedy decode's
``csrc/decode.cu`` (one persistent cooperative launch for all steps) with a
sampling pick; its note says what bounds it on Hopper and what its design
does about that. It reads the greedy decode's weights
(:class:`.fused_decode.GreedyWeights`, x-gate table and padded head
included): there is no second copy of them.

Each step draws ``argmax(filter(logits / t) + gumbel)``, which is
``jax.random.categorical`` under the step's subkey
(:func:`.prng.sample_step_keys`). The filters work without a sort, as the
TPU kernel's do: :func:`monotone_keys` maps floats to order-preserving
int32 keys, :func:`keyspace_threshold` bisects that key space for the
smallest key whose strict tail weighs less than a budget, and
:func:`filter_scaled_logits` keeps everything at or above it (top-k first,
then the nucleus over the renormalised survivors), masking the rest to
``-1e30``. The keep sets equal :func:`..decode.sample.filter_logits`'s.
The kernel reaches the same keep sets another way (a radix select for the
k-th largest key, the nucleus over top-k's survivors, noise hashed only for
the kept columns); :func:`kth_largest_keys`, :func:`kernel_keep_sets` and
:func:`survivor_gumbel_pick` are plain models of those steps, for the
tests, and :func:`launch_step_keys` of the subkeys it carries.

Routing in :func:`fused_sample_decode` is that of
:func:`.fused_decode.fused_greedy_decode`: CUDA tensors run the kernel (or
the call raises), CPU tensors run :func:`sample_decode_plain`,
``use_fused_kernel=False`` selects the plain version and ``True`` on CPU
tensors raises. The noise counters are uint32 ``(row0 + row) * V + col``,
where ``row0`` is the batch's first row in a global batch that a rank or a
mesh entry decodes a slice of (:mod:`..parallel.serve`; 0 otherwise), so a
batch needs ``(row0 + rows) * V < 2**32`` (:func:`fused_rows_ok`); a larger
one raises on every route. V is the vocabulary's own width even where the head
is padded to an even one (:func:`.fused_decode.pad_greedy_weights`): the
padded word is cut from the logits before the filters and the noise. The
kernel takes any V (a filtered row held in a warp's registers up to
:data:`WARP_VOCAB`, walked in L2 past it).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import MAX_SEQ_LEN
from . import prng
from .fused_decode import (
    PICK_FILTER,
    PICK_GUMBEL,
    GreedyWeights,
    check_clock,
    decode_clock_slots,
    launch_decode,
    lstm_cell_plain,
    pad_features,
    round_to,
    wmatmul,
)
from .kernel_build import runs_kernel
from .linalg import matmul

# the longest row (or survivor list) the kernel's filtered pick holds in a
# warp's registers (csrc/decode.cu: 32 PER); a longer one is walked in L2
WARP_VOCAB = 1024
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
                        temperature=1.0, top_k: int = 0, top_p=None, margins: bool = False,
                        row0: int = 0):
    """The sampling kernel's function in eager torch.

    The cell and head round where the greedy kernel's plain version does
    (:func:`.fused_decode.greedy_decode_plain`); the logits are divided by
    the float32 temperature (not multiplied by ``1/t``, which rounds
    otherwise), filtered by :func:`filter_scaled_logits` and drawn with
    Gumbel noise from :func:`.prng.gumbel_noise_plain` (not the noise
    kernel), under the subkeys :func:`.prng.sample_step_keys` makes from the
    host key ``key`` (rows ``[row0, row0 + N)`` of the global draw). With
    float32 weights it is the JAX package's sampling decode, token for
    token.

    Returns ``[N, max_len]`` int32 tokens; with ``margins=True`` also, per
    step, the smallest distance to a tie ``[N, max_len - 1]``: the gap
    between the two largest noisy filtered logits and the filter margins of
    :func:`filter_scaled_logits`.
    """
    features = pad_features(weights, features)
    vocab = weights.emb.shape[0]  # a padded head's extra word is cut from the logits
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
        logits = (wmatmul(round_to(h, wd), weights.wo) + weights.bo)[:, :vocab]
        scaled = filter_scaled_logits(logits / t, k, top_p, use_top_k, use_top_p, margins)
        if margins:
            scaled, margin = scaled
        noisy = scaled + prng.gumbel_noise_plain(sub[None], (n, vocab), dev, row0)[0]
        tok = torch.argmax(noisy, dim=-1)  # first maximal index on ties
        toks.append(tok)
        if margins:
            top2 = torch.topk(noisy, min(2, vocab), dim=-1).values
            gaps.append(torch.minimum(margin, top2[:, 0] - top2[:, -1]))
    out = torch.stack(toks, dim=1).to(torch.int32)
    return (out, torch.stack(gaps, dim=1)) if margins else out


def _launch_sample(weights: GreedyWeights, features: torch.Tensor, start_tokens: torch.Tensor,
                   key, max_len: int, temperature: float, top_k, top_p,
                   clock: torch.Tensor | None = None, row0: int = 0) -> torch.Tensor:
    k, use_top_k, use_top_p = _filters(weights.emb.shape[0], top_k, top_p)
    pick = PICK_FILTER if use_top_k or use_top_p else PICK_GUMBEL
    return launch_decode(weights, features, start_tokens, max_len, pick, temperature, k,
                         top_p if use_top_p else None, prng.key_words(key), clock, row0)


def fused_sample_decode(weights: GreedyWeights, features: torch.Tensor,
                        start_tokens: torch.Tensor, key, max_len: int = MAX_SEQ_LEN,
                        temperature=1.0, top_k: int = 0, top_p=None,
                        use_fused_kernel: bool | None = None,
                        clock: torch.Tensor | None = None, row0: int = 0) -> torch.Tensor:
    """Sampled decode: ``features [N, F]`` f32, ``start_tokens [N]`` int32
    and the host key ``key`` (uint32 ``[2]``, :func:`.prng.PRNGKey`) ->
    ``[N, max_len]`` int32 tokens on the features' device. ``temperature``
    must be positive; top-k runs when ``0 < top_k < V``, the nucleus when
    ``top_p`` is given.

    CUDA tensors run the kernel (``csrc/decode.cu``, one launch for all
    steps beside one that asserts the start tokens' range; the step subkeys
    carried in the launch from the key's two words); CPU tensors run
    :func:`sample_decode_plain`. ``use_fused_kernel=False`` forces the plain
    version; ``True`` on CPU tensors raises. ``row0``: the rows are ``[row0,
    row0 + N)`` of a global batch, and draw those rows' noise of its draw
    (a shard's slice of a sampled batch, :mod:`..parallel.serve`). A batch
    with ``(row0 + N) * V >= 2**32`` raises on every route. ``fused_sample_decode.launches`` counts kernel
    calls. ``clock`` is the greedy decode's phase profile
    (:func:`.fused_decode.fused_greedy_decode`).
    """
    check_counter_space(row0 + features.shape[0], weights.emb.shape[0])
    if not float(temperature) > 0:
        raise ValueError(f"temperature must be positive, got {temperature} (0 is greedy)")
    check_clock(clock, decode_clock_slots(max_len), features, use_fused_kernel)
    args = (weights, features, start_tokens, key, max_len, temperature, top_k, top_p)
    if runs_kernel(use_fused_kernel, features, "sampling"):
        out = _launch_sample(*args, clock=clock, row0=row0)
        fused_sample_decode.launches += 1
        return out
    return sample_decode_plain(*args, row0=row0)


fused_sample_decode.launches = 0


# ---- Plain models of the kernel's pick and key schedule (for tests) ----

def _threefry_u32(k0, k1, x0, x1):
    """threefry2x32 as the kernel computes it (``csrc/threefry.cuh``), in
    wrapping uint32 numpy arithmetic."""
    u = np.uint32
    ks = (u(k0), u(k1), u(k0) ^ u(k1) ^ u(0x1BD11BDA))
    x0 = np.array([x0], dtype=u) + ks[0]
    x1 = np.array([x1], dtype=u) + ks[1]
    for i in range(5):
        for d in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << u(d)) | (x1 >> u(32 - d))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u(i + 1)
    return int(x0[0]), int(x1[0])


def launch_step_keys(key, steps: int) -> np.ndarray:
    """The subkeys the kernel carries (``csrc/decode.cu`` decode_steps): from
    the key's two words, each step ``sub = threefry(key, (0, 1))`` and ``key =
    threefry(key, (0, 0))`` -> uint32 ``[steps, 2]``."""
    k0, k1 = prng.key_words(key)
    subs = np.empty((steps, 2), dtype=np.uint32)
    for t in range(steps):
        subs[t] = _threefry_u32(k0, k1, 0, 1)
        k0, k1 = _threefry_u32(k0, k1, 0, 0)
    return subs


def kth_largest_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Per row of int32 ``keys [N, V]``, the k-th largest, by the kernel's
    radix select: 2-bit digits of the order-preserving unsigned key (``key ^
    0x80000000``), most significant first, each pass keeping the digit that
    holds the k-th largest candidate, until at most 64 candidates remain;
    then the smallest candidate with fewer than k candidates above it ->
    ``[N, 1]`` int32."""
    out = []
    for u in ((keys.to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000).numpy():
        kk, shift = k, 30
        while len(u) > 64 and shift >= 0:
            digits = (u >> shift) & 3
            for d in (3, 2, 1, 0):
                count = int((digits == d).sum())
                if kk <= count:
                    break
                kk -= count
            u, shift = u[digits == d], shift - 2
        if len(u) > 64:  # every digit fixed: all equal
            out.append(int(u[0]))
        else:
            above = (u[None, :] > u[:, None]).sum(axis=1)
            out.append(int(u[above < kk].min()))
    thr = np.array(out, dtype=np.int64)[:, None] ^ 0x80000000
    return torch.from_numpy(np.where(thr >= 2**31, thr - 2**32, thr).astype(np.int32))


def kernel_keep_sets(scaled: torch.Tensor, k: int, p, use_top_k: bool, use_top_p: bool
                     ) -> torch.Tensor:
    """The columns the kernel's filtered pick keeps, ``[N, V]`` bool: top-k
    by :func:`kth_largest_keys`, then the nucleus over top-k's survivors only
    (weights ``exp(v - max)`` against ``p * z``): for at most 64 survivors
    the smallest survivor key whose strict tail mass is under the budget
    (the max's key at least), else the bisection of
    :func:`keyspace_threshold` from the survivors' own key range."""
    keys = monotone_keys(scaled)
    keep = torch.ones_like(scaled, dtype=torch.bool)
    if use_top_k:
        keep = keys >= kth_largest_keys(keys, k)
    if use_top_p:
        big = torch.iinfo(torch.int64).max
        k64 = keys.to(torch.int64)
        mx = torch.where(keep, scaled, -torch.inf).amax(dim=1, keepdim=True)
        e = torch.where(keep, torch.exp(scaled - mx), 0.0)
        budget = torch.tensor(float(p), dtype=torch.float32) * e.sum(dim=1, keepdim=True)
        lo = torch.where(keep, k64, big).amin(dim=1, keepdim=True) - 1
        hi = torch.where(keep, k64, -big).amax(dim=1, keepdim=True)
        for _ in range(32):
            mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
            below = torch.where(k64 > mid, e, 0.0).sum(dim=1, keepdim=True) < budget
            lo = torch.where(below, lo, mid)
            hi = torch.where(below, mid, hi)
        # at most 64 survivors: each one's tail mass directly
        rows = (keep.sum(dim=1) <= 64).nonzero()[:, 0]
        cols = torch.argsort((~keep[rows]).to(torch.int8), dim=1, stable=True)[:, :64]
        valid = keep[rows].gather(1, cols)
        ks, es = k64[rows].gather(1, cols), e[rows].gather(1, cols)
        above = (es[:, None, :] * (ks[:, None, :] > ks[:, :, None])).sum(dim=2)
        direct = torch.where(valid & (above < budget[rows]), ks, big).amin(dim=1, keepdim=True)
        hi[rows] = torch.minimum(direct, torch.where(valid, ks, -big).amax(dim=1, keepdim=True))
        keep = keep & (k64 >= hi)
    return keep


def survivor_gumbel_pick(scaled: torch.Tensor, keep: torch.Tensor, noise: torch.Tensor
                         ) -> torch.Tensor:
    """The kernel's Gumbel-max over the kept columns only (the noise of the
    others never computed): the first column of the largest ``scaled +
    noise`` among them -> ``[N]``."""
    return torch.argmax(torch.where(keep, scaled + noise, -torch.inf), dim=1)
