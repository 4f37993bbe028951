"""Batch-sharded decoding over a mesh (counterpart of the JAX
``parallel/serve.py``): multi-card serving and evaluation.

The batch is padded up to a multiple of the mesh's ``data`` size by
repeating its last row, split into equal row blocks, and each block is
decoded on its mesh entry's device through the hand-written kernels of that
device (a CUDA tensor runs the kernel: greedy ``csrc/decode.cu``, the beam
``csrc/beam_search.cu``, sampling ``csrc/decode.cu``'s sampling pick), the
plain versions on the CPU; a bidirectional policy takes the carried eager
decodes of :mod:`..decode`. The blocks come back to the mesh's first device
(to every rank, on a mesh that spans processes) and the padded rows are cut
off. Parameters are committed to the mesh once (:func:`.sharding.replicate`
passes a committed tree through, and gathers a vocab-sharded one) and each
device's kernel weights are laid out once, in the committed tree's cache.
On a 2-D ``("data", "model")`` mesh the rows split over ``data`` and the
parameters are replicated over ``model``, as the JAX package serves: the
``model`` ranks of a data block decode the same rows, and the blocks are
gathered over the ``data`` group.

Sampling draws the global batch's noise: block ``j`` starts at global row
``lo`` and draws rows ``[lo, hi)`` of each step's ``[N, V]`` draw (the
kernels' and plain versions' ``row0``), so a sharded call is token-exact
against one unsharded call for any N, as in the JAX package. With ``R``
samples a row, the rows are tiled samples-minor before the padding, so the
real rows keep their global index and the padded rows come last.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DecodeConfig, NetConfig
from ..decode.beam import beam_search
from ..decode.greedy import greedy_decode
from ..decode.sample import sample_decode
from ..ops.fused_beam import fused_beam_search, prepare_beam_weights
from ..ops.fused_decode import fused_greedy_decode, prepare_greedy_weights
from ..ops.fused_sample import check_counter_space, fused_sample_decode
from ..ops.kernel_build import kernel_weight_dtype
from .collectives import gather_blocks
from .hostbatch import GlobalBatcher
from .mesh import Mesh
from .sharding import Replicated, replicate


def _pad_to_multiple(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = torch.cat([x, x[-1:].expand(rem, *x.shape[1:])], dim=0)
    return x, n


def _inputs(mesh: Mesh, features, start_tokens, repeat: int = 1):
    feats = torch.as_tensor(features, dtype=torch.float32)
    start = torch.as_tensor(start_tokens).to(torch.int32)
    if repeat > 1:  # samples-minor, before the padding
        feats = feats.repeat_interleave(repeat, dim=0)
        start = start.repeat_interleave(repeat, dim=0)
    feats, n = _pad_to_multiple(feats, mesh.shape.get("data", 1))
    start, _ = _pad_to_multiple(start, mesh.shape.get("data", 1))
    return feats, start, n


def _blocks(mesh: Mesh, rows: int) -> list:
    """``(device, lo, hi)`` of each block this process decodes: one process
    decodes a block on each entry of its ``data`` axis."""
    if mesh.spans_processes:
        return [(mesh.first_device, *GlobalBatcher(mesh).local_rows(rows))]
    entries = mesh.entries("data")
    b = rows // len(entries)
    return [(d, j * b, (j + 1) * b) for j, d in enumerate(entries)]


def _run(mesh: Mesh, rows: int, decode_block, outputs: int = 1):
    """``decode_block(device, lo, hi)`` on each block of this process, the
    outputs (``outputs`` tensors a block) joined into ``[rows, ...]`` on the
    mesh's first device: concatenated on one process's mesh, gathered to
    every rank on a mesh that spans processes."""
    parts = []
    for dev, lo, hi in _blocks(mesh, rows):
        out = decode_block(dev, lo, hi)
        parts.append(out if outputs > 1 else (out,))
    first = mesh.first_device
    if mesh.spans_processes:
        lo = _blocks(mesh, rows)[0][1]
        if "data" not in mesh.shape:  # every rank decoded every row
            joined = tuple(x.to(first) for x in parts[0])
        else:
            joined = tuple(gather_blocks(x.to(first), lo, rows, mesh.group("data"))
                           for x in parts[0])
    else:
        joined = tuple(torch.cat([p[i].to(first) for p in parts]) for i in range(outputs))
    return joined if outputs > 1 else joined[0]


def _greedy_weights(policy: Replicated, device: torch.device, weight_dtype):
    key = ("greedy", device, kernel_weight_dtype(device, weight_dtype))
    if key not in policy.cache:
        policy.cache[key] = prepare_greedy_weights(policy[device], key[2])
    return policy.cache[key]


def _beam_weights(policy: Replicated, value: Replicated, device: torch.device, weight_dtype):
    key = ("beam", device, kernel_weight_dtype(device, weight_dtype), id(policy))
    if key not in value.cache:
        value.cache[key] = prepare_beam_weights(
            _greedy_weights(policy, device, weight_dtype), value[device])
    return value.cache[key]


def sharded_greedy_tokens(mesh: Mesh, policy_params: dict, cfg: NetConfig, features,
                          start_tokens, weight_dtype: Optional[torch.dtype] = None,
                          use_fused_kernel: Optional[bool] = None) -> torch.Tensor:
    """Greedy decode with the batch sharded over ``mesh``'s data axis:
    ``[N, T]`` int32 on the mesh's first device. ``weight_dtype``: the
    kernels' weight type (bf16 on a card, float32 on the CPU by default);
    ``use_fused_kernel`` as in :func:`..ops.fused_decode.fused_greedy_decode`,
    honoured block by block."""
    feats, start, n = _inputs(mesh, features, start_tokens)
    pp = replicate(mesh, policy_params)

    def block(dev, lo, hi):
        f, s = feats[lo:hi].to(dev), start[lo:hi].to(dev)
        if cfg.bidirectional:
            with torch.no_grad():
                return greedy_decode(pp[dev], cfg, f, s)
        return fused_greedy_decode(_greedy_weights(pp, dev, weight_dtype), f, s,
                                   max_len=cfg.max_seq_len, use_fused_kernel=use_fused_kernel)

    return _run(mesh, feats.shape[0], block)[:n]


def sharded_beam_tokens(mesh: Mesh, policy_params: dict, value_params: dict, cfg: NetConfig,
                        dcfg: Optional[DecodeConfig], features, start_tokens,
                        weight_dtype: Optional[torch.dtype] = None,
                        use_fused_kernel: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value-guided beam search sharded over ``mesh``'s data axis ->
    ``(tokens [N, B, T], scores [N, B])``. Per-sample beams only: the
    faithful batch-mean mode (Q2) couples every row of the batch through one
    shared ranking, a single-device computation, and raises
    ``ValueError``."""
    dcfg = dcfg or DecodeConfig(max_seq_len=cfg.max_seq_len)
    if not dcfg.per_sample_beams:
        raise ValueError("sharded beam decode requires per-sample beams; the batch-mean "
                         "faithful mode (Q2) couples the whole batch on one device")
    feats, start, n = _inputs(mesh, features, start_tokens)
    pp, vp = replicate(mesh, policy_params), replicate(mesh, value_params)

    def block(dev, lo, hi):
        f, s = feats[lo:hi].to(dev), start[lo:hi].to(dev)
        if cfg.bidirectional:
            with torch.no_grad():
                return beam_search(pp[dev], vp[dev], cfg, dcfg, f, s)
        return fused_beam_search(_beam_weights(pp, vp, dev, weight_dtype), f, s,
                                 max_len=dcfg.max_seq_len, beam=dcfg.beam_size,
                                 value_weight=dcfg.value_weight,
                                 logprob_weight=dcfg.logprob_weight,
                                 use_fused_kernel=use_fused_kernel)

    toks, scores = _run(mesh, feats.shape[0], block, outputs=2)
    return toks[:n], scores[:n]


def sharded_sample_tokens(mesh: Mesh, policy_params: dict, cfg: NetConfig, features,
                          start_tokens, rng, num_samples: int = 1, temperature=1.0,
                          top_k: int = 0, top_p=None, weight_dtype: Optional[torch.dtype] = None,
                          use_fused_kernel: Optional[bool] = None) -> torch.Tensor:
    """Stochastic decode with the batch sharded over ``mesh``'s data axis,
    under the host key ``rng``: ``[N, T]`` int32, or ``[N, R, T]`` for
    ``num_samples = R > 1`` (rows tiled samples-minor, one batch). Each
    block draws its rows of the global noise, so the tokens equal one
    unsharded :func:`..ops.fused_sample.fused_sample_decode` (the JAX
    ``sample_decode_n``) under the same key for any N."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    feats, start, n = _inputs(mesh, features, start_tokens, repeat=num_samples)
    check_counter_space(feats.shape[0], cfg.vocab_size)
    pp = replicate(mesh, policy_params)

    def block(dev, lo, hi):
        f, s = feats[lo:hi].to(dev), start[lo:hi].to(dev)
        if cfg.bidirectional:
            with torch.no_grad():
                return sample_decode(pp[dev], cfg, f, s, rng, temperature=temperature,
                                     top_k=top_k, top_p=top_p, row0=lo)
        return fused_sample_decode(_greedy_weights(pp, dev, weight_dtype), f, s, rng,
                                   max_len=cfg.max_seq_len, temperature=temperature,
                                   top_k=top_k, top_p=top_p, use_fused_kernel=use_fused_kernel,
                                   row0=lo)

    toks = _run(mesh, feats.shape[0], block)[:n]
    if num_samples > 1:
        toks = toks.reshape(n // num_samples, num_samples, toks.shape[-1])
    return toks
