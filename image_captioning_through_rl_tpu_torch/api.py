"""High-level user API: caption image features (counterpart of the JAX
``api.py``).

>>> data = load_data("datasets/coco_captioning", max_train=1)
>>> cap = load_captioner("logs/<stamp>/a2cNetwork.ckpt", data, network_paths)
>>> cap.caption(features)                 # greedy
>>> cap.caption(features, beam_size=5)    # value-guided beam search
>>> cap.sample_captions(features, temperature=0.8, top_p=0.9, num_samples=3, seed=7)

On a CUDA device the captioner decodes through the hand-written kernels
(:mod:`.ops.fused_decode`, :mod:`.ops.fused_beam`, :mod:`.ops.fused_sample`);
on the CPU through their plain PyTorch versions. A bidirectional model has
no decode kernel, in the JAX package as here: it decodes through the
carried eager decodes of :mod:`.decode` in float32 on its device (its
draws' noise from :func:`.ops.prng.gumbel`, as every draw's), and
``use_fused_kernel=True`` raises ``ValueError``. The faithful beam
(``faithful_beam=True``: the reference's Q2 batch-mean beam with its
Q1-stateful critic, :func:`.decode.beam_compat.beam_search_compat`) has no
kernel either, in either direction mode. Nothing falls back from the
kernels at serving time: ``chip_smoke.py`` holds each kernel against its
plain version. :func:`evaluate_captions` scores caption pairs
(:mod:`.metrics`). :func:`load_captioner` takes the JAX package's
arguments (a ``.ckpt`` or ``.pt`` model, the bundle for the vocabulary, the
sub-network paths); :func:`load_captioner_pt` builds one from a
reference-layout ``.pt`` and ``coco2014_vocab.json`` alone. The mesh and
image paths of the JAX ``Captioner``, and its verified dispatch with
fresh-key canary retries, are not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import START_ID
from .config import DecodeConfig, NetConfig
from .data.coco import decode_captions, load_vocab
from .decode.beam import beam_search
from .decode.beam_compat import beam_search_compat
from .decode.greedy import greedy_decode
from .decode.sample import sample_decode_n
from .models.convert import a2c_from_state_dict, load_state_dict
from .ops import prng
from .ops.fused_beam import fused_beam_search, prepare_beam_weights
from .ops.fused_decode import fused_greedy_decode, prepare_greedy_weights
from .ops.fused_sample import check_counter_space, fused_sample_decode


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — there is
    no quiet CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                           "is False")
    return dev


class Captioner:
    """Caption image features with a policy (+ value, for beam search).

    ``params``: a2c ``{"policy", "value"}`` or policy-only parameters in
    the JAX layout. ``weight_dtype``: the kernels' weight type; the default
    is bf16 on CUDA (the TPU kernels' type) and f32 on the CPU, where the
    plain versions then equal the JAX package's float32 decode. The
    weights are cast and laid out for the kernels once, here. ``device``
    is the card unless the caller asks for ``"cpu"``; a missing CUDA
    device raises. A bidirectional ``cfg`` keeps the float32 weights as
    they are, on the device, for the eager decodes (another
    ``weight_dtype`` raises: no decode kernel reads it).
    """

    def __init__(self, params: dict, cfg: NetConfig, idx_to_word: dict, device="cuda",
                 weight_dtype: torch.dtype | None = None):
        self.device = resolve_device(device)
        policy, value = (params["policy"], params.get("value")) if "policy" in params \
            else (params, None)

        def to_dev(tree):
            if isinstance(tree, dict):
                return {k: to_dev(v) for k, v in tree.items()}
            return tree.to(self.device, torch.float32)

        self._policy, self._value = to_dev(policy), to_dev(value) if value is not None else None
        if cfg.bidirectional:
            if weight_dtype not in (None, torch.float32):
                raise ValueError(f"weight_dtype={weight_dtype}: a bidirectional model decodes "
                                 "in float32 (no decode kernel serves it)")
            self.weight_dtype = torch.float32
            self._greedy_w = self._beam_w = None
        else:
            if weight_dtype is None:
                weight_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
            self.weight_dtype = weight_dtype
            self._greedy_w = prepare_greedy_weights(self._policy, weight_dtype)
            self._beam_w = (prepare_beam_weights(self._greedy_w, self._value)
                            if value is not None else None)
        self._cfg = cfg
        self._idx_to_word = idx_to_word

    @property
    def cfg(self) -> NetConfig:
        return self._cfg

    def _features(self, features) -> torch.Tensor:
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.asarray(features, np.float32))
        return features.to(self.device, torch.float32).contiguous()

    def _start(self, rows: int) -> torch.Tensor:
        return torch.full((rows,), START_ID, dtype=torch.int32, device=self.device)

    def _check_kernel(self, use_fused_kernel, what: str) -> None:
        if use_fused_kernel and self._cfg.bidirectional:
            raise ValueError(f"use_fused_kernel=True cannot be honored: the fused {what} "
                             "kernel is unidirectional only")

    def caption_tokens(self, features, beam_size: int = 0, use_fused_kernel=None,
                       faithful_beam: bool = False) -> np.ndarray:
        """Token ids ``[N, T]`` for a feature batch ``[N, F]``
        (beam 0 of the beam search when ``beam_size > 0``).
        ``use_fused_kernel`` as in :func:`.ops.fused_decode.fused_greedy_decode`.
        ``faithful_beam=True`` decodes the beam as the reference's eval does
        (Q2 and Q1, the critic's carry reset per call; the reference resets
        it per slice), in float32 on the device; forcing the kernel then
        raises ``ValueError``."""
        feats = self._features(features)
        start = self._start(feats.shape[0])
        max_len = self._cfg.max_seq_len
        if beam_size > 0:
            if self._value is None:
                raise ValueError("beam search needs a value network (pass a2c params)")
            if use_fused_kernel and faithful_beam:
                raise ValueError("use_fused_kernel=True cannot be honored: the fused beam "
                                 "kernel is unidirectional and non-faithful only")
            self._check_kernel(use_fused_kernel, "beam")
            dcfg = DecodeConfig(beam_size=beam_size, max_seq_len=max_len,
                                per_sample_beams=not faithful_beam)
            if faithful_beam:
                with torch.no_grad():
                    toks, _, _ = beam_search_compat(self._policy, self._value, self._cfg, dcfg,
                                                    feats, start)
                return toks[:, 0].cpu().numpy()
            if self._cfg.bidirectional:
                with torch.no_grad():
                    toks, _ = beam_search(self._policy, self._value, self._cfg, dcfg, feats,
                                          start)
                return toks[:, 0].cpu().numpy()
            toks, _ = fused_beam_search(
                self._beam_w, feats, start, max_len=max_len, beam=beam_size,
                value_weight=dcfg.value_weight, logprob_weight=dcfg.logprob_weight,
                use_fused_kernel=use_fused_kernel)
            return toks[:, 0].cpu().numpy()
        self._check_kernel(use_fused_kernel, "greedy")
        if self._cfg.bidirectional:
            with torch.no_grad():
                return greedy_decode(self._policy, self._cfg, feats, start, max_len).cpu().numpy()
        toks = fused_greedy_decode(self._greedy_w, feats, start, max_len=max_len,
                                   use_fused_kernel=use_fused_kernel)
        return toks.cpu().numpy()

    def sample_tokens(self, features, temperature: float = 1.0, top_k: int = 0,
                      top_p: float = 1.0, num_samples: int = 1, seed: int = 0,
                      use_fused_kernel=None) -> np.ndarray:
        """Stochastic decode: token ids ``[N, T]``, or ``[N, R, T]`` for
        ``num_samples = R > 1``, drawn from the filtered softmax as the JAX
        ``Captioner.sample_tokens`` draws them under ``PRNGKey(seed)``.
        ``temperature = 0`` is exact greedy (repeated R times); ``top_p =
        1.0`` leaves the nucleus off; ``top_k`` in ``(0, V)`` turns top-k on.
        The R samples of a row are rows ``i * R .. i * R + R - 1`` of one
        batch (samples-minor), decoded by :func:`.ops.fused_sample.fused_sample_decode`
        with the greedy weights: on the card every request with ``temperature
        > 0`` runs the kernel, filtered or not. ``use_fused_kernel`` as
        there. A batch of ``N * R * V >= 2**32`` raises. A bidirectional
        model samples through :func:`.decode.sample.sample_decode_n` under the
        same key, in the same samples-minor order."""
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if temperature == 0:
            toks = self.caption_tokens(features, use_fused_kernel=use_fused_kernel)
            return np.repeat(toks[:, None, :], num_samples, axis=1) if num_samples > 1 else toks
        self._check_kernel(use_fused_kernel, "sampling")
        feats = self._features(features)
        n = feats.shape[0]
        check_counter_space(n * num_samples, self._cfg.vocab_size)  # before the R-fold copy
        if self._cfg.bidirectional:
            with torch.no_grad():
                toks = sample_decode_n(
                    self._policy, self._cfg, feats, self._start(n), prng.PRNGKey(seed),
                    num_samples, temperature=float(temperature), top_k=top_k,
                    top_p=float(top_p) if top_p < 1.0 else None).cpu().numpy()
            return toks[:, 0] if num_samples == 1 else toks
        tiled = feats.repeat_interleave(num_samples, dim=0)
        toks = fused_sample_decode(
            self._greedy_w, tiled, self._start(tiled.shape[0]), prng.PRNGKey(seed),
            max_len=self._cfg.max_seq_len, temperature=float(temperature), top_k=top_k,
            top_p=float(top_p) if top_p < 1.0 else None, use_fused_kernel=use_fused_kernel)
        toks = toks.cpu().numpy().reshape(n, num_samples, -1)
        return toks[:, 0] if num_samples == 1 else toks

    def sample_captions(self, features, num_samples: int = 1, **kw) -> List:
        """Sampled caption strings: a flat list for ``num_samples = 1``, else
        one list of R captions per image."""
        toks = self.sample_tokens(features, num_samples=num_samples, **kw)
        if num_samples == 1:
            return decode_captions(toks, self._idx_to_word)
        return [decode_captions(row, self._idx_to_word) for row in toks]

    def caption(self, features, **kw) -> List[str]:
        """Caption strings for a feature batch."""
        return decode_captions(self.caption_tokens(features, **kw), self._idx_to_word)


def evaluate_captions(real: List[str], generated: List[str]) -> dict:
    """Score caption pairs (BLEU 1-4, METEOR, ROUGE-L, CIDEr)."""
    from .metrics import score

    refs = {i: [r.strip()] for i, r in enumerate(real)}
    hypos = {i: [g.strip()] for i, g in enumerate(generated)}
    return score(refs, hypos)


def load_captioner(model_path: str, data, network_paths: dict, bidirectional: bool = False,
                   mesh=None, device="cuda", weight_dtype: torch.dtype | None = None
                   ) -> Captioner:
    """A :class:`Captioner` from checkpoints on disk, as the JAX package's
    ``load_captioner``: the policy and value networks of ``network_paths``
    with the a2c checkpoint ``model_path`` over them, each ``.ckpt``
    (native) or ``.pt`` (reference) by its suffix
    (:func:`.train.loops.load_a2c_models`), sized by ``data`` (a
    :class:`.data.coco.CocoData`, whose vocabulary captions). ``mesh``
    other than None raises: multi-GPU serving is not ported (ROADMAP §1
    item 8)."""
    if mesh is not None:
        raise NotImplementedError("load_captioner(mesh=...): multi-GPU serving is not ported "
                                  "yet (ROADMAP §1 item 8)")
    from .train.loops import load_a2c_models  # the loops import this module

    params, cfg = load_a2c_models(model_path, data, network_paths, bidirectional,
                                  device=device)
    return Captioner(params, cfg, data.idx_to_word, device=device, weight_dtype=weight_dtype)


def load_captioner_pt(model_pt: str, vocab_json: str, device="cuda",
                      weight_dtype: torch.dtype | None = None,
                      bidirectional: bool = False) -> Captioner:
    """A :class:`Captioner` from a reference-layout a2c ``.pt`` checkpoint
    (``value_network.* / policy_network.*``) and ``coco2014_vocab.json``
    alone, without the bundle or the sub-network files. The network widths
    come from the checkpoint's shapes; a bidirectional checkpoint needs
    ``bidirectional=True``."""
    params = a2c_from_state_dict(load_state_dict(model_pt), bidirectional)
    _, idx_to_word = load_vocab(vocab_json)
    pol = params["policy"]
    vocab, wordvec = pol["embedding"].shape
    cell = pol["lstm_fwd" if bidirectional else "lstm"]
    cfg = NetConfig(vocab_size=vocab, input_dim=pol["cnn2linear"]["w"].shape[0],
                    wordvec_dim=wordvec, hidden_dim=cell["wh"].shape[0],
                    bidirectional=bidirectional)
    if len(idx_to_word) != vocab:
        raise ValueError(f"the vocabulary has {len(idx_to_word)} words, the model {vocab}")
    return Captioner(params, cfg, idx_to_word, device=device, weight_dtype=weight_dtype)
