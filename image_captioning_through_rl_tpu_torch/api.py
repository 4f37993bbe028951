"""High-level user API: caption image features (counterpart of the JAX
``api.py``).

>>> cap = load_captioner("a2cNetwork.pt", "coco2014_vocab.json", device="cuda")
>>> cap.caption(features)                 # greedy
>>> cap.caption(features, beam_size=5)    # value-guided beam search
>>> cap.sample_captions(features, temperature=0.8, top_p=0.9, num_samples=3, seed=7)

On a CUDA device the captioner decodes through the hand-written kernels
(:mod:`.ops.fused_decode`, :mod:`.ops.fused_beam`, :mod:`.ops.fused_sample`);
on the CPU through their plain PyTorch versions. Nothing falls back from
the kernels at serving time: ``chip_smoke.py`` holds each kernel against its
plain version. The mesh, faithful-beam and image paths of the JAX
``Captioner``, and its verified dispatch with fresh-key canary retries, are
not ported.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import START_ID
from .config import DecodeConfig, NetConfig
from .data.coco import decode_captions, load_vocab
from .models.convert import a2c_from_state_dict, load_state_dict
from .models.policy import check_unidirectional
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
    device raises.
    """

    def __init__(self, params: dict, cfg: NetConfig, idx_to_word: dict, device="cuda",
                 weight_dtype: torch.dtype | None = None):
        check_unidirectional(cfg)
        self.device = resolve_device(device)
        if weight_dtype is None:
            weight_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.weight_dtype = weight_dtype
        policy, value = (params["policy"], params.get("value")) if "policy" in params \
            else (params, None)

        def to_dev(tree):
            if isinstance(tree, dict):
                return {k: to_dev(v) for k, v in tree.items()}
            return tree.to(self.device, torch.float32)

        self._greedy_w = prepare_greedy_weights(to_dev(policy), weight_dtype)
        self._beam_w = (prepare_beam_weights(self._greedy_w, to_dev(value))
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

    def caption_tokens(self, features, beam_size: int = 0, use_fused_kernel=None
                       ) -> np.ndarray:
        """Token ids ``[N, T]`` for a feature batch ``[N, F]``
        (beam 0 of the beam search when ``beam_size > 0``).
        ``use_fused_kernel`` as in :func:`.ops.fused_decode.fused_greedy_decode`."""
        feats = self._features(features)
        start = self._start(feats.shape[0])
        max_len = self._cfg.max_seq_len
        if beam_size > 0:
            if self._beam_w is None:
                raise ValueError("beam search needs a value network (pass a2c params)")
            dcfg = DecodeConfig(beam_size=beam_size, max_seq_len=max_len)
            toks, _ = fused_beam_search(
                self._beam_w, feats, start, max_len=max_len, beam=beam_size,
                value_weight=dcfg.value_weight, logprob_weight=dcfg.logprob_weight,
                use_fused_kernel=use_fused_kernel)
            return toks[:, 0].cpu().numpy()
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
        there. A batch of ``N * R * V >= 2**32`` raises."""
        if num_samples < 1:
            raise ValueError(f"num_samples must be >= 1, got {num_samples}")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if temperature == 0:
            toks = self.caption_tokens(features, use_fused_kernel=use_fused_kernel)
            return np.repeat(toks[:, None, :], num_samples, axis=1) if num_samples > 1 else toks
        feats = self._features(features)
        n = feats.shape[0]
        check_counter_space(n * num_samples, self._cfg.vocab_size)  # before the R-fold copy
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


def load_captioner(model_pt: str, vocab_json: str, device="cuda",
                   weight_dtype: torch.dtype | None = None) -> Captioner:
    """A :class:`Captioner` from a reference-layout a2c ``.pt`` checkpoint
    (``value_network.* / policy_network.*``) and ``coco2014_vocab.json``.
    The network widths come from the checkpoint's shapes."""
    params = a2c_from_state_dict(load_state_dict(model_pt))
    _, idx_to_word = load_vocab(vocab_json)
    pol = params["policy"]
    vocab, wordvec = pol["embedding"].shape
    cfg = NetConfig(vocab_size=vocab, input_dim=pol["cnn2linear"]["w"].shape[0],
                    wordvec_dim=wordvec, hidden_dim=pol["lstm"]["wh"].shape[0])
    if len(idx_to_word) != vocab:
        raise ValueError(f"the vocabulary has {len(idx_to_word)} words, the model {vocab}")
    return Captioner(params, cfg, idx_to_word, device=device, weight_dtype=weight_dtype)
