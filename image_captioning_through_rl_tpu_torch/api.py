"""High-level user API: caption image features (counterpart of the JAX
``api.py``).

>>> cap = load_captioner("a2cNetwork.pt", "coco2014_vocab.json", device="cuda")
>>> cap.caption(features)                 # greedy
>>> cap.caption(features, beam_size=5)    # value-guided beam search

On a CUDA device the captioner decodes through the hand-written kernels
(:mod:`.ops.fused_decode`, :mod:`.ops.fused_beam`); on the CPU through
their plain PyTorch versions. Nothing falls back from the kernels at
serving time: ``chip_smoke.py`` holds each kernel against its plain
version. The mesh, sampling, faithful-beam and image paths of the JAX
``Captioner`` are not ported yet.
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
from .ops.fused_beam import fused_beam_search, prepare_beam_weights
from .ops.fused_decode import fused_greedy_decode, prepare_greedy_weights


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
    weights are cast and laid out for the kernels once, here.
    """

    def __init__(self, params: dict, cfg: NetConfig, idx_to_word: dict, device="cpu",
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

    def caption_tokens(self, features, beam_size: int = 0, use_fused_kernel=None
                       ) -> np.ndarray:
        """Token ids ``[N, T]`` for a feature batch ``[N, F]``
        (beam 0 of the beam search when ``beam_size > 0``).
        ``use_fused_kernel`` as in :func:`.ops.fused_decode.fused_greedy_decode`."""
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.asarray(features, np.float32))
        feats = features.to(self.device, torch.float32).contiguous()
        start = torch.full((feats.shape[0],), START_ID, dtype=torch.int32, device=self.device)
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

    def caption(self, features, **kw) -> List[str]:
        """Caption strings for a feature batch."""
        return decode_captions(self.caption_tokens(features, **kw), self._idx_to_word)


def load_captioner(model_pt: str, vocab_json: str, device="cpu",
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
