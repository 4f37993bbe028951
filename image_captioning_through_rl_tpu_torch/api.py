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
reference-layout ``.pt`` and ``coco2014_vocab.json`` alone. Raw images
go through the visual front end, :class:`FeatureExtractor` (VGG16 fc7 and an
optional PCA, :func:`load_feature_extractor`), then the same decodes:
:meth:`Captioner.caption_images` and :meth:`Captioner.sample_images`.
``mesh=`` (:mod:`.parallel`) shards each batch over a mesh's ``data`` axis:
the captioner through :mod:`.parallel.serve` (each entry's rows through its
device's kernels; on a mesh that spans processes every rank decodes its rows
and receives every row's tokens), the extractor over one process's devices.
The JAX ``Captioner``'s verified dispatch with fresh-key canary retries is
not ported.
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
from .parallel.sharding import gather_params
from .utils.profiling import annotate


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

    ``mesh``: greedy, per-sample beam and sampled decodes shard each batch
    over the mesh's ``data`` axis (:mod:`.parallel.serve`), the parameters
    committed to the mesh once, here; ``device`` is then the mesh's first
    device of this process. ``use_fused_kernel=True`` is honoured on every
    block. The faithful beam couples a batch's rows and decodes unsharded.
    """

    def __init__(self, params: dict, cfg: NetConfig, idx_to_word: dict, device="cuda",
                 weight_dtype: torch.dtype | None = None, mesh=None):
        self._mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.first_device)
        params = gather_params(params)  # a vocab-sharded tree, once
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
        self._mesh_params = None
        if mesh is not None:
            from .parallel.sharding import replicate

            self._mesh_params = (replicate(mesh, self._policy),
                                 None if self._value is None else replicate(mesh, self._value))

    @property
    def cfg(self) -> NetConfig:
        return self._cfg

    def _mesh_kw(self, use_fused_kernel) -> dict:
        return {"weight_dtype": None if self._cfg.bidirectional else self.weight_dtype,
                "use_fused_kernel": use_fused_kernel}

    def _features(self, features) -> torch.Tensor:
        with annotate("caption.features_in"):
            if not isinstance(features, torch.Tensor):
                features = torch.from_numpy(np.asarray(features, np.float32))
            return features.to(self.device, torch.float32).contiguous()

    @staticmethod
    def _tokens_out(toks: torch.Tensor) -> np.ndarray:
        with annotate("caption.tokens_out"):
            return toks.cpu().numpy()

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
        with annotate("caption.search"):
            toks = self._search(feats, beam_size, use_fused_kernel, faithful_beam)
        return self._tokens_out(toks)

    def _search(self, feats: torch.Tensor, beam_size: int, use_fused_kernel,
                faithful_beam: bool) -> torch.Tensor:
        """:meth:`caption_tokens`' decode, its tokens ``[N, T]`` left on the
        device."""
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
            elif self._mesh is not None:
                from .parallel.serve import sharded_beam_tokens

                toks, _ = sharded_beam_tokens(self._mesh, *self._mesh_params, self._cfg, dcfg,
                                              feats, start, **self._mesh_kw(use_fused_kernel))
            elif self._cfg.bidirectional:
                with torch.no_grad():
                    toks, _ = beam_search(self._policy, self._value, self._cfg, dcfg, feats,
                                          start)
            else:
                toks, _ = fused_beam_search(
                    self._beam_w, feats, start, max_len=max_len, beam=beam_size,
                    value_weight=dcfg.value_weight, logprob_weight=dcfg.logprob_weight,
                    use_fused_kernel=use_fused_kernel)
            return toks[:, 0]
        self._check_kernel(use_fused_kernel, "greedy")
        if self._mesh is not None:
            from .parallel.serve import sharded_greedy_tokens

            return sharded_greedy_tokens(self._mesh, self._mesh_params[0], self._cfg, feats,
                                         start, **self._mesh_kw(use_fused_kernel))
        if self._cfg.bidirectional:
            with torch.no_grad():
                return greedy_decode(self._policy, self._cfg, feats, start, max_len)
        return fused_greedy_decode(self._greedy_w, feats, start, max_len=max_len,
                                   use_fused_kernel=use_fused_kernel)

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
        key = prng.PRNGKey(seed)
        kw = dict(temperature=float(temperature), top_k=top_k,
                  top_p=float(top_p) if top_p < 1.0 else None)
        with annotate("caption.search"):
            if self._mesh is not None:
                from .parallel.serve import sharded_sample_tokens

                toks = sharded_sample_tokens(self._mesh, self._mesh_params[0], self._cfg, feats,
                                             self._start(n), key, num_samples, **kw,
                                             **self._mesh_kw(use_fused_kernel))
            elif self._cfg.bidirectional:
                with torch.no_grad():
                    toks = sample_decode_n(self._policy, self._cfg, feats, self._start(n), key,
                                           num_samples, **kw)
            else:
                tiled = feats.repeat_interleave(num_samples, dim=0)
                toks = fused_sample_decode(self._greedy_w, tiled, self._start(tiled.shape[0]),
                                           key, max_len=self._cfg.max_seq_len,
                                           use_fused_kernel=use_fused_kernel, **kw)
        toks = self._tokens_out(toks).reshape(n, num_samples, -1)
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

    def caption_images(self, images, extractor: "FeatureExtractor", batch_size: int = 64,
                       **kw) -> List[str]:
        """Caption raw images end to end: pixels -> VGG16 fc7 (-> PCA) ->
        :meth:`caption`. ``images``: file paths or an ``[N, H, W, 3]`` uint8
        array; ``extractor`` the visual front end
        (:func:`load_feature_extractor`)."""
        return self.caption(self._extract_checked(images, extractor, batch_size), **kw)

    def sample_images(self, images, extractor: "FeatureExtractor", batch_size: int = 64,
                      **kw) -> List:
        """:meth:`sample_captions` from raw images (the sampling twin of
        :meth:`caption_images`)."""
        return self.sample_captions(self._extract_checked(images, extractor, batch_size), **kw)

    def _extract_checked(self, images, extractor: "FeatureExtractor", batch_size: int):
        feats = extractor(images, batch_size=batch_size)
        if feats.shape[1] != self._cfg.input_dim:
            raise ValueError(
                f"extractor produces {feats.shape[1]}-d features but the model was trained on "
                f"{self._cfg.input_dim}-d input — pass the matching PCA projection (or none, "
                "for raw fc7 models) to load_feature_extractor")
        return feats


class FeatureExtractor:
    """The visual front end: VGG16 fc7 features, optionally PCA-reduced to
    the bundle's compact dimension (the live counterpart of the bundle's
    ``*_vgg16_fc7[_pca].h5`` tables).

    ``vgg``: a :class:`.models.vgg.VGG16` (moved to ``device``, the card
    unless the caller asks for ``"cpu"``); ``projection`` a
    :class:`.data.pca.PCAProjection` or None. ``compute_dtype``
    (``torch.bfloat16``) runs the stack with weights and activations in that
    type, the weights cast once, here; float32 (None) runs in float32 on
    every device (TF32 off). ``images`` of a call: file paths (decoded on
    the host: the shorter side to 256, a centre crop of 224,
    :func:`.cli.extract.load_image_batch`) or an ``[N, H, W, 3]`` array.
    ``mesh`` (one process's devices) splits each batch over its ``data``
    entries (:func:`.models.vgg.iter_features`); ``device`` is then the
    mesh's first device."""

    def __init__(self, vgg, projection=None, compute_dtype: torch.dtype | None = None,
                 mesh=None, device="cuda"):
        from .models import vgg as vgg_mod

        self.mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.first_device)
        vgg = vgg.to(self.device).eval()
        if compute_dtype is not None:
            vgg = vgg_mod.cast_params(vgg, compute_dtype)
        self.vgg = vgg
        self.projection = projection.to(self.device) if projection is not None else None
        self.compute_dtype = compute_dtype

    @property
    def dim(self) -> int:
        """The output feature dimension (the PCA's components, or fc7's
        4096)."""
        from .models.vgg import FC7_DIM

        return self.projection.dim if self.projection is not None else FC7_DIM

    def __call__(self, images, batch_size: int = 64, progress=None) -> np.ndarray:
        from .models import vgg as vgg_mod

        loader = None
        if len(images) and isinstance(images[0], str):
            from .cli.extract import load_image_batch

            loader = load_image_batch
        return vgg_mod.extract_features(self.vgg, images, batch_size=batch_size,
                                        projection=self.projection, loader=loader,
                                        progress=progress, compute_dtype=self.compute_dtype,
                                        mesh=self.mesh)


def load_feature_extractor(weights: str = "", pca: str = "", bf16: bool = False, mesh=None,
                           device="cuda") -> FeatureExtractor:
    """A :class:`FeatureExtractor` from files, as the JAX package's: VGG16
    weights (a torchvision-layout ``.pt`` state dict or a native ``.ckpt``;
    empty: random weights, with a warning on stderr, for pipeline testing)
    and an optional fitted PCA projection ``.npz`` (``cli/extract`` writes
    one). ``bf16`` runs the stack in bfloat16. ``mesh``: each batch split
    over one process's devices (:class:`FeatureExtractor`)."""
    from .models import vgg as vgg_mod
    from .models.convert import load_vgg_ckpt, vgg_from_state_dict

    dev = resolve_device(device if mesh is None else mesh.first_device)
    if weights.endswith(".pt"):
        model = vgg_from_state_dict(load_state_dict(weights), device=dev)
    elif weights:
        model = load_vgg_ckpt(weights, device=dev)
    else:
        import sys

        print("[FeatureExtractor] WARNING: random VGG16 weights (pipeline testing only)",
              file=sys.stderr)
        model = vgg_mod.init(torch.Generator().manual_seed(0)).to(dev)
    projection = None
    if pca:
        from .data.pca import PCAProjection

        projection = PCAProjection.load(pca)
    return FeatureExtractor(model, projection, compute_dtype=torch.bfloat16 if bf16 else None,
                            mesh=mesh, device=dev)


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
    :class:`.data.coco.CocoData`, whose vocabulary captions). ``mesh``: a
    sharded captioner (:class:`Captioner`); on a mesh that spans processes
    rank 0 reads the checkpoints for every rank."""
    from .train.loops import load_a2c_models  # the loops import this module

    params, cfg = load_a2c_models(model_path, data, network_paths, bidirectional,
                                  device=device, mesh=mesh)
    return Captioner(params, cfg, data.idx_to_word, device=device, weight_dtype=weight_dtype,
                     mesh=mesh)


def load_captioner_pt(model_pt: str, vocab_json: str, device="cuda",
                      weight_dtype: torch.dtype | None = None,
                      bidirectional: bool = False, mesh=None) -> Captioner:
    """A :class:`Captioner` from a reference-layout a2c ``.pt`` checkpoint
    (``value_network.* / policy_network.*``) and ``coco2014_vocab.json``
    alone, without the bundle or the sub-network files. The network widths
    come from the checkpoint's shapes; a bidirectional checkpoint needs
    ``bidirectional=True``. ``mesh`` as in :class:`Captioner`."""
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
    return Captioner(params, cfg, idx_to_word, device=device, weight_dtype=weight_dtype,
                     mesh=mesh)
