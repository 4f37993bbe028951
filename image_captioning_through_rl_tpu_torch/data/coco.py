"""COCO-2014 captioning bundle helpers (counterpart of the JAX
``data/coco.py``): the in-memory bundle (:class:`CocoData`), the
vocabulary file, caption lengths, the token-to-text decoder and the batch
iterators. ``load_data`` is not ported yet: it reads the h5 tables with
``h5py``, which the port's GPU machines do not have.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .. import END_ID


@dataclasses.dataclass
class CocoData:
    """In-memory dataset bundle, field for field the JAX package's (the
    reference's data dict keys)."""

    train_captions: np.ndarray  # [Nc_train, 17] int
    train_image_idxs: np.ndarray  # [Nc_train] int
    val_captions: np.ndarray
    val_image_idxs: np.ndarray
    train_features: np.ndarray  # [Ni_train, F] float32
    val_features: np.ndarray
    word_to_idx: Dict[str, int]
    idx_to_word: Dict[int, str]
    train_urls: np.ndarray  # [Ni_train] str
    val_urls: np.ndarray
    train_captions_lens: np.ndarray  # [Nc_train] int (END pos + 1)
    val_captions_lens: np.ndarray
    embeddings: Optional[np.ndarray] = None  # aligned word vectors or None

    def split(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        caps = getattr(self, f"{name}_captions")
        idxs = getattr(self, f"{name}_image_idxs")
        feats = getattr(self, f"{name}_features")
        urls = getattr(self, f"{name}_urls")
        return caps, idxs, feats, urls


def caption_lengths(captions: np.ndarray) -> np.ndarray:
    """Length = first index of the END token + 1. Rows without an END
    token are a malformed bundle and raise."""
    is_end = captions == END_ID
    missing = ~is_end.any(axis=1)
    if missing.any():
        bad = np.flatnonzero(missing)
        raise ValueError(
            f"{bad.size} caption row(s) contain no <END> token "
            f"(first bad rows: {bad[:5].tolist()}); the COCO bundle is "
            "malformed or truncated"
        )
    return np.argmax(is_end, axis=1) + 1


def load_vocab(path: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    """Parse ``coco2014_vocab.json`` -> ``(word_to_idx, idx_to_word)``;
    ``idx_to_word`` ships as a list or a str-keyed dict."""
    with open(path) as f:
        vocab = json.load(f)
    word_to_idx = vocab["word_to_idx"]
    raw = vocab["idx_to_word"]
    if isinstance(raw, list):
        idx_to_word = dict(enumerate(raw))
    else:
        idx_to_word = {int(k): v for k, v in raw.items()}
    return word_to_idx, idx_to_word


def decode_captions(captions: np.ndarray, idx_to_word: Dict[int, str]):
    """Token ids -> text. Skips <NULL>, keeps words up to and including
    <END>, then stops."""
    captions = np.asarray(captions)
    singleton = captions.ndim == 1
    if singleton:
        captions = captions[None]
    decoded = []
    for row in captions:
        words = []
        for tok in row:
            word = idx_to_word[int(tok)]
            if word != "<NULL>":
                words.append(word)
            if word == "<END>":
                break
        decoded.append(" ".join(words))
    return decoded[0] if singleton else decoded


def get_coco_batch(data: CocoData, batch_size: int = 100, split: str = "train",
                   rng: Optional[np.random.Generator] = None):
    """One random batch sampled *with replacement* (quirk Q8)."""
    rng = rng or np.random.default_rng()
    caps, idxs, feats, urls = data.split(split)
    mask = rng.integers(caps.shape[0], size=batch_size)
    image_idxs = idxs[mask]
    return caps[mask], feats[image_idxs], urls[image_idxs]


def epoch_minibatch_indices(n: int, batch_size: int,
                            rng: Optional[np.random.Generator] = None) -> Iterator[np.ndarray]:
    """The epoch index stream: one permutation, sliced in order, the last
    minibatch ragged (the same draws as the JAX package's, so both packages
    see the same minibatches from the same seed)."""
    rng = rng or np.random.default_rng()
    perm = rng.permutation(n)
    for i in range(0, n, batch_size):
        yield perm[i: i + batch_size]


def get_coco_minibatches(data: CocoData, batch_size: int = 100, split: str = "train",
                         rng: Optional[np.random.Generator] = None
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Epoch iterator of ``(captions, features, urls)``: one random
    permutation, sliced into minibatches; features gather per caption
    through ``image_idxs`` (several captions share an image)."""
    caps, idxs, feats, urls = data.split(split)
    for mask in epoch_minibatch_indices(caps.shape[0], batch_size, rng):
        image_idxs = idxs[mask]
        yield caps[mask], feats[image_idxs], urls[image_idxs]
