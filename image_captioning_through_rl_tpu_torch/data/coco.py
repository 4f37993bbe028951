"""COCO-2014 captioning bundle loader and helpers (counterpart of the JAX
``data/coco.py``): :func:`load_data` reads the bundle directory (the
reference's layout, utilities.py:45-113: ``coco2014_captions.h5``,
``{train,val}2014_vgg16_fc7[_pca].h5``, ``coco2014_vocab.json``,
``{train,val}2014_urls.txt``) into the in-memory bundle
(:class:`CocoData`); then the vocabulary file, caption lengths, the
token-to-text decoder and the batch iterators. The h5 tables are read by
the port's own reader (:mod:`.hdf5`), not ``h5py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .. import END_ID
from ..utils.profiling import annotate
from .hdf5 import read_h5


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

    @property
    def vocab_size(self) -> int:
        return len(self.word_to_idx)

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


def load_data(base_dir: str, max_train: Optional[int] = None, pca_features: bool = True,
              print_keys: bool = False, seed: Optional[int] = None) -> CocoData:
    """Load the bundle from ``base_dir``, field for field and dtype for
    dtype as the JAX package's ``load_data``: captions and image indices
    int32, features float32, lengths from the raw captions, urls the
    stripped lines. ``max_train`` subsamples the training captions *with
    replacement* as the reference does (utilities.py:92-96): from numpy's
    global generator (``np.random.randint``) when ``seed`` is None, else
    from ``default_rng(seed).integers``. ``pca_features=False`` reads the
    full ``{split}2014_vgg16_fc7.h5`` tables."""
    raw: Dict[str, np.ndarray] = read_h5(os.path.join(base_dir, "coco2014_captions.h5"))
    variant = "_pca" if pca_features else ""
    for split in ("train", "val"):
        raw[f"{split}_features"] = read_h5(
            os.path.join(base_dir, f"{split}2014_vgg16_fc7{variant}.h5"), ["features"])["features"]
    word_to_idx, idx_to_word = load_vocab(os.path.join(base_dir, "coco2014_vocab.json"))
    urls = {}
    for split in ("train", "val"):
        with open(os.path.join(base_dir, f"{split}2014_urls.txt")) as f:
            urls[split] = np.asarray([line.strip() for line in f])

    if max_train is not None:
        num_train = raw["train_captions"].shape[0]
        if seed is None:
            mask = np.random.randint(num_train, size=max_train)
        else:
            mask = np.random.default_rng(seed).integers(num_train, size=max_train)
        raw["train_captions"] = raw["train_captions"][mask]
        raw["train_image_idxs"] = raw["train_image_idxs"][mask]

    data = CocoData(
        train_captions=raw["train_captions"].astype(np.int32),
        train_image_idxs=raw["train_image_idxs"].astype(np.int32),
        val_captions=raw["val_captions"].astype(np.int32),
        val_image_idxs=raw["val_image_idxs"].astype(np.int32),
        train_features=raw["train_features"].astype(np.float32),
        val_features=raw["val_features"].astype(np.float32),
        word_to_idx=word_to_idx,
        idx_to_word=idx_to_word,
        train_urls=urls["train"],
        val_urls=urls["val"],
        train_captions_lens=caption_lengths(raw["train_captions"]),
        val_captions_lens=caption_lengths(raw["val_captions"]),
    )
    if print_keys:
        for f in dataclasses.fields(data):
            v = getattr(data, f.name)
            if isinstance(v, np.ndarray):
                print(f.name, type(v), v.shape, v.dtype)
            elif v is not None:
                print(f.name, type(v), len(v))
    return data


def decode_captions(captions: np.ndarray, idx_to_word: Dict[int, str]):
    """Token ids -> text. Skips <NULL>, keeps words up to and including
    <END>, then stops."""
    with annotate("caption.strings"):
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


def get_coco_validation_data(data: CocoData):
    """The whole val split: ``(captions, features, urls)`` (reference
    utilities.py:181-190)."""
    return data.val_captions, data.val_features, data.val_urls
