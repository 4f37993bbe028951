"""Synthetic mini-COCO bundle generator (counterpart of the JAX
``data/synthetic.py``).

Writes a dataset directory in the schema the reference's loader reads
(utilities.py:45-113): ``coco2014_captions.h5`` with
``{train,val}_captions`` and ``{train,val}_image_idxs``,
``{train,val}2014_vgg16_fc7_pca.h5`` feature tables,
``coco2014_vocab.json`` and ``{train,val}2014_urls.txt``. The same seed
gives the JAX package's arrays, vocabulary file and url files byte for
byte; the h5 files go through the port's own writer (:mod:`.hdf5`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import END_ID, MAX_SEQ_LEN, NULL_ID, START_ID
from .hdf5 import write_h5

_SPECIALS = ["<NULL>", "<START>", "<END>", "<UNK>"]


def make_vocab(vocab_size: int):
    """``(word_to_idx, words)``: the four specials, then ``word0``..."""
    if vocab_size <= len(_SPECIALS):
        raise ValueError(f"vocab_size must exceed the {len(_SPECIALS)} special tokens; "
                         f"got {vocab_size}")
    words = list(_SPECIALS) + [f"word{i}" for i in range(vocab_size - len(_SPECIALS))]
    return {w: i for i, w in enumerate(words)}, words


def random_captions(rng: np.random.Generator, n: int, vocab_size: int,
                    max_len: int = MAX_SEQ_LEN) -> np.ndarray:
    """``<START> body <END> <NULL>*`` rows, like the real bundle."""
    if max_len < 3:
        raise ValueError(f"max_len must be >= 3 (<START> body <END>); got {max_len}")
    if vocab_size <= len(_SPECIALS):
        raise ValueError(f"vocab_size must exceed the {len(_SPECIALS)} special tokens; "
                         f"got {vocab_size}")
    caps = rng.integers(len(_SPECIALS), vocab_size, size=(n, max_len)).astype(np.int32)
    caps[:, 0] = START_ID
    end_pos = rng.integers(2, max_len, size=n)
    caps[np.arange(n), end_pos] = END_ID
    caps[np.arange(max_len)[None, :] > end_pos[:, None]] = NULL_ID
    return caps


def make_synthetic_coco(out_dir: str, num_train_images: int = 20, num_val_images: int = 10,
                        captions_per_image: int = 2, vocab_size: int = 50,
                        feature_dim: int = 512, max_len: int = MAX_SEQ_LEN,
                        seed: int = 0) -> str:
    """Write the bundle into ``out_dir`` and return it."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    word_to_idx, words = make_vocab(vocab_size)

    n_train = num_train_images * captions_per_image
    n_val = num_val_images * captions_per_image
    # the draws in the JAX package's order: train captions, val captions,
    # then each split's features
    tables = {"train_captions": random_captions(rng, n_train, vocab_size, max_len),
              "train_image_idxs": np.repeat(np.arange(num_train_images), captions_per_image)}
    tables["val_captions"] = random_captions(rng, n_val, vocab_size, max_len)
    tables["val_image_idxs"] = np.repeat(np.arange(num_val_images), captions_per_image)
    write_h5(os.path.join(out_dir, "coco2014_captions.h5"), tables)

    for split, n_img in (("train", num_train_images), ("val", num_val_images)):
        write_h5(os.path.join(out_dir, f"{split}2014_vgg16_fc7_pca.h5"),
                 {"features": rng.standard_normal((n_img, feature_dim)).astype(np.float32)})
        with open(os.path.join(out_dir, f"{split}2014_urls.txt"), "w") as f:
            f.write("".join(f"http://example.com/{split}/{i}.jpg\n" for i in range(n_img)))

    with open(os.path.join(out_dir, "coco2014_vocab.json"), "w") as f:
        json.dump({"word_to_idx": word_to_idx, "idx_to_word": words}, f)
    return out_dir
