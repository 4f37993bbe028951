"""COCO-2014 captioning bundle helpers (counterpart of the JAX
``data/coco.py``): the vocabulary file, caption lengths and the
token-to-text decoder. ``load_data`` is not ported yet: it reads the h5
tables with ``h5py``, which the port's GPU machines do not have.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

from .. import END_ID


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
