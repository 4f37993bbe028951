"""Align word vectors to the caption vocabulary (counterpart of the JAX
``embeddings/vocab_align.py``, reference utilities.py:418-441)."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def get_vectors_by_vocab(model: Mapping[str, np.ndarray], word_to_idx: Dict[str, int]
                         ) -> np.ndarray:
    """A ``[vocab, dim]`` float32 matrix for ``word_to_idx`` from a
    word -> vector mapping. An OOV word gets ``np.random.rand(dim)`` (numpy's
    global generator) while no word has been found yet, after that the mean
    of the vectors found so far (the reference's fallback,
    utilities.py:429-439; the mean is recomputed only when a word was found
    since, with the reference's ``np.mean`` call, so the values are its)."""
    if hasattr(model, "values"):
        if not model:
            raise ValueError("cannot align an empty embedding model (no vectors — "
                             "empty corpus or truncated vectors file?)")
        dim = len(next(iter(model.values())))
    else:
        dim = model.vector_size
    idx_to_word = {i: w for w, i in word_to_idx.items()}
    out = np.empty((len(idx_to_word), dim), dtype=np.float32)
    seen = []
    mean_at = -1  # len(seen) when the mean was computed
    mean = None
    for idx in range(len(idx_to_word)):
        try:
            vec = np.asarray(model[idx_to_word[idx]], dtype=np.float32)
        except KeyError:
            if not seen:
                out[idx] = np.random.rand(dim).astype(np.float32)
            else:
                if mean_at != len(seen):
                    mean = np.mean(np.asarray(seen), axis=0)
                    mean_at = len(seen)
                out[idx] = mean
            continue
        out[idx] = vec
        seen.append(vec)
    return out
