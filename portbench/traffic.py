"""The benchmark's seeded inputs: vocabulary, COCO-size caption and feature
tables, word vectors and weights.

Everything here is drawn from one integer seed, in bulk, and is the same
for the same seed. The program receives only what these functions make,
and the reference receives the same arrays. Nothing here imports the
program: the caption tables are plain numpy in the layout of the CS231n
``coco_captioning`` bundle (``<START> words <END> <NULL>*``, 17 columns,
ids 0-3 the specials).
"""

from __future__ import annotations

import numpy as np
import torch

NULL_ID, START_ID, END_ID, UNK_ID = 0, 1, 2, 3
SPECIALS = ("<NULL>", "<START>", "<END>", "<UNK>")


def sub_seed(seed: int, *path: int) -> int:
    """A 31-bit seed derived from ``seed`` (any size) and ``path``: the
    program's trainers take seeds that must fit 32 signed bits after they
    add small offsets."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), *path])
    return int(ss.generate_state(1, np.uint32)[0] >> 2)


def vocab(vocab_size: int) -> tuple[dict, dict]:
    """``(word_to_idx, idx_to_word)``: the four specials, then ``w4`` ...
    (one word per id, so a decoded caption maps back to its ids)."""
    words = list(SPECIALS) + [f"w{i}" for i in range(len(SPECIALS), vocab_size)]
    return {w: i for i, w in enumerate(words)}, dict(enumerate(words))


def caption_table(rng: np.random.Generator, n: int, traffic: dict, vocab_size: int,
                  steps: int) -> np.ndarray:
    """``[n, steps]`` int32 captions: a body of ``traffic["lengths"]`` words
    (drawn with ``traffic["length_weights"]``), each word id drawn from a
    Zipf law of exponent ``traffic["zipf"]`` over the non-special ids, then
    ``<END>`` and ``<NULL>`` padding."""
    lengths = np.asarray(traffic["lengths"], np.int64)
    weights = np.asarray(traffic["length_weights"], np.float64)
    if lengths.max() + 2 > steps:
        raise ValueError(f"a caption of {lengths.max()} words needs {lengths.max() + 2} columns")
    body = rng.choice(lengths, size=n, p=weights / weights.sum())
    words = vocab_size - len(SPECIALS)
    p = 1.0 / np.arange(1, words + 1, dtype=np.float64) ** float(traffic["zipf"])
    caps = (rng.choice(words, size=(n, steps), p=p / p.sum()) + len(SPECIALS)).astype(np.int32)
    caps[:, 0] = START_ID
    col = np.arange(steps)[None, :]
    caps[col == body[:, None] + 1] = END_ID
    caps[col > body[:, None] + 1] = NULL_ID
    return caps


def feature_table(rng: np.random.Generator, n: int, dim: int) -> np.ndarray:
    """``[n, dim]`` float32 features shaped like PCA-reduced VGG16 fc7:
    independent normal components whose scale falls with the component's
    rank, as a PCA's does."""
    scale = (4.0 / np.sqrt(1.0 + np.arange(dim) / 8.0)).astype(np.float32)
    return rng.standard_normal((n, dim), dtype=np.float32) * scale


def image_index(num_captions: int, num_images: int) -> np.ndarray:
    """Caption row -> image row: every image has ``num_captions //
    num_images`` captions and the first ``num_captions % num_images`` one
    more, as COCO's 4-7 captions an image."""
    per, extra = divmod(num_captions, num_images)
    counts = np.full(num_images, per, np.int64)
    counts[:extra] += 1
    return np.repeat(np.arange(num_images, dtype=np.int64), counts)


def word_vectors(rng: np.random.Generator, vocab_size: int, dim: int) -> np.ndarray:
    """``[V, dim]`` float32 stand-ins for published 300-d word vectors
    (word2vec GoogleNews rows have norms near 2-3)."""
    return (rng.standard_normal((vocab_size, dim), dtype=np.float32) * 0.13).astype(np.float32)


def draw_weights(seed: int, specs: list, device) -> list:
    """Weights of ``specs`` (``(shape, kind, scale)``: ``"normal"`` N(0, 1),
    ``"uniform"`` U(-scale, scale)) drawn on ``device`` from one
    ``torch.Generator`` in two calls, one per kind, then cut into leaves of
    their own storage. The same seed and specs give the same weights on the
    same kind of device."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = [None] * len(specs)
    for kind in ("normal", "uniform"):
        idx = [i for i, s in enumerate(specs) if s[1] == kind]
        total = sum(int(np.prod(specs[i][0])) for i in idx)
        if not total:
            continue
        flat = torch.empty(total, dtype=torch.float32, device=device)
        if kind == "normal":
            flat.normal_(generator=gen)
        else:
            flat.uniform_(-1.0, 1.0, generator=gen)
        at = 0
        for i in idx:
            shape, _, scale = specs[i]
            size = int(np.prod(shape))
            leaf = flat[at: at + size].view(shape)
            out[i] = (leaf * scale if kind == "uniform" else leaf).clone()
            at += size
    return out
