"""Dataset-bundle builder (counterpart of the JAX ``data/build.py``): raw
COCO annotation JSON -> the CS231n-style captioning bundle the port (and the
reference) trains from. ``coco2014_captions.h5`` goes through the port's
own HDF5 writer (:mod:`.hdf5`).

The reference consumes a preprocessed bundle (``coco2014_captions.h5``,
``coco2014_vocab.json``, ``*_urls.txt``, VGG16 fc7 feature tables —
reference utilities.py:45-113) but ships no way to produce it; users
must download a prebuilt archive. This module closes that loop for the
caption half: given the official ``captions_train2014.json`` /
``captions_val2014.json`` annotation files it tokenizes, builds the
vocabulary, encodes fixed-length token rows and writes the bundle. The
image half (feature tables) is the JAX package's ``cli.extract`` (not
ported yet, ROADMAP §1 item 9); the builder emits
per-split image file lists so ``--file_list`` pins feature-row order to
the caption table's ``image_idxs``.

Conventions (matching what the shipped bundle's loader expects):
  * special ids ``<NULL>=0 <START>=1 <END>=2 <UNK>=3`` (package
    constants; reference utilities.py:101-103);
  * every caption row is ``<START> body <END> <NULL>*`` of width
    ``max_len`` — rows always contain ``<END>`` because
    :func:`.coco.caption_lengths` (reference utilities.py:98-103)
    defines length as END position + 1;
  * tokenization is lowercase, punctuation stripped, whitespace split —
    the preprocessing family the original bundle used;
  * the vocabulary is built from the TRAIN split only, thresholded at
    ``min_count``, ordered by (count desc, first occurrence) so builds
    are deterministic.
"""

from __future__ import annotations

import dataclasses
import json
import os
import string
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import END_ID, MAX_SEQ_LEN, NULL_ID, START_ID, UNK_ID
from ..utils.io import atomic_write
from .hdf5 import write_h5

SPECIAL_TOKENS = ("<NULL>", "<START>", "<END>", "<UNK>")

_PUNCT_TABLE = str.maketrans({c: " " for c in string.punctuation})


def tokenize(caption: str) -> List[str]:
    """Lowercase, strip punctuation, split on whitespace.

    Punctuation maps to spaces (not deletion) so hyphenated and
    slash-joined forms split into their words instead of fusing into
    tokens that would never meet ``min_count``.
    """
    return caption.lower().translate(_PUNCT_TABLE).split()


def build_vocab(
    token_lists: Iterable[Sequence[str]],
    min_count: int = 1,
    max_words: Optional[int] = None,
) -> Dict[str, int]:
    """Deterministic vocabulary: specials at ids 0-3, then words with
    ``count >= min_count`` ordered by (count desc, first occurrence),
    optionally capped at ``max_words`` non-special entries."""
    counts: Dict[str, int] = {}
    first: Dict[str, int] = {}
    pos = 0
    for toks in token_lists:
        for w in toks:
            counts[w] = counts.get(w, 0) + 1
            if w not in first:
                first[w] = pos
            pos += 1
    kept = [w for w, c in counts.items()
            if c >= min_count and w not in SPECIAL_TOKENS]
    kept.sort(key=lambda w: (-counts[w], first[w]))
    if max_words is not None:
        if max_words < 0:
            # kept[:negative] would silently DROP the |max_words| rarest
            # words and keep the rest — the opposite of the cap
            raise ValueError(f"max_words must be >= 0, got {max_words}")
        kept = kept[:max_words]
    vocab = {w: i for i, w in enumerate(SPECIAL_TOKENS)}
    for w in kept:
        vocab[w] = len(vocab)
    return vocab


def encode_caption(
    tokens: Sequence[str],
    word_to_idx: Dict[str, int],
    max_len: int = MAX_SEQ_LEN,
) -> Optional[np.ndarray]:
    """``<START> body <END> <NULL>*`` row of width ``max_len``; OOV
    words become ``<UNK>``. Returns None when the body exceeds
    ``max_len - 2`` (caller decides drop vs truncate)."""
    if len(tokens) > max_len - 2:
        return None
    row = np.full((max_len,), NULL_ID, np.int32)
    row[0] = START_ID
    for i, w in enumerate(tokens):
        row[1 + i] = word_to_idx.get(w, UNK_ID)
    row[1 + len(tokens)] = END_ID
    return row


@dataclasses.dataclass
class SplitBuild:
    """One split's encoded arrays plus its image bookkeeping."""

    captions: np.ndarray  # [Nc, max_len] int32
    image_idxs: np.ndarray  # [Nc] int32 rows into the image order
    file_names: List[str]  # feature-extraction order (sorted image id)
    urls: List[str]
    n_dropped: int  # captions over length (when not truncating)
    n_empty: int = 0  # captions that tokenized to zero words (dropped)


def _parse_split(
    annotations_path: str,
) -> Tuple[List[List[str]], List[int], List[str], List[str]]:
    """Parse one COCO annotation file into token lists + image tables.

    Returns (token_lists, caption_image_rows, file_names, urls).
    Encoding happens later so the train split can be parsed once, used
    for vocab building, then encoded."""
    with open(annotations_path) as f:
        ann = json.load(f)
    images = sorted(ann["images"], key=lambda im: im["id"])
    row_of_image = {im["id"]: i for i, im in enumerate(images)}
    file_names = [im["file_name"] for im in images]
    urls = [im.get("coco_url") or im.get("flickr_url") or im["file_name"]
            for im in images]

    token_lists: List[List[str]] = []
    image_rows: List[int] = []
    for a in ann["annotations"]:
        img_id = a["image_id"]
        if img_id not in row_of_image:
            raise ValueError(
                f"annotation {a.get('id', '?')} references image_id "
                f"{img_id} absent from the images table of "
                f"{annotations_path}"
            )
        token_lists.append(tokenize(a["caption"]))
        image_rows.append(row_of_image[img_id])
    return token_lists, image_rows, file_names, urls


def _encode_split(
    token_lists: List[List[str]],
    image_rows: List[int],
    word_to_idx: Dict[str, int],
    max_len: int,
    truncate: bool,
    file_names: List[str],
    urls: List[str],
) -> SplitBuild:
    rows, idxs, dropped, empty = [], [], 0, 0
    body = max_len - 2
    for toks, img_row in zip(token_lists, image_rows):
        if not toks:
            # punctuation/whitespace-only captions exist in the real
            # annotation files; a contentless <START><END> row would
            # silently enter training (and caplen=2 confuses the
            # curriculum windows) — drop and count it
            empty += 1
            continue
        if len(toks) > body:
            if not truncate:
                dropped += 1
                continue
            toks = toks[:body]
        enc = encode_caption(toks, word_to_idx, max_len)
        assert enc is not None
        rows.append(enc)
        idxs.append(img_row)
    if not rows:
        raise ValueError(
            "no captions survived encoding — every caption exceeded "
            f"max_len-2={body} body words (pass truncate=True?)"
        )
    return SplitBuild(
        captions=np.stack(rows).astype(np.int32),
        image_idxs=np.asarray(idxs, np.int32),
        file_names=file_names,
        urls=urls,
        n_dropped=dropped,
        n_empty=empty,
    )


def build_bundle(
    train_annotations: str,
    val_annotations: str,
    out_dir: str,
    min_count: int = 5,
    max_words: Optional[int] = None,
    max_len: int = MAX_SEQ_LEN,
    truncate: bool = False,
) -> dict:
    """Build and write the caption half of the bundle into ``out_dir``.

    Writes ``coco2014_captions.h5`` (train/val captions + image_idxs),
    ``coco2014_vocab.json``, ``{split}2014_urls.txt`` and
    ``{split}2014_images.txt`` (feature-extraction file lists in
    image-row order, for ``cli.extract --file_list``). Returns a stats
    dict. Feature tables come from the JAX package's ``cli.extract``; rows
    align because both sides order images by ascending COCO image id.
    """
    tr_toks, tr_rows, tr_files, tr_urls = _parse_split(train_annotations)
    va_toks, va_rows, va_files, va_urls = _parse_split(val_annotations)

    word_to_idx = build_vocab(tr_toks, min_count=min_count,
                              max_words=max_words)
    train = _encode_split(tr_toks, tr_rows, word_to_idx, max_len,
                          truncate, tr_files, tr_urls)
    val = _encode_split(va_toks, va_rows, word_to_idx, max_len,
                        truncate, va_files, va_urls)

    os.makedirs(out_dir, exist_ok=True)
    # atomic publish (write_h5): a crash mid-build must not leave a
    # truncated h5 next to a stale-but-valid vocab from a previous run
    write_h5(os.path.join(out_dir, "coco2014_captions.h5"), {
        "train_captions": train.captions, "train_image_idxs": train.image_idxs,
        "val_captions": val.captions, "val_image_idxs": val.image_idxs})

    idx_to_word = [None] * len(word_to_idx)
    for w, i in word_to_idx.items():
        idx_to_word[i] = w
    with atomic_write(os.path.join(out_dir, "coco2014_vocab.json")) as f:
        f.write(json.dumps({"word_to_idx": word_to_idx,
                            "idx_to_word": idx_to_word}).encode())
    for split, b in (("train", train), ("val", val)):
        with atomic_write(
                os.path.join(out_dir, f"{split}2014_urls.txt")) as f:
            f.write("".join(u + "\n" for u in b.urls).encode())
        with atomic_write(
                os.path.join(out_dir, f"{split}2014_images.txt")) as f:
            f.write("".join(n + "\n" for n in b.file_names).encode())

    return {
        "vocab_size": len(word_to_idx),
        "train_captions": int(train.captions.shape[0]),
        "val_captions": int(val.captions.shape[0]),
        "train_images": len(train.file_names),
        "val_images": len(val.file_names),
        "train_dropped": train.n_dropped,
        "val_dropped": val.n_dropped,
        "train_empty": train.n_empty,
        "val_empty": val.n_empty,
    }
