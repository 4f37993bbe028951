"""Corpus preparation (counterpart of the JAX ``embeddings/corpus.py``,
reference utilities.py:361-372)."""

from __future__ import annotations

import re
import unicodedata
from typing import List

from ..data.coco import CocoData

# gensim's PAT_ALPHABETIC: runs of word characters that are not digits
# (letters of any script and underscore; accented tokens survive, as with
# the reference's simple_preprocess(deacc=False) default)
_TOKEN = re.compile(r"(?:(?!\d)\w)+", re.UNICODE)


def simple_preprocess(doc: str, deacc: bool = False, min_len: int = 2,
                      max_len: int = 15) -> List[str]:
    """Lowercase, tokenize, keep tokens of length [min, max]: gensim's
    ``simple_preprocess`` contract, which the reference relies on.
    ``deacc=False`` (gensim's default) keeps accented words intact, so they
    align against the dataset vocabulary instead of falling to the OOV
    path."""
    doc = doc.lower()
    if deacc:
        doc = unicodedata.normalize("NFKD", doc)
        doc = doc.encode("ascii", "ignore").decode("ascii")
    return [t for t in _TOKEN.findall(doc) if min_len <= len(t) <= max_len]


def get_preprocessed_corpus(data: CocoData) -> List[List[str]]:
    """The train and then the val captions, de-tokenized back to word lists
    (every column of a caption, specials and padding included, as the
    reference does)."""
    idx_to_word = data.idx_to_word
    return [simple_preprocess(" ".join(idx_to_word[int(d)] for d in sent))
            for caps in (data.train_captions, data.val_captions) for sent in caps]
