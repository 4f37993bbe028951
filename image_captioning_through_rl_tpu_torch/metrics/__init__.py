"""Caption evaluation metrics (the port's copy of the JAX package's
``metrics``, which it does not import: that package's ``utils`` loads JAX).

Native Python implementations of the scorers the reference gets from
``pycocoevalcap`` (tylin/coco-caption — reference metrics.py:19-23):
corpus BLEU 1-4, ROUGE-L, CIDEr, and METEOR. BLEU/ROUGE-L/CIDEr follow
the pycocoevalcap algorithms exactly (same smoothing constants, brevity
penalty, tf-idf weighting and length penalty); METEOR is a native
implementation of all four METEOR-1.5 match modules (exact, stem,
synonym, paraphrase) with delta weighting — the synonym/paraphrase
modules activate when the user supplies WordNet / paraphrase-table
files (:mod:`.synonyms`); without them native METEOR is a LOWER BOUND
on the Java tool's number — see :mod:`.meteor`.

The file-level API mirrors the reference: :func:`load_textfiles` /
:func:`score` / :func:`get_singleton_score` (metrics.py:26-91) and the
evaluation-side :func:`calculate_a2c_network_score` (utilities.py:341-358).
"""

from .score import (
    calculate_a2c_network_score,
    get_singleton_score,
    load_text_data,
    load_textfiles,
    score,
)
from .bleu import corpus_bleu
from .rouge import rouge_l
from .cider import cider
from .meteor import meteor
from .synonyms import MeteorResources, ParaphraseTable, SynonymLookup

__all__ = [
    "score",
    "get_singleton_score",
    "load_textfiles",
    "load_text_data",
    "calculate_a2c_network_score",
    "corpus_bleu",
    "rouge_l",
    "cider",
    "meteor",
    "MeteorResources",
    "ParaphraseTable",
    "SynonymLookup",
]
