"""ctypes bindings over the native fastmetrics library.

Tokenization/interning happens here (whitespace split, word -> int32
id); the C++ side counts n-grams over flat id arrays. Used by
:func:`.score.score` when the toolchain is available; numerics are
identical to the pure-Python scorers (asserted by tests and by the
golden reference-dump parity test).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np

from ..native import load_fastmetrics



def _intern(refs: Dict[int, List[str]], hypos: Dict[int, List[str]]):
    """Flatten corpora into (tokens, offsets) id arrays + ref grouping
    for the n-gram kernels (BLEU/CIDEr). Those kernels pack 16 bits per
    token into 64-bit n-gram keys, so a vocab >= 2^16 returns None (the
    caller falls back to Python). An empty reference group raises like
    the pure-Python scorers — the C++ kernels would otherwise divide by
    nrefs=0 (CIDEr NaN) or feed best_len=-1 into BLEU's brevity penalty."""
    (hyp_tok, hyp_off, ref_tok, ref_off, group_off, num, _, _) = _flatten_words(
        refs, hypos, require_refs=True, with_meteor_tables=False)
    n_vocab = int(max(hyp_tok.max(initial=-1), ref_tok.max(initial=-1))) + 1
    if n_vocab >= 1 << 16:
        return None
    return hyp_tok, hyp_off, ref_tok, ref_off, group_off, num


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def corpus_bleu_native(
    refs: Dict[int, List[str]], hypos: Dict[int, List[str]], max_n: int = 4
) -> Optional[List[float]]:
    """Native corpus BLEU; None when unavailable (caller falls back)."""
    lib = load_fastmetrics()
    if lib is None or max_n != 4 or not hypos:
        return None
    interned = _intern(refs, hypos)
    if interned is None:
        return None
    hyp_tok, hyp_off, ref_tok, ref_off, group_off, num = interned
    correct = np.zeros(4, np.int64)
    guess = np.zeros(4, np.int64)
    testlen = np.zeros(1, np.int64)
    reflen = np.zeros(1, np.int64)
    lib.bleu_stats(
        _ptr(hyp_tok, ctypes.c_int32), _ptr(hyp_off, ctypes.c_int64), num,
        _ptr(ref_tok, ctypes.c_int32), _ptr(ref_off, ctypes.c_int64),
        _ptr(group_off, ctypes.c_int64),
        _ptr(correct, ctypes.c_int64), _ptr(guess, ctypes.c_int64),
        _ptr(testlen, ctypes.c_int64), _ptr(reflen, ctypes.c_int64),
    )
    # the C++ side only accumulates stats; the smoothing/geomean/brevity
    # recipe lives in ONE place (bleu.bleu_from_stats)
    from .bleu import bleu_from_stats

    return bleu_from_stats(correct, guess, float(testlen[0]), float(reflen[0]))


def _flatten_words(refs: Dict[int, List[str]], hypos: Dict[int, List[str]],
                   require_refs: bool, with_meteor_tables: bool):
    """The single corpus-flattening walk every native kernel shares —
    interning, ordering, offsets and empty-group semantics live here so
    BLEU/CIDEr (via :func:`_intern`) and ROUGE/METEOR can never
    desynchronize. Words intern as exact strings; ``require_refs``
    raises on an empty reference group (the scorers that divide by it);
    ``with_meteor_tables`` also builds the per-word-id Porter-stem-id
    and delta-mass tables METEOR's stem and content/function-word
    modules need."""
    vocab: Dict[str, int] = {}
    stem_vocab: Dict[str, int] = {}
    stem_ids: List[int] = []
    deltas: List[float] = []
    if with_meteor_tables:
        from .function_words import is_function_word
        from .meteor import _DELTA
        from .porter import porter_stem

    def wid(w: str) -> int:
        i = vocab.get(w)
        if i is None:
            i = vocab[w] = len(vocab)
            if with_meteor_tables:
                s = porter_stem(w)
                stem_ids.append(stem_vocab.setdefault(s, len(stem_vocab)))
                deltas.append(_DELTA if not is_function_word(w) else 1.0 - _DELTA)
        return i

    order = list(hypos.keys())
    hyp_tok: List[int] = []
    hyp_off = [0]
    ref_tok: List[int] = []
    ref_off = [0]
    group_off = [0]
    for i in order:
        if require_refs and not refs.get(i):
            # the pure-Python ROUGE raises here (max() of an empty list)
            raise ValueError(f"empty reference group for id {i!r}")
        hyp_tok.extend(wid(w) for w in hypos[i][0].split())
        hyp_off.append(len(hyp_tok))
        for r in refs[i]:
            ref_tok.extend(wid(w) for w in r.split())
            ref_off.append(len(ref_tok))
        group_off.append(group_off[-1] + len(refs[i]))
    c = lambda a, t: np.ascontiguousarray(np.asarray(a, dtype=t))  # noqa: E731
    return (
        c(hyp_tok, np.int32), c(hyp_off, np.int64),
        c(ref_tok, np.int32), c(ref_off, np.int64), c(group_off, np.int64),
        len(order), c(stem_ids, np.int32), c(deltas, np.float64),
    )


def rouge_scores_native(
    refs: Dict[int, List[str]], hypos: Dict[int, List[str]]
) -> Optional[List[float]]:
    """Per-sentence native ROUGE-L; None when the library is
    unavailable (caller falls back to the pure-Python scorer)."""
    lib = load_fastmetrics()
    if lib is None:
        return None
    if not hypos:
        return []
    hyp_tok, hyp_off, ref_tok, ref_off, group_off, num, _, _ = _flatten_words(
        refs, hypos, require_refs=True, with_meteor_tables=False)
    scores = np.zeros(num, np.float64)
    lib.rouge_scores(
        _ptr(hyp_tok, ctypes.c_int32), _ptr(hyp_off, ctypes.c_int64), num,
        _ptr(ref_tok, ctypes.c_int32), _ptr(ref_off, ctypes.c_int64),
        _ptr(group_off, ctypes.c_int64),
        _ptr(scores, ctypes.c_double),
    )
    return scores.tolist()


def meteor_scores_native(
    refs: Dict[int, List[str]], hypos: Dict[int, List[str]]
) -> Optional[List[float]]:
    """Per-sentence native METEOR (exact + stem modules with delta
    weighting — the default, resource-free configuration); None when the
    library is unavailable. The caller must ensure the synonym and
    paraphrase modules are inactive — those need the Python aligner."""
    lib = load_fastmetrics()
    if lib is None:
        return None
    if not hypos:
        return []
    (hyp_tok, hyp_off, ref_tok, ref_off, group_off, num,
     stem_ids, deltas) = _flatten_words(
        refs, hypos, require_refs=False, with_meteor_tables=True)
    scores = np.zeros(num, np.float64)
    lib.meteor_scores(
        _ptr(hyp_tok, ctypes.c_int32), _ptr(hyp_off, ctypes.c_int64), num,
        _ptr(ref_tok, ctypes.c_int32), _ptr(ref_off, ctypes.c_int64),
        _ptr(group_off, ctypes.c_int64),
        _ptr(stem_ids, ctypes.c_int32), _ptr(deltas, ctypes.c_double),
        _ptr(scores, ctypes.c_double),
    )
    return scores.tolist()


def cider_native(
    refs: Dict[int, List[str]], hypos: Dict[int, List[str]]
) -> Optional[float]:
    lib = load_fastmetrics()
    if lib is None or not hypos:
        return None
    interned = _intern(refs, hypos)
    if interned is None:
        return None
    hyp_tok, hyp_off, ref_tok, ref_off, group_off, num = interned
    scores = np.zeros(num, np.float64)
    lib.cider_scores(
        _ptr(hyp_tok, ctypes.c_int32), _ptr(hyp_off, ctypes.c_int64), num,
        _ptr(ref_tok, ctypes.c_int32), _ptr(ref_off, ctypes.c_int64),
        _ptr(group_off, ctypes.c_int64),
        _ptr(scores, ctypes.c_double),
    )
    return float(scores.mean())
