"""ROUGE-L, matching pycocoevalcap's rouge.py.

Per-sentence LCS-based F-measure with beta=1.2; precision/recall take
the max over references; corpus score is the mean over sentences.
"""

from __future__ import annotations

from typing import Dict, List

_BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Classic O(len(a)*len(b)) longest-common-subsequence length."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hypo: str, refs: List[str]) -> float:
    hyp_words = hypo.split()
    prec, rec = [], []
    for ref in refs:
        ref_words = ref.split()
        lcs = _lcs_len(hyp_words, ref_words)
        prec.append(lcs / len(hyp_words) if hyp_words else 0.0)
        rec.append(lcs / len(ref_words) if ref_words else 0.0)
    p, r = max(prec), max(rec)
    if p != 0 and r != 0:
        return ((1 + _BETA**2) * p * r) / (r + _BETA**2 * p)
    return 0.0


def rouge_l(refs: Dict[int, List[str]], hypos: Dict[int, List[str]]) -> float:
    from .native import rouge_scores_native

    native = rouge_scores_native(refs, hypos)  # None -> toolchain absent
    if native is not None:
        return sum(native) / len(native) if native else 0.0
    scores = [rouge_l_sentence(hypos[i][0], refs[i]) for i in hypos]
    return sum(scores) / len(scores) if scores else 0.0
