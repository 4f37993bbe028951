"""CIDEr, matching pycocoevalcap's cider_scorer.py.

tf-idf weighted n-gram (n=1..4) cosine similarity with a Gaussian
length penalty (sigma=6), document frequencies computed over the
reference corpus, scaled by 10 and averaged over n and references.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List

_N = 4
_SIGMA = 6.0


def _counts(words: List[str]):
    out = []
    for n in range(1, _N + 1):
        out.append(Counter(tuple(words[i : i + n]) for i in range(len(words) - n + 1)))
    return out


def cider(refs: Dict[int, List[str]], hypos: Dict[int, List[str]]) -> float:
    if not hypos:
        return 0.0  # like the other scorers; log(0 images) is undefined
    ids = list(hypos.keys())
    ref_counts = {i: [_counts(r.split()) for r in refs[i]] for i in ids}
    hyp_counts = {i: _counts(hypos[i][0].split()) for i in ids}

    # document frequency: each unique ngram counted once per image's refs
    df = defaultdict(float)
    for i in ids:
        seen = set()
        for counts in ref_counts[i]:
            for n in range(_N):
                seen.update(counts[n].keys())
        for ng in seen:
            df[ng] += 1.0

    log_n_images = math.log(float(len(ids)))

    def vec_norm(counts):
        vec = [dict() for _ in range(_N)]
        norm = [0.0] * _N
        for n in range(_N):
            for ng, tf in counts[n].items():
                w = float(tf) * (log_n_images - math.log(max(1.0, df[ng])))
                vec[n][ng] = w
                norm[n] += w * w
            norm[n] = math.sqrt(norm[n])
        return vec, norm

    scores = []
    for i in ids:
        hyp_words = hypos[i][0].split()
        h_vec, h_norm = vec_norm(hyp_counts[i])
        total = [0.0] * _N
        for ref_str, r_counts in zip(refs[i], ref_counts[i]):
            r_words = ref_str.split()
            r_vec, r_norm = vec_norm(r_counts)
            delta = float(len(hyp_words) - len(r_words))
            for n in range(_N):
                val = 0.0
                for ng, w in h_vec[n].items():
                    val += min(w, r_vec[n].get(ng, 0.0)) * r_vec[n].get(ng, 0.0)
                if h_norm[n] != 0 and r_norm[n] != 0:
                    val /= h_norm[n] * r_norm[n]
                val *= math.exp(-(delta**2) / (2 * _SIGMA**2))
                total[n] += val
        score_avg = sum(total) / _N / len(refs[i]) * 10.0
        scores.append(score_avg)
    return sum(scores) / len(scores) if scores else 0.0
