"""Corpus BLEU, matching pycocoevalcap's BleuScorer numerics.

Specifics reproduced from bleu_scorer.py (tylin/coco-caption):
  * corpus-level clipped n-gram counts with ``tiny``/``small`` smoothing
    (correct + 1e-15) / (guess + 1e-9);
  * BLEU_k is the geometric mean of p_1..p_k;
  * the "closest" reference length per segment (ties -> the shorter);
  * brevity penalty exp(1 - reflen/testlen) when testlen < reflen.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(tuple(words[i : i + n]) for i in range(len(words) - n + 1))


def corpus_bleu(refs: Dict[int, List[str]], hypos: Dict[int, List[str]], max_n: int = 4) -> List[float]:
    """BLEU_1..BLEU_max_n over a corpus of tokenized-by-whitespace strings.

    ``refs[i]`` is a list of reference sentences for item ``i``;
    ``hypos[i]`` a singleton list with the hypothesis.
    """
    correct = [0] * max_n
    guess = [0] * max_n
    testlen = 0
    reflen = 0

    for idx in hypos:
        hyp_words = hypos[idx][0].split()
        ref_words_list = [r.split() for r in refs[idx]]
        testlen += len(hyp_words)

        # closest reference length; ties pick the shorter ref
        lens = sorted((abs(len(r) - len(hyp_words)), len(r)) for r in ref_words_list)
        reflen += lens[0][1]

        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp_words, n)
            max_ref = Counter()
            for r in ref_words_list:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            guess[n - 1] += max(0, len(hyp_words) - n + 1)
            correct[n - 1] += sum(min(c, max_ref[ng]) for ng, c in hyp_counts.items())

    return bleu_from_stats(correct, guess, testlen, reflen, max_n)


def bleu_from_stats(correct: Sequence[int], guess: Sequence[int],
                    testlen: float, reflen: float, max_n: int = 4) -> List[float]:
    """Combine corpus accumulators into BLEU_1..max_n — the ONE copy of
    the smoothing/geometric-mean/brevity-penalty recipe, shared by the
    pure-Python scorer above and the native C++ stats kernel
    (metrics/native.py) so the two can never drift."""
    bleus = []
    running = 1.0
    # pycocoevalcap's exact brevity-penalty ratio (bleu_scorer.py):
    # tiny in the numerator keeps an empty hypothesis corpus at BLEU 0
    # instead of dividing by zero in 1/ratio
    ratio = (float(testlen) + _TINY) / (float(reflen) + _SMALL)
    for n in range(max_n):
        p_n = (float(correct[n]) + _TINY) / (float(guess[n]) + _SMALL)
        running *= p_n
        b = running ** (1.0 / (n + 1))
        if ratio < 1.0:
            b *= pow(2.718281828459045, 1.0 - 1.0 / ratio)
        bleus.append(b)
    return bleus
