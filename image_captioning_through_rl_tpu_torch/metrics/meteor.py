"""METEOR (native implementation of the METEOR-1.5 scheme: exact, stem,
synonym and paraphrase match modules, delta weighting, METEOR-1.5
English parameters).

pycocoevalcap's METEOR shells out to the Java METEOR-1.5 jar (reference
metrics.py:23); that binary and its resources are not portable
dependencies, so this is a from-scratch implementation of the METEOR
scheme:

  * match modules **exact** (weight 1.0), **stem** (weight 0.6, Porter
    stemmer — :mod:`.porter`), **synonym** (weight 0.8, shared-synset
    test) and **paraphrase** (weight 0.6, phrase-table lookup), applied
    like the Java tool: a hypothesis word may align to a reference word
    through the highest-weight module whose test passes, and phrase
    spans may align through the paraphrase table. The synonym and
    paraphrase modules need external resources (WordNet, a paraphrase
    table) that cannot ship with this package — they activate when the
    user supplies files (:mod:`.synonyms`: ``ICRL_METEOR_SYNONYMS`` /
    ``ICRL_METEOR_PARAPHRASES`` or explicit :class:`MeteorResources`)
    and are inert otherwise;
  * alignment resolution order: maximum matched-word count first, then
    MINIMUM chunk count, then maximum module-weight sum (exact matches
    preferred over synonym over stem) — searched exactly by DFS with
    bipartite-matching feasibility bounds (captions are <= 17 tokens;
    METEOR-1.5 itself approximates this with a beam of 40). When
    paraphrase spans are in play the search runs over span matches with
    suffix-bound pruning and a node budget (beyond the budget the best
    alignment found so far is kept — again beam-like, and only
    reachable on adversarial repetitive inputs);
  * **content/function-word weighting** (the METEOR-1.5 ``delta``
    parameter): each word contributes ``delta`` to precision/recall
    mass if it is a content word and ``1 - delta`` if it is a function
    word (:mod:`.function_words`), on the hypothesis side for P and the
    reference side for R (Denkowski & Lavie 2014, eq. 1-2);
  * METEOR-1.5 English ranking parameters: alpha=0.85, beta=0.2,
    gamma=0.6, delta=0.75.

Remaining gaps vs the Java tool (documented, unverifiable without it):
without user-supplied synonym/paraphrase resources those two modules
never fire, and the shipped function-word list is a curated
closed-class list rather than the tool's corpus-frequency-derived
resource. Missing modules can only REMOVE match possibilities, so
resource-free scores track below the full-resource configuration in
practice — but not as a strict bound: the alignment objective ranks
coverage, then chunks, then module weight, so an added paraphrase span
can displace a weight-1.0 exact match by forming fewer chunks and
(rarely, on repetitive phrasing — ~3% of adversarial random cases
measured) LOWER the delta-weighted score. Treat scores from different
module configurations as non-comparable, and do not compare any of
them against published numbers from the Java tool. The reference's
shipped results do not include METEOR at all (BASELINE.md), so no
parity target exists.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .function_words import is_function_word
from .porter import porter_stem
from .synonyms import MeteorResources, default_resources

_ALPHA = 0.85
_BETA = 0.2
_GAMMA = 0.6
_DELTA = 0.75
_W_EXACT = 1.0
_W_STEM = 0.6
_W_SYN = 0.8
_W_PARA = 0.6

# span-DFS node budget; only adversarial repetitive inputs WITH
# paraphrase-table hits can reach it (see module docstring)
_SPAN_NODE_BUDGET = 200_000


def _max_matching(edges: List[List[int]], n_right: int, left_alive, right_alive) -> int:
    """Maximum bipartite matching size (augmenting paths) over the
    still-alive subgraph. ``edges[i]`` lists right nodes of left i."""
    match_r = [-1] * n_right

    def augment(i, seen):
        for j in edges[i]:
            if right_alive[j] and not seen[j]:
                seen[j] = True
                if match_r[j] == -1 or augment(match_r[j], seen):
                    match_r[j] = i
                    return True
        return False

    size = 0
    for i, alive in enumerate(left_alive):
        if alive and augment(i, [False] * n_right):
            size += 1
    return size


def _word_pair_weight(hw: str, rw: str, hs: str, rs: str, syn) -> Optional[float]:
    """Highest-weight word-level module matching (hw, rw), or None.
    Module weights: exact 1.0 > synonym 0.8 > stem 0.6."""
    if hw == rw:
        return _W_EXACT
    if syn is not None and syn.are_synonyms(hw, rw):
        return _W_SYN
    if hs == rs:
        return _W_STEM
    return None


def _align(
    hyp: List[str], ref: List[str], syn=None
) -> Tuple[int, int, float, List[Tuple[int, int, float]]]:
    """Word-level METEOR alignment (exact + stem + optional synonym
    modules).

    Returns ``(matches, chunks, weighted_matches, pairs)`` for the
    alignment that maximizes matches, then minimizes chunks, then
    maximizes the module-weight sum; ``pairs`` are the chosen
    ``(hyp_i, ref_j, module_weight)`` matches (for the delta-weighted
    P/R computation).
    """
    n, m = len(hyp), len(ref)
    hyp_stem = [porter_stem(w) for w in hyp]
    ref_stem = [porter_stem(w) for w in ref]

    # candidate edges + per-pair module weight (best module wins)
    edges: List[List[int]] = [[] for _ in range(n)]
    weight: Dict[Tuple[int, int], float] = {}
    for i in range(n):
        for j in range(m):
            w = _word_pair_weight(hyp[i], ref[j], hyp_stem[i], ref_stem[j], syn)
            if w is not None:
                edges[i].append(j)
                weight[(i, j)] = w

    left_all = [True] * n
    right_alive = [True] * m
    total = _max_matching(edges, m, left_all, right_alive)
    if total == 0:
        return 0, 0, 0.0, []

    best = [total + 1, -1.0, []]  # (min chunks, max weight, its pairs)
    trail: List[Tuple[int, int]] = []

    def dfs(i, matched, chunks, wsum, last_i, last_j):
        if chunks > best[0]:  # chunk count only grows
            return
        if chunks == best[0] and wsum + (total - matched) * _W_EXACT <= best[1]:
            return  # cannot beat the incumbent weight at equal chunks
        if matched == total:
            if chunks < best[0] or (chunks == best[0] and wsum > best[1]):
                best[0], best[1], best[2] = chunks, wsum, list(trail)
            return
        if i == n:
            return
        # feasibility: can the remaining graph still reach max cardinality?
        left_alive = [False] * i + [True] * (n - i)
        if matched + _max_matching(edges, m, left_alive, right_alive) < total:
            return

        cands = edges[i]
        if last_i == i - 1 and (last_j + 1) in cands and right_alive[last_j + 1]:
            cands = [last_j + 1] + [j for j in cands if j != last_j + 1]
        for j in cands:
            if not right_alive[j]:
                continue
            extend = last_i == i - 1 and j == last_j + 1
            right_alive[j] = False
            trail.append((i, j))
            dfs(i + 1, matched + 1, chunks + (0 if extend else 1),
                wsum + weight[(i, j)], i, j)
            trail.pop()
            right_alive[j] = True
        dfs(i + 1, matched, chunks, wsum, last_i, last_j)

    dfs(0, 0, 0, 0.0, -2, -2)
    return total, best[0], best[1], [(i, j, weight[(i, j)]) for i, j in best[2]]


# one span match: (hyp_start, hyp_len, ref_start, ref_len, module_weight)
Span = Tuple[int, int, int, int, float]


def _phrase_candidates(hyp: List[str], ref: List[str], para) -> List[Span]:
    """Paraphrase-table span matches between the two sentences. Table
    entries are lowercase-normalized (synonyms.py), so span keys and
    queries lowercase too — matching is case-insensitive like the stem
    and synonym modules."""
    n, m = len(hyp), len(ref)
    L = para.max_len
    out: List[Span] = []
    ref_spans: Dict[Tuple[str, ...], List[Tuple[int, int]]] = {}
    for j in range(m):
        for lj in range(1, min(L, m - j) + 1):
            key = tuple(w.lower() for w in ref[j:j + lj])
            ref_spans.setdefault(key, []).append((j, lj))
    for i in range(n):
        for li in range(1, min(L, n - i) + 1):
            for b in para.paraphrases_of(tuple(hyp[i:i + li])):
                for j, lj in ref_spans.get(b, ()):
                    out.append((i, li, j, lj, _W_PARA))
    return out


def _align_spans(
    hyp: List[str], ref: List[str], syn, phrase_cands: List[Span]
) -> Tuple[int, int, int, List[Span]]:
    """Span-level METEOR alignment (all four modules; used only when
    the paraphrase table produced at least one span candidate).

    Returns ``(hyp_covered, ref_covered, chunks, matches)`` maximizing
    covered-word count (hyp+ref), then minimizing chunks, then
    maximizing the module-weight word mass. Exact for caption-length
    inputs under the node budget; beyond it, best-found (beam-like).
    """
    n, m = len(hyp), len(ref)
    hyp_stem = [porter_stem(w) for w in hyp]
    ref_stem = [porter_stem(w) for w in ref]

    by_start: List[List[Span]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(m):
            w = _word_pair_weight(hyp[i], ref[j], hyp_stem[i], ref_stem[j], syn)
            if w is not None:
                by_start[i].append((i, 1, j, 1, w))
    for c in phrase_cands:
        by_start[c[0]].append(c)

    # optimistic suffix bounds ignoring ref-side conflicts: coverage
    # mass cb[i] and weight mass wb[i] reachable from hyp position i
    cb = [0.0] * (n + 1)
    wb = [0.0] * (n + 1)
    for i in range(n - 1, -1, -1):
        cb[i], wb[i] = cb[i + 1], wb[i + 1]
        for (_, li, _, lj, w) in by_start[i]:
            cb[i] = max(cb[i], li + lj + cb[i + li])
            wb[i] = max(wb[i], w * (li + lj) / 2.0 + wb[i + li])

    best = [0.0, 1 << 30, -1.0, []]  # (cov, chunks, wmass, matches)
    trail: List[Span] = []
    nodes = [0]

    def dfs(i, used_mask, cov, chunks, wmass, last_h_end, last_r_end):
        nodes[0] += 1
        if nodes[0] > _SPAN_NODE_BUDGET:
            return
        if i >= n:
            if (cov, -chunks, wmass) > (best[0], -best[1], best[2]):
                best[0], best[1], best[2], best[3] = cov, chunks, wmass, list(trail)
            return
        # bound: even a conflict-free completion cannot beat the incumbent
        key = (cov + cb[i], -chunks, wmass + wb[i])
        if key < (best[0], -best[1], best[2]):
            return
        for c in by_start[i]:
            _, li, j, lj, w = c
            span_mask = ((1 << lj) - 1) << j
            if used_mask & span_mask:
                continue
            extend = last_h_end == i and last_r_end == j
            trail.append(c)
            dfs(i + li, used_mask | span_mask, cov + li + lj,
                chunks + (0 if extend else 1), wmass + w * (li + lj) / 2.0,
                i + li, j + lj)
            trail.pop()
        dfs(i + 1, used_mask, cov, chunks, wmass, last_h_end, last_r_end)

    dfs(0, 0, 0.0, 0, 0.0, -1, -1)
    matches = best[3]
    hyp_cov = sum(c[1] for c in matches)
    ref_cov = sum(c[3] for c in matches)
    return hyp_cov, ref_cov, (best[1] if matches else 0), matches


def _delta_weight(word: str) -> float:
    return _DELTA if not is_function_word(word) else 1.0 - _DELTA


def _delta_mass(words: List[str]) -> float:
    """Total content/function-weighted mass of a token list."""
    return sum(_delta_weight(w) for w in words)


def meteor_sentence(
    hypo: str, refs: List[str], resources: Optional[MeteorResources] = None
) -> float:
    res = default_resources() if resources is None else resources
    syn, para = res.synonyms, res.paraphrases
    hyp = hypo.split()
    best = 0.0
    for ref_str in refs:
        ref = ref_str.split()
        if not hyp or not ref:
            continue
        phrase_cands = (
            _phrase_candidates(hyp, ref, para)
            if para is not None and para.max_len else [])
        if phrase_cands:
            hyp_cov, ref_cov, chunks, matches = _align_spans(
                hyp, ref, syn, phrase_cands)
        else:
            n_pairs, chunks, _, pairs = _align(hyp, ref, syn)
            hyp_cov = ref_cov = n_pairs
            matches = [(i, 1, j, 1, w) for i, j, w in pairs]
        if not matches:
            continue
        # delta-weighted precision/recall (Denkowski & Lavie 2014 eq. 1):
        # a matched word contributes its module weight scaled by delta
        # (content) or 1-delta (function) — judged on the hypothesis
        # side for P and the reference side for R
        p_num = r_num = 0.0
        for i, li, j, lj, w in matches:
            p_num += w * sum(_delta_weight(hyp[i + t]) for t in range(li))
            r_num += w * sum(_delta_weight(ref[j + t]) for t in range(lj))
        p = p_num / _delta_mass(hyp)
        r = r_num / _delta_mass(ref)
        if p == 0.0 or r == 0.0:
            continue
        fmean = p * r / (_ALPHA * p + (1 - _ALPHA) * r)
        m_avg = (hyp_cov + ref_cov) / 2.0
        penalty = _GAMMA * (chunks / m_avg) ** _BETA
        best = max(best, fmean * (1.0 - penalty))
    return best


def meteor(
    refs: Dict[int, List[str]], hypos: Dict[int, List[str]],
    resources: Optional[MeteorResources] = None,
) -> float:
    res = default_resources() if resources is None else resources
    if res.synonyms is None and (res.paraphrases is None
                                 or not res.paraphrases.max_len):
        # the default (resource-free) configuration has a native C++
        # aligner — a faithful port of _align, identical scores
        from .native import meteor_scores_native

        native = meteor_scores_native(refs, hypos)  # None -> toolchain absent
        if native is not None:
            return sum(native) / len(native) if native else 0.0
    scores = [meteor_sentence(hypos[i][0], refs[i], res) for i in hypos]
    return sum(scores) / len(scores) if scores else 0.0
