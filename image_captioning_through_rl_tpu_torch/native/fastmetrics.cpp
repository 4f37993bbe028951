// fastmetrics: native scoring kernels for caption evaluation.
//
// The eval path scores tens of thousands of caption pairs (reference
// utilities.py:341-358 over 40k val lines); the Python inner loops in
// metrics/{bleu,cider,rouge,meteor}.py dominate that wall time. This
// library implements the same statistics over pre-interned token-id
// sequences:
//
//   * corpus BLEU accumulators (clipped n-gram matches, guesses,
//     closest reference lengths) — combined into BLEU_k in Python;
//   * CIDEr (tf-idf weighted n-gram cosine with Gaussian length
//     penalty, sigma=6, x10) — full scores returned per image;
//   * ROUGE-L per-sentence LCS F-measure (beta=1.2, max over refs);
//   * METEOR per-sentence scores for the default exact+stem module
//     configuration — a faithful port of metrics/meteor.py::_align
//     (max matches, then min chunks, then max module-weight sum, with
//     identical candidate ordering so tie-broken alignments — hence
//     the delta-weighted P/R masses — are identical to the Python
//     aligner). Stemming and the content/function-word split happen
//     Python-side per unique word and arrive as per-word-id tables.
//     The synonym/paraphrase modules stay in Python (resource-gated;
//     the wrapper falls back when they are active).
//
// Sentences arrive as flat int32 token-id arrays with offsets (see
// native.py). N-grams are packed into 64-bit keys (16 bits per token,
// vocab < 65536 asserted Python-side) and counted in open-address hash
// maps, so a 40k-pair corpus scores in milliseconds.
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kMaxN = 4;

using Key = uint64_t;
using CountMap = std::unordered_map<Key, int32_t>;
using WeightMap = std::unordered_map<Key, double>;

// Pack up to 4 token ids (16 bits each) into a key. Token ids must be
// < 2^16 (checked by the Python wrapper). All maps are per-n, so keys
// of different orders never share a map and need no disambiguation.
inline Key pack(const int32_t* toks, int n) {
  Key k = 0;
  for (int i = 0; i < n; ++i) {
    k = (k << 16) | static_cast<Key>(toks[i] & 0xffff);
  }
  return k;
}

// ---------------------------------------------------------------------------
// Small-vector n-gram counting. Captions are <= ~20 tokens, so a
// per-sentence hash map costs more in allocation and cache misses than
// sorting a handful of keys; key-sorted vectors also turn every
// intersection/union below into a linear two-pointer merge. Buffers are
// reused across sentences (clear() keeps capacity), so the steady state
// allocates nothing.

using KeyCount = std::pair<Key, int32_t>;
using KeyVec = std::vector<KeyCount>;

inline bool key_less(const KeyCount& a, const KeyCount& b) {
  return a.first < b.first;
}

// Order-n n-gram counts as a key-sorted, deduplicated (key, count) vector.
void count_ngrams_vec(const int32_t* toks, int len, int n, KeyVec& out) {
  out.clear();
  for (int i = 0; i + n <= len; ++i) out.emplace_back(pack(toks + i, n), 1);
  std::sort(out.begin(), out.end(), key_less);
  size_t w = 0;
  for (size_t r = 0; r < out.size(); ++r) {
    if (w > 0 && out[w - 1].first == out[r].first) ++out[w - 1].second;
    else out[w++] = out[r];
  }
  out.resize(w);
}

// dst = per-key elementwise max of dst and src (both key-sorted).
void max_merge(KeyVec& dst, const KeyVec& src, KeyVec& scratch) {
  scratch.clear();
  size_t a = 0, b = 0;
  while (a < dst.size() && b < src.size()) {
    if (dst[a].first < src[b].first) scratch.push_back(dst[a++]);
    else if (src[b].first < dst[a].first) scratch.push_back(src[b++]);
    else {
      scratch.emplace_back(dst[a].first,
                           dst[a].second > src[b].second ? dst[a].second
                                                         : src[b].second);
      ++a;
      ++b;
    }
  }
  for (; a < dst.size(); ++a) scratch.push_back(dst[a]);
  for (; b < src.size(); ++b) scratch.push_back(src[b]);
  dst.swap(scratch);
}

struct Corpus {
  const int32_t* tokens;
  const int64_t* offsets;  // [num + 1]
  int64_t num;
  const int32_t* sent(int64_t i, int* len) const {
    *len = static_cast<int>(offsets[i + 1] - offsets[i]);
    return tokens + offsets[i];
  }
};

// ---------------------------------------------------------------------------
// METEOR word-level alignment (exact + stem modules), port of
// metrics/meteor.py::_align / meteor_sentence. Kept structurally
// identical to the Python search (same pruning bounds, same candidate
// ordering) so equal-(matches, chunks, weight) ties resolve to the
// same alignment and the delta-weighted P/R numerators match bitwise.

namespace meteor {

constexpr double kWExact = 1.0;
constexpr double kWStem = 0.6;
constexpr double kAlpha = 0.85;   // METEOR-1.5 English parameters
constexpr double kBeta = 0.2;
constexpr double kGamma = 0.6;

// Maximum bipartite matching (augmenting paths) over lefts >= left_start
// and still-alive rights — the DFS feasibility bound.
struct Matcher {
  const std::vector<std::vector<int>>& edges;
  const std::vector<char>& right_alive;
  std::vector<int> match_r;
  std::vector<char> seen;
  Matcher(const std::vector<std::vector<int>>& e, int m, const std::vector<char>& ra)
      : edges(e), right_alive(ra), match_r(m, -1), seen(m, 0) {}
  bool augment(int i) {
    for (int j : edges[i]) {
      if (right_alive[j] && !seen[j]) {
        seen[j] = 1;
        if (match_r[j] == -1 || augment(match_r[j])) {
          match_r[j] = i;
          return true;
        }
      }
    }
    return false;
  }
  int run(int left_start, int n) {
    int size = 0;
    for (int i = left_start; i < n; ++i) {
      std::fill(seen.begin(), seen.end(), 0);
      if (augment(i)) ++size;
    }
    return size;
  }
};

struct Aligner {
  int n = 0, m = 0;
  std::vector<std::vector<int>> edges;   // per hyp word: matching ref indices
  std::vector<double> weight;            // n*m module weights, -1 = no edge
  std::vector<char> right_alive;
  int total = 0;
  int best_chunks = 0;
  double best_wsum = 0.0;
  std::vector<std::pair<int, int>> best_pairs, trail;

  double edge_w(int i, int j) const { return weight[(size_t)i * m + j]; }

  void dfs(int i, int matched, int chunks, double wsum, int last_i, int last_j) {
    if (chunks > best_chunks) return;  // chunk count only grows
    if (chunks == best_chunks && wsum + (total - matched) * kWExact <= best_wsum)
      return;  // cannot beat the incumbent weight at equal chunks
    if (matched == total) {
      if (chunks < best_chunks || (chunks == best_chunks && wsum > best_wsum)) {
        best_chunks = chunks;
        best_wsum = wsum;
        best_pairs = trail;
      }
      return;
    }
    if (i == n) return;
    // feasibility: can the remaining graph still reach max cardinality?
    Matcher fm(edges, m, right_alive);
    if (matched + fm.run(i, n) < total) return;

    std::vector<int> cands = edges[i];
    if (last_i == i - 1 && last_j + 1 < m && edge_w(i, last_j + 1) >= 0.0 &&
        right_alive[last_j + 1]) {
      // try the chunk-extending candidate first (mirrors the Python reorder)
      std::vector<int> re;
      re.reserve(cands.size());
      re.push_back(last_j + 1);
      for (int j : cands)
        if (j != last_j + 1) re.push_back(j);
      cands.swap(re);
    }
    for (int j : cands) {
      if (!right_alive[j]) continue;
      bool extend = last_i == i - 1 && j == last_j + 1;
      right_alive[j] = 0;
      trail.emplace_back(i, j);
      dfs(i + 1, matched + 1, chunks + (extend ? 0 : 1), wsum + edge_w(i, j), i, j);
      trail.pop_back();
      right_alive[j] = 1;
    }
    dfs(i + 1, matched, chunks, wsum, last_i, last_j);  // leave hyp word i unmatched
  }

  // One hypothesis/reference pair. stem[id] maps a word id to its Porter
  // stem id; delta[id] is the content/function mass (0.75 / 0.25).
  // Returns the METEOR segment score, or -1 when the pair contributes
  // nothing (no matches, or zero P/R) — the caller skips it like the
  // Python `continue`.
  double score(const int32_t* hyp, int hlen, const int32_t* ref, int rlen,
               const int32_t* stem, const double* delta) {
    n = hlen;
    m = rlen;
    edges.assign(n, {});
    weight.assign((size_t)n * m, -1.0);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < m; ++j) {
        double w = -1.0;
        if (hyp[i] == ref[j]) w = kWExact;                  // exact module
        else if (stem[hyp[i]] == stem[ref[j]]) w = kWStem;  // stem module
        if (w >= 0.0) {
          edges[i].push_back(j);
          weight[(size_t)i * m + j] = w;
        }
      }
    right_alive.assign(m, 1);
    Matcher fm(edges, m, right_alive);
    total = fm.run(0, n);
    if (total == 0) return -1.0;
    best_chunks = total + 1;
    best_wsum = -1.0;
    best_pairs.clear();
    trail.clear();
    dfs(0, 0, 0, 0.0, -2, -2);

    // delta-weighted precision/recall (metrics/meteor.py meteor_sentence)
    double p_num = 0.0, r_num = 0.0;
    for (const auto& pr : best_pairs) {
      double w = edge_w(pr.first, pr.second);
      p_num += w * delta[hyp[pr.first]];
      r_num += w * delta[ref[pr.second]];
    }
    double hyp_mass = 0.0, ref_mass = 0.0;
    for (int i = 0; i < n; ++i) hyp_mass += delta[hyp[i]];
    for (int j = 0; j < m; ++j) ref_mass += delta[ref[j]];
    double p = p_num / hyp_mass;
    double r = r_num / ref_mass;
    if (p == 0.0 || r == 0.0) return -1.0;
    double fmean = p * r / (kAlpha * p + (1.0 - kAlpha) * r);
    double m_avg = (double)(total + total) / 2.0;  // hyp_cov == ref_cov == total
    double penalty = kGamma * std::pow((double)best_chunks / m_avg, kBeta);
    return fmean * (1.0 - penalty);
  }
};

}  // namespace meteor

}  // namespace

extern "C" {

// Corpus BLEU accumulators. refs are grouped per hypothesis by
// ref_group_offsets: hypothesis i has refs [ref_group_offsets[i],
// ref_group_offsets[i+1]) in the refs corpus.
//
// Outputs: correct[4], guess[4], and {testlen,reflen} totals.
void bleu_stats(const int32_t* hyp_tokens, const int64_t* hyp_offsets, int64_t num,
                const int32_t* ref_tokens, const int64_t* ref_offsets,
                const int64_t* ref_group_offsets,
                int64_t* correct, int64_t* guess,
                int64_t* testlen_out, int64_t* reflen_out) {
  Corpus hyps{hyp_tokens, hyp_offsets, num};
  Corpus refs{ref_tokens, ref_offsets, 0};
  int64_t testlen = 0, reflen = 0;
  std::memset(correct, 0, kMaxN * sizeof(int64_t));
  std::memset(guess, 0, kMaxN * sizeof(int64_t));

  KeyVec hyp_v[kMaxN], max_ref[kMaxN], rv, scratch;
  for (int64_t i = 0; i < num; ++i) {
    int hlen;
    const int32_t* h = hyps.sent(i, &hlen);
    testlen += hlen;

    for (int n = 0; n < kMaxN; ++n) {
      count_ngrams_vec(h, hlen, n + 1, hyp_v[n]);
      max_ref[n].clear();
    }

    // closest reference length (ties -> shorter)
    int best_len = -1;
    int64_t best_diff = INT64_MAX;
    for (int64_t r = ref_group_offsets[i]; r < ref_group_offsets[i + 1]; ++r) {
      int rlen;
      const int32_t* rt = refs.sent(r, &rlen);
      int64_t diff = llabs(static_cast<int64_t>(rlen) - hlen);
      if (diff < best_diff || (diff == best_diff && rlen < best_len)) {
        best_diff = diff;
        best_len = rlen;
      }
      for (int n = 0; n < kMaxN; ++n) {
        count_ngrams_vec(rt, rlen, n + 1, rv);
        max_merge(max_ref[n], rv, scratch);  // per-key max over the group
      }
    }
    reflen += best_len;

    for (int n = 0; n < kMaxN; ++n) {
      int64_t g = hlen - n;  // hlen - (n+1) + 1
      if (g > 0) guess[n] += g;
      // clipped matches: two-pointer intersection of the sorted vectors
      size_t a = 0, b = 0;
      const KeyVec& hv = hyp_v[n];
      const KeyVec& mv = max_ref[n];
      while (a < hv.size() && b < mv.size()) {
        if (hv[a].first < mv[b].first) ++a;
        else if (mv[b].first < hv[a].first) ++b;
        else {
          correct[n] += hv[a].second < mv[b].second ? hv[a].second : mv[b].second;
          ++a;
          ++b;
        }
      }
    }
  }
  *testlen_out = testlen;
  *reflen_out = reflen;
}

// CIDEr per-image scores (pycocoevalcap cider_scorer.py semantics):
// df over reference groups, w = tf * (log(num) - log(max(1, df))),
// per-n clipped dot / (|h| |r|), Gaussian length penalty sigma=6,
// averaged over n and refs, x10.
void cider_scores(const int32_t* hyp_tokens, const int64_t* hyp_offsets, int64_t num,
                  const int32_t* ref_tokens, const int64_t* ref_offsets,
                  const int64_t* ref_group_offsets,
                  double* scores_out) {
  Corpus hyps{hyp_tokens, hyp_offsets, num};
  Corpus refs{ref_tokens, ref_offsets, 0};
  const double sigma = 6.0;
  const double log_num = std::log(static_cast<double>(num));

  // document frequency: each unique ngram once per image's ref group.
  // The df table is the one corpus-global structure, so it stays a hash
  // map; per-sentence counting below uses sorted small vectors.
  WeightMap df[kMaxN];
  {
    KeyVec seen[kMaxN], rv, scratch;
    for (int64_t i = 0; i < num; ++i) {
      for (int n = 0; n < kMaxN; ++n) seen[n].clear();
      for (int64_t r = ref_group_offsets[i]; r < ref_group_offsets[i + 1]; ++r) {
        int rlen;
        const int32_t* rt = refs.sent(r, &rlen);
        for (int n = 0; n < kMaxN; ++n) {
          count_ngrams_vec(rt, rlen, n + 1, rv);
          max_merge(seen[n], rv, scratch);  // union of the group's keys
        }
      }
      for (int n = 0; n < kMaxN; ++n) {
        for (const auto& kv : seen[n]) df[n][kv.first] += 1.0;
      }
    }
  }

  auto weight = [&](int n, Key k, int32_t tf) {
    auto it = df[n].find(k);
    double d = it == df[n].end() ? 1.0 : (it->second < 1.0 ? 1.0 : it->second);
    return static_cast<double>(tf) * (log_num - std::log(d));
  };

  // (key, tf*idf weight) rows, key-sorted — dot products become merges
  struct WKey { Key k; double w; };
  std::vector<WKey> hw[kMaxN], rw;
  KeyVec cv;
  for (int64_t i = 0; i < num; ++i) {
    int hlen;
    const int32_t* h = hyps.sent(i, &hlen);

    double h_norm[kMaxN] = {0, 0, 0, 0};
    for (int n = 0; n < kMaxN; ++n) {
      count_ngrams_vec(h, hlen, n + 1, cv);
      hw[n].clear();
      for (const auto& kv : cv) {
        double w = weight(n, kv.first, kv.second);
        hw[n].push_back({kv.first, w});
        h_norm[n] += w * w;
      }
      h_norm[n] = std::sqrt(h_norm[n]);
    }

    double total[kMaxN] = {0, 0, 0, 0};
    int64_t nrefs = ref_group_offsets[i + 1] - ref_group_offsets[i];
    for (int64_t r = ref_group_offsets[i]; r < ref_group_offsets[i + 1]; ++r) {
      int rlen;
      const int32_t* rt = refs.sent(r, &rlen);
      double delta = static_cast<double>(hlen - rlen);
      double penalty = std::exp(-(delta * delta) / (2.0 * sigma * sigma));
      for (int n = 0; n < kMaxN; ++n) {
        count_ngrams_vec(rt, rlen, n + 1, cv);
        double r_norm = 0.0;
        rw.clear();
        for (const auto& kv : cv) {
          double w = weight(n, kv.first, kv.second);
          rw.push_back({kv.first, w});
          r_norm += w * w;
        }
        r_norm = std::sqrt(r_norm);
        double dot = 0.0;
        size_t a = 0, b = 0;
        while (a < hw[n].size() && b < rw.size()) {
          if (hw[n][a].k < rw[b].k) ++a;
          else if (rw[b].k < hw[n][a].k) ++b;
          else {
            double wh = hw[n][a].w, wr = rw[b].w;
            dot += (wh < wr ? wh : wr) * wr;  // clipped cosine numerator
            ++a;
            ++b;
          }
        }
        double val = 0.0;
        if (h_norm[n] != 0.0 && r_norm != 0.0) val = dot / (h_norm[n] * r_norm);
        total[n] += val * penalty;
      }
    }
    double s = 0.0;
    for (int n = 0; n < kMaxN; ++n) s += total[n];
    scores_out[i] = s / kMaxN / static_cast<double>(nrefs) * 10.0;
  }
}

// ROUGE-L per-sentence scores (metrics/rouge.py semantics, which match
// pycocoevalcap's rouge.py): LCS-based F with beta=1.2, precision and
// recall each take the max over the reference group, corpus mean is
// computed by the Python caller.
void rouge_scores(const int32_t* hyp_tokens, const int64_t* hyp_offsets, int64_t num,
                  const int32_t* ref_tokens, const int64_t* ref_offsets,
                  const int64_t* ref_group_offsets,
                  double* scores_out) {
  Corpus hyps{hyp_tokens, hyp_offsets, num};
  Corpus refs{ref_tokens, ref_offsets, 0};
  const double beta2 = 1.2 * 1.2;
  std::vector<int> prev, cur;
  for (int64_t i = 0; i < num; ++i) {
    int hlen;
    const int32_t* h = hyps.sent(i, &hlen);
    double p = -1.0, r = -1.0;
    for (int64_t g = ref_group_offsets[i]; g < ref_group_offsets[i + 1]; ++g) {
      int rlen;
      const int32_t* rt = refs.sent(g, &rlen);
      // classic O(hlen*rlen) LCS length with two rolling rows
      int lcs = 0;
      if (hlen > 0 && rlen > 0) {
        prev.assign(rlen + 1, 0);
        for (int a = 0; a < hlen; ++a) {
          cur.assign(rlen + 1, 0);
          for (int b = 1; b <= rlen; ++b) {
            cur[b] = h[a] == rt[b - 1] ? prev[b - 1] + 1
                                       : (prev[b] > cur[b - 1] ? prev[b] : cur[b - 1]);
          }
          prev.swap(cur);
        }
        lcs = prev[rlen];
      }
      double prec = hlen ? (double)lcs / hlen : 0.0;
      double rec = rlen ? (double)lcs / rlen : 0.0;
      if (prec > p) p = prec;
      if (rec > r) r = rec;
    }
    scores_out[i] =
        (p > 0.0 && r > 0.0) ? ((1.0 + beta2) * p * r) / (r + beta2 * p) : 0.0;
  }
}

// METEOR per-sentence scores for the exact+stem module configuration.
// stem_ids[id] / delta_weights[id] are per-word-id tables built by the
// Python wrapper (Porter stems interned to their own id space; delta
// content/function masses). Best score over the reference group; pairs
// with no alignment contribute nothing (Python `continue`).
void meteor_scores(const int32_t* hyp_tokens, const int64_t* hyp_offsets, int64_t num,
                   const int32_t* ref_tokens, const int64_t* ref_offsets,
                   const int64_t* ref_group_offsets,
                   const int32_t* stem_ids, const double* delta_weights,
                   double* scores_out) {
  Corpus hyps{hyp_tokens, hyp_offsets, num};
  Corpus refs{ref_tokens, ref_offsets, 0};
  meteor::Aligner aligner;
  for (int64_t i = 0; i < num; ++i) {
    int hlen;
    const int32_t* h = hyps.sent(i, &hlen);
    double best = 0.0;
    for (int64_t g = ref_group_offsets[i]; g < ref_group_offsets[i + 1]; ++g) {
      int rlen;
      const int32_t* rt = refs.sent(g, &rlen);
      if (hlen == 0 || rlen == 0) continue;
      double s = aligner.score(h, hlen, rt, rlen, stem_ids, delta_weights);
      if (s > best) best = s;
    }
    scores_out[i] = best;
  }
}

}  // extern "C"
