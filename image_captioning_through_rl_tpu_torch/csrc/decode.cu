// Greedy and sampled caption decodes on Hopper: one persistent cooperative
// launch for all T - 1 steps.
//
// Replaces the TPU kernels image_captioning_through_rl_tpu/ops/pallas_decode.py
// (fused_greedy_decode, body _kernel, pallas_call at line 176) and
// ops/pallas_sample.py (fused_sample_decode, body _kernel, pallas_call at line
// 350). Both: h0 = feats @ wc + bc, c0 = 0, then T - 1 steps of (the LSTM
// cell on the previous token, the vocab head, a pick) into column t + 1;
// column 0 is the start token. The picks:
//   * argmax (greedy): the first index of the row's largest logit;
//   * Gumbel (sampling, no filter): the first index of the largest
//     logits / t + gumbel(threefry(subkey_t, row * V + col)), which is
//     jax.random.categorical under the step's subkey;
//   * filtered (sampling with top-k and/or the nucleus): the same over the
//     columns the filters keep. A dropped column is -1e30 in the TPU kernel,
//     and -1e30 + g == -1e30 for every noise value g (in ~[-4.5, 16.6],
//     pallas_sample.py:261-264), so it never wins: only the kept columns are
//     hashed, and the result is exact.
//
// Rounding points, as in the TPU kernels: the h0 product takes the float32
// features (pallas_decode.py:83; with bf16 weights the features enter the
// tensor cores as three bf16 parts hi + mid + lo, whose products with a bf16
// weight are exact in float32, so h0 is a float32 product up to the sum
// order); x (an x-gate table row) and h are in the weight type for every
// gate and head product; sums and gate math are float32, the gates added
// as xg[tok] + h @ wh + b (lstm_cell_plain's order).
//
// The filters are the TPU kernel's (pallas_sample.py:143-219), without its
// bisection over the whole row: a float's key is the total-order map of
// x + 0.f; top-k keeps the keys >= the k-th largest key of the row, found
// by a radix select (2-bit digits of the order-preserving unsigned key, each
// pass three warp-wide integer counts, until at most 64 candidates remain,
// then the k-th largest among them directly: the threshold is the
// bisection's to the bit); the survivors are compacted with their columns
// in column order; the nucleus runs over them (max, expf, z = sum, and
// keyspace_threshold's smallest key whose strict tail weighs less than
// p * z, which is always a survivor's key: a dropped entry weighs exactly 0
// there; for at most 64 survivors each one's tail mass directly, else the
// bisection from their own key range); the nucleus alone bisects over the
// whole row. expf and the warp's sum order are not
// torch.exp's and torch.sum's: where the mass at the boundary lies within
// float error of p * z, a row may keep one token more or fewer than the
// plain version, which chip_smoke.py's near-tie rule covers.
//
// The step subkeys come from inside the launch: every thread carries the
// key's two words and, each step, takes sub = threefry(key, (0, 1)) and
// key = threefry(key, (0, 0)) (jax.random.split, prng.sample_step_keys), so
// no host table and no step cap.
//
// Design. A step multiplies the state entering it by [wo | wh] (V + 4H
// columns, depth H; 3 MB of bf16 weights at COCO width); the token only
// picks a row of the x-gate table (icrl_token_gates, once per weights). So
// the whole decode is one cooperative launch on the beam's skeleton
// (beam_search.cu), each step two phases split by grid barriers:
//   * Launch plan (decode_plan, mirrored by ops/fused_decode.decode_plan and
//     checked here): the columns of [wo | wh] are cut into slices of NC = 4U
//     consecutive columns, U the widest (bf16 32, 16, 8; float32 16, 8) whose
//     slice (of max(H, F) rows) fits shared memory beside chain.cuh's cp.async
//     ring while every slice has a block of its own, one block per SM. The
//     blocks left over replicate the slices as row groups: h_groups copies of
//     each head slice and a_groups of each cell slice, the counts that make
//     phase A's slowest block quickest (DECODE_TILE_COST, per pick), then the
//     grid largest. A block loads its slice once and keeps it for the whole
//     decode; where no width fits (bf16 from H = 1024) the weights stream
//     through the ring with the A rows, and every block takes (slice, row
//     tile) items in turn. Phase B's shared memory (a token per warp, a short
//     list per warp) overlays the ring, which no product uses then
//     (DECODE_SCRATCH_INTS, checked against the ring at compile time).
//   * Phase A: the slices over the rows (chain_product_src: rnd(h) staged
//     from L2, mma.sync from ldmatrix, or fmaf for float32 weights). A head
//     slice keeps per row its (largest value, first column): of the logits
//     (argmax) or of logits / t + noise (Gumbel), so the logits never reach
//     memory; for the filters it writes logits / t (IEEE division) to an
//     [N, V] float32 row scratch. The cell slices write h @ wh to an L2
//     scratch, and idle on the last step.
//   * Phase B: one warp per row takes the token (the slices' pairs merged:
//     the larger value wins, the lower column among equal ones, across
//     slices too; or the filters and the survivors' Gumbel-max over its row,
//     held in registers up to 32 x 32 = 1024 columns, else walked in L2),
//     writes column t + 1, then the block runs the rows' cells, four units a
//     thread.
// Before the loop, in the same launch: the start column (and, with bf16
// weights, the features' three parts), h0 = feats @ wc + bc (every block, by
// items), rnd(h0) @ wh on the cell slices, and the first cell on <START>.
// Every sum runs in a fixed order, so two calls give the same bits. An
// optional clock (clock_mark) reads each phase's time; chip_smoke.py phases
// 6 and 18 report it.
#include <assert.h>

#include "chain.cuh"
#include "threefry.cuh"

namespace icrl {
namespace {

enum DecodePick { PICK_ARGMAX = 0, PICK_GUMBEL = 1, PICK_FILTER = 2, PICKS };

// The products of a step in slice order: the head's V columns, the cell's 4H.
enum DecodeMat { DEC_HEAD = 0, DEC_CELL, DEC_MATS };

struct DecodeCols {
  int c[DEC_MATS];
  __host__ __device__ DecodeCols(int H, int V) : c{V, 4 * H} {}
  __host__ __device__ int slices(int m, int nc) const { return ceil_div(c[m], nc); }
  __host__ __device__ int a_slices(int nc) const {
    return slices(DEC_HEAD, nc) + slices(DEC_CELL, nc);
  }
};

// The relative time of one row tile of a head slice and of a cell slice, per
// pick, which the plan balances. Measured by the clock's tile counters on an
// H100 (bf16, COCO width, N = 4 to 1024, t = 1): a cell tile ~7.3-8.5 k
// cycles, a head tile 1.19-1.30x that for the argmax, 2.41x for the Gumbel
// head (it hashes every column, ~130 operations each) and 1.45x for the
// filters' row store.
constexpr int DECODE_TILE_COST[PICKS][2] = {{9, 8}, {5, 2}, {3, 2}};

constexpr int PER = 32;  // list entries a lane holds in registers (WARP_VOCAB = 32 PER)
constexpr int SHORT = 64;  // a short list: two entries a lane
constexpr int WARPS = CHAIN_THREADS / 32;
// Phase B's shared ints: a token per warp, then per warp the radix select's
// last candidates and a short survivor list (values, columns).
constexpr int DECODE_SCRATCH_INTS = WARPS + WARPS * 3 * SHORT;

// The launch plan; ops/fused_decode.py:decode_plan computes the same.
// Stationary: blocks [0, sh h_groups) hold the head slices, the next
// sp a_groups the cell slices, each slice's copies taking its row tiles in
// turn.
struct DecodePlan {
  int rows_per_tile, units, stream, grid, h_groups, a_groups;
  long smem;
};

template <typename W>
DecodePlan decode_plan(int n, int F, int H, int V, int pick, int sms) {
  constexpr int kc = ChainRing<W>::KC;
  const long Kp = ceil_div(std::max(H, F), kc) * (long)kc;
  const DecodeCols cols(H, V);
  auto co_resident = [&](long smem) {
    return smem > SMEM_PER_BLOCK ? 0L
                                 : sms * std::min(1L, SMEM_PER_SM / (smem + SMEM_RESERVED));
  };
  DecodePlan p{CHAIN_BR, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < SliceUnits<W>::N && !p.units; ++i) {
    const int units = SliceUnits<W>::U[i];
    const long smem = chain_smem<W>(false, 4, units, false, Kp);
    if (co_resident(smem) >= cols.a_slices(4 * units)) {
      p.units = units;
      p.smem = smem;
    }
  }
  if (!p.units) {
    p.units = stream_units<W, false, 4>();
    p.stream = 1;
    p.smem = chain_smem<W>(false, 4, p.units, true, Kp);
    p.grid = (int)co_resident(p.smem);
    return p;
  }
  const long co = co_resident(p.smem), nc = 4 * p.units;
  const long sh = cols.slices(DEC_HEAD, nc), sp = cols.slices(DEC_CELL, nc);
  const long ta = ceil_div(std::max(n, 1), CHAIN_BR);
  const int* cost = DECODE_TILE_COST[pick];
  // the least weighted time of phase A's slowest block, then the most blocks
  // (every block serves phase B)
  long best = -1;
  for (long gh = 1; gh <= ta && sh * gh + sp <= co; ++gh) {
    for (long gp = 1; gp <= ta && sh * gh + sp * gp <= co; ++gp) {
      const long t = std::max(ceil_div(ta, gh) * cost[0], ceil_div(ta, gp) * cost[1]);
      const long grid = sh * gh + sp * gp;
      if (best < 0 || t < best || (t == best && grid > p.grid)) {
        best = t;
        p.h_groups = (int)gh;
        p.a_groups = (int)gp;
        p.grid = (int)grid;
      }
    }
  }
  return p;
}

template <typename W>
struct DecodeArgs {
  int n, F, E, H, V, Vh, T, pick, top_k, top_p, h_groups, a_groups, parts;
  float temp, p;
  unsigned key0, key1;
  const float* feats;  // [n, F]
  const int* start;    // [n]
  const W* h0_a;       // the h0 product's A: [parts, n, F] (bf16: the features' parts)
  const W* wc;         // [F, H]
  const float* bc;     // [H]
  const float* xg;     // [V, 4H] emb @ wi
  const W* w;          // [E + H, 4H] [wi; wh]
  const float* b;      // [4H]
  const W* wo;         // [H, Vh] the head, rows padded to Vh columns
  const float* bo;     // [>= V]
  int* out;            // [n, T]
  // scratch (written and read inside the launch: plain loads, no .nc path)
  W* fs;               // [3, n, F] the features' bf16 parts (bf16 weights)
  W* h;                // [n, H] in the weight type
  float* c;            // [n, H]
  float* pre;          // [n, 4H] rnd(h) @ wh of the entering state
  float* part;         // per (row, head slice): value, column
  float *xs, *sv;      // [n, V] scaled logits; the survivors' values
  int* sc;             // [n, V] the survivors' columns
  int pp;              // head slices allocated per row: ceil(V / 32)
  // null, or decode_clock_slots(T) zeros: a profile of the phases (clock_mark)
  // and of phase A's tiles
  unsigned long long* clock;
};

template <typename W>
__device__ __forceinline__ ColSlice<W> decode_weight(const DecodeArgs<W>& a, bool head, int c0) {
  const int H = a.H;
  if (head) return {a.wo, H, a.V, a.Vh, c0};
  return {a.w + (size_t)a.E * 4 * H, H, 4 * H, 4 * H, c0};
}

// ---- Phase A ----

// A head slice's epilogue over the row tile at row0, the slice's columns
// [c0, c0 + lim): the four threads of a row take its local columns q + 4i
// (conflict-free reads of Cs), every row at once. Argmax and Gumbel: per
// row the (largest value, first column) over four interleaved chains (i % 4,
// each a strict > over ascending columns), then over the four threads under
// the full tie rule. Filtered: logits / t to the row scratch.
template <class Tl, typename W>
__device__ void head_epilogue(const DecodeArgs<W>& a, const float* Cs, int cld, int idx, int c0,
                              int lim, int row0, unsigned s0, unsigned s1) {
  constexpr int CPT = Tl::NC / 4;
  static_assert(CHAIN_THREADS == 4 * CHAIN_BR, "four threads a row");
  const int tid = threadIdx.x, r = tid / 4, q = tid % 4, row = row0 + r;
  // x / t, skipped where t = 1 (x / 1 == x exactly): the division's slow
  // path is a branch, which serialises the loops around it
  const bool div = a.temp != 1.f;
  if (a.pick == PICK_FILTER) {  // consecutive threads on consecutive columns of a row
    auto store = [&](auto divide) {
#pragma unroll 8
      for (int e = tid; e < CHAIN_BR * Tl::NC; e += CHAIN_THREADS) {
        const int rr = e / Tl::NC, c = e % Tl::NC;
        const float l = Cs[rr * cld + c] + a.bo[c0 + min(c, lim - 1)];
        if ((c < lim) & (row0 + rr < a.n))
          a.xs[(size_t)(row0 + rr) * a.V + c0 + c] = decltype(divide)::value ? l / a.temp : l;
      }
    };
    if (div)
      store(std::true_type{});
    else
      store(std::false_type{});
    return;
  }
  const float* cr = Cs + r * cld;
  float bias[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) bias[i] = a.bo[c0 + min(q + 4 * i, lim - 1)];
  float v[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  int vi[4] = {0x7fffffff, 0x7fffffff, 0x7fffffff, 0x7fffffff};  // sentinels
  if (a.pick == PICK_GUMBEL) {
    const unsigned base = (unsigned)min(row, a.n - 1) * (unsigned)a.V + (unsigned)c0;
    auto pick = [&](auto divide) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = q + 4 * i;
        const float g = gumbel_from_bits(random_bits(s0, s1, base + (unsigned)c));
        const float x = cr[c] + bias[i];
        const float l = c < lim ? (decltype(divide)::value ? x / a.temp : x) + g : -INFINITY;
        const bool take = l > v[i % 4];
        v[i % 4] = take ? l : v[i % 4];
        vi[i % 4] = take ? c0 + c : vi[i % 4];
      }
    };
    if (div)
      pick(std::true_type{});
    else
      pick(std::false_type{});
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = q + 4 * i;
      const float l = c < lim ? cr[c] + bias[i] : -INFINITY;
      const bool take = l > v[i % 4];
      v[i % 4] = take ? l : v[i % 4];
      vi[i % 4] = take ? c0 + c : vi[i % 4];
    }
  }
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    const bool take = ranks_before(v[j], vi[j], v[0], vi[0]);
    v[0] = take ? v[j] : v[0];
    vi[0] = take ? vi[j] : vi[0];
  }
  argmax_width(v[0], vi[0], 4);
  if (q == 0 && row < a.n) {
    float* p = a.part + ((size_t)row * a.pp + idx) * 2;
    p[0] = v[0];
    p[1] = __int_as_float(vi[0]);
  }
}

// Phase A of step t (t = -1: rnd(h0) @ wh on the cell slices).
template <class Tl, typename W>
__device__ void phase_a(const DecodeArgs<W>& a, const ChainStage<Tl>& st, const DecodeCols& cols,
                        int my_slice, int group, int groups, int t, unsigned s0, unsigned s1) {
  const int H = a.H, S = a.T - 1, nh = cols.slices(DEC_HEAD, Tl::NC);
  const int tiles = ceil_div(a.n, CHAIN_BR);
  for_items<Tl::STREAM>(my_slice, group, groups, cols.a_slices(Tl::NC), tiles,
                        [&](int s, int rt) {
    const bool head = s < nh;
    if (head ? t < 0 : t + 1 >= S) return;
    const int c0 = (head ? s : s - nh) * Tl::NC, row0 = rt * CHAIN_BR;
    const int lim = min(Tl::NC, cols.c[head ? DEC_HEAD : DEC_CELL] - c0);
    const long long tick = a.clock ? clock64() : 0;
    float* Cs = st.product(a.h, H, row0, a.n, H, decode_weight(a, head, c0));
    __syncthreads();
    if (head)
      head_epilogue<Tl>(a, Cs, ChainStage<Tl>::CLD, s, c0, lim, row0, s0, s1);
    else
      pre_epilogue<Tl>(a.pre, 4 * H, a.n, Cs, ChainStage<Tl>::CLD, c0, lim, row0);
    __syncthreads();  // Cs overlays the ring the next product fills
    if (a.clock && threadIdx.x == 0 && t >= 0) {  // the tile counters
      unsigned long long* k = a.clock + 2 + 4 * S + (head ? 0 : 2);
      atomicAdd(k, (unsigned long long)(clock64() - tick));
      atomicAdd(k + 1, 1ull);
    }
  });
}

// ---- Phase B: the filtered pick ----
//
// Every loop over a row's entries below is unrolled and branch-free (tests
// are selects): a data-dependent branch per entry made each entry's chain of
// dependent instructions run alone, and the pick several times slower.

__device__ __forceinline__ int monotone_key(float x) {
  const int i = __float_as_int(x + 0.f);
  return i ^ (i < 0 ? 0x7fffffff : 0);
}

// The order-preserving unsigned key: monotone_key with its sign bit flipped.
__device__ __forceinline__ unsigned ukey(float x) {
  return (unsigned)monotone_key(x) ^ 0x80000000u;
}

// A list of m values of one row in column order: value j at vals[j], its
// column cols[j] (cols null: column j). RegList<NS> holds it in registers,
// lane l the entries l + 32 i (i < NS, so m <= 32 NS); WalkList reads it
// from L2 in chunks of 32 PER. each(f) calls f(value, j, valid) on every
// lane for every slot, valid or not (so warp-wide votes inside f stay
// converged).
template <int NS>
struct RegList {
  static constexpr int kSlots = NS;
  const int* cols;
  int m, lane;
  float x[NS];
  __device__ __forceinline__ RegList(const float* vals, const int* c, int m_, int lane_)
      : cols(c), m(m_), lane(lane_) {
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = lane + 32 * i < m ? vals[lane + 32 * i] : 0.f;
  }
  __device__ __forceinline__ int col(int j) const { return cols ? cols[j] : j; }
  template <class F>
  __device__ __forceinline__ void each(const F& f) const {
#pragma unroll
    for (int i = 0; i < NS; ++i) f(x[i], lane + 32 * i, lane + 32 * i < m);
  }
};

struct WalkList {
  static constexpr int kSlots = 0;
  const float* vals;
  const int* cols;
  int m, lane;
  __device__ __forceinline__ int col(int j) const { return cols ? cols[j] : j; }
  template <class F>
  __device__ __forceinline__ void each(const F& f) const {
    for (int j0 = 0; j0 < m; j0 += 32 * PER) {
      float y[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int j = j0 + lane + 32 * i;
        y[i] = j < m ? vals[j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) f(y[i], j0 + lane + 32 * i, j0 + lane + 32 * i < m);
    }
  }
};

// The k-th largest key of the list (1 <= k <= m): a radix select over the
// 2-bit digits of the unsigned key, most significant first. Each pass counts
// the candidates (keys under the prefix so far) with digit 3, 2 and 1, three
// warp reductions side by side, and keeps the digit holding the k-th largest
// of them; once at most SHORT candidates remain they are compacted into the
// warp's shared cu and the k-th largest taken among them directly: the
// smallest candidate with fewer than k candidates above it. Integer counts:
// the result is the bisection's to the bit, whatever the order.
template <class List>
__device__ __forceinline__ int kth_largest_key(const List& L, int k, unsigned* cu) {
  const int lane = L.lane;
  unsigned prefix = 0u, pmask = 0u;
  int ncand = L.m;
#pragma unroll 1
  for (int shift = 30; shift >= 0 && ncand > SHORT; shift -= 2) {
    int c1 = 0, c2 = 0, c3 = 0;
    L.each([&](float v, int, bool valid) {
      const unsigned u = ukey(v), d = (u >> shift) & 3u;
      const bool cand = valid & ((u & pmask) == prefix);
      c3 += cand & (d == 3u);
      c2 += cand & (d == 2u);
      c1 += cand & (d == 1u);
    });
    const int t3 = (int)__reduce_add_sync(FULL, (unsigned)c3);
    const int t2 = (int)__reduce_add_sync(FULL, (unsigned)c2);
    const int t1 = (int)__reduce_add_sync(FULL, (unsigned)c1);
    const int t0 = ncand - t3 - t2 - t1;
    const unsigned d = k <= t3 ? 3u : k <= t3 + t2 ? 2u : k <= t3 + t2 + t1 ? 1u : 0u;
    k -= d == 3u ? 0 : d == 2u ? t3 : d == 1u ? t3 + t2 : t3 + t2 + t1;
    ncand = d == 3u ? t3 : d == 2u ? t2 : d == 1u ? t1 : t0;
    prefix |= d << shift;
    pmask |= 3u << shift;
  }
  if (ncand > SHORT) return (int)(prefix ^ 0x80000000u);  // every digit fixed: all equal
  int base = 0;
  L.each([&](float v, int, bool valid) {
    const unsigned u = ukey(v);
    const bool cand = valid & ((u & pmask) == prefix);
    const unsigned vote = __ballot_sync(FULL, cand);
    if (cand) cu[base + __popc(vote & ((1u << lane) - 1u))] = u;
    base += __popc(vote);
  });
  __syncwarp();
  const unsigned a0 = lane < ncand ? cu[lane] : 0u, a1 = lane + 32 < ncand ? cu[lane + 32] : 0u;
  int g0 = 0, g1 = 0;  // candidates above each
  for (int j = 0; j < ncand; ++j) {
    const unsigned uj = cu[j];
    g0 += uj > a0;
    g1 += uj > a1;
  }
  unsigned best = 0xffffffffu;
  best = (lane < ncand) & (g0 < k) ? min(best, a0) : best;
  best = (lane + 32 < ncand) & (g1 < k) ? min(best, a1) : best;
  best = __reduce_min_sync(FULL, best);
  __syncwarp();  // cu serves the next row
  return (int)(best ^ 0x80000000u);
}

// The entries with key >= thr, in column order, to vals and cols in L2, the
// first SHORT of them also to the warp's shared svs and scs (visible to its
// lanes after the __syncwarp); returns their count.
template <class List>
__device__ __forceinline__ int compact(const List& L, int thr, float* vals, int* cols,
                                       float* svs, int* scs) {
  const int lane = L.lane;
  int m = 0;
  L.each([&](float v, int j, bool valid) {
    const bool keep = valid & (monotone_key(v) >= thr);
    const unsigned vote = __ballot_sync(FULL, keep);
    const int pos = m + __popc(vote & ((1u << lane) - 1u)), c = L.col(valid ? j : 0);
    if (keep) {
      vals[pos] = v;
      cols[pos] = c;
    }
    if (keep & (pos < SHORT)) {
      svs[pos] = v;
      scs[pos] = c;
    }
    m += __popc(vote);
  });
  __syncwarp();
  return m;
}

// keyspace_threshold of the list with the weights e = expf(v - max) against
// p * sum(e): the smallest key j with sum(e over keys > j) < p z. That is
// always one of the list's keys (the sum steps only there, and is z >= p z
// below them), so a short list (top-k's survivors) takes it directly: each
// entry's mass strictly above it, summed over the list in list order, and
// the smallest key whose mass is under the budget (the largest key at
// least, where the bisection starts). A longer one bisects from its
// kmin - 1 and kmax (a converged range stops: further rounds would stall),
// e in registers for a list held there, recomputed each round for one
// walked in L2.
template <class List>
__device__ __forceinline__ int nucleus_threshold(const List& L, float p) {
  constexpr int NS = List::kSlots;
  float mx = -INFINITY;
  int kmin = 0x7fffffff, kmax = -0x7fffffff - 1;
  L.each([&](float v, int, bool valid) {
    const int key = monotone_key(v);
    mx = valid ? fmaxf(mx, v) : mx;
    kmin = valid ? min(kmin, key) : kmin;
    kmax = valid ? max(kmax, key) : kmax;
  });
  mx = warp_max(mx);
  kmin = __reduce_min_sync(FULL, kmin);
  kmax = __reduce_max_sync(FULL, kmax);
  float e[NS > 0 ? NS : 1], z = 0.f;
  if constexpr (NS > 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      e[i] = L.lane + 32 * i < L.m ? expf(L.x[i] - mx) : 0.f;
      z += e[i];
    }
  } else {
    L.each([&](float v, int, bool valid) { z += valid ? expf(v - mx) : 0.f; });
  }
  const float budget = p * warp_sum(z);
  if constexpr (NS == 2) {
    const int k0 = monotone_key(L.x[0]), k1 = monotone_key(L.x[1]);
    float above0 = 0.f, above1 = 0.f;
    for (int j = 0; j < L.m; ++j) {  // entry j from its lane, in list order
      const float ej = __shfl_sync(FULL, j < 32 ? e[0] : e[1], j % 32);
      const int kj = __shfl_sync(FULL, j < 32 ? k0 : k1, j % 32);
      above0 += kj > k0 ? ej : 0.f;
      above1 += kj > k1 ? ej : 0.f;
    }
    int thr = 0x7fffffff;
    thr = (L.lane < L.m) & (above0 < budget) ? min(thr, k0) : thr;
    thr = (L.lane + 32 < L.m) & (above1 < budget) ? min(thr, k1) : thr;
    return min(__reduce_min_sync(FULL, thr), kmax);
  } else {
    int lo = (int)((unsigned)kmin - 1u), hi = kmax;
    for (int round = 0; round < 32 && (unsigned)hi - (unsigned)lo > 1u; ++round) {
      const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);  // floor((lo + hi) / 2)
      float mass = 0.f;
      if constexpr (NS > 0) {
#pragma unroll
        for (int i = 0; i < NS; ++i) mass += monotone_key(L.x[i]) > mid ? e[i] : 0.f;
      } else {
        L.each([&](float v, int, bool valid) {
          mass += valid & (monotone_key(v) > mid) ? expf(v - mx) : 0.f;
        });
      }
      if (warp_sum(mass) < budget)
        hi = mid;
      else
        lo = mid;
    }
    return hi;
  }
}

// The first column of the largest v + gumbel(threefry(sub, base + col)) over
// the entries with key >= thr. A lane's entries ascend in column, so its
// strict > keeps the first of equal values; the lanes then merge under the
// full tie rule.
template <class List>
__device__ __forceinline__ int gumbel_pick(const List& L, int thr, unsigned base, unsigned s0,
                                           unsigned s1) {
  float best = -INFINITY;
  int bi = 0x7fffffff;
  L.each([&](float v, int j, bool valid) {
    const int c = L.col(valid ? j : 0);
    const float noisy = v + gumbel_from_bits(random_bits(s0, s1, base + (unsigned)c));
    const bool take = valid & (monotone_key(v) >= thr) & (noisy > best);
    best = take ? noisy : best;
    bi = take ? c : bi;
  });
  argmax_width(best, bi, 32);
  return bi;
}

// What the filtered pick reads of the launch's arguments.
struct FilterArgs {
  const float* xs;  // [n, V] scaled logits
  float* sv;        // [n, V] survivors' values
  int* sc;          // [n, V] survivors' columns
  int V, top_k, top_p;
  float p;
};

// The filtered pick of one row (a warp): top-k (the row's survivors then
// held in registers: two a lane for at most SHORT, from shared memory),
// the nucleus over the survivors, their Gumbel-max. sh: the warp's shared
// cu, survivors' values and columns. Not inlined: every kernel variant of
// the file calls the one copy (it depends on neither the weight type nor
// the slice width), which keeps the build short.
__device__ __noinline__ int pick_filtered(FilterArgs a, int row, int* sh, unsigned s0,
                                          unsigned s1) {
  const int lane = threadIdx.x % 32;
  const size_t o = (size_t)row * a.V;
  const unsigned base = (unsigned)row * (unsigned)a.V;
  unsigned* cu = reinterpret_cast<unsigned*>(sh);
  float* svs = reinterpret_cast<float*>(sh + SHORT);
  int* scs = sh + 2 * SHORT;
  auto finish = [&](const auto& S) {
    const int thr = a.top_p ? nucleus_threshold(S, a.p) : -0x7fffffff - 1;
    return gumbel_pick(S, thr, base, s0, s1);
  };
  auto run = [&](const auto& L) {
    if (!a.top_k) return finish(L);
    const int m = compact(L, kth_largest_key(L, a.top_k, cu), a.sv + o, a.sc + o, svs, scs);
    if (m <= SHORT) return finish(RegList<2>(svs, scs, m, lane));
    if (m <= 32 * PER) return finish(RegList<PER>(a.sv + o, a.sc + o, m, lane));
    return finish(WalkList{a.sv + o, a.sc + o, m, lane});
  };
  return a.V <= 32 * PER ? run(RegList<PER>(a.xs + o, nullptr, a.V, lane))
                         : run(WalkList{a.xs + o, nullptr, a.V, lane});
}

// ---- Phase B ----

// Phase B of step t (t = -1: the first cell, on <START>): this block's rows,
// a batch of at most 8 at a time, one warp per row for the token, then every
// thread over the batch's (row, four units) cell items.
template <typename W>
__device__ void phase_b(const DecodeArgs<W>& a, int nh, int* sh, int t, unsigned s0,
                        unsigned s1) {
  const int H = a.H, n = a.n, S = a.T - 1, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nblk = gridDim.x, rb = max(1, min(WARPS, ceil_div(n, nblk))), H4 = H / 4;
  int* wsh = sh + WARPS + warp * 3 * SHORT;  // this warp's filter scratch
  for (int r0 = blockIdx.x * rb; r0 < n; r0 += nblk * rb) {
    const int rows = min(rb, n - r0);
    if (t >= 0 && warp < rows) {
      const int row = r0 + warp;
      int tok;
      if (a.pick == PICK_FILTER) {
        tok = pick_filtered({a.xs, a.sv, a.sc, a.V, a.top_k, a.top_p, a.p}, row, wsh, s0, s1);
      } else {
        const float* pr = a.part + (size_t)row * a.pp * 2;
        float v = -INFINITY;
        int vi = 0x7fffffff;
        for (int s = lane; s < nh; s += 32) {
          const float pv = pr[2 * s];
          const int pi = __float_as_int(pr[2 * s + 1]);
          const bool take = ranks_before(pv, pi, v, vi);
          v = take ? pv : v;
          vi = take ? pi : vi;
        }
        argmax_width(v, vi, 32);
        tok = vi;
      }
      if (lane == 0) {
        a.out[(size_t)row * a.T + t + 1] = tok;
        sh[warp] = tok;
      }
    }
    if (t + 1 >= S) continue;  // the last step's cell would feed no step
    __syncthreads();
    for (int e = tid; e < rows * H4; e += CHAIN_THREADS) {
      const int w = e / H4, j = e % H4 * 4, row = r0 + w;
      const int tok = t < 0 ? a.start[row] : sh[w];
      const size_t o = (size_t)row * H + j;
      Cell4 in;
      cell_load(in, H, a.xg + (size_t)tok * 4 * H + j, a.pre + (size_t)row * 4 * H + j, a.b + j,
                t < 0 ? nullptr : a.c + o);
      cell_store(in, a.h + o, a.c + o);
    }
    __syncthreads();  // sh serves the next batch
  }
}

// ---- The launch ----

template <class Tl, typename W>
__device__ void decode_steps(const DecodeArgs<W>& a, const ChainStage<Tl>& st) {
  constexpr int NC = Tl::NC;
  const int n = a.n, H = a.H, F = a.F, S = a.T - 1, tid = threadIdx.x;
  const DecodeCols cols(H, a.V);
  const int sh = cols.slices(DEC_HEAD, NC), sp = cols.slices(DEC_CELL, NC);
  // this block's slice (stationary): a head slice or a cell slice, by the
  // plan's two ranges of blocks
  int a_slice = -1, a_group = 0, a_groups = 0;
  if constexpr (!Tl::STREAM) {
    const int blk = blockIdx.x, hb = sh * a.h_groups;
    if (blk < hb) {
      a_slice = blk % sh;
      a_group = blk / sh;
      a_groups = a.h_groups;
    } else {
      a_slice = sh + (blk - hb) % sp;
      a_group = (blk - hb) / sp;
      a_groups = a.a_groups;
    }
  }
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  clock_mark(a.clock, 0);
  const int gt = blockIdx.x * CHAIN_THREADS + tid, gn = gridDim.x * CHAIN_THREADS;
  for (int r = gt; r < n; r += gn) a.out[(size_t)r * a.T] = a.start[r];
  if constexpr (kIsBf16<W>) {
    // the features' parts hi + mid + lo: each a bf16 value, the three summing
    // to the float32 feature (24 significant bits)
    const size_t nf = (size_t)n * F;
    for (size_t i = gt; i < nf; i += gn) {
      const float x = a.feats[i];
      const W hi = __float2bfloat16_rn(x);
      const float r1 = x - __bfloat162float(hi);
      const W mid = __float2bfloat16_rn(r1);
      a.fs[i] = hi;
      a.fs[nf + i] = mid;
      a.fs[2 * nf + i] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
    }
    grid.sync();
  }
  // h0 = feats @ wc + bc, rounded to the weight type, by items over every
  // block: the parts' products (smallest first) summed in registers
  {
    constexpr int Q = NC / 4, RS = CHAIN_THREADS / Q, RPT = CHAIN_BR / RS;
    const int ns = ceil_div(H, NC), tiles = ceil_div(n, CHAIN_BR), c = tid % Q * 4;
    for (int i = blockIdx.x; i < ns * tiles; i += gridDim.x) {
      const int c0 = i % ns * NC, row0 = i / ns * CHAIN_BR;
      const ColSlice<W> src{a.wc, F, H, H, c0};
      st.load(src, F);
      float acc[RPT][4];
#pragma unroll
      for (int k = 0; k < RPT; ++k) zero4(acc[k]);
      for (int part = a.parts - 1; part >= 0; --part) {
        const float* Cs = st.product(a.h0_a + (size_t)part * n * F, F, row0, n, F, src);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          float v[4];
          ld4(v, Cs + (tid / Q + RS * k) * ChainStage<Tl>::CLD + c);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[k][u] += v[u];
        }
        __syncthreads();  // Cs overlays the ring the next product fills
      }
      if (c0 + c < H) {
        float bias[4];
        ld4(bias, a.bc + c0 + c);
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int row = row0 + tid / Q + RS * k;
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[k][u] += bias[u];
          if (row < n) st4(a.h + (size_t)row * H + c0 + c, acc[k]);
        }
      }
    }
  }
  if (a_slice >= 0) {
    const bool head = a_slice < sh;
    st.load(decode_weight(a, head, (head ? a_slice : a_slice - sh) * NC), H);
  }
  int* scratch = st.scratch();  // phase B's tokens
  grid.sync();
  phase_a<Tl>(a, st, cols, a_slice, a_group, a_groups, -1, 0u, 0u);
  grid.sync();
  phase_b(a, sh, scratch, -1, 0u, 0u);
  clock_mark(a.clock, 1);
  unsigned k0 = a.key0, k1 = a.key1;
  for (int t = 0; t < S; ++t) {
    // the step's subkey split(key)[1], and the key carried on, split(key)[0]
    unsigned s0 = 0u, s1 = 1u, n0 = 0u, n1 = 0u;
    if (a.pick != PICK_ARGMAX) {
      threefry2x32(k0, k1, s0, s1);
      threefry2x32(k0, k1, n0, n1);
      k0 = n0;
      k1 = n1;
    }
    const int k = 2 + 4 * t;
    grid.sync();
    clock_mark(a.clock, k);
    phase_a<Tl>(a, st, cols, a_slice, a_group, a_groups, t, s0, s1);
    clock_mark(a.clock, k + 1);
    grid.sync();
    clock_mark(a.clock, k + 2);
    phase_b(a, sh, scratch, t, s0, s1);
    clock_mark(a.clock, k + 3);
  }
}

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) decode_kernel(DecodeArgs<W> a) {
  using Tl = ChainTile<W, false, U, 4, kStream>;
  using Sm = ChainSmem<Tl>;
  static_assert((Sm::PARTS + DECODE_SCRATCH_INTS) * sizeof(float) <=
                    (size_t)Tl::STAGES * Sm::SLOT * sizeof(W),
                "phase B's scratch fits the ring it overlays");
  extern __shared__ __align__(16) unsigned char decode_smem[];
  decode_steps<Tl>(a, ChainStage<Tl>{decode_smem, a.H});
}

// The start tokens' range, checked on the device before the decode reads
// them (the wrapper does not sync for it): a token outside [0, Vx) fails the
// assertion, and the stream with it. A launch of its own, as the beam's: an
// assert inside a persistent kernel slowed the beam's phase A by a quarter.
__global__ void decode_start_check_kernel(int n, int Vx, const int* __restrict__ start) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    assert(static_cast<unsigned>(start[i]) < static_cast<unsigned>(Vx));
}

template <typename W, int U, bool kStream>
cudaError_t launch_decode_kernel(const DecodePlan& p, DecodeArgs<W> a, cudaStream_t s) {
  const auto kernel = decode_kernel<W, U, kStream>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  void* argv[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.grid), dim3(CHAIN_THREADS),
                                     argv, (size_t)p.smem, s);
}

// One case per kernel instantiation (units, stream mode); the pick is the
// kernel's argument.
template <typename W>
cudaError_t launch_decode(const DecodePlan& p, const DecodeArgs<W>& a, cudaStream_t s) {
  constexpr int SU = stream_units<W, false, 4>();
  if (p.stream) return launch_decode_kernel<W, SU, true>(p, a, s);
  switch (p.units) {
    case 32:
      if constexpr (kIsBf16<W>) return launch_decode_kernel<W, 32, false>(p, a, s);
      break;
    case 16:
      return launch_decode_kernel<W, 16, false>(p, a, s);
    case 8:
      return launch_decode_kernel<W, 8, false>(p, a, s);
  }
  return cudaErrorInvalidValue;
}

// The workspace: h in the weight type (float32 at most), the features' bf16
// parts with bf16 weights, c, the pre-activations and the head partials
// (sized for the narrowest slices, 32 columns) in float32; the filtered
// pick's row scratch and survivors.
struct DecodeLayout {
  float *fs, *h, *c, *pre, *part, *xs, *sv;
  int* sc;
  int pp;
};

DecodeLayout decode_layout(float* ws, int n, int F, int H, int V, bool bf16, bool filter,
                           size_t* used = nullptr) {
  Carver cv{ws};
  DecodeLayout l{};
  l.pp = ceil_div(V, 32);
  l.fs = bf16 ? reinterpret_cast<float*>(cv.take<__nv_bfloat16>((size_t)3 * n * F)) : nullptr;
  l.h = cv.take((size_t)n * H);
  l.c = cv.take((size_t)n * H);
  l.pre = cv.take((size_t)n * 4 * H);
  l.part = cv.take((size_t)n * l.pp * 2);
  if (filter) {
    l.xs = cv.take((size_t)n * V);
    l.sv = cv.take((size_t)n * V);
    l.sc = cv.take<int>((size_t)n * V);
  }
  if (used) *used = cv.used;
  return l;
}

// icrl_decode on the current device, after its argument checks.
int decode_on_device(int n, int F, int E, int H, int V, int Vh, int Vx, int T, int bf16, int pick,
                     int top_k, int top_p, float temp, float p, unsigned key0, unsigned key1,
                     int rows_per_tile, int units, int stream, int grid, int h_groups,
                     int a_groups, int smem, const float* feats, const int* start,
                     const void* wc, const float* bc, const float* xg, const void* w,
                     const float* b, const void* head, const float* bo, int* out, float* ws,
                     unsigned long long* clock, cudaStream_t s) {
  const int sms = device_sms();
  const DecodePlan pl = bf16 ? decode_plan<__nv_bfloat16>(n, F, H, V, pick, sms)
                             : decode_plan<float>(n, F, H, V, pick, sms);
  if (pl.rows_per_tile != rows_per_tile || pl.units != units || pl.stream != stream ||
      pl.grid != grid || pl.h_groups != h_groups || pl.a_groups != a_groups || pl.smem != smem)
    return (int)cudaErrorInvalidValue;
  decode_start_check_kernel<<<1, 256, 0, s>>>(n, Vx, start);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const DecodeLayout L = decode_layout(ws, n, F, H, V, bf16, pick == PICK_FILTER);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    DecodeArgs<W> a{};
    a.n = n;
    a.F = F;
    a.E = E;
    a.H = H;
    a.V = V;
    a.Vh = Vh;
    a.T = T;
    a.pick = pick;
    a.top_k = pick == PICK_FILTER ? top_k : 0;
    a.top_p = pick == PICK_FILTER && top_p;
    a.h_groups = pl.h_groups;
    a.a_groups = pl.a_groups;
    a.parts = bf16 ? 3 : 1;
    a.temp = temp;
    a.p = p;
    a.key0 = key0;
    a.key1 = key1;
    a.feats = feats;
    a.start = start;
    a.h0_a = bf16 ? (const W*)L.fs : (const W*)feats;
    a.wc = (const W*)wc;
    a.bc = bc;
    a.xg = xg;
    a.w = (const W*)w;
    a.b = b;
    a.wo = (const W*)head;
    a.bo = bo;
    a.out = out;
    a.fs = (W*)L.fs;
    a.h = (W*)L.h;
    a.c = L.c;
    a.pre = L.pre;
    a.part = L.part;
    a.xs = L.xs;
    a.sv = L.sv;
    a.sc = L.sc;
    a.pp = L.pp;
    a.clock = clock;
    return (int)launch_decode(pl, a, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

}  // namespace
}  // namespace icrl

extern "C" {

// Float32 elements of the workspace icrl_decode needs.
size_t icrl_decode_workspace_floats(int n, int F, int H, int V, int bf16, int pick) {
  size_t used = 0;
  icrl::decode_layout(nullptr, n, F, H, V, bf16, pick == icrl::PICK_FILTER, &used);
  return used;
}

// Greedy (pick 0) or sampled (pick 1: no filter, Gumbel-max in the head's
// epilogue; pick 2: top-k when top_k > 0, the nucleus p when top_p != 0, and
// with neither the Gumbel-max over the whole row in phase B) decode of n
// rows into out [n, T], on CUDA device `device`, whose `stream` runs the
// launches (the caller's current device is restored after them). Returns 0
// or the CUDA error of a launch (a refused cooperative launch included). All
// pointers are device pointers: feats [n, F] and the biases float32;
// wc [F, H], w = [wi; wh] [E + H, 4H] and head [H, Vh] (the head wo's
// columns, rows padded to Vh, a multiple of 8) bf16 when bf16 != 0, else
// float32; xg = emb @ wi [Vx, 4H]
// float32 (icrl_token_gates). V <= Vh is the vocabulary the picks range over
// (the noise counters row * V + col, uint32: n V < 2^32); bo holds at least
// V values. key0, key1: the host key's words (the step subkeys are carried in
// the launch); temp > 0. Needs T >= 2, n >= 1; a start token outside [0, Vx)
// fails a device assertion (decode_start_check_kernel, one small launch
// before the decode's). The plan (rows per tile, units, streaming or not,
// grid, head and cell row groups, shared bytes) must be decode_plan's for
// the pick. clock is null or 6 + 4 (T - 1) zeros on the device, which the
// launch fills with the times of its phases: 0 the start, 1 the set-up
// done, then for step t 2 + 4t phase A entered, + 1 done, + 2 phase B
// entered, + 3 done; then phase A's head tiles' summed clock64 cycles and
// their count, and the cell tiles' (DECODE_TILE_COST's measure).
int icrl_decode(int n, int F, int E, int H, int V, int Vh, int Vx, int T, int bf16, int pick,
                int top_k, int top_p, float temp, float p, unsigned key0, unsigned key1,
                int rows_per_tile, int units, int stream, int grid, int h_groups, int a_groups,
                int smem, const float* feats, const int* start, const void* wc, const float* bc,
                const float* xg, const void* w, const float* b, const void* head,
                const float* bo, int* out, float* ws, unsigned long long* clock, int device,
                void* stream_) {
  using namespace icrl;
  if (T < 2 || n < 1 || V < 1 || Vh % 8 || Vh < V || H % 4 || pick < 0 || pick >= PICKS ||
      (pick != PICK_ARGMAX && !(temp > 0.f)) ||
      (pick == PICK_FILTER && (top_k < 0 || top_k >= V)))
    return (int)cudaErrorInvalidValue;
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int code = decode_on_device(n, F, E, H, V, Vh, Vx, T, bf16, pick, top_k, top_p, temp, p,
                                    key0, key1, rows_per_tile, units, stream, grid, h_groups,
                                    a_groups, smem, feats, start, wc, bc, xg, w, b, head, bo, out,
                                    ws, clock, static_cast<cudaStream_t>(stream_));
  if (prev != device) cudaSetDevice(prev);
  return code;
}

}  // extern "C"
