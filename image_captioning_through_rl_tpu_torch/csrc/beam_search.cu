// Per-sample value-guided beam search on Hopper: one persistent cooperative
// launch.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_beam.py
// (fused_beam_search, body _beam_kernel, helpers _lstm_step and
// _max_mask_rounds). For N samples and B beams (R = N*B candidates), each of
// the T - 1 steps:
//   1. policy logits for every candidate and their logsumexp;
//   2. the top-B tokens per candidate, lowest index first on ties;
//   3. logp = topv - lse;
//   4. for each of the B^2 expansions, one critic LSTM cell from the parent's
//      (h_v, c_v), then V = linear2(linear1([feats; h_v']));
//   5. cand = parent_score - (vw * V + lw * logp);
//   6. the B smallest of the B^2 candidates per sample, lowest flat index
//      p*B + e first on ties;
//   7. reorder the history, scores, critic state (by (p, e)) and policy
//      state (by p), and write the new token to column t + 1;
//   8. advance the policy cell, except on the last step.
// Before step 0, beam 0 is live with score 0 and the clones score +inf.
// Output: tokens [N, B, T] int32 (written sample-major, so no de-interleave
// is needed) and scores [N, B] float32, beam 0 the best.
//
// Rounding points, as in the TPU kernel: features are cast to the weight
// type before the h0 product (pallas_beam.py:121-123) and inside
// [feats; h_v']; x and h are in the weight type for every gate product, the
// policy h for the head, and linear1's output for linear2.
//
// Design. A step multiplies the states entering it by [wo | p_wh | v_wh]
// (V + 8H columns, depth H) and then the B^2 expansion rows by w1[F:] (H
// columns): 5.5 MB of bf16 weights at COCO width. Every product but the last
// depends only on the entering states; a token only picks a row of an x-gate
// table (icrl_token_gates, once per weights). So the whole search is one
// cooperative launch, each step four phases split by grid barriers:
//   * Launch plan (beam_plan, mirrored by ops/fused_beam.beam_plan and
//     checked here): the columns of [wo | p_wh | v_wh] (the A slices: head,
//     then cells) are cut into slices of NC = 4U consecutive columns, U the
//     widest (bf16 32, 16, 8; float32 16, 8) whose slice fits shared memory
//     beside chain.cuh's cp.async ring while every slice has a block of its
//     own, one block per SM. The blocks left over replicate the slices as
//     row groups: h_groups copies of each head slice and a_groups of each
//     cell slice, the counts that make phase A's slowest block quickest
//     (BEAM_TILE_COST: a head tile's top-B epilogue costs about a second
//     product), then the grid largest (COCO width, bf16, N = 127: 8 head
//     slices x 8 + 32 cell slices x 2 = 128 blocks of 226 KB). A block loads
//     its slice once and keeps it for the whole search; where no width fits
//     (bf16 from H = 1024) the weights stream through the ring with the A
//     rows, and every block takes (slice, row tile) items in turn. w1[F:]
//     (H columns, the C slices) streams through the ring on every block,
//     c_cols columns a slice (BeamCTile): held stationary on blocks of its
//     own, it left phase C to the few blocks phase A did not need.
//   * Phase A: the A slices over the candidate rows (chain_product_src:
//     rnd(h) staged from L2, mma.sync from ldmatrix, or fmaf for float32
//     weights). A head slice keeps per row its max logit, the sum of
//     exp(l - max) and its sorted top-B (value, column) list; the logits never
//     reach memory. The policy and critic slices write h @ wh to an L2
//     scratch, per candidate row: a kept beam's policy cell is its parent's
//     row plus p_xg[new token] (the same product on the same row as a cell
//     after selection, only taken before it), and an expansion's critic cell
//     is its parent's row plus v_xg[token]. The policy slices idle on the
//     last step.
//   * Phase B: one warp per candidate row merges the head slices' lists (the
//     larger value first, the lower column among equal ones, across slices
//     too: the order is total, so the merge order does not matter) and their
//     sums, giving logp and the B tokens; then the block writes the B
//     expansion rows rnd(h_v') from the parent's critic row.
//   * Phase C: every block takes (C slice, row tile) items of the B^2
//     expansion rows: + fproj (the feature half of linear1 with b1,
//     rnd(feats) @ w1[:F] + b1, taken once before the loop), rounded, and
//     each row's partial linear2 dot over the slice.
//   * Phase D: each block takes a few whole samples, sums each expansion's
//     partials in slice order (so two calls give the same bits), scores the
//     B^2 candidates,
//     keeps the B best and reorders: the history, the scores, the kept
//     critic cells (recomputed from their parents' rows, the same function of
//     the same operands as phase B's, so the expansion rows need no c) and,
//     except on the last step, the kept beams' policy cells.
// Before the loop, in the same launch: h0 = rnd(feats) @ wc + bc and fproj
// (all blocks, by items), then rnd(h0) @ p_wh on the policy slices (one row
// per sample), then the first policy and critic cells on <START>. The
// expansion rows and both pre-activation scratches are the L2 traffic of a
// step; at N = 1024 the scratches (2 x R x 4H float32, 84 MB) exceed the
// 50 MB L2 and go to device memory. An optional clock (beam_mark) reads each
// phase's time; chip_smoke.py phase 6 reports it.
#include <assert.h>

#include "chain.cuh"

namespace icrl {
namespace {

constexpr int MAX_BEAM = 8;  // the top-B lists live in registers of this size

// The A products of a step in slice order (the head's V, both cells' 4H),
// then the C product (w1[F:]'s H).
enum BeamMat { BEAM_HEAD = 0, BEAM_POLICY, BEAM_VALUE, BEAM_LIN1, BEAM_MATS };

struct BeamCols {
  int c[BEAM_MATS];
  __host__ __device__ BeamCols(int H, int V) : c{V, 4 * H, 4 * H, H} {}
  __host__ __device__ int slices(int m, int nc) const { return ceil_div(c[m], nc); }
  __host__ __device__ int a_slices(int nc) const {
    return slices(BEAM_HEAD, nc) + slices(BEAM_POLICY, nc) + slices(BEAM_VALUE, nc);
  }
};

// The relative time of one row tile of a head slice and of a cell slice
// (policy or critic), which the plan balances (bf16 at COCO width on an
// H100: ~8 and ~4 us; the head's epilogue takes its top-B lists).
constexpr int BEAM_TILE_COST[2] = {2, 1};

// The C slices' width: linear1's columns stream through the ring, c_cols a
// slice, on every block (see BeamCTile).
template <typename W>
__host__ __device__ constexpr int c_cols() {
  return kIsBf16<W> ? 128 : 64;
}

// The launch plan; ops/fused_beam.py:beam_plan computes the same. Stationary:
// blocks [0, sh h_groups) hold the head slices, the next sp a_groups the cell
// slices, each slice's copies taking its row tiles in turn.
struct BeamPlan {
  int rows_per_tile, units, stream, grid, h_groups, a_groups;
  long smem;
};

template <typename W>
BeamPlan beam_plan(int n, int B, int F, int H, int V, int sms) {
  constexpr int kc = ChainRing<W>::KC;
  const long Kp = ceil_div(std::max(H, F), kc) * (long)kc;
  const BeamCols cols(H, V);
  auto co_resident = [&](long smem) {
    return smem > SMEM_PER_BLOCK ? 0L
                                 : sms * std::min(1L, SMEM_PER_SM / (smem + SMEM_RESERVED));
  };
  BeamPlan p{CHAIN_BR, 0, 0, 0, 0, 0, 0};
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
  const long co = co_resident(p.smem), nc = 4 * p.units, nn = std::max(n, 1);
  const long sh = cols.slices(BEAM_HEAD, nc), sp = cols.a_slices(nc) - sh;
  const long ta = ceil_div(nn * B, CHAIN_BR);
  // the least weighted time of phase A's slowest block, then the most blocks
  // (every block serves phases B, C and D)
  long best = -1;
  for (long gh = 1; gh <= ta && sh * gh + sp <= co; ++gh) {
    for (long gp = 1; gp <= ta && sh * gh + sp * gp <= co; ++gp) {
      const long cost = std::max(ceil_div(ta, gh) * BEAM_TILE_COST[0],
                                 ceil_div(ta, gp) * BEAM_TILE_COST[1]);
      const long grid = sh * gh + sp * gp;
      if (best < 0 || cost < best || (cost == best && grid > p.grid)) {
        best = cost;
        p.h_groups = (int)gh;
        p.a_groups = (int)gp;
        p.grid = (int)grid;
      }
    }
  }
  return p;
}

// One slice: its product, its first column and its index among that
// product's slices; beam_slice maps an A slice's index (the head's slices,
// then the cells') to it.
struct BeamSlice {
  int m, c0, idx;
};

__device__ __forceinline__ BeamSlice beam_slice(int s, const BeamCols& cols, int nc) {
  int m = 0;
  for (; m < BEAM_MATS - 1; ++m) {
    const int k = ceil_div(cols.c[m], nc);
    if (s < k) break;
    s -= k;
  }
  return {m, s * nc, s};
}

template <typename W>
struct BeamArgs {
  int n, F, E, H, V, Vh, T, B, h_groups, a_groups;
  float vw, lw;
  const float* feats;  // [n, F]
  const int* start;    // [n]
  const W* p_wc;       // [F, H]
  const float* p_bc;   // [H]
  const float* p_xg;   // [V, 4H] policy emb @ wi
  const W* p_w;        // [E + H, 4H] policy [wi; wh]
  const float* p_b;    // [4H]
  const W* p_wo;       // [H, Vh] the head, rows padded to Vh columns
  const float* p_bo;   // [V]
  const float* v_xg;   // critic, as the policy
  const W* v_w;
  const float* v_b;
  const W* v_w1;       // [F + H, H]
  const float* v_b1;   // [H]
  const W* v_w2;       // [H]
  const float* v_b2;   // [1]
  int* out_tokens;     // [n, B, T]
  float* scores;       // [n, B]
  // scratch (written and read inside the launch: plain loads, no .nc path)
  W *h0, *pol_h, *val_h, *vh2;  // [n, H], [R, H], [R, H], [R B, H] in the weight type
  float* fproj;                 // [n, H] rnd(feats) @ w1[:F] + b1
  float *pol_c[2], *val_c[2];   // [R, H] cell states, read from [cur], written to [cur ^ 1]
  float *pre_p, *hg;            // [R, 4H] rnd(h) @ wh of the entering states
  float* lpart;                 // per (row, head slice): max, sum, B values, B columns
  float* logp;                  // [R B]
  int* topi;                    // [R B]
  float* vpart;                 // per (expansion row, C slice): the linear2 partial
  int* hist2;                   // [R, T] the history's other buffer
  int lp, vp;                   // slices allocated per row: ceil(V / 32), ceil(H / 32)
  // null, or beam_clock_slots(T) zeros: a profile of the phases (beam_mark)
  unsigned long long* clock;
};

template <typename W>
__device__ __forceinline__ ColSlice<W> beam_weight(const BeamArgs<W>& a, int m, int c0) {
  const int H = a.H;
  switch (m) {
    case BEAM_HEAD:
      return {a.p_wo, H, a.V, a.Vh, c0};
    case BEAM_POLICY:
      return {a.p_w + (size_t)a.E * 4 * H, H, 4 * H, 4 * H, c0};
    case BEAM_VALUE:
      return {a.v_w + (size_t)a.E * 4 * H, H, 4 * H, 4 * H, c0};
    default:
      return {a.v_w1 + (size_t)a.F * H, H, H, H, c0};
  }
}

// The profile: when a.clock is given, thread 0 of every block raises slot k
// to the %globaltimer nanoseconds at which it passed mark k, so each slot
// holds the latest block's time: 0 the start, 1 the set-up done, then for
// step t and phase q (A, B, C, D) 2 + 8t + 2q entered and + 1 done. A null
// clock costs a branch.
template <typename W>
__device__ __forceinline__ void beam_mark(const BeamArgs<W>& a, int k) {
  clock_mark(a.clock, k);
}

// A sorted top-B list in registers: (v, i) enters where it ranks, the last
// entry leaves (by selects: no branch).
__device__ __forceinline__ void list_insert(float (&tv)[MAX_BEAM], int (&ti)[MAX_BEAM], int B,
                                            float v, int i) {
#pragma unroll
  for (int k = 0; k < MAX_BEAM; ++k) {
    const bool in = (k < B) & ranks_before(v, i, tv[k], ti[k]);
    const float tvk = tv[k];
    const int tik = ti[k];
    tv[k] = in ? v : tvk;
    ti[k] = in ? i : tik;
    v = in ? tvk : v;
    i = in ? tik : i;
  }
}

__device__ __forceinline__ void list_init(float (&tv)[MAX_BEAM], int (&ti)[MAX_BEAM]) {
#pragma unroll
  for (int k = 0; k < MAX_BEAM; ++k) {
    tv[k] = -INFINITY;
    ti[k] = 0x7fffffff;  // sentinel: ranks after every real column
  }
}

// Entry ``head`` of the list (a register array read at a runtime index).
__device__ __forceinline__ void list_at(const float (&tv)[MAX_BEAM], const int (&ti)[MAX_BEAM],
                                        int head, float& v, int& i) {
  v = -INFINITY;
  i = 0x7fffffff;
#pragma unroll
  for (int q = 0; q < MAX_BEAM; ++q)
    if (q == head) {
      v = tv[q];
      i = ti[q];
    }
}

// The B best of ``width`` lanes' sorted lists, best first: B rounds of a
// first-index argmax over the lanes' list heads (column indices are unique,
// so exactly one lane advances a round). Every lane gets each round's
// winner through emit(k, v, i).
template <class Emit>
__device__ __forceinline__ void lists_merge(const float (&tv)[MAX_BEAM],
                                            const int (&ti)[MAX_BEAM], int B, int width,
                                            const Emit& emit) {
  int head = 0;
  for (int k = 0; k < B; ++k) {
    float v;
    int i;
    list_at(tv, ti, head, v, i);
    const int mine = i;
    argmax_width(v, i, width);
    if (mine == i) ++head;
    emit(k, v, i);
  }
}

// The history buffer step t writes (reading step t - 1's): the last step
// (t = S - 1) writes to out_tokens.
template <typename W>
__device__ __forceinline__ int* beam_hist(const BeamArgs<W>& a, int t) {
  return ((a.T - 2 - t) % 2 == 0) ? a.out_tokens : a.hist2;
}

// A head slice's epilogue over the row tile at row0 (rows < R): the four
// threads of a row take its local columns q + 4i (conflict-free reads of
// Cs) and every row is done at once. Per row: the logits (the bias added in
// place in Cs), their max and the sum of exp(l - max), then the B best as B
// rounds: each thread's best column that ranks after the round before's
// winner (its columns ascend, so a strict > keeps the first of equal
// values), then a first-index argmax over the four threads. Every reduction
// over a thread's columns runs as four interleaved chains (i % 4), and every
// test is a select: written with short-circuit tests, each column was a
// branch and a reconvergence point, and phase A took nearly twice as long.
template <class Tl, typename W>
__device__ void head_epilogue(const BeamArgs<W>& a, float* Cs, int cld, const BeamSlice& sl,
                              int lim, int row0) {
  constexpr int CPT = Tl::NC / 4;
  static_assert(CHAIN_THREADS == 4 * CHAIN_BR, "four threads a row");
  const int tid = threadIdx.x, r = tid / 4, q = tid % 4, row = row0 + r, B = a.B;
  float* cr = Cs + r * cld;
  float bias[CPT], mm[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < CPT; ++i) bias[i] = a.p_bo[sl.c0 + min(q + 4 * i, lim - 1)];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = q + 4 * i;
    const float l = c < lim ? cr[c] + bias[i] : -INFINITY;
    cr[c] = l;
    mm[i % 4] = fmaxf(mm[i % 4], l);
  }
  float m = fmaxf(fmaxf(mm[0], mm[1]), fmaxf(mm[2], mm[3]));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
  float ss[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < CPT; ++i) ss[i % 4] += expf(cr[q + 4 * i] - m);  // exp(-inf) = 0 past lim
  const float se = sum4((ss[0] + ss[1]) + (ss[2] + ss[3]));
  const bool write = q == 0 && row < a.n * B;
  float* out = a.lpart + ((size_t)row * a.lp + sl.idx) * (2 + 2 * B);
  float pv = INFINITY;  // the round before's winner: every column ranks after it
  int pi = -1;
  for (int k = 0; k < B; ++k) {
    float v[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    int idx[4] = {0x7fffffff, 0x7fffffff, 0x7fffffff, 0x7fffffff};  // sentinels
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const float l = cr[q + 4 * i];  // -inf past lim: never taken
      const int col = sl.c0 + q + 4 * i;
      const bool take = ((l < pv) | ((l == pv) & (col > pi))) & (l > v[i % 4]);
      v[i % 4] = take ? l : v[i % 4];
      idx[i % 4] = take ? col : idx[i % 4];
    }
#pragma unroll
    for (int j = 1; j < 4; ++j) {  // the chains' winners, under the full tie rule
      const bool take = ranks_before(v[j], idx[j], v[0], idx[0]);
      v[0] = take ? v[j] : v[0];
      idx[0] = take ? idx[j] : idx[0];
    }
    argmax_width(v[0], idx[0], 4);
    pv = v[0];
    pi = idx[0];
    if (write) {
      out[2 + k] = pv;
      out[2 + B + k] = __int_as_float(pi);
    }
  }
  if (write) {
    out[0] = m;
    out[1] = se;
  }
}

// The C slices' tile: linear1's columns c_cols at a time streamed through
// the ring with the expansion rows, on every block, so phase C spreads over
// the whole grid (as stationary slices it had only the blocks phase A left
// over). Its ring fits inside the A slices' ring by a shallower depth a slot
// (bf16 64 rows, three slots; float32 32 rows, two slots): a slice as wide
// as the A slices', since a tile's time is mostly its expansion rows'
// staging, whatever its width (32-column slices took about as long a tile,
// with four times the tiles).
template <typename W>
struct BeamCTile : ChainTile<W, false, c_cols<W>() / 4, 4, true> {
  static constexpr int KC = kIsBf16<W> ? 64 : 32, STAGES = kIsBf16<W> ? 3 : 2;
};

// A C slice's epilogue: per expansion row r2 (sample r2 / B^2), the partial
// sum over the slice's columns of rnd(fproj + acc) * w2. One warp per row,
// lane l over the local columns l + 32k; a warp loads the fproj parts of all
// its rows before it uses any.
template <class Tl, typename W>
__device__ void value_epilogue(const BeamArgs<W>& a, const float* Cs, int cld, const BeamSlice& sl,
                               int lim, int row0) {
  constexpr int CPL = Tl::NC / 32, RPW = CHAIN_BR / (CHAIN_THREADS / 32);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, BB = a.B * a.B;
  const int R2 = a.n * BB;
  float z[CPL], x[RPW][CPL];
  // every load unconditional (columns past lim read the last one, weighted
  // 0), so none waits behind a branch
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    z[k] = c < lim ? ld(a.v_w2 + sl.c0 + c) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = min(row0 + warp + 8 * i, R2 - 1);
    const float* fp = a.fproj + (size_t)(row / BB) * a.H + sl.c0;
#pragma unroll
    for (int k = 0; k < CPL; ++k) x[i][k] = fp[min(lane + 32 * k, lim - 1)];
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + 8 * i, row = row0 + r;
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) dot += rnd<W>(x[i][k] + Cs[r * cld + lane + 32 * k]) * z[k];
    dot = warp_sum(dot);
    if (lane == 0 && row < R2) a.vpart[(size_t)row * a.vp + sl.idx] = dot;
  }
}

// Phase A of step t (t = -1: rnd(h0) @ p_wh on the policy slices, one row per
// sample).
template <class Tl, typename W>
__device__ void phase_a(const BeamArgs<W>& a, const ChainStage<Tl>& st, const BeamCols& cols,
                        int my_slice, int group, int groups, int t) {
  const int H = a.H, S = a.T - 1, nrows = t < 0 ? a.n : a.n * a.B;
  const int tiles = ceil_div(nrows, CHAIN_BR);
  for_items<Tl::STREAM>(my_slice, group, groups, cols.a_slices(Tl::NC), tiles,
                        [&](int s, int rt) {
    const BeamSlice sl = beam_slice(s, cols, Tl::NC);
    if (sl.m == BEAM_POLICY ? t + 1 >= S && t >= 0 : t < 0) return;
    const ColSlice<W> src = beam_weight(a, sl.m, sl.c0);
    const int lim = min(Tl::NC, cols.c[sl.m] - sl.c0), row0 = rt * CHAIN_BR;
    const W* x = t < 0 ? a.h0 : sl.m == BEAM_VALUE ? a.val_h : a.pol_h;
    float* Cs = st.product(x, H, row0, nrows, H, src);
    __syncthreads();
    if (sl.m == BEAM_HEAD)
      head_epilogue<Tl>(a, Cs, ChainStage<Tl>::CLD, sl, lim, row0);
    else
      pre_epilogue<Tl>(sl.m == BEAM_POLICY ? a.pre_p : a.hg, 4 * H, nrows, Cs,
                       ChainStage<Tl>::CLD, sl.c0, lim, row0);
    __syncthreads();  // Cs overlays the ring the next product fills
  });
}

// Phase B of step t: this block's candidate rows, a batch of at most 8 at a
// time, one warp per row for the merge, then every thread over the batch's
// (row, expansion, four units) items.
template <typename W>
__device__ void phase_b(const BeamArgs<W>& a, const BeamCols& cols, int nc, int* sh, int cur) {
  const int B = a.B, H = a.H, R = a.n * B, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nblk = gridDim.x, nh = ceil_div(cols.c[BEAM_HEAD], nc), LS = 2 + 2 * B;
  const int rb = max(1, min(CHAIN_THREADS / 32, ceil_div(R, nblk)));
  for (int r0 = blockIdx.x * rb; r0 < R; r0 += nblk * rb) {
    const int rows = min(rb, R - r0);
    if (warp < rows) {
      const int row = r0 + warp;
      const float* base = a.lpart + (size_t)row * a.lp * LS;
      float m = -INFINITY;
      for (int s = lane; s < nh; s += 32) m = fmaxf(m, base[s * LS]);
      m = warp_max(m);
      float se = 0.f, tv[MAX_BEAM], last_v = -INFINITY;
      int ti[MAX_BEAM], last_i = 0x7fffffff;
      list_init(tv, ti);
      for (int s = lane; s < nh; s += 32) {
        const float* p = base + s * LS;
        float pv[MAX_BEAM];
        int pi[MAX_BEAM];
#pragma unroll
        for (int k = 0; k < MAX_BEAM; ++k)
          if (k < B) {  // every load of the slice's list issued before any is used
            pv[k] = p[2 + k];
            pi[k] = __float_as_int(p[2 + B + k]);
          }
        se += expf(p[0] - m) * p[1];
#pragma unroll
        for (int k = 0; k < MAX_BEAM; ++k)
          if ((k < B) & ranks_before(pv[k], pi[k], last_v, last_i)) {
            list_insert(tv, ti, B, pv[k], pi[k]);
            list_at(tv, ti, B - 1, last_v, last_i);
          }
      }
      se = warp_sum(se);
      const float log_sum = logf(se);
      lists_merge(tv, ti, B, 32, [&](int k, float v, int i) {
        if (lane == 0) {
          a.logp[(size_t)row * B + k] = (v - m) - log_sum;
          a.topi[(size_t)row * B + k] = i;
          sh[warp * MAX_BEAM + k] = i;
        }
      });
    }
    __syncthreads();
    // a (row, four units) item a thread: the parent's parts once, then the
    // expansions' x-gate rows four at a time, every load before its use
    const int H4 = H / 4, items = rows * H4;
    for (int e = tid; e < items; e += CHAIN_THREADS) {
      const int w = e / H4, j = e % H4 * 4, row = r0 + w;
      Cell4 in;
      ld_gates(in.p, H, a.hg + (size_t)row * 4 * H + j);
      ld_gates(in.b, H, a.v_b + j);
      ld4(in.c, a.val_c[cur] + (size_t)row * H + j);
      for (int x0 = 0; x0 < B; x0 += 4) {
        float xs[4][4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)  // past B: the last expansion's row again, unused
          ld_gates(xs[q], H, a.v_xg + (size_t)sh[w * MAX_BEAM + min(x0 + q, B - 1)] * 4 * H + j);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (x0 + q < B) {
            float h[4], c[4];
            cell_math(xs[q], in, h, c);
            st4(a.vh2 + ((size_t)row * B + x0 + q) * H + j, h);
          }
      }
    }
    __syncthreads();  // sh serves the next batch
  }
}

// Phase D of step t (t = -1: the first cells on <START>, the history's start
// column and the scores): this block's samples, a batch of at most 8 at a
// time, every thread over the batch's (sample, candidate), then (sample,
// beam, four units) items.
template <typename W>
__device__ void phase_d(const BeamArgs<W>& a, int nc_slices, int* sh, int t, int cur) {
  constexpr int SB = 8, QB = MAX_BEAM * MAX_BEAM;  // samples a batch, candidates a sample
  const int B = a.B, BB = B * B, H = a.H, T = a.T, S = T - 1, tid = threadIdx.x, H4 = H / 4;
  float* cand = reinterpret_cast<float*>(sh);  // [SB][QB]
  int* sel = sh + SB * QB;                      // [SB][MAX_BEAM]
  int* tok = sel + SB * MAX_BEAM;               // [SB][MAX_BEAM]
  int* hist_out = beam_hist(a, t);
  const int nblk = gridDim.x, sb = max(1, min(SB, ceil_div(a.n, nblk)));
  for (int n0 = blockIdx.x * sb; n0 < a.n; n0 += nblk * sb) {
    const int ns = min(sb, a.n - n0), nB0 = n0 * B;
    if (t < 0) {
      for (int i = tid; i < ns * B * T; i += CHAIN_THREADS)
        hist_out[(size_t)nB0 * T + i] = i % T ? 0 : a.start[n0 + i / (B * T)];
      for (int i = tid; i < ns * B; i += CHAIN_THREADS) a.scores[nB0 + i] = i % B ? INFINITY : 0.f;
      for (int e = tid; e < ns * B * H4; e += CHAIN_THREADS) {
        const int n = n0 + e / (B * H4), j = e % H4 * 4, st = a.start[n];
        const size_t o = (size_t)(nB0 + e / H4) * H + j;
        Cell4 pin, vin;
        cell_load(pin, H, a.p_xg + (size_t)st * 4 * H + j, a.pre_p + (size_t)n * 4 * H + j,
                  a.p_b + j, nullptr);
        cell_load(vin, H, a.v_xg + (size_t)st * 4 * H + j, nullptr, a.v_b + j, nullptr);
        cell_store(pin, a.pol_h + o, a.pol_c[cur] + o);
        cell_store(vin, a.val_h + o, a.val_c[cur] + o);
      }
      continue;
    }
    for (int i = tid; i < ns * BB; i += CHAIN_THREADS) {
      const int sj = i / BB, q = i % BB;
      const size_t r2 = (size_t)nB0 * B + i;  // expansion (n0 + sj, p = q / B, e = q % B)
      float dot = 0.f;
      for (int s = 0; s < nc_slices; ++s) dot += a.vpart[r2 * a.vp + s];
      const float value = dot + a.v_b2[0];
      cand[sj * QB + q] = a.scores[nB0 + sj * B + q / B] - (a.vw * value + a.lw * a.logp[r2]);
    }
    __syncthreads();
    // candidate q's rank among its sample's B^2: smaller scores first, the
    // lower flat index first on ties; the B best land in sel in rank order
    for (int i = tid; i < ns * BB; i += CHAIN_THREADS) {
      const int sj = i / BB, q = i % BB;
      const float* c = cand + sj * QB;
      int rank = 0;
      for (int q2 = 0; q2 < BB; ++q2) rank += (c[q2] < c[q]) | ((c[q2] == c[q]) & (q2 < q));
      if (rank < B) sel[sj * MAX_BEAM + rank] = q;
    }
    __syncthreads();
    for (int i = tid; i < ns * B; i += CHAIN_THREADS) {
      const int sj = i / B, q = sel[sj * MAX_BEAM + i % B];
      a.scores[nB0 + i] = cand[sj * QB + q];
      tok[sj * MAX_BEAM + i % B] = a.topi[((size_t)nB0 + sj * B) * B + q];
    }
    __syncthreads();
    const int* hist_in = beam_hist(a, t - 1);
    for (int i = tid; i < ns * B * T; i += CHAIN_THREADS) {
      const int sj = i / (B * T), k = i / T % B, j = i % T, sk = sj * MAX_BEAM + k;
      hist_out[(size_t)nB0 * T + i] =
          j == t + 1 ? tok[sk] : hist_in[((size_t)nB0 + sj * B + sel[sk] / B) * T + j];
    }
    if (t + 1 < S) {
      for (int e = tid; e < ns * B * H4; e += CHAIN_THREADS) {
        const int sj = e / (B * H4), k = e / H4 % B, j = e % H4 * 4, sk = sj * MAX_BEAM + k;
        const int tk = tok[sk];
        const size_t par = (size_t)nB0 + sj * B + sel[sk] / B, o = (size_t)(nB0 + e / H4) * H + j;
        Cell4 vin, pin;  // the kept critic cell as phase B made it, and the policy's
        cell_load(vin, H, a.v_xg + (size_t)tk * 4 * H + j, a.hg + par * 4 * H + j, a.v_b + j,
                  a.val_c[cur] + par * H + j);
        cell_load(pin, H, a.p_xg + (size_t)tk * 4 * H + j, a.pre_p + par * 4 * H + j, a.p_b + j,
                  a.pol_c[cur] + par * H + j);
        cell_store(vin, a.val_h + o, a.val_c[cur ^ 1] + o);
        cell_store(pin, a.pol_h + o, a.pol_c[cur ^ 1] + o);
      }
    }
    __syncthreads();  // the shared arrays serve the next batch
  }
}

template <class Tl, typename W>
__device__ void beam_steps(const BeamArgs<W>& a, const ChainStage<Tl>& st) {
  constexpr int NC = Tl::NC;
  const int n = a.n, H = a.H, S = a.T - 1;
  const BeamCols cols(H, a.V);
  const int sh = cols.slices(BEAM_HEAD, NC), sp = cols.a_slices(NC) - sh;
  constexpr int CC = c_cols<typename Tl::W>();
  const int sc = ceil_div(H, CC);
  // this block's slice (stationary): a head slice or a cell slice, by the
  // plan's two ranges of blocks
  int a_slice = -1, a_group = 0, a_groups = 0;
  if constexpr (!Tl::STREAM) {
    const int b = blockIdx.x, hb = sh * a.h_groups;
    if (b < hb) {
      a_slice = b % sh;
      a_group = b / sh;
      a_groups = a.h_groups;
    } else {
      a_slice = sh + (b - hb) % sp;
      a_group = (b - hb) / sp;
      a_groups = a.a_groups;
    }
  }
  beam_mark(a, 0);
  // h0 = rnd(feats) @ wc + bc (in the weight type) and fproj =
  // rnd(feats) @ w1[:F] + b1, by items over every block
  {
    const int ns = ceil_div(H, NC), tiles = ceil_div(n, CHAIN_BR);
    for (int i = blockIdx.x; i < 2 * ns * tiles; i += gridDim.x) {
      const int j = i % (2 * ns), rt = i / (2 * ns), c0 = j % ns * NC, row0 = rt * CHAIN_BR;
      const bool lin1 = j >= ns;
      const ColSlice<W> src{lin1 ? a.v_w1 : a.p_wc, a.F, H, H, c0};
      st.load(src, a.F);
      const float* Cs = st.product(a.feats, a.F, row0, n, a.F, src);
      __syncthreads();
      constexpr int Q = NC / 4, RS = CHAIN_THREADS / Q;
      const int c = threadIdx.x % Q * 4;
      if (c0 + c < H) {
        float bias[4];
        ld4(bias, (lin1 ? a.v_b1 : a.p_bc) + c0 + c);
        for (int r = threadIdx.x / Q; r < CHAIN_BR && row0 + r < n; r += RS) {
          float v[4];
          ld4(v, Cs + r * ChainStage<Tl>::CLD + c);
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] += bias[u];
          const size_t o = (size_t)(row0 + r) * H + c0 + c;
          if (lin1)
            st4(a.fproj + o, v);
          else
            st4(a.h0 + o, v);
        }
      }
      __syncthreads();  // Cs overlays the ring the next product fills
    }
  }
  if (a_slice >= 0) {
    const BeamSlice sl = beam_slice(a_slice, cols, NC);
    st.load(beam_weight(a, sl.m, sl.c0), H);
  }
  // phase C's ring: where phase A's starts (after the stationary slice)
  using CT = BeamCTile<typename Tl::W>;
  const ChainSmem<CT> csm(reinterpret_cast<unsigned char*>(ChainSmem<Tl>(st.base, H).ring), H);
  int* scratch = st.scratch();  // phases B and D's few shared values
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();
  phase_a<Tl>(a, st, cols, a_slice, a_group, a_groups, -1);
  grid.sync();
  phase_d(a, sc, scratch, -1, 0);
  beam_mark(a, 1);
  int cur = 0;
  for (int t = 0; t < S; ++t) {
    const int k = 2 + 8 * t;
    grid.sync();
    beam_mark(a, k);
    phase_a<Tl>(a, st, cols, a_slice, a_group, a_groups, t);
    beam_mark(a, k + 1);
    grid.sync();
    beam_mark(a, k + 2);
    phase_b(a, cols, NC, scratch, cur);
    beam_mark(a, k + 3);
    grid.sync();
    beam_mark(a, k + 4);
    const int c_rows = n * a.B * a.B, c_tiles = ceil_div(c_rows, CHAIN_BR);
    for (int i = blockIdx.x; i < sc * c_tiles; i += gridDim.x) {
      const BeamSlice sl{BEAM_LIN1, i % sc * CC, i % sc};
      const int row0 = i / sc * CHAIN_BR;
      chain_product_src<CT>(csm, a.vh2, H, row0, c_rows, H, beam_weight(a, sl.m, sl.c0));
      __syncthreads();
      value_epilogue<CT>(a, csm.Cs, ChainSmem<CT>::CLD, sl, min(CC, H - sl.c0), row0);
      __syncthreads();  // Cs overlays the ring the next product fills
    }
    beam_mark(a, k + 5);
    grid.sync();
    beam_mark(a, k + 6);
    phase_d(a, sc, scratch, t, cur);
    beam_mark(a, k + 7);
    cur ^= 1;
  }
}

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) beam_kernel(BeamArgs<W> a) {
  using Tl = ChainTile<W, false, U, 4, kStream>;
  extern __shared__ __align__(16) unsigned char beam_smem[];
  beam_steps<Tl>(a, ChainStage<Tl>{beam_smem, a.H});
}

// The start tokens' range, checked on the device before the search reads
// them (the wrapper does not sync for it): a token outside [0, Vx) fails the
// assertion, and the stream with it. A launch of its own: an assert inside
// the search's kernel (a call to __assertfail) slowed its phase A by a
// quarter at N = 1024.
__global__ void beam_start_check_kernel(int n, int Vx, const int* __restrict__ start) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    assert(static_cast<unsigned>(start[i]) < static_cast<unsigned>(Vx));
}

template <typename W, int U, bool kStream>
cudaError_t launch_beam_kernel(const BeamPlan& p, BeamArgs<W> a, cudaStream_t s) {
  const auto kernel = beam_kernel<W, U, kStream>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  void* argv[] = {&a};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.grid), dim3(CHAIN_THREADS),
                                     argv, (size_t)p.smem, s);
}

template <typename W>
cudaError_t launch_beam(const BeamPlan& p, const BeamArgs<W>& a, cudaStream_t s) {
  constexpr int SU = stream_units<W, false, 4>();
  if (p.stream) return launch_beam_kernel<W, SU, true>(p, a, s);
  switch (p.units) {
    case 32:
      if constexpr (kIsBf16<W>) return launch_beam_kernel<W, 32, false>(p, a, s);
      break;
    case 16:
      return launch_beam_kernel<W, 16, false>(p, a, s);
    case 8:
      return launch_beam_kernel<W, 8, false>(p, a, s);
  }
  return cudaErrorInvalidValue;
}

// The workspace: every h in the weight type (only ever read as a product's
// rounded operand); c, products, partials and scores in float32; the
// partials sized for the narrowest slices (32 columns).
struct BeamLayout {
  float *h0, *pol_h, *val_h, *vh2, *fproj, *pol_c[2], *val_c[2], *pre_p, *hg, *lpart, *logp,
      *vpart;
  int *topi, *hist2;
  int lp, vp;
};

BeamLayout beam_layout(float* ws, int n, int H, int V, int T, int B, size_t* used = nullptr) {
  const size_t R = (size_t)n * B, R2 = R * B;
  Carver cv{ws};
  BeamLayout l;
  l.lp = ceil_div(V, 32);
  l.vp = ceil_div(H, 32);
  l.h0 = cv.take((size_t)n * H);  // W-typed regions: float32 at most
  l.pol_h = cv.take(R * H);
  l.val_h = cv.take(R * H);
  l.vh2 = cv.take(R2 * H);
  l.fproj = cv.take((size_t)n * H);
  for (int i = 0; i < 2; ++i) {
    l.pol_c[i] = cv.take(R * H);
    l.val_c[i] = cv.take(R * H);
  }
  l.pre_p = cv.take(R * 4 * H);
  l.hg = cv.take(R * 4 * H);
  l.lpart = cv.take(R * l.lp * (2 + 2 * B));
  l.logp = cv.take(R * B);
  l.vpart = cv.take(R2 * l.vp);
  l.topi = cv.take<int>(R * B);
  l.hist2 = cv.take<int>(R * T);
  if (used) *used = cv.used;
  return l;
}

}  // namespace
}  // namespace icrl

extern "C" {

int icrl_beam_max_beam() { return icrl::MAX_BEAM; }

// Float32 elements of the workspace icrl_beam_search needs.
size_t icrl_beam_workspace_floats(int n, int H, int V, int T, int B) {
  size_t used = 0;
  icrl::beam_layout(nullptr, n, H, V, T, B, &used);
  return used;
}

// Returns 0 or the CUDA error of the launch (a refused cooperative launch
// included). All pointers are device pointers. Policy: wc [F, H],
// w = [wi; wh] [E + H, 4H], wo [H, Vh] (the head's V columns, each row padded
// to Vh, a multiple of 8 columns); value: w [E + H, 4H], w1 [F + H, H],
// w2 [H]. These are bf16 when bf16 != 0, else float32; every bias (bo has V
// elements, b2 one) and both x-gate tables xg (emb @ wi, [Vx, 4H] for the
// embedding's Vx rows, from icrl_token_gates) are float32. Needs
// 1 <= B <= icrl_beam_max_beam(), T >= 2 and n >= 1; a start token outside
// [0, Vx) fails a device assertion (beam_start_check_kernel, one small
// launch before the search's). The plan (rows per tile,
// units, streaming or not, grid, A and C row groups, shared bytes) must be
// beam_plan's. clock is null or 2 + 8 (T - 1) zeros on the device, which the
// launch fills with the times of its phases (beam_mark).
int icrl_beam_search(int n, int F, int E, int H, int V, int Vh, int Vx, int T, int B, float vw,
                     float lw,
                     int bf16, int rows_per_tile, int units, int stream, int grid, int h_groups,
                     int a_groups, int smem, const float* feats, const int* start,
                     const void* p_wc, const float* p_bc, const float* p_xg, const void* p_w,
                     const float* p_b, const void* p_wo, const float* p_bo, const float* v_xg,
                     const void* v_w, const float* v_b, const void* v_w1, const float* v_b1,
                     const void* v_w2, const float* v_b2, int* out_tokens, float* out_scores,
                     float* ws, unsigned long long* clock, void* stream_) {
  using namespace icrl;
  if (B < 1 || B > MAX_BEAM || T < 2 || n < 1 || Vh % 8 || Vh < V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const int sms = device_sms();
  const BeamPlan p = bf16 ? beam_plan<__nv_bfloat16>(n, B, F, H, V, sms)
                          : beam_plan<float>(n, B, F, H, V, sms);
  if (p.rows_per_tile != rows_per_tile || p.units != units || p.stream != stream ||
      p.grid != grid || p.h_groups != h_groups || p.a_groups != a_groups || p.smem != smem)
    return (int)cudaErrorInvalidValue;
  beam_start_check_kernel<<<1, 256, 0, s>>>(n, Vx, start);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BeamLayout L = beam_layout(ws, n, H, V, T, B);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    const BeamArgs<W> a{n,
                        F,
                        E,
                        H,
                        V,
                        Vh,
                        T,
                        B,
                        p.h_groups,
                        p.a_groups,
                        vw,
                        lw,
                        feats,
                        start,
                        (const W*)p_wc,
                        p_bc,
                        p_xg,
                        (const W*)p_w,
                        p_b,
                        (const W*)p_wo,
                        p_bo,
                        v_xg,
                        (const W*)v_w,
                        v_b,
                        (const W*)v_w1,
                        v_b1,
                        (const W*)v_w2,
                        v_b2,
                        out_tokens,
                        out_scores,
                        (W*)L.h0,
                        (W*)L.pol_h,
                        (W*)L.val_h,
                        (W*)L.vh2,
                        L.fproj,
                        {L.pol_c[0], L.pol_c[1]},
                        {L.val_c[0], L.val_c[1]},
                        L.pre_p,
                        L.hg,
                        L.lpart,
                        L.logp,
                        L.topi,
                        L.vpart,
                        L.hist2,
                        L.lp,
                        L.vp,
                        clock};
    return (int)launch_beam(p, a, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

}  // extern "C"
