// The A2C rollout's forward on Hopper: one persistent cooperative launch.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_rollout.py
// _rollout_fwd_kernel (fused_rollout). Over S = T - 1 steps from the
// start-token states (h_p, c_p), (h_v, c_v) and, with the reward stream fused
// in, h_r, step s (position p = s + 1) computes:
//   logits = rnd(h_p) @ hw + hb
//   action = first argmax of logits + noise[s]          (Gumbel-max: categorical)
//   logp   = (logits - max)[action] - log(sum(exp(logits - max)))
//   v1     = rnd(feats) @ w1[:F] + rnd(h_v) @ w1[F:] + b1,  value = rnd(v1) . rnd(w2) + b2
//   token  = teacher[s] if p < curr_seq_len else action
//   reward = the reward stream's step (reward_stream.cuh), when fused in:
//     gh = rnd(h_r) @ r_wh + bh, after = gru(xg_r[action], gh, h_r),
//     se = rnd(after) @ sem_w + sem_b, reward = vn . se / max(|se|, 1e-12),
//     h_r advances on the token
//   (h_p, c_p), (h_v, c_v) advance with the token (not on the last step:
//   nothing reads those states, and the backward's chain ends one step early).
// The tape is float32: h and c entering every step, the post-activation gates
// of every advance, and v1 (RolloutTape in ops/fused_rollout.py; the backward,
// rollout.cu, reads it). Rounding points are the TPU kernel's: h_p before the
// head; feats, h_v and v1 in the value MLP; the embedding row (through the
// x-gate table) and h in each cell; h_r and `after` before their products.
// Sums, gate math, the softmax and the tape are float32.
//
// What bounds it: a step multiplies six weight matrices of depth H by the
// states entering it, [N, H] @ [H, Vp | H | 4H | 4H | 3H | H] (7664 columns
// at COCO width, 7.85 MB in bf16, ~4 GFLOP at N = 512), and every product
// but the semantic one depends only on those states: the token only picks
// the row of an x-gate table. So a step is two phases with a grid barrier
// after each, in one launch for the whole rollout:
//   * Launch plan (rollout_plan, mirrored by ops/fused_rollout.rollout_plan
//     and checked here): the columns of the six matrices, in that order, are
//     cut into slices of NC = 4U consecutive columns (bf16 U = 32, 16 or 8;
//     float32 16 or 8), the widest whose slice fits shared memory beside the
//     chains' cp.async ring while every slice has a block of its own, one
//     block per SM; the blocks left over make row groups, each a replica of
//     the weights (COCO width, bf16: 60 slices of 128 columns x 2 row groups,
//     120 blocks of 226 KB). A block loads its slice once and keeps it for
//     all S steps (chain.cuh's stationary mode); where no slice width fits
//     (bf16 from H = 1024) the weights stream through the ring with the A
//     rows every step (the streaming mode), and a block walks several slices.
//     The cells' columns need not lie gate-major in a block, as the chains'
//     do: a cell cannot finish before the token is known, so its products go
//     through an L2 scratch either way.
//   * Phase A: each block multiplies its slices for its row tiles
//     (chain_product_src: rnd(h) rows staged from L2, mma.sync from
//     ldmatrix, or fmaf for float32 weights) and reduces in its epilogue:
//     the head's slices keep, per row, the maximum logit, the sum of
//     exp(l - max) and the largest l + noise with its first index and its
//     logit (the logits never reach device memory); linear1's slices write
//     v1 to the tape and each row's partial rnd(v1) . rnd(w2); the cells'
//     and the reward GRU's slices write their pre-activations (gh with bh)
//     to the scratch; the semantic slices take step s - 1's after, so that
//     product shares a phase with step s's, and keep each row's partial
//     |se|^2 and vn . se. rnd(feats) @ w1[:F] runs once, before the loop,
//     on the linear1 blocks (which then load w1[F:]).
//   * Phase B: each block takes a few whole rows. One warp per row combines
//     the row's partials, lane-strided over the slices and then a xor
//     butterfly (a fixed order: every block and every call gets the same
//     bits): the action (the first index among equal maxima, across slices
//     too), its log-prob, the value, the token and the reward of step s - 1;
//     then the block finishes the row's cells from the scratch, the x-gate
//     rows and the biases, writing h, c and the gate tape and the W-typed
//     copies of h that the next phase A stages.
// One more phase A and B after the loop take the last step's reward. So the
// forward is 2S (+ 1) grid barriers in one launch, against ~9 dependent
// launches a step before; its floor is the A rows' re-reads from L2 (each
// block stages all its rows every step), the phases' serial epilogues and
// the barriers, not the ~4 GFLOP. PERF.md holds the times; chip_smoke.py
// phase 15 reads each phase's through the optional clock (clock_mark).
//
// The reward stream alone (TPU kernel 5; reward_stream.cu) is the same
// launch in its reward-only mode (rollout_steps<Tl, true>, as
// reward_stream_kernel): the head's, linear1's and both cells' products
// have no columns, so the plan deals out only the reward GRU's 3H and
// semantic_embed's H (at COCO width, bf16: 16 slices of 128 columns x 8 row
// groups, one 64-row tile a block at N = 512), and phase B reads each row's
// action and token from the inputs instead of combining the head's partials
// and writes only the rewards. The cosine's per-slice partials, their
// combine and the GRU's lookahead and advance are the rollout's own code, so
// where both plans cut slices of one width the stream alone gives the bits
// of the stream fused in.
//
// rollout_fwd.cu and reward_stream.cu include this file, each instantiating
// its own kernels, so the two compile in parallel.
#pragma once

#include "chain.cuh"
#include "reward_stream.cuh"

namespace icrl {
namespace {

// The six products of a step, in slice order.
enum RolloutMat { M_HEAD = 0, M_LIN1, M_POLICY, M_VALUE, M_REWARD, M_SEM, N_MATS };

// The columns of each product: the head's Vp, linear1's h half, both cells'
// 4H, the reward GRU's 3H and semantic_embed's H (none without the stream);
// reward_only: the last two alone.
struct RolloutCols {
  int c[N_MATS];
  __host__ __device__ RolloutCols(int H, int Vp, bool reward, bool reward_only = false)
      : c{reward_only ? 0 : Vp,
          reward_only ? 0 : H,
          reward_only ? 0 : 4 * H,
          reward_only ? 0 : 4 * H,
          reward || reward_only ? 3 * H : 0,
          reward || reward_only ? H : 0} {}
  __host__ __device__ int slices(int nc) const {
    int s = 0;
    for (int m = 0; m < N_MATS; ++m) s += ceil_div(c[m], nc);
    return s;
  }
};

// The launch plan; ops/fused_rollout.py:rollout_plan computes the same. The
// stationary slice holds max(H, F) rows: the linear1 blocks first stage
// w1[:F] for rnd(feats) @ w1[:F] (reward_only: H rows, F is not read).
template <typename W>
ChainPlan rollout_plan(int n, int F, int H, int Vp, bool reward, int sms,
                       bool reward_only = false) {
  constexpr int kc = ChainRing<W>::KC;
  const long Kp = ceil_div(reward_only ? H : std::max(H, F), kc) * (long)kc;
  const RolloutCols cols(H, Vp, reward, reward_only);
  auto co_resident = [&](long smem) {
    return smem > SMEM_PER_BLOCK ? 0L
                                 : sms * std::min(1L, SMEM_PER_SM / (smem + SMEM_RESERVED));
  };
  ChainPlan p{CHAIN_BR, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < SliceUnits<W>::N && !p.units; ++i) {
    const int units = SliceUnits<W>::U[i];
    const long smem = chain_smem<W>(false, 4, units, false, Kp);
    if (co_resident(smem) >= cols.slices(4 * units)) {
      p.units = units;
      p.smem = smem;
    }
  }
  if (!p.units) {
    p.units = stream_units<W, false, 4>();
    p.stream = 1;
    p.smem = chain_smem<W>(false, 4, p.units, true, Kp);
  }
  const long co = co_resident(p.smem), tiles = ceil_div(std::max(n, 1), CHAIN_BR);
  p.slices = cols.slices(4 * p.units);
  p.grid_x = (int)std::min<long>(p.slices, co);
  p.row_groups = (int)std::max(1L, std::min<long>(tiles, co / std::max(p.grid_x, 1)));
  return p;
}

// Slice s of the plan: its product, its first column and its index among
// that product's slices.
struct SliceRef {
  int m, c0, idx;
};

__device__ __forceinline__ SliceRef slice_of(int s, const RolloutCols& cols, int nc) {
  int m = 0;
  for (; m < N_MATS - 1; ++m) {
    const int k = ceil_div(cols.c[m], nc);
    if (s < k) break;
    s -= k;
  }
  return {m, s * nc, s};
}

template <typename W>
struct RolloutFwdArgs {
  int n, S, F, E, H, V, Vp, curr, row_groups;
  const float* feats;  // [n, F]
  const int* teach;    // [S, n] teacher tokens of positions 1 .. S
  const float* noise;  // [S, n, V] Gumbel noise
  const float* p_xg;   // [V, 4H] policy emb @ wi
  const W* p_w;        // [E + H, 4H] policy [wi; wh]
  const float* p_b;    // [4H]
  const W* hw;         // [H, Vp] head, zero padding columns
  const float* hb;     // [Vp]
  const float* v_xg;   // value net, as the policy
  const W* v_w;
  const float* v_b;
  const W* w1;          // [F + H, H] linear1
  const float* b1;      // [H]
  const W* w2;          // [H] linear2
  const float* b2;      // [1]
  RewardNet<W> rnet;    // rnet.xg null: no reward stream
  const float* rew0;    // [n, H]
  float *values, *logp;  // [S, n]
  int *act, *tok;        // [S, n] written; read in the reward-only mode
  float* rewards;        // [S, n]
  float *hp, *cp, *gp;   // tape: [S n, H] (first n rows: the start state), [(S - 1) n, 4H]
  float *hv, *cv, *gv;
  float* v1;  // [S n, H]
  // scratch (written and read inside the launch: plain loads, no .nc path)
  float* fw1;              // [n, H] rnd(feats) @ w1[:F]
  float *pre_p, *pre_v;    // [n, 4H] rnd(h) @ wh of this step
  float* gh;               // [n, 3H] rnd(h_r) @ r_wh + bh
  float* hr;               // [n, H] the reward GRU's state
  float *lpart, *vpart, *spart;  // per (row, slice): 5, 1 and 2 floats
  int lp, hp_stride;       // slices allocated per row: ceil(Vp / 32), ceil(H / 32)
  W *hwp, *hwv, *hwr, *aw;  // [n, H] h_p, h_v, h_r, after in the weight type
  // null, or [2 + 4 (S + 1)] zeros: a profile of the phases (rollout_steps)
  unsigned long long* clock;
};

template <typename W>
__device__ __forceinline__ ColSlice<W> weight_slice(const RolloutFwdArgs<W>& a, int m, int c0) {
  const int H = a.H;
  switch (m) {
    case M_HEAD:
      return {a.hw, H, a.Vp, a.Vp, c0};
    case M_LIN1:
      return {a.w1 + (size_t)a.F * H, H, H, H, c0};
    case M_POLICY:
      return {a.p_w + (size_t)a.E * 4 * H, H, 4 * H, 4 * H, c0};
    case M_VALUE:
      return {a.v_w + (size_t)a.E * 4 * H, H, 4 * H, 4 * H, c0};
    case M_REWARD:
      return {a.rnet.wh, H, 3 * H, 3 * H, c0};
    default:
      return {a.rnet.sem_w, H, H, H, c0};
  }
}

// Whether product m runs in the phase A of step t (t == S: the semantic
// product of the last step's after, after the loop).
__device__ __forceinline__ bool runs_at(int m, int t, int S) {
  if (t == S) return m == M_SEM;
  if (m == M_SEM) return t > 0;
  if (m == M_POLICY || m == M_VALUE) return t + 1 < S;
  return true;
}

// (noisy value, first index, its logit) over the lanes whose xor masks are
// below ``width``: the largest value, the lowest index among equal ones.
__device__ __forceinline__ void argmax_lanes(float& v, int& i, float& l, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, off), l2 = __shfl_xor_sync(FULL, l, off);
    const int i2 = __shfl_xor_sync(FULL, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
      l = l2;
    }
  }
}

// Phase A's epilogue for slice ``sl`` of product m over the row tile at
// row0, from Cs [CHAIN_BR][CLD] (valid local columns [0, lim)). Each thread
// issues all its global loads before it uses them, and before any store
// (which a later load may not pass): one memory latency per tile, not one
// per column. kOnly (the reward-only mode) compiles out the products it
// has no columns of.
template <class Tl, bool kOnly, typename W>
__device__ void phase_a_epilogue(const RolloutFwdArgs<W>& a, const float* Cs, int cld,
                                 const SliceRef& sl, int lim, int t, int row0) {
  constexpr int NC = Tl::NC, CPT = NC / 4;
  static_assert(CHAIN_THREADS % (NC / 4) == 0, "a thread's columns are the same in every row");
  const int n = a.n, H = a.H, tid = threadIdx.x;
  if ((!kOnly && (sl.m == M_POLICY || sl.m == M_VALUE)) || sl.m == M_REWARD) {
    // four consecutive columns a thread, 16-byte stores
    constexpr int Q = NC / 4, RS = CHAIN_THREADS / Q;
    float* out = sl.m == M_POLICY ? a.pre_p : sl.m == M_VALUE ? a.pre_v : a.gh;
    const int ld = sl.m == M_REWARD ? 3 * H : 4 * H, c = tid % Q * 4;
    if (c >= lim) return;
    float bias[4] = {0.f, 0.f, 0.f, 0.f};
    if (sl.m == M_REWARD) ld4(bias, a.rnet.bh + sl.c0 + c);
    for (int r = tid / Q; r < CHAIN_BR; r += RS) {
      const int row = row0 + r;
      if (row >= n) break;
      float v[4];
      ld4(v, Cs + r * cld + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] += bias[u];
      st4(out + (size_t)row * ld + sl.c0 + c, v);
    }
    return;
  }
  // row reductions: 4 threads per row, thread q over local columns q + 4 i
  const int r = tid / 4, q = tid % 4, row = row0 + r, rowc = min(row, n - 1);
  const float* cr = Cs + r * cld;
  float x[CPT], y[CPT], z[CPT];
  if (!kOnly && sl.m == M_HEAD) {
    const int vlim = min(lim, a.V - sl.c0);  // the real vocabulary's columns
    const float* noise = a.noise + ((size_t)t * n + rowc) * a.V + sl.c0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = q + 4 * i;
      x[i] = c < vlim ? a.hb[sl.c0 + c] : 0.f;
      y[i] = c < vlim ? noise[c] : 0.f;
    }
    float m = -INFINITY, best = -INFINITY, lb = 0.f;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = q + 4 * i;
      if (c < vlim) {
        const float l = cr[c] + x[i], v = l + y[i];
        x[i] = l;
        m = fmaxf(m, l);
        if (v > best) {  // strict: the first index within the thread
          best = v;
          bi = sl.c0 + c;
          lb = l;
        }
      }
    }
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
    m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
    argmax_lanes(best, bi, lb, 4);
    float se = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (q + 4 * i < vlim) se += expf(x[i] - m);
    se = sum4(se);
    if (q == 0 && row < n) {
      float* p = a.lpart + ((size_t)row * a.lp + sl.idx) * 5;
      p[0] = m;
      p[1] = se;
      p[2] = best;
      p[3] = __int_as_float(bi);
      p[4] = lb;
    }
  } else if (!kOnly && sl.m == M_LIN1) {
    const float* f = a.fw1 + (size_t)rowc * H + sl.c0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = q + 4 * i;
      x[i] = c < lim ? f[c] : 0.f;
      y[i] = c < lim ? a.b1[sl.c0 + c] : 0.f;
      z[i] = c < lim ? ld(a.w2 + sl.c0 + c) : 0.f;
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = q + 4 * i;
      if (c < lim) {
        const float v = cr[c] + x[i] + y[i];
        if (row < n) a.v1[((size_t)t * n + row) * H + sl.c0 + c] = v;
        dot += rnd<W>(v) * z[i];
      }
    }
    dot = sum4(dot);
    if (q == 0 && row < n) a.vpart[(size_t)row * a.hp_stride + sl.idx] = dot;
  } else {  // M_SEM: se = rnd(after) @ sem_w + sem_b of the step before
    const float* vn = a.rnet.vn + (size_t)rowc * H + sl.c0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = q + 4 * i;
      x[i] = c < lim ? vn[c] : 0.f;
      y[i] = c < lim ? a.rnet.sem_b[sl.c0 + c] : 0.f;
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (q + 4 * i < lim) {
        const float se = cr[q + 4 * i] + y[i];
        ss += se * se;
        dot += x[i] * se;
      }
    }
    ss = sum4(ss);
    dot = sum4(dot);
    if (q == 0 && row < n) {
      float* p = a.spart + ((size_t)row * a.hp_stride + sl.idx) * 2;
      p[0] = dot;
      p[1] = ss;
    }
  }
}

// Phase A of step t: this block's slices over its row tiles.
template <class Tl, bool kOnly, class Stage, typename W>
__device__ void phase_a(const RolloutFwdArgs<W>& a, const Stage& st, const RolloutCols& cols,
                        int t) {
  const int n = a.n, H = a.H, tiles = (n + Stage::ROWS - 1) / Stage::ROWS;
  for (int s = blockIdx.x; s < cols.slices(Tl::NC); s += gridDim.x) {
    const SliceRef sl = slice_of(s, cols, Tl::NC);
    if (!runs_at(sl.m, t, a.S)) continue;
    const ColSlice<W> src = weight_slice(a, sl.m, sl.c0);
    const int lim = min(Tl::NC, cols.c[sl.m] - sl.c0);
    for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
      const int row0 = rt * Stage::ROWS;
      // the A rows: the start states (float32, rounded as they are staged)
      // at step 0, then the W-typed copies phase B wrote
      float* Cs;
      if (sl.m == M_SEM) {
        Cs = st.product(a.aw, H, row0, n, H, src);
      } else if (t == 0) {
        const float* x = sl.m == M_HEAD || sl.m == M_POLICY ? a.hp
                         : sl.m == M_REWARD                 ? a.rew0
                                                            : a.hv;
        Cs = st.product(x, H, row0, n, H, src);
      } else {
        const W* x = sl.m == M_HEAD || sl.m == M_POLICY ? a.hwp
                     : sl.m == M_REWARD                 ? a.hwr
                                                        : a.hwv;
        Cs = st.product(x, H, row0, n, H, src);
      }
      __syncthreads();
      for (int h0 = 0; h0 < Stage::ROWS && row0 + h0 < n; h0 += CHAIN_BR)
        phase_a_epilogue<Tl, kOnly>(a, Cs + h0 * Stage::CLD, Stage::CLD, sl, lim, t, row0 + h0);
      __syncthreads();  // Cs overlays the ring the next product fills
    }
  }
}

// What the advances of four consecutive units j .. j + 3 of a row read: each
// LSTM's x-gate row, pre-activations, bias and c, the reward GRU's h, gh and
// the action's and the token's table rows, [gate][unit]. All of an item's
// loads are 16 bytes and issued before any of its stores (which the
// compiler may not move loads past), so they overlap: phase B is bound by
// how many bytes each SM keeps in flight.
struct LstmIn {
  float x[4][4], p[4][4], b[4][4], c[4];
};
struct GruIn {
  float h[4], gh[3][4], xa[3][4], xt[3][4];
};

__device__ __forceinline__ void lstm_load(LstmIn& in, int H, size_t NH, int t, int row, int j,
                                          int tk, const float* xg, const float* pre,
                                          const float* b, const float* cbuf) {
  const size_t G = 4 * (size_t)H;
  const float* x = xg + (size_t)tk * G + j;
  const float* p = pre + (size_t)row * G + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    ld4(in.x[g], x + g * H);
    ld4(in.p[g], p + g * H);
    ld4(in.b[g], b + g * H + j);
  }
  ld4(in.c, cbuf + t * NH + (size_t)row * H + j);
}

// The LSTM advance (x + h @ wh + b, the TPU kernel's order): h, c, the gate
// tape and h in the weight type.
template <typename W>
__device__ __forceinline__ void lstm_store(const LstmIn& in, int n, int H, int t, int row, int j,
                                           float* hbuf, float* cbuf, float* gates, W* hw) {
  const size_t NH = (size_t)n * H, o = (size_t)row * H + j;
  float g[4][4], c[4], h[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    g[0][u] = sigmoid(in.x[0][u] + in.p[0][u] + in.b[0][u]);
    g[1][u] = sigmoid(in.x[1][u] + in.p[1][u] + in.b[1][u]);
    g[2][u] = tanhf(in.x[2][u] + in.p[2][u] + in.b[2][u]);
    g[3][u] = sigmoid(in.x[3][u] + in.p[3][u] + in.b[3][u]);
    c[u] = g[1][u] * in.c[u] + g[0][u] * g[2][u];
    h[u] = g[3][u] * tanhf(c[u]);
  }
  st4(cbuf + (t + 1) * NH + o, c);
  st4(hbuf + (t + 1) * NH + o, h);
  st4(hw + o, h);
  float* gp = gates + ((size_t)t * n + row) * 4 * H + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) st4(gp + q * H, g[q]);
}

// Phase B of step t (t == S: only the last step's reward): this block's
// rows, a batch of at most 8 at a time, one warp per row for the combine,
// then every thread over the batch's (row, unit) cells. kOnly (the
// reward-only mode): the step's action and token are inputs, and only the
// reward GRU advances.
template <class Tl, bool kOnly, typename W>
__device__ void phase_b(const RolloutFwdArgs<W>& a, int* sh, int t) {
  constexpr int NC = Tl::NC;
  const int n = a.n, H = a.H, S = a.S, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool reward = kOnly || a.rnet.xg != nullptr;
  const int nblk = gridDim.x * gridDim.y, bid = blockIdx.y * gridDim.x + blockIdx.x;
  const int rb = max(1, min(CHAIN_THREADS / 32, (n + nblk - 1) / nblk));
  const int nh = ceil_div(a.Vp, NC), nv = ceil_div(H, NC);
  for (int r0 = bid * rb; r0 < n; r0 += nblk * rb) {
    const int rows = min(rb, n - r0);
    if (warp < rows) {
      const int row = r0 + warp;
      if (reward && t > 0) {  // the reward of step t - 1
        float dot = 0.f, ss = 0.f;
        for (int b = lane; b < nv; b += 32) {
          const float* p = a.spart + ((size_t)row * a.hp_stride + b) * 2;
          dot += p[0];
          ss += p[1];
        }
        dot = warp_sum(dot);
        ss = warp_sum(ss);
        if (lane == 0) a.rewards[(size_t)(t - 1) * n + row] = dot / fmaxf(sqrtf(ss), 1e-12f);
      }
      if (kOnly && t < S && lane == 0) {
        const size_t o = (size_t)t * n + row;
        sh[warp] = a.act[o];
        sh[8 + warp] = a.tok[o];
      }
      if (!kOnly && t < S) {
        float m = -INFINITY, best = -INFINITY, lb = 0.f;
        int bi = 0x7fffffff;
        for (int b = lane; b < nh; b += 32) {
          const float* p = a.lpart + ((size_t)row * a.lp + b) * 5;
          m = fmaxf(m, p[0]);
          const float v = p[2];
          const int i = __float_as_int(p[3]);
          if (v > best || (v == best && i < bi)) {
            best = v;
            bi = i;
            lb = p[4];
          }
        }
        m = warp_max(m);
        argmax_lanes(best, bi, lb, 32);
        float se = 0.f, dot = 0.f;
        for (int b = lane; b < nh; b += 32) {
          const float* p = a.lpart + ((size_t)row * a.lp + b) * 5;
          se += expf(p[0] - m) * p[1];
        }
        for (int b = lane; b < nv; b += 32) dot += a.vpart[(size_t)row * a.hp_stride + b];
        se = warp_sum(se);
        dot = warp_sum(dot);
        const size_t o = (size_t)t * n + row;
        const int tk = t + 1 < a.curr ? a.teach[o] : bi;
        if (lane == 0) {
          a.act[o] = bi;
          a.tok[o] = tk;
          a.logp[o] = (lb - m) - logf(se);
          a.values[o] = dot + a.b2[0];
          sh[warp] = bi;
          sh[8 + warp] = tk;
        }
      }
    }
    __syncthreads();
    if (t < S && (t + 1 < S || reward)) {  // four units j .. j + 3 a thread at a time
      // more: the states advance (not on the last step); adv: the LSTMs too
      const bool more = t + 1 < S, adv = !kOnly && more;
      const int H4 = H / 4, items = rows * H4;
      const size_t NH = (size_t)n * H, G3 = 3 * (size_t)H;
      for (int e = tid; e < items; e += CHAIN_THREADS) {
        const int w = e / H4, j = e % H4 * 4, row = r0 + w, at = sh[w], tk = sh[8 + w];
        const size_t o = (size_t)row * H + j;
        LstmIn pin, vin;
        GruIn rin;
        if (adv) {
          lstm_load(pin, H, NH, t, row, j, tk, a.p_xg, a.pre_p, a.p_b, a.cp);
          lstm_load(vin, H, NH, t, row, j, tk, a.v_xg, a.pre_v, a.v_b, a.cv);
        }
        if (reward) {
          ld4(rin.h, (t ? a.hr : a.rew0) + o);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            ld4(rin.gh[q], a.gh + row * G3 + q * H + j);
            ld4(rin.xa[q], a.rnet.xg + at * G3 + q * H + j);
            if (more && tk != at) ld4(rin.xt[q], a.rnet.xg + tk * G3 + q * H + j);
          }
        }
        if (adv) {
          lstm_store(pin, n, H, t, row, j, a.hp, a.cp, a.gp, a.hwp);
          lstm_store(vin, n, H, t, row, j, a.hv, a.cv, a.gv, a.hwv);
        }
        if (reward) {  // the lookahead on the action, the advance on the token
          float after[4], hn[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float gh[3] = {rin.gh[0][u], rin.gh[1][u], rin.gh[2][u]};
            after[u] = gru_update({rin.xa[0][u], rin.xa[1][u], rin.xa[2][u]}, gh, rin.h[u]);
            hn[u] = tk == at ? after[u]
                             : gru_update({rin.xt[0][u], rin.xt[1][u], rin.xt[2][u]}, gh, rin.h[u]);
          }
          st4(a.aw + o, after);
          if (more) {
            st4(a.hr + o, hn);
            st4(a.hwr + o, hn);
          }
        }
      }
    }
    __syncthreads();  // sh serves the next batch
  }
}

// The profile: when a.clock is given, thread 0 of every block raises slot k
// to the %globaltimer nanoseconds at which it passed mark k, so each slot
// holds the latest block's time: 0 the start, 1 the slices loaded, then per
// step t (t = S: the last reward's pass) 2 + 4t phase A entered, + 1 phase A
// done, + 2 phase B entered, + 3 phase B done. A null clock costs a branch.
template <typename W>
__device__ __forceinline__ void clock_mark(const RolloutFwdArgs<W>& a, int k) {
  if (a.clock && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    atomicMax(a.clock + k, ns);
  }
}

// The whole launch: the slices loaded, then S passes of phases A and B, and
// with the reward stream one more for the last step's reward. kOnly: the
// reward-only mode (the stream alone, reward_stream_kernel).
template <class Tl, bool kOnly, class Stage, typename W>
__device__ void rollout_steps(const RolloutFwdArgs<W>& a, const Stage& st) {
  const int n = a.n, H = a.H, tiles = (n + Stage::ROWS - 1) / Stage::ROWS;
  const bool reward = kOnly || a.rnet.xg != nullptr;
  const RolloutCols cols(H, a.Vp, reward, kOnly);
  clock_mark(a, 0);
  // rnd(feats) @ w1[:F] on the linear1 slices, then each block's slice
  for (int s = blockIdx.x; s < cols.slices(Tl::NC); s += gridDim.x) {
    const SliceRef sl = slice_of(s, cols, Tl::NC);
    if (!kOnly && sl.m == M_LIN1) {
      const ColSlice<W> src{a.w1, a.F, H, H, sl.c0};
      st.load(src, a.F);
      for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
        const int row0 = rt * Stage::ROWS;
        const float* Cs = st.product(a.feats, a.F, row0, n, a.F, src);
        __syncthreads();
        for (int e = threadIdx.x; e < Stage::ROWS * Tl::NC; e += CHAIN_THREADS) {
          const int r = e / Tl::NC, c = e % Tl::NC, row = row0 + r;
          if (row < n && sl.c0 + c < H) a.fw1[(size_t)row * H + sl.c0 + c] = Cs[r * Stage::CLD + c];
        }
        __syncthreads();
      }
    }
    st.load(weight_slice(a, sl.m, sl.c0), H);
  }
  int* sh = st.scratch();  // phase B's actions and tokens
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  clock_mark(a, 1);
  for (int t = 0; t < a.S; ++t) {
    if (t) grid.sync();
    clock_mark(a, 2 + 4 * t);
    phase_a<Tl, kOnly>(a, st, cols, t);
    clock_mark(a, 3 + 4 * t);
    grid.sync();
    clock_mark(a, 4 + 4 * t);
    phase_b<Tl, kOnly>(a, sh, t);
    clock_mark(a, 5 + 4 * t);
  }
  if (reward) {  // the last step's semantic product and reward
    const int k = 2 + 4 * a.S;
    grid.sync();
    clock_mark(a, k);
    phase_a<Tl, kOnly>(a, st, cols, a.S);
    clock_mark(a, k + 1);
    grid.sync();
    clock_mark(a, k + 2);
    phase_b<Tl, kOnly>(a, sh, a.S);
    clock_mark(a, k + 3);
  }
}

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) rollout_fwd_kernel(RolloutFwdArgs<W> a) {
  using Tl = ChainTile<W, false, U, 4, kStream>;
  extern __shared__ __align__(16) unsigned char rollout_smem[];
  rollout_steps<Tl, false>(a, ChainStage<Tl>{rollout_smem, a.H});
}

// The reward stream alone: the reward-only mode of the same launch.
template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) reward_stream_kernel(RolloutFwdArgs<W> a) {
  using Tl = ChainTile<W, false, U, 4, kStream>;
  extern __shared__ __align__(16) unsigned char rollout_smem[];
  rollout_steps<Tl, true>(a, ChainStage<Tl>{rollout_smem, a.H});
}

// The kernel of a mode, U and kStream.
template <typename W, int U, bool kStream, bool kOnly>
auto steps_kernel() {
  if constexpr (kOnly)
    return reward_stream_kernel<W, U, kStream>;
  else
    return rollout_fwd_kernel<W, U, kStream>;
}

// Launches the plan's instantiation: the rollout, or with kOnly the stream
// alone.
template <typename W, bool kOnly>
cudaError_t launch_rollout_fwd(const ChainPlan& p, const RolloutFwdArgs<W>& a, cudaStream_t s) {
  constexpr int SU = stream_units<W, false, 4>();
  if (p.stream) return launch_chain(steps_kernel<W, SU, true, kOnly>(), p, a, s);
  switch (p.units) {
    case 32:
      if constexpr (kIsBf16<W>) return launch_chain(steps_kernel<W, 32, false, kOnly>(), p, a, s);
      break;
    case 16:
      return launch_chain(steps_kernel<W, 16, false, kOnly>(), p, a, s);
    case 8:
      return launch_chain(steps_kernel<W, 8, false, kOnly>(), p, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace icrl
