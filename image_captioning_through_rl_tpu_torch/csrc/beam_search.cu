// Per-sample value-guided beam search on Hopper.
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
// What bounds it here: written as on the TPU, the B^2 critic cells and value
// MLP rows (N*B^2 rows of [1024] x [1024, 2048] and [1024] x [1024, 512]
// products at COCO width) are ~25x the policy's work. Design: a critic
// cell's input product is a row of the x-gate table (icrl_token_gates, once
// per weights) and its recurrent product rnd(h_v) @ wh is shared by the B
// expansions of a parent, so it runs once per candidate; linear1's feature
// half runs once per sample per call; only rnd(h_v') @ w1[F:] runs per
// expansion. That cuts the products about 4x at N = 1024. Every product goes
// through the shared tiled kernels of common.cuh, whose tile products then
// take most of a step, with the expansion cells (memory-bound at N = 1024:
// one thread per parent and unit writes the B expansions) next; the value
// MLP folds linear2 into its epilogue (one partial dot per 64-column tile,
// summed in a fixed order by the select kernel, so results do not depend on
// scheduling); one block per sample does steps 5-7. The step loop runs on
// the host inside one C call.
#include "common.cuh"

namespace icrl {
namespace {

constexpr int MAX_BEAM = 8;  // the top-B lists live in registers of this size

__global__ void beam_init_kernel(int n, int B, int T, const int* __restrict__ start,
                                 int* __restrict__ hist, float* __restrict__ scores) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t R = (size_t)n * B;
  if (i < R * T) hist[i] = i % T == 0 ? start[i / T / B] : 0;
  if (i < R) scores[i] = i % B == 0 ? 0.f : INFINITY;
}

// (v, i) ranks before (v2, i2): a larger value, or an equal one at a lower
// index, as lax.top_k orders them.
__device__ __forceinline__ bool ranks_before(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// Per candidate row: logp[r, k] = log_softmax(logits[r])[topi[r, k]] for the
// B largest logits (lowest index first on ties), one warp per row, in one
// pass over the row: each lane keeps a running max and exp-sum (rescaled
// when the max grows) and its own B best columns in sorted registers; the
// warp then merges the sums, and takes the row's top B as B rounds of a
// first-index argmax over the lanes' list heads.
__global__ void __launch_bounds__(NT) lse_topb_kernel(int M, int V, int B,
                                                      const float* __restrict__ logits,
                                                      float* __restrict__ logp,
                                                      int* __restrict__ topi) {
  const int lane = threadIdx.x % 32, r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (r >= M) return;
  const float* row = logits + (size_t)r * V;
  float m = -INFINITY, sum = 0.f;
  float tv[MAX_BEAM];
  int ti[MAX_BEAM];
#pragma unroll
  for (int k = 0; k < MAX_BEAM; ++k) {
    tv[k] = -INFINITY;
    ti[k] = V;  // sentinel: ranks after every real column
  }
  for (int c = lane; c < V; c += 32) {
    const float x = __ldg(row + c);
    if (x > m) {
      sum = sum * expf(m - x) + 1.f;
      m = x;
    } else {
      sum += expf(x - m);
    }
    float xv = x;
    int xi = c;
#pragma unroll
    for (int k = 0; k < MAX_BEAM; ++k) {  // insertion into the sorted list
      if (k < B && ranks_before(xv, xi, tv[k], ti[k])) {
        const float tvk = tv[k];
        const int tik = ti[k];
        tv[k] = xv;
        ti[k] = xi;
        xv = tvk;
        xi = tik;
      }
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off), s2 = __shfl_xor_sync(FULL, sum, off);
    const float mm = fmaxf(m, m2);
    sum = (m == -INFINITY ? 0.f : sum * expf(m - mm)) +
          (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mm));
    m = mm;
  }
  const float log_sum = logf(sum);
  int head = 0;  // this lane's next list entry
  for (int k = 0; k < B; ++k) {
    float v = -INFINITY;
    int idx = V;
#pragma unroll
    for (int q = 0; q < MAX_BEAM; ++q)
      if (q == head) {
        v = tv[q];
        idx = ti[q];
      }
    const int mine = idx;
    warp_argmax(v, idx);
    if (mine == idx) ++head;  // column indices are unique across lanes
    if (lane == 0) {
      logp[(size_t)r * B + k] = (v - m) - log_sum;
      topi[(size_t)r * B + k] = idx;
    }
  }
}

// The critic cells of the B^2 expansions: expansion row r2 = p * B + e of
// parent candidate row p takes the token tok[r2], the parent's recurrent
// product hg[p] (= rnd(h_v) @ wh, computed once per parent) and its cell
// state c_in[p]. One thread per (parent, hidden unit) reads the parent's
// parts once and writes its B expansions.
template <typename W>
__global__ void lstm_expand_kernel(int parents, int H, int B, const int* __restrict__ tok,
                                   const float* __restrict__ xg, const float* __restrict__ hg,
                                   const float* __restrict__ c_in, const float* __restrict__ b,
                                   W* __restrict__ h_out, float* __restrict__ c_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)parents * H) return;
  const int p = (int)(i / H), j = (int)(i % H), G = 4 * H;
  const float* h = hg + (size_t)p * G;
  const float h_part[4] = {h[j], h[H + j], h[2 * H + j], h[3 * H + j]};
  const float c = c_in[i];
  for (int e = 0; e < B; ++e) {
    const size_t r2 = (size_t)p * B + e;
    lstm_update(H, j, xg + (size_t)tok[r2] * G, h_part, b, c, h_out + r2 * H + j,
                c_out + r2 * H + j);
  }
}

// vpart[blockIdx.x, r] = sum over this block's 64 columns c of
//   rnd(fproj[r / feat_div, c] + (vh[r] @ w1[F:])[c]) * w2[c],
// where fproj = rnd(feats) @ w1[:F] + b1 is computed once per sample: linear1
// over [feats; h_v'] split at F, and the partial linear2 dot of row r.
// The column tiles of a row tile are consecutive blocks (blockIdx.x), so
// they read its rows of vh while L2 still holds them: at N = 1024 vh is
// larger than L2, and a row-tile-fastest order reads it from device memory
// once per column tile.
template <typename W>
__global__ void __launch_bounds__(NT) value_mlp_kernel(int rows, int H, int feat_div,
                                                       const float* __restrict__ fproj,
                                                       const W* __restrict__ vh,
                                                       const W* __restrict__ w1h,
                                                       const W* __restrict__ w2,
                                                       float* __restrict__ vpart) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  auto arow = [&](int m) { return row0 + m < rows ? row0 + m : -1; };
  auto bcol = [&](int c) { return col0 + c < H ? col0 + c : -1; };
  float acc[4][4];
  gemm<kIsBf16<W>>(acc, H, vh, H, arow, w1h, H, bcol);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    const float* fp = fproj + (size_t)(min(r, rows - 1) / feat_div) * H;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < H) s += rnd<W>(fp[col] + acc[i][j]) * ld(w2 + col);
    }
    // the 16 tx lanes of a row sit in one half-warp
#pragma unroll
    for (int off = 8; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (tx == 0 && r < rows) vpart[(size_t)blockIdx.x * rows + r] = s;
  }
}

// One block per sample: steps 5-7 of the beam step.
template <typename W>
struct SelectArgs {
  int B, T, H, t, ncb, rows2;
  float vw, lw;
  float* scores;          // [N, B], updated in place
  const float* logp;      // [R, B]
  const int* topi;        // [R, B]
  const float* vpart;     // [ncb, R*B]
  const float* b2;        // [1]
  const int* hist_in;     // [R, T]
  int* hist_out;          // [R, T]
  const W* vh2;           // [R*B, H] critic states of the expansions
  const float* vc2;
  W* val_h;               // [R, H] critic state of the kept candidates
  float* val_c;
  int* new_tok;           // [R]
  int* parent;            // [R] candidate row each kept candidate extends
};

template <typename W>
__global__ void select_reorder_kernel(SelectArgs<W> a) {
  __shared__ float cand[MAX_BEAM * MAX_BEAM];
  __shared__ int sel[MAX_BEAM];
  const int n = blockIdx.x, B = a.B, BB = B * B;
  for (int q = threadIdx.x; q < BB; q += blockDim.x) {
    const size_t r2 = (size_t)n * BB + q;  // expansion (n, p = q / B, e = q % B)
    float dot = 0.f;
    for (int cb = 0; cb < a.ncb; ++cb) dot += a.vpart[(size_t)cb * a.rows2 + r2];
    const float value = dot + a.b2[0];
    cand[q] = a.scores[n * B + q / B] - (a.vw * value + a.lw * a.logp[r2]);
  }
  __syncthreads();
  // candidate q's rank among the B^2: smaller scores first, the lower flat
  // index first on ties; the B best land in sel in rank order
  for (int q = threadIdx.x; q < BB; q += blockDim.x) {
    int rank = 0;
    for (int q2 = 0; q2 < BB; ++q2) rank += cand[q2] < cand[q] || (cand[q2] == cand[q] && q2 < q);
    if (rank < B) sel[rank] = q;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    const int k = threadIdx.x, q = sel[k];
    a.scores[n * B + k] = cand[q];
    a.new_tok[n * B + k] = a.topi[(size_t)n * BB + q];
    a.parent[n * B + k] = n * B + q / B;
  }
  for (int i = threadIdx.x; i < B * a.T; i += blockDim.x) {
    const int k = i / a.T, j = i % a.T, q = sel[k];
    a.hist_out[((size_t)n * B + k) * a.T + j] =
        j == a.t + 1 ? a.topi[(size_t)n * BB + q] : a.hist_in[((size_t)n * B + q / B) * a.T + j];
  }
  for (int i = threadIdx.x; i < B * a.H; i += blockDim.x) {
    const int k = i / a.H, u = i % a.H;
    const size_t src = ((size_t)n * BB + sel[k]) * a.H + u, dst = ((size_t)n * B + k) * a.H + u;
    a.val_h[dst] = a.vh2[src];
    a.val_c[dst] = a.vc2[src];
  }
}

// Every h in the weight type (only ever read as a product's rounded
// operand); c, products and scores in float32.
template <typename W>
struct BeamLayout {
  W *h0, *pol_h[2], *val_h, *vh2;
  float *fproj, *pol_c[2], *val_c, *hg, *logits, *logp, *vc2, *vpart;
  int *topi, *new_tok, *parent, *hist2;
};

template <typename W>
BeamLayout<W> beam_layout(float* ws, int n, int H, int V, int T, int B,
                          size_t* used = nullptr) {
  const size_t R = (size_t)n * B, R2 = R * B;
  Carver cv{ws};
  BeamLayout<W> l;
  l.h0 = cv.take<W>((size_t)n * H);
  l.fproj = cv.take((size_t)n * H);
  for (int i = 0; i < 2; ++i) {
    l.pol_h[i] = cv.take<W>(R * H);
    l.pol_c[i] = cv.take(R * H);
  }
  l.val_h = cv.take<W>(R * H);
  l.val_c = cv.take(R * H);
  l.hg = cv.take(R * 4 * H);
  l.logits = cv.take(R * V);
  l.logp = cv.take(R * B);
  l.topi = cv.take<int>(R * B);
  l.vh2 = cv.take<W>(R2 * H);
  l.vc2 = cv.take(R2 * H);
  l.vpart = cv.take((size_t)cdiv(H, BN) * R2);
  l.new_tok = cv.take<int>(R);
  l.parent = cv.take<int>(R);
  l.hist2 = cv.take<int>(R * T);
  if (used) *used = cv.used;
  return l;
}

struct PolicyWeights {
  const void *wc, *w, *wo;
  const float *bc, *xg, *b, *bo;
};
struct ValueWeights {
  const void *w, *w1, *w2;
  const float *xg, *b, *b1, *b2;
};

template <typename W>
int beam(int n, int F, int E, int H, int V, int T, int B, float vw, float lw, const float* feats,
         const int* start, const PolicyWeights& p, const ValueWeights& v, int* out_tokens,
         float* out_scores, float* ws, cudaStream_t s) {
  const BeamLayout<W> l = beam_layout<W>(ws, n, H, V, T, B);
  const int R = n * B, R2 = R * B, S = T - 1, ncb = cdiv(H, BN), G = 4 * H;
  const W *p_wc = (const W*)p.wc, *p_wh = (const W*)p.w + (size_t)E * G, *p_wo = (const W*)p.wo,
          *v_wh = (const W*)v.w + (size_t)E * G, *v_w1 = (const W*)v.w1,
          *v_w2 = (const W*)v.w2;
  // step t writes its history to hist(t), reading hist(t - 1); the last step
  // (t = S - 1) writes to out_tokens
  auto hist = [&](int t) { return ((S - 1 - t) % 2 == 0) ? out_tokens : l.hist2; };

  beam_init_kernel<<<cdiv((long)R * T, 256), 256, 0, s>>>(n, B, T, start, hist(-1), out_scores);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK((launch_linear<W, float, true, W>(n, F, H, feats, p_wc, p.bc, l.h0, s)));
  ICRL_CHECK((launch_linear<W, float, true>(n, F, H, feats, v_w1, v.b1, l.fproj, s)));
  // first policy cell on <START>, one copy per beam (h0 row r / B, c0 = 0);
  // fields: rows, H, tok, tok_div, tok_stride, xg, h_in, c_in, state_idx,
  // state_div, wh, b, h_out, c_out
  ICRL_CHECK(launch_lstm(LstmArgs<W>{R, H, start, B, 1, p.xg, l.h0, nullptr, nullptr, B, p_wh,
                                     p.b, l.pol_h[0], l.pol_c[0]},
                         s));
  // first critic cell on <START> from the zero state
  ICRL_CHECK(launch_lstm(LstmArgs<W>{R, H, start, B, 1, v.xg, nullptr, nullptr, nullptr, 1, v_wh,
                                     v.b, l.val_h, l.val_c},
                         s));
  int cur = 0;
  for (int t = 0; t < S; ++t) {
    ICRL_CHECK((launch_linear<W, W, false>(R, H, V, l.pol_h[cur], p_wo, p.bo, l.logits, s)));
    lse_topb_kernel<<<cdiv(R, ROWS_PER_BLOCK), NT, 0, s>>>(R, V, B, l.logits, l.logp, l.topi);
    ICRL_CHECK(cudaGetLastError());
    // critic: one recurrent product per parent, then the B^2 expansion cells
    ICRL_CHECK((launch_linear<W, W, false>(R, H, G, l.val_h, v_wh, nullptr, l.hg, s)));
    lstm_expand_kernel<W><<<cdiv((long)R * H, 256), 256, 0, s>>>(R, H, B, l.topi, v.xg, l.hg,
                                                              l.val_c, v.b, l.vh2, l.vc2);
    ICRL_CHECK(cudaGetLastError());
    value_mlp_kernel<W><<<dim3(ncb, cdiv(R2, BM)), NT, 0, s>>>(R2, H, B * B, l.fproj, l.vh2,
                                                                 v_w1 + (size_t)F * H, v_w2,
                                                                 l.vpart);
    ICRL_CHECK(cudaGetLastError());
    const SelectArgs<W> sa{B,          T,          H,        t,       ncb,      R2,
                        vw,         lw,         out_scores, l.logp, l.topi,  l.vpart,
                        v.b2,       hist(t - 1), hist(t),  l.vh2,   l.vc2,    l.val_h,
                        l.val_c,    l.new_tok,  l.parent};
    select_reorder_kernel<W><<<n, NT, 0, s>>>(sa);
    ICRL_CHECK(cudaGetLastError());
    if (t + 1 < S) {
      ICRL_CHECK(launch_lstm(LstmArgs<W>{R, H, l.new_tok, 1, 1, p.xg, l.pol_h[cur], l.pol_c[cur],
                                         l.parent, 1, p_wh, p.b, l.pol_h[cur ^ 1],
                                         l.pol_c[cur ^ 1]},
                             s));
      cur ^= 1;
    }
  }
  return 0;
}

}  // namespace
}  // namespace icrl

extern "C" {

int icrl_beam_max_beam() { return icrl::MAX_BEAM; }

// Float32 elements of the workspace icrl_beam_search needs (bf16 as in
// icrl_beam_search).
size_t icrl_beam_workspace_floats(int n, int H, int V, int T, int B, int bf16) {
  size_t used = 0;
  if (bf16)
    icrl::beam_layout<__nv_bfloat16>(nullptr, n, H, V, T, B, &used);
  else
    icrl::beam_layout<float>(nullptr, n, H, V, T, B, &used);
  return used;
}

// Returns 0 or the first CUDA error raised by a launch. All pointers are
// device pointers. Policy: wc [F, H], w = [wi; wh] [E + H, 4H], wo [H, V];
// value: w [E + H, 4H], w1 [F + H, H], w2 [H]. These are bf16 when
// bf16 != 0, else float32; every bias (b2 has one element) and both x-gate
// tables xg (emb @ wi, [V, 4H], from icrl_token_gates) are float32. Needs
// 1 <= B <= icrl_beam_max_beam() and T >= 2.
int icrl_beam_search(int n, int F, int E, int H, int V, int T, int B, float vw, float lw,
                     int bf16, const float* feats, const int* start, const void* p_wc,
                     const float* p_bc, const float* p_xg, const void* p_w, const float* p_b,
                     const void* p_wo, const float* p_bo, const float* v_xg, const void* v_w,
                     const float* v_b, const void* v_w1, const float* v_b1, const void* v_w2,
                     const float* v_b2, int* out_tokens, float* out_scores, float* ws,
                     void* stream) {
  using namespace icrl;
  if (B < 1 || B > MAX_BEAM || T < 2) return (int)cudaErrorInvalidValue;
  const PolicyWeights p{p_wc, p_w, p_wo, p_bc, p_xg, p_b, p_bo};
  const ValueWeights v{v_w, v_w1, v_w2, v_xg, v_b, v_b1, v_b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return beam<__nv_bfloat16>(n, F, E, H, V, T, B, vw, lw, feats, start, p, v, out_tokens,
                               out_scores, ws, s);
  return beam<float>(n, F, E, H, V, T, B, vw, lw, feats, start, p, v, out_tokens, out_scores,
                     ws, s);
}

}  // extern "C"
