// The A2C rollout on Hopper, forward and backward.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_rollout.py
// (fused_rollout: _rollout_fwd_kernel, _policy_bwd_kernel and
// _value_bwd_kernel under the custom VJP of _make_core). Over S = T - 1 steps
// from the start-token states (h_p, c_p), (h_v, c_v) and, with the reward
// fused in, h_r, step s (position p = s + 1) computes:
//   logits = rnd(h_p) @ hw + hb
//   action = first argmax of logits + noise[s]          (Gumbel-max: categorical)
//   logp   = (logits - max)[action] - log(sum(exp(logits - max)))
//   v1     = rnd(feats) @ w1[:F] + rnd(h_v) @ w1[F:] + b1,  value = rnd(v1) @ w2 + b2
//   token  = teacher[s] if p < curr_seq_len else action
//   reward = the reward stream's step (reward_stream.cuh), when fused in
//   (h_p, c_p), (h_v, c_v) advance with the token (not on the last step:
//   nothing reads those states, and the backward's chain ends one step early).
// The tape is float32: h and c entering every step, the post-activation gates
// of every advance, and v1.
//
// The backward (the TPU kernel's _policy_bwd_kernel and _value_bwd_kernel):
// only the recurrences are sequential, and the heads' backward needs the
// tape and the cotangents, not the reverse carry. So both heads run first,
// once over all S N rows:
//   policy: logits recomputed (the same tile sums as the forward's, so the
//     same values), dlogits = dlogp (onehot - softmax), dhw = rnd(h_p)^T
//     rnd(dlogits), dhb = column sums, dh_head = rnd(dlogits) @ rnd(hw)^T;
//   value: dv1 = rnd(dval) rnd(w2)^T, dw2 = rnd(v1)^T rnd(dval), db2,
//     dw1 = rnd([feats; h_v])^T rnd(dv1), db1, dfh = rnd(dv1) @ rnd(w1)^T,
//     split into dfeat (summed over the steps) and dh_head.
// Then each encoder's recurrence is the teacher-forced chain's backward
// (lstm_chain_backward, lstm_chain_bwd.cu) over the S - 1 advances: the
// chain's step t output h_p[t + 1] feeds the head at step t + 1, so its
// upstream gradient is dh_head[t + 1], and the cotangent of the start state
// is the chain's dh0 plus dh_head[0]. The rounding points of the TPU kernel's _cell_bwd and _outer
// (pallas_rollout.py:324-373) are the chain's, line by line: the gate
// gradients are formed in float32 from the taped gates and c (lstm_cell_bwd:
// do, dct, di, df, dg, dc_prev as in _cell_bwd), cast to the weight
// type before dh_prev = rnd(dg) @ rnd(wh)^T and dx = rnd(dg) @ rnd(wi)^T
// (_cell_bwd's dxh), and before d[wi; wh] = rnd([x; h])^T rnd(dg) (_outer);
// db sums them unrounded; the carried dh adds the head's dh as the TPU kernel
// adds dxh_h + dh_head.
//
// Rounding points of the forward, as in the TPU kernel body: h_p before the
// head; feats, h_v and v1 in the value MLP; the embedding row and h in each
// cell; the reward's h and `after` before their products. Sums, gate math,
// the softmax and the tape are float32.
//
// What differs from the TPU kernel in form: it keeps every weight of three
// networks (~15 MB in bf16) in VMEM across a (tile, step) grid; no SM holds
// that, so here a host loop runs the S steps, each as per-step kernels over
// the whole batch that stream the weights from L2, on the tile product of
// common.cuh. The cells' input products are rows of x-gate tables
// (token_gates.cu, rebuilt every call because Adam moves the weights); the
// features' half of linear1 is computed once per call; the reward GRU's
// recurrent product once per step (the TPU kernel computes it twice). The
// Mosaic workarounds are gone: the vocabulary is padded to a multiple of 8
// (zero head columns no reduction reads), not to 1024 with a -1e30 bias; no
// one-hot matmuls; the value head is a dot product, not 128 padded columns;
// rows are sample-major within a step, with no batch padding. The gate tape
// holds the S - 1 advances only: the chain backward reads no last-step row,
// so none needs the TPU kernel's defined zeros.
//
// What bounds it: at N = 512, COCO width, the forward moves ~250 MB (the
// tape and the noise) and does ~70 GFLOP in products; the backward ~180
// GFLOP. The forward is a chain of small dependent products (one wave of
// block tiles or less), so launch latency and the tile product's instruction
// rate bound it, far from the bytes and the tensor-core peak; the backward's
// two recurrences are the chain's persistent kernel and its large products
// run on wgmma (lstm_chain.cuh); PERF.md holds the times beside the bounds.
#include "lstm_chain.cuh"
#include "reward_stream.cuh"

namespace icrl {
namespace {

// One advance of the policy or value LSTM inside the rollout's step loop
// (its token is the one this step placed, so the chain's whole-chain
// kernels do not apply): a block owns 64 rows and 16 hidden units j (the
// four gate columns {j, H+j, 2H+j, 3H+j} of wh), so each thread holds the
// four gates of one (row, j) after the product and finishes the cell in its
// epilogue, writing the tape the chain's backward reads.
template <typename W>
struct RolloutCellArgs {
  int n, H;
  const int* tok;      // [n] this step's tokens
  const float* xg;     // [V, 4H] x-gate table emb @ wi
  const W* wh;         // [H, 4H]
  const float* b;      // [4H]
  const float* h_in;   // [n, H] state entering the step
  const float* c_in;
  float* h_out;        // [n, H] state leaving it
  float* c_out;
  float* gates;        // [n, 4H] post-activation i, f, g, o
};

template <typename W>
__global__ void __launch_bounds__(NT) rollout_cell_kernel(RolloutCellArgs<W> a) {
  __shared__ int s_tok[BM];
  const int row0 = blockIdx.x * BM, j0 = blockIdx.y * UNITS, H = a.H, G = 4 * H;
  if (threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    s_tok[threadIdx.x] = r < a.n ? a.tok[r] : 0;
  }
  __syncthreads();
  auto arow = [&](int m) { return row0 + m < a.n ? row0 + m : -1; };
  auto bcol = [&](int c) {  // tile column c = gate * UNITS + unit
    const int j = j0 + c % UNITS;
    return j < H ? (c / UNITS) * H + j : -1;
  };
  float acc[4][4];
  gemm<kIsBf16<W>>(acc, H, a.h_in, H, arow, a.wh, G, bcol);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, j = j0 + tx;
  if (j >= H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i, r = row0 + m;
    if (r >= a.n) continue;
    const float* x = a.xg + (size_t)s_tok[m] * G;
    const size_t o = (size_t)r * H + j;
    const float gi = sigmoid(x[j] + acc[i][0] + a.b[j]);
    const float gf = sigmoid(x[H + j] + acc[i][1] + a.b[H + j]);
    const float gg = tanhf(x[2 * H + j] + acc[i][2] + a.b[2 * H + j]);
    const float go = sigmoid(x[3 * H + j] + acc[i][3] + a.b[3 * H + j]);
    const float c = gf * a.c_in[o] + gi * gg;
    a.c_out[o] = c;
    a.h_out[o] = go * tanhf(c);
    float* g = a.gates + (size_t)r * G + j;
    g[0] = gi;
    g[H] = gf;
    g[2 * H] = gg;
    g[3 * H] = go;
  }
}

// v1 = rnd(h_v) @ w1[F:] + fw1 + b1 over [M, N] (fw1 = rnd(feats) @ w1[:F],
// computed once per call).
template <typename W>
__global__ void __launch_bounds__(NT) value_hidden_kernel(int M, int K, int N,
                                                          const float* __restrict__ A,
                                                          const W* __restrict__ w,
                                                          const float* __restrict__ fw1,
                                                          const float* __restrict__ bias,
                                                          float* __restrict__ out) {
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  auto arow = [&](int m) { return row0 + m < M ? row0 + m : -1; };
  auto bcol = [&](int c) { return col0 + c < N ? col0 + c : -1; };
  float acc[4][4];
  gemm<kIsBf16<W>>(acc, K, A, K, arow, w, N, bcol);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < M && c < N) {
        const size_t o = (size_t)r * N + c;
        out[o] = acc[i][j] + fw1[o] + bias[c];
      }
    }
  }
}

// Block-wide reductions over NT threads (8 warps) through shared memory;
// every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += sh[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* sh) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = sh[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) t = fmaxf(t, sh[i]);
  return t;
}

__device__ __forceinline__ void block_argmax(float& v, int& idx, float* shv, int* shi) {
  warp_argmax(v, idx);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) {
    shv[warp] = v;
    shi[warp] = idx;
  }
  __syncthreads();
  v = shv[0];
  idx = shi[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i)
    if (shv[i] > v || (shv[i] == v && shi[i] < idx)) {
      v = shv[i];
      idx = shi[i];
    }
}

// One block per row r of one step: the Gumbel-max action (first index on
// ties), its log-softmax log-prob, the placed token and the value
// rnd(v1) . rnd(w2) + b2.
template <typename W>
__global__ void __launch_bounds__(NT) sample_rows_kernel(
    int V, int ldl, const float* __restrict__ logits, const float* __restrict__ noise,
    int use_teacher, const int* __restrict__ teach, int H, const float* __restrict__ v1,
    const W* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ logp,
    int* __restrict__ act, int* __restrict__ tok, float* __restrict__ value) {
  __shared__ float shv[NT / 32];
  __shared__ int shi[NT / 32];
  const int r = blockIdx.x;
  const float* l = logits + (size_t)r * ldl;
  const float* z = noise + (size_t)r * V;
  float m = -INFINITY, best = -INFINITY;
  int bi = V;  // sentinel: loses every tie against a real column
  for (int c = threadIdx.x; c < V; c += NT) {
    const float x = l[c], y = x + z[c];
    m = fmaxf(m, x);
    if (bi == V || y > best) {
      best = y;
      bi = c;
    }
  }
  block_argmax(best, bi, shv, shi);
  m = block_max(m, shv);
  float se = 0.f;
  for (int c = threadIdx.x; c < V; c += NT) se += expf(l[c] - m);
  se = block_sum(se, shv);
  float dot = 0.f;
  const float* v = v1 + (size_t)r * H;
  for (int j = threadIdx.x; j < H; j += NT) dot += rnd<W>(v[j]) * ld(w2 + j);
  dot = block_sum(dot, shv);
  if (threadIdx.x == 0) {
    act[r] = bi;
    tok[r] = use_teacher ? teach[r] : bi;
    logp[r] = (l[bi] - m) - logf(se);
    value[r] = dot + b2[0];
  }
}

// In place, one block per row of the [R, ldl] logits: dlogits = dlogp (onehot
// - softmax) on the first V columns (softmax = exp(l - max) / sum, as the TPU
// kernel forms it), zeros on the padding columns.
__global__ void __launch_bounds__(NT) softmax_grad_rows_kernel(int V, int ldl,
                                                               float* __restrict__ logits,
                                                               const int* __restrict__ act,
                                                               const float* __restrict__ dlogp) {
  __shared__ float sh[NT / 32];
  const int r = blockIdx.x;
  float* l = logits + (size_t)r * ldl;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < V; c += NT) m = fmaxf(m, l[c]);
  m = block_max(m, sh);
  float se = 0.f;
  for (int c = threadIdx.x; c < V; c += NT) se += expf(l[c] - m);
  se = block_sum(se, sh);
  const int a = act[r];
  const float d = dlogp[r];
  for (int c = threadIdx.x; c < ldl; c += NT)
    l[c] = c < V ? d * ((c == a ? 1.f : 0.f) - expf(l[c] - m) / se) : 0.f;
}

// Elementwise over [R, H]: dv1 = rnd(dval) rnd(w2), tmp = rnd(v1) rnd(dval)
// (its column sums are dw2), and ridx[r] = r % n, the feature row of
// tape row r.
template <typename W>
__global__ void value_grad_kernel(int R, int H, int n, const float* __restrict__ dval,
                                  const float* __restrict__ v1, const W* __restrict__ w2,
                                  float* __restrict__ dv1, float* __restrict__ tmp,
                                  int* __restrict__ ridx) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * H) return;
  const int r = (int)(idx / H), j = (int)(idx % H);
  const float d = rnd<W>(dval[r]);
  dv1[idx] = d * ld(w2 + j);
  tmp[idx] = rnd<W>(v1[idx]) * d;
  if (j == 0) ridx[r] = r % n;
}

// out [n, F] = sum over the steps, last first (the TPU kernel's reverse-time
// accumulation), of x [S n, F].
__global__ void step_sum_kernel(int n, int S, int F, const float* __restrict__ x,
                                float* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x, NF = (size_t)n * F;
  if (idx >= NF) return;
  float t = 0.f;
  for (int s = S - 1; s >= 0; --s) t += x[s * NF + idx];
  out[idx] = t;
}

__global__ void add_kernel(size_t size, float* __restrict__ a, const float* __restrict__ b) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < size) a[idx] += b[idx];
}

struct FwdLayout {
  float *logits, *fw1, *hr[2];
  RewardScratch r;
};

FwdLayout fwd_layout(float* ws, int n, int H, int Vp, size_t* used = nullptr) {
  Carver cv{ws};
  FwdLayout l;
  l.logits = cv.take((size_t)n * Vp);
  l.fw1 = cv.take((size_t)n * H);
  l.hr[0] = cv.take((size_t)n * H);
  l.hr[1] = cv.take((size_t)n * H);
  l.r.gh = cv.take((size_t)n * 3 * H);
  l.r.after = cv.take((size_t)n * H);
  l.r.se = cv.take((size_t)n * H);
  if (used) *used = cv.used;
  return l;
}

template <typename W>
struct RolloutFwdArgs {
  int n, S, F, E, H, V, Vp, curr;
  const float* feats;     // [n, F]
  const int* teach;       // [S, n] teacher tokens of positions 1 .. S
  const float* noise;     // [S, n, V] Gumbel noise
  const float* p_xg;      // [V, 4H] policy emb @ wi
  const W* p_w;           // [E + H, 4H] policy [wi; wh]
  const float* p_b;       // [4H]
  const W* hw;            // [H, Vp] head, zero padding columns
  const float* hb;        // [Vp]
  const float* v_xg;      // value net, as the policy
  const W* v_w;
  const float* v_b;
  const W* w1;            // [F + H, H] linear1
  const float* b1;        // [H]
  const W* w2;            // [H] linear2
  const float* b2;        // [1]
  RewardNet<W> rnet;      // rnet.xg null: no reward stream
  const float* rew0;      // [n, H]
  float *values, *logp;   // [S, n]
  int *act, *tok;         // [S, n]
  float* rewards;         // [S, n]
  float *hp, *cp, *gp;    // tape: [S n, H] (first n rows: the start state), [(S - 1) n, 4H]
  float *hv, *cv, *gv;
  float* v1;              // [S n, H]
  float* ws;
};

template <typename W>
int rollout_fwd(const RolloutFwdArgs<W>& a, cudaStream_t s) {
  const FwdLayout L = fwd_layout(a.ws, a.n, a.H, a.Vp);
  const int n = a.n, H = a.H;
  const size_t NH = (size_t)n * H, NG = (size_t)n * 4 * H;
  const W* wh_p = a.p_w + (size_t)a.E * 4 * H;
  const W* wh_v = a.v_w + (size_t)a.E * 4 * H;
  ICRL_CHECK((launch_linear<W, float, true>(n, a.F, H, a.feats, a.w1, nullptr, L.fw1, s)));
  for (int t = 0; t < a.S; ++t) {
    const size_t row = (size_t)t * n;
    ICRL_CHECK((launch_linear<W, float, true>(n, H, a.Vp, a.hp + t * NH, a.hw, a.hb, L.logits,
                                               s)));
    value_hidden_kernel<W><<<dim3(cdiv(n, BM), cdiv(H, BN)), NT, 0, s>>>(
        n, H, H, a.hv + t * NH, a.w1 + (size_t)a.F * H, L.fw1, a.b1, a.v1 + t * NH);
    ICRL_CHECK(cudaGetLastError());
    sample_rows_kernel<W><<<n, NT, 0, s>>>(a.V, a.Vp, L.logits, a.noise + row * a.V,
                                           t + 1 < a.curr, a.teach + row, H, a.v1 + t * NH,
                                           a.w2, a.b2, a.logp + row, a.act + row, a.tok + row,
                                           a.values + row);
    ICRL_CHECK(cudaGetLastError());
    if (a.rnet.xg)
      ICRL_CHECK(reward_step(n, H, a.rnet, a.act + row, t + 1 < a.S ? a.tok + row : nullptr,
                             t ? L.hr[(t + 1) % 2] : a.rew0, L.hr[t % 2], L.r,
                             a.rewards + row, s));
    if (t + 1 == a.S) break;  // the last step's advances are never read
    const dim3 grid(cdiv(n, BM), cdiv(H, UNITS));
    const RolloutCellArgs<W> p{n,          H,          a.tok + row,      a.p_xg,
                               wh_p,       a.p_b,      a.hp + t * NH,    a.cp + t * NH,
                               a.hp + (t + 1) * NH, a.cp + (t + 1) * NH, a.gp + t * NG};
    rollout_cell_kernel<W><<<grid, NT, 0, s>>>(p);
    ICRL_CHECK(cudaGetLastError());
    const RolloutCellArgs<W> v{n,          H,          a.tok + row,      a.v_xg,
                               wh_v,       a.v_b,      a.hv + t * NH,    a.cv + t * NH,
                               a.hv + (t + 1) * NH, a.cv + (t + 1) * NH, a.gv + t * NG};
    rollout_cell_kernel<W><<<grid, NT, 0, s>>>(v);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

template <typename W>
int rollout_policy_bwd(int n, int S, int E, int H, int V, int Vp, const int* tok, const int* act,
                       const float* dlogp, const float* hp, const float* cp, const float* gp,
                       const W* emb, const W* w, const W* hw, const float* hb, float* dlogits,
                       float* part, float* dg, __nv_bfloat16* dg16, __nv_bfloat16* h16, float* dhw,
                       float* dhb, float* dh_head, float* dh, float* dc, float* dw, float* db,
                       float* dx, cudaStream_t s) {
  const int R = S * n;
  const size_t NH = (size_t)n * H;
  ICRL_CHECK((launch_linear<W, float, true>(R, H, Vp, hp, hw, hb, dlogits, s)));
  softmax_grad_rows_kernel<<<R, NT, 0, s>>>(V, Vp, dlogits, act, dlogp);
  ICRL_CHECK(cudaGetLastError());
  // dhw = rnd(h_p)^T rnd(dlogits) [H, V]; dhb; dh_head = rnd(dlogits) @ rnd(hw)^T [R, H]
  ICRL_CHECK((launch_view<W, true, false>(H, V, R, hp, H, nullptr, dlogits, Vp, false, dhw, s)));
  ICRL_CHECK(launch_colsum(R, Vp, dlogits, part, dhb, s));
  ICRL_CHECK((launch_view<W, false, true>(R, H, Vp, dlogits, Vp, nullptr, hw, Vp, false, dh_head,
                                          s)));
  if (S > 1)
    ICRL_CHECK(lstm_chain_backward(n, S - 1, E, H, tok, dh_head + NH, H, (long)NH, hp, cp, gp,
                                   emb, w, dg, dg16, h16, dh, dc, part, dw, db, dx, s));
  add_kernel<<<cdiv(NH, 256), 256, 0, s>>>(NH, dh, dh_head);
  return (int)cudaGetLastError();
}

template <typename W>
int rollout_value_bwd(int n, int S, int F, int E, int H, const int* tok, const float* dval,
                      const float* feats, const float* hv, const float* cv, const float* gv,
                      const float* v1, const W* emb, const W* w, const W* w1, const W* w2,
                      int* ridx, float* tmp, float* dv1, float* part, float* dg,
                      __nv_bfloat16* dg16, __nv_bfloat16* h16, float* dfh, float* dw2, float* db2,
                      float* dw1, float* db1, float* dfeat,
                      float* dh_head, float* dh, float* dc, float* dw, float* db, float* dx,
                      cudaStream_t s) {
  const int R = S * n;
  const size_t NH = (size_t)n * H, RH = (size_t)R * H;
  value_grad_kernel<W><<<cdiv(RH, 256), 256, 0, s>>>(R, H, n, dval, v1, w2, dv1, tmp, ridx);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK(launch_colsum(R, H, tmp, part, dw2, s));
  ICRL_CHECK(launch_colsum(R, 1, dval, part, db2, s));
  // dw1 = rnd([feats; h_v])^T rnd(dv1): the feature rows through ridx
  ICRL_CHECK((launch_view<W, true, false>(F, H, R, feats, F, ridx, dv1, H, false, dw1, s)));
  ICRL_CHECK((launch_view<W, true, false>(H, H, R, hv, H, nullptr, dv1, H, false,
                                          dw1 + (size_t)F * H, s)));
  ICRL_CHECK(launch_colsum(R, H, dv1, part, db1, s));
  // dfh = rnd(dv1) @ rnd(w1)^T, as its feature half and its h half
  ICRL_CHECK((launch_view<W, false, true>(R, F, H, dv1, H, nullptr, w1, H, false, dfh, s)));
  ICRL_CHECK((launch_view<W, false, true>(R, H, H, dv1, H, nullptr, w1 + (size_t)F * H, H, false,
                                          dh_head, s)));
  step_sum_kernel<<<cdiv((size_t)n * F, 256), 256, 0, s>>>(n, S, F, dfh, dfeat);
  ICRL_CHECK(cudaGetLastError());
  if (S > 1)
    ICRL_CHECK(lstm_chain_backward(n, S - 1, E, H, tok, dh_head + NH, H, (long)NH, hv, cv, gv,
                                   emb, w, dg, dg16, h16, dh, dc, part, dw, db, dx, s));
  add_kernel<<<cdiv(NH, 256), 256, 0, s>>>(NH, dh, dh_head);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace icrl

extern "C" {

// Float32 elements of the workspace icrl_rollout_fwd needs for n rows.
size_t icrl_rollout_workspace_floats(int n, int H, int Vp) {
  size_t used = 0;
  icrl::fwd_layout(nullptr, n, H, Vp, &used);
  return used;
}

// Forward. Weights (p_w, hw, v_w, w1, w2, r_wh, sem_w) are bf16 when bf16 != 0,
// else float32; tables, biases, states and the tape are float32; shapes as in
// RolloutFwdArgs. r_xg null runs no reward stream (then r_wh .. rew0 and
// rewards are not read or written). hp, cp, hv, cv hold the start states in
// their first n rows. Returns 0 or the first CUDA error of a launch.
int icrl_rollout_fwd(int n, int S, int F, int E, int H, int V, int Vp, int curr, int bf16,
                     const float* feats, const int* teach, const float* noise, const float* p_xg,
                     const void* p_w, const float* p_b, const void* hw, const float* hb,
                     const float* v_xg, const void* v_w, const float* v_b, const void* w1,
                     const float* b1, const void* w2, const float* b2, const float* r_xg,
                     const void* r_wh, const float* r_bh, const void* sem_w, const float* sem_b,
                     const float* vn, const float* rew0, float* values, float* logp, int* act,
                     int* tok, float* rewards, float* hp, float* cp, float* gp, float* hv,
                     float* cv, float* gv, float* v1, float* ws, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    const RolloutFwdArgs<W> a{
        n, S, F, E, H, V, Vp, curr, feats, teach, noise, p_xg, (const W*)p_w, p_b,
        (const W*)hw, hb, v_xg, (const W*)v_w, v_b, (const W*)w1, b1, (const W*)w2, b2,
        RewardNet<W>{r_xg, (const W*)r_wh, r_bh, (const W*)sem_w, sem_b, vn}, rew0, values,
        logp, act, tok, rewards, hp, cp, gp, hv, cv, gv, v1, ws};
    return rollout_fwd(a, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

// Policy backward. tok, act [S, n]; dlogp [S, n]; the tape hp, cp, gp; emb
// [V, E], w = [wi; wh] [E + H, 4H] and hw [H, Vp] in the weight type; hb [Vp].
// Scratch: dlogits [S n, Vp], part [16, max(Vp, 4H)], dg [(S - 1) n, 4H], and
// for bf16 weights dg16 [(S - 1) n, 4H] and h16 [(S - 1) n, H] bf16.
// Outputs: dhw [H, V], dhb [Vp], dh_head [S n, H], dh and dc [n, H] (zero on
// entry; the start state's cotangents on return), dw [E + H, 4H], db [4H], dx
// [(S - 1) n, E].
int icrl_rollout_policy_bwd(int n, int S, int E, int H, int V, int Vp, int bf16, const int* tok,
                            const int* act, const float* dlogp, const float* hp, const float* cp,
                            const float* gp, const void* emb, const void* w, const void* hw,
                            const float* hb, float* dlogits, float* part, float* dg, void* dg16,
                            void* h16, float* dhw, float* dhb, float* dh_head, float* dh,
                            float* dc, float* dw, float* db, float* dx, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    return rollout_policy_bwd<W>(n, S, E, H, V, Vp, tok, act, dlogp, hp, cp, gp, (const W*)emb,
                                 (const W*)w, (const W*)hw, hb, dlogits, part, dg,
                                 (__nv_bfloat16*)dg16, (__nv_bfloat16*)h16, dhw, dhb, dh_head, dh,
                                 dc, dw, db, dx, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

// Value backward. tok [S, n]; dval [S, n]; feats [n, F]; the tape hv, cv, gv,
// v1; emb, w as the policy's; w1 [F + H, H], w2 [H] in the weight type.
// Scratch: ridx [S n] int32, tmp and dv1 [S n, H], part [16, 4H], dg, dg16 and
// h16 as the policy's, dfh [S n, F]. Outputs: dw2 [H], db2 [1], dw1 [F + H, H],
// db1 [H], dfeat [n, F], dh_head [S n, H], dh, dc, dw, db, dx as the policy's.
int icrl_rollout_value_bwd(int n, int S, int F, int E, int H, int bf16, const int* tok,
                           const float* dval, const float* feats, const float* hv,
                           const float* cv, const float* gv, const float* v1, const void* emb,
                           const void* w, const void* w1, const void* w2, int* ridx, float* tmp,
                           float* dv1, float* part, float* dg, void* dg16, void* h16, float* dfh,
                           float* dw2, float* db2, float* dw1, float* db1, float* dfeat,
                           float* dh_head, float* dh, float* dc, float* dw, float* db, float* dx,
                           void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    return rollout_value_bwd<W>(n, S, F, E, H, tok, dval, feats, hv, cv, gv, v1, (const W*)emb,
                                (const W*)w, (const W*)w1, (const W*)w2, ridx, tmp, dv1, part,
                                dg, (__nv_bfloat16*)dg16, (__nv_bfloat16*)h16, dfh, dw2, db2, dw1,
                                db1, dfeat, dh_head, dh, dc, dw, db, dx, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

}  // extern "C"
