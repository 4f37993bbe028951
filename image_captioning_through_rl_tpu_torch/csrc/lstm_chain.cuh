// The teacher-forced LSTM chain's step kernels and host loops, forward and
// backward (lstm_fwd, lstm_bwd), shared by lstm_chain.cu (the chain's C entry
// points) and rollout.cu (the A2C rollout, whose encoders' backward is this
// chain's backward). The design notes are lstm_chain.cu's.
#pragma once

#include "common.cuh"

namespace icrl {
namespace {

template <typename W>
struct LstmStepArgs {
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

// One step: a block owns 64 rows and 16 hidden units j (the four gate
// columns {j, H+j, 2H+j, 3H+j} of wh), so each thread holds the four gates of
// one (row, j) after the product and finishes the cell in its epilogue.
template <typename W>
__global__ void __launch_bounds__(NT) lstm_chain_step_kernel(LstmStepArgs<W> a) {
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

// The gate gradients of one step, one thread per (row, unit), from the tape
// (i, f, g, o; c entering and leaving the step) and dh = carry + upstream.
// Writes dg [n, 4H] and the carried dc; dh is then replaced by the product
// dg @ wh^T.
__global__ void lstm_chain_grad_kernel(int n, int H, const float* __restrict__ gates,
                                       const float* __restrict__ c_prev,
                                       const float* __restrict__ c_new,
                                       const float* __restrict__ dh_up,
                                       const float* __restrict__ dh, float* __restrict__ dc,
                                       float* __restrict__ dg) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * H) return;
  const size_t r = idx / H, j = idx % H, G = 4 * (size_t)H;
  const float* g = gates + r * G + j;
  const float i = g[0], f = g[H], gg = g[2 * H], o = g[3 * H];
  const float tc = tanhf(c_new[idx]);
  const float dhv = dh[idx] + dh_up[idx];
  const float d_o = dhv * tc;
  const float dct = dhv * o * (1.f - tc * tc) + dc[idx];
  const float di = dct * gg, dgg = dct * i, df = dct * c_prev[idx];
  float* d = dg + r * G + j;
  d[0] = di * i * (1.f - i);
  d[H] = df * f * (1.f - f);
  d[2 * H] = dgg * (1.f - gg * gg);
  d[3 * H] = d_o * o * (1.f - o);
  dc[idx] = dct * f;
}

// hbuf, cbuf: [(T + 1) n, H], the state entering step t in rows t n .. t n + n
// (the wrapper writes h0, c0 into the first n rows).
template <typename W>
int lstm_fwd(int n, int T, int H, const int* tok, const float* xg, const W* wh, const float* b,
             float* hbuf, float* cbuf, float* gates, cudaStream_t s) {
  const size_t NH = (size_t)n * H, NG = (size_t)n * 4 * H;
  for (int t = 0; t < T; ++t) {
    const LstmStepArgs<W> a{n,        H,           tok + (size_t)t * n, xg,
                            wh,       b,           hbuf + t * NH,       cbuf + t * NH,
                            hbuf + (t + 1) * NH, cbuf + (t + 1) * NH, gates + t * NG};
    lstm_chain_step_kernel<W><<<dim3(cdiv(n, BM), cdiv(H, UNITS)), NT, 0, s>>>(a);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

template <typename W>
int lstm_bwd(int n, int T, int E, int H, const int* tok, const float* dhs, const float* hbuf,
             const float* cbuf, const float* gates, const W* emb, const W* w, float* dg,
             float* dh, float* dc, float* part, float* dw, float* db, float* dx, cudaStream_t s) {
  const int G = 4 * H, R = T * n;
  const size_t NH = (size_t)n * H, NG = (size_t)n * G;
  const W* wi = w;
  const W* wh = w + (size_t)E * G;
  for (int t = T - 1; t >= 0; --t) {
    lstm_chain_grad_kernel<<<cdiv(NH, 256), 256, 0, s>>>(n, H, gates + t * NG, cbuf + t * NH,
                                                          cbuf + (t + 1) * NH, dhs + t * NH, dh,
                                                          dc, dg + t * NG);
    ICRL_CHECK(cudaGetLastError());
    // dh_prev = rnd(dg_t) @ rnd(wh)^T   ([n, 4H] x [4H, H])
    ICRL_CHECK((launch_view<W, false, true>(n, H, G, dg + t * NG, G, nullptr, wh, G, false, dh,
                                            s)));
  }
  // d[wi; wh] = rnd([x; h_prev])^T @ rnd(dg) over all T n rows: x through the
  // tokens (step-major, row t n + r), h_prev = hbuf's first T n rows
  ICRL_CHECK((launch_view<W, true, false>(E, G, R, emb, E, tok, dg, G, false, dw, s)));
  ICRL_CHECK((launch_view<W, true, false>(H, G, R, hbuf, H, nullptr, dg, G, false,
                                          dw + (size_t)E * G, s)));
  ICRL_CHECK(launch_colsum(R, G, dg, part, db, s));
  // dx = rnd(dg) @ rnd(wi)^T   ([T n, 4H] x [4H, E])
  ICRL_CHECK((launch_view<W, false, true>(R, E, G, dg, G, nullptr, wi, G, false, dx, s)));
  return 0;
}

}  // namespace
}  // namespace icrl
