// Teacher-forced GRU chain on Hopper, forward and backward.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_gru.py
// (fused_gru_chain: _fwd_kernel and _bwd_kernel under the custom VJP of
// _make_chain), the reward network's caption encoder in the VSE step. Per
// step, gate order r, z, n:
//   gi = rnd(x) @ rnd(wi) + bi,  gh = rnd(h) @ rnd(wh) + bh,
//   r = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z),
//   n = tanh(gi_n + r * gh_n),  h' = (1 - z) * n + z * h.
// The forward tapes r, z, n and gh_n; the backward runs in reverse time and
// returns dwi, dwh, dbi, dbh, the per-step dx, and dh0.
//
// Rounding points, as in the TPU kernel: x and h are cast to the weight type
// before their products, the gate gradients before the backward products;
// sums, gate math, h and the bias gradients (sums of the unrounded gate
// gradients) stay float32.
//
// What bounds it here: as in lstm_chain.cu, a chain of small dependent
// products ([N, 512] x [512, 1536] per step each way), one wave of block
// tiles at N = 512, bound by launch latency and the tile's instruction rate,
// not bytes. The design is lstm_chain.cu's:
//   * gi depends on the token alone: the wrapper builds the table
//     emb @ wi + bi once per call (token_gates.cu; bi added after the
//     product, as gi is formed), so each forward step runs rnd(h) @ wh with
//     the gate math and the update in its epilogue. A block owns 16 hidden
//     units, i.e. 48 of its tile's 64 columns (three gates; the fourth group
//     of 16 columns stays empty).
//   * The backward keeps per step an elementwise pass (dgi, dgh from the
//     tape, dgh's n part times r) and the product
//     dh_prev = rnd(dgh) @ rnd(wh)^T + dh * z; dwi, dwh, dbi, dbh and
//     dx = rnd(dgi) @ rnd(wi)^T run once after the loop over all T N rows.
//   * The step loop runs on the host inside one C call per direction.
#include "common.cuh"

namespace icrl {
namespace {

template <typename W>
struct GruStepArgs {
  int n, H;
  const int* tok;      // [n] this step's tokens
  const float* xg;     // [V, 3H] table emb @ wi + bi
  const W* wh;         // [H, 3H]
  const float* bh;     // [3H]
  const float* h_in;   // [n, H]
  float* h_out;        // [n, H]
  float* gates;        // [n, 3H] r, z, n
  float* ghn;          // [n, H] gh_n = (rnd(h) @ wh + bh)[:, 2H:]
};

template <typename W>
__global__ void __launch_bounds__(NT) gru_chain_step_kernel(GruStepArgs<W> a) {
  __shared__ int s_tok[BM];
  const int row0 = blockIdx.x * BM, j0 = blockIdx.y * UNITS, H = a.H, G = 3 * H;
  if (threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    s_tok[threadIdx.x] = r < a.n ? a.tok[r] : 0;
  }
  __syncthreads();
  auto arow = [&](int m) { return row0 + m < a.n ? row0 + m : -1; };
  auto bcol = [&](int c) {  // tile column c = gate * UNITS + unit; gate 3 is empty
    const int gate = c / UNITS, j = j0 + c % UNITS;
    return gate < 3 && j < H ? gate * H + j : -1;
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
    const float gh_r = acc[i][0] + a.bh[j];
    const float gh_z = acc[i][1] + a.bh[H + j];
    const float gh_n = acc[i][2] + a.bh[2 * H + j];
    const float rg = sigmoid(x[j] + gh_r);
    const float zg = sigmoid(x[H + j] + gh_z);
    const float ng = tanhf(x[2 * H + j] + rg * gh_n);
    a.h_out[o] = (1.f - zg) * ng + zg * a.h_in[o];
    float* g = a.gates + (size_t)r * G + j;
    g[0] = rg;
    g[H] = zg;
    g[2 * H] = ng;
    a.ghn[o] = gh_n;
  }
}

// The gate gradients of one step, one thread per (row, unit): dgi, dgh
// [n, 3H] from the tape and dh = carry + upstream; dh is replaced by its
// direct part dh * z, to which the product adds dgh @ wh^T.
__global__ void gru_chain_grad_kernel(int n, int H, const float* __restrict__ gates,
                                      const float* __restrict__ ghn,
                                      const float* __restrict__ h_prev,
                                      const float* __restrict__ dh_up, float* __restrict__ dh,
                                      float* __restrict__ dgi, float* __restrict__ dgh) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * H) return;
  const size_t r = idx / H, j = idx % H, G = 3 * (size_t)H;
  const float* g = gates + r * G + j;
  const float rg = g[0], zg = g[H], ng = g[2 * H];
  const float dhv = dh[idx] + dh_up[idx];
  const float dz = dhv * (h_prev[idx] - ng);
  const float dn = dhv * (1.f - zg);
  const float dn_pre = dn * (1.f - ng * ng);
  const float dr = dn_pre * ghn[idx];
  const float dr_pre = dr * rg * (1.f - rg);
  const float dz_pre = dz * zg * (1.f - zg);
  float* di = dgi + r * G + j;
  float* dhh = dgh + r * G + j;
  di[0] = dr_pre;
  di[H] = dz_pre;
  di[2 * H] = dn_pre;
  dhh[0] = dr_pre;
  dhh[H] = dz_pre;
  dhh[2 * H] = dn_pre * rg;
  dh[idx] = dhv * zg;
}

// hbuf: [(T + 1) n, H], the state entering step t in rows t n .. t n + n (the
// wrapper writes h0 into the first n rows).
template <typename W>
int gru_fwd(int n, int T, int H, const int* tok, const float* xg, const W* wh, const float* bh,
            float* hbuf, float* gates, float* ghn, cudaStream_t s) {
  const size_t NH = (size_t)n * H, NG = (size_t)n * 3 * H;
  for (int t = 0; t < T; ++t) {
    const GruStepArgs<W> a{n,  H,  tok + (size_t)t * n, xg, wh, bh, hbuf + t * NH,
                           hbuf + (t + 1) * NH, gates + t * NG, ghn + t * NH};
    gru_chain_step_kernel<W><<<dim3(cdiv(n, BM), cdiv(H, UNITS)), NT, 0, s>>>(a);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

template <typename W>
int gru_bwd(int n, int T, int E, int H, const int* tok, const float* dhs, const float* hbuf,
            const float* gates, const float* ghn, const W* emb, const W* wi, const W* wh,
            float* dgi, float* dgh, float* dh, float* part, float* dwi, float* dwh, float* dbi,
            float* dbh, float* dx, cudaStream_t s) {
  const int G = 3 * H, R = T * n;
  const size_t NH = (size_t)n * H, NG = (size_t)n * G;
  for (int t = T - 1; t >= 0; --t) {
    gru_chain_grad_kernel<<<cdiv(NH, 256), 256, 0, s>>>(n, H, gates + t * NG, ghn + t * NH,
                                                         hbuf + t * NH, dhs + t * NH, dh,
                                                         dgi + t * NG, dgh + t * NG);
    ICRL_CHECK(cudaGetLastError());
    // dh_prev = rnd(dgh_t) @ rnd(wh)^T + dh * z   ([n, 3H] x [3H, H])
    ICRL_CHECK((launch_view<W, false, true>(n, H, G, dgh + t * NG, G, nullptr, wh, G, true, dh,
                                            s)));
  }
  ICRL_CHECK((launch_view<W, true, false>(E, G, R, emb, E, tok, dgi, G, false, dwi, s)));
  ICRL_CHECK((launch_view<W, true, false>(H, G, R, hbuf, H, nullptr, dgh, G, false, dwh, s)));
  ICRL_CHECK(launch_colsum(R, G, dgi, part, dbi, s));
  ICRL_CHECK(launch_colsum(R, G, dgh, part, dbh, s));
  ICRL_CHECK((launch_view<W, false, true>(R, E, G, dgi, G, nullptr, wi, G, false, dx, s)));
  return 0;
}

}  // namespace
}  // namespace icrl

extern "C" {

// Forward. tok [T, n] int32 step-major; xg [V, 3H] float32 (emb @ wi + bi,
// icrl_token_gates); wh [H, 3H] bf16 when bf16 != 0, else float32; bh [3H];
// hbuf [(T + 1) n, H] float32 with h0 in the first n rows; gates [T n, 3H];
// ghn [T n, H]. Returns 0 or the first CUDA error of a launch.
int icrl_gru_chain_fwd(int n, int T, int H, int bf16, const int* tok, const float* xg,
                       const void* wh, const float* bh, float* hbuf, float* gates, float* ghn,
                       void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return gru_fwd(n, T, H, tok, xg, static_cast<const __nv_bfloat16*>(wh), bh, hbuf, gates, ghn,
                   s);
  return gru_fwd(n, T, H, tok, xg, static_cast<const float*>(wh), bh, hbuf, gates, ghn, s);
}

// Backward. dhs [T, n, H] float32; hbuf, gates, ghn as the forward left them;
// emb [V, E], wi [E, 3H], wh [H, 3H] in the weight type. Scratch: dgi, dgh
// [T n, 3H], part [16, 3H]. Outputs: dh [n, H] (zero on entry, dh0 on
// return), dwi [E, 3H], dwh [H, 3H], dbi, dbh [3H], dx [T n, E].
int icrl_gru_chain_bwd(int n, int T, int E, int H, int bf16, const int* tok, const float* dhs,
                       const float* hbuf, const float* gates, const float* ghn, const void* emb,
                       const void* wi, const void* wh, float* dgi, float* dgh, float* dh,
                       float* part, float* dwi, float* dwh, float* dbi, float* dbh, float* dx,
                       void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    return gru_bwd(n, T, E, H, tok, dhs, hbuf, gates, ghn, static_cast<const W*>(emb),
                   static_cast<const W*>(wi), static_cast<const W*>(wh), dgi, dgh, dh, part,
                   dwi, dwh, dbi, dbh, dx, s);
  }
  return gru_bwd(n, T, E, H, tok, dhs, hbuf, gates, ghn, static_cast<const float*>(emb),
                 static_cast<const float*>(wi), static_cast<const float*>(wh), dgi, dgh, dh, part,
                 dwi, dwh, dbi, dbh, dx, s);
}

}  // extern "C"
