// Sampled caption decode on Hopper: temperature, top-k, nucleus, Gumbel-max.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_sample.py
// (fused_sample_decode, body _kernel, pallas_call at line 350): h0 = feats @
// Wc + bc, c0 = 0, then max_len - 1 steps of (the LSTM cell on the previous
// token, the vocab head, scaled = logits / t, top-k and/or nucleus, plus the
// Gumbel noise of threefry(subkey_s, row * V + col), first-index argmax)
// into column s + 1. Column 0 is the start token. The cell and head, and
// their rounding points, are the greedy kernel's (greedy_decode.cu).
//
// The filters are the TPU kernel's, without a sort (pallas_sample.py:143-219):
// a float's key is the total-order map of x + 0.f (the + 0.f turns -0.0 into
// +0.0; the card keeps subnormals where the TPU flushes them, which never
// matters for logits; the build has no --use_fast_math, so neither that add
// nor the IEEE division by t is rewritten). Each filter keeps keys >= the
// smallest j with "weight of keys > j" < budget, found by 32 rounds of
// bisection from lo = rowmin - 1, hi = rowmax with the overflow-free
// midpoint; a converged row stalls. Top-k weighs each element 1 against k;
// the nucleus runs over top-k's survivors (the rest are -1e30) and weighs
// e = expf(x - rowmax) against p * sum(e). expf and the warp's sum order are
// not torch.exp's and torch.sum's: where the mass at the boundary lies within
// float error of p * z, a row may keep one token more or fewer than the plain
// version, which chip_smoke.py's near-tie rule covers.
//
// The noise is never stored: each element hashes its own counter row * V +
// col (uint32, V unpadded, row over the whole batch: the wrapper checks
// n * V < 2^32) under the step's subkey, which each step's launch takes by
// value from the host key table, so no step count is capped.
//
// What bounds it on Hopper: per step the cell and head stream the weights
// from L2 as the greedy decode does; then each row does ~130 scalar
// operations per element (hash and Gumbel map), and ~270 with both filters
// (64 bisection passes). Design: the greedy loop with its argmax replaced by
// one warp per row that holds the row's V <= 1024 scaled logits in registers
// (32 per lane), so the bisection rounds read no memory; the warp's shuffle
// sums leave the same total in every lane, so every decision is the warp's.
#include "common.cuh"
#include "threefry.cuh"

namespace icrl {
namespace {

constexpr int PER_LANE = 32;  // logits a lane holds: V <= 1024 (MAX_VOCAB in ops/fused_sample.py)
constexpr float MASKED = -1e30f;  // a filtered-out logit (pallas_decode.py _NEG)

__device__ __forceinline__ int monotone_key(float x) {
  const int i = __float_as_int(x + 0.f);
  return i ^ (i < 0 ? 0x7fffffff : 0);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Smallest key j of the row with sum(w over valid keys > j) < budget
// (pallas_sample.py keyspace_threshold); w = 1 when kCount.
template <bool kCount>
__device__ __forceinline__ int keyspace_threshold(const int (&key)[PER_LANE],
                                                  const float (&w)[PER_LANE], int lane, int V,
                                                  float budget) {
  int kmin = 0x7fffffff, kmax = -0x7fffffff - 1;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i)
    if (lane + 32 * i < V) {
      kmin = min(kmin, key[i]);
      kmax = max(kmax, key[i]);
    }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(FULL, kmin, off));
    kmax = max(kmax, __shfl_xor_sync(FULL, kmax, off));
  }
  int lo = (int)((unsigned)kmin - 1u), hi = kmax;
  for (int round = 0; round < 32; ++round) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);  // floor((lo + hi) / 2)
    float mass = 0.f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      if (lane + 32 * i < V && key[i] > mid) mass += kCount ? 1.f : w[i];
    if (warp_sum(mass) < budget)
      hi = mid;
    else
      lo = mid;
  }
  return hi;
}

// out[r * out_stride] = the token drawn for row r of logits [M, V] under
// the step key (k0, k1).
template <bool kTopK, bool kTopP>
__global__ void __launch_bounds__(NT)
    sample_rows_kernel(int M, int V, float temp, int k, float p, unsigned k0, unsigned k1,
                       const float* __restrict__ logits, int* __restrict__ out, int out_stride) {
  const int lane = threadIdx.x % 32, r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (r >= M) return;
  const float* row = logits + (size_t)r * V;
  float x[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < V ? row[c] / temp : MASKED;
  }
  if constexpr (kTopK || kTopP) {
    int key[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) key[i] = monotone_key(x[i]);
    if constexpr (kTopK) {
      const int thr = keyspace_threshold<true>(key, x, lane, V, (float)k);
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        if (key[i] < thr) x[i] = MASKED;
        key[i] = monotone_key(x[i]);
      }
    }
    if constexpr (kTopP) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (lane + 32 * i < V) m = fmaxf(m, x[i]);
#pragma unroll
      for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      float e[PER_LANE], z = 0.f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        e[i] = lane + 32 * i < V ? expf(x[i] - m) : 0.f;  // filtered entries underflow to 0
        z += e[i];
      }
      const int thr = keyspace_threshold<false>(key, e, lane, V, p * warp_sum(z));
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (key[i] < thr) x[i] = MASKED;
    }
  }
  // Gumbel-max: jax.random.categorical(subkey, scaled), first index on ties
  const unsigned base = (unsigned)r * (unsigned)V;
  float best = -INFINITY;
  int idx = V;  // sentinel: loses every tie against a real column
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    if (c < V) {
      const float noisy = x[i] + gumbel_from_bits(random_bits(k0, k1, base + (unsigned)c));
      if (idx == V || noisy > best) {
        best = noisy;
        idx = c;
      }
    }
  }
  warp_argmax(best, idx);
  if (lane == 0) out[(size_t)r * out_stride] = idx;
}

cudaError_t launch_sample_rows(bool top_k, bool top_p, int M, int V, float temp, int k, float p,
                               unsigned k0, unsigned k1, const float* logits, int* out,
                               int out_stride, cudaStream_t s) {
  const dim3 grid(cdiv(M, ROWS_PER_BLOCK)), block(NT);
  if (top_k && top_p)
    sample_rows_kernel<true, true><<<grid, block, 0, s>>>(M, V, temp, k, p, k0, k1, logits, out,
                                                          out_stride);
  else if (top_k)
    sample_rows_kernel<true, false><<<grid, block, 0, s>>>(M, V, temp, k, p, k0, k1, logits, out,
                                                           out_stride);
  else if (top_p)
    sample_rows_kernel<false, true><<<grid, block, 0, s>>>(M, V, temp, k, p, k0, k1, logits, out,
                                                           out_stride);
  else
    sample_rows_kernel<false, false><<<grid, block, 0, s>>>(M, V, temp, k, p, k0, k1, logits,
                                                            out, out_stride);
  return cudaGetLastError();
}

template <typename W>
int sample(int n, int F, int E, int H, int V, int T, bool top_k, bool top_p, int k, float temp,
           float p, const unsigned* keys, const float* feats, const int* start, const W* wc,
           const float* bc, const float* xg, const W* w, const float* b, const W* wo,
           const float* bo, int* out, float* ws, cudaStream_t s) {
  const GreedyLayout<W> l = greedy_layout<W>(ws, n, H, V);
  const W* wh = w + (size_t)E * 4 * H;
  fill_start_kernel<<<cdiv(n, 256), 256, 0, s>>>(n, T, start, out);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK((launch_linear<W, float, false, W>(n, F, H, feats, wc, bc, l.h[0], s)));
  int cur = 0;
  for (int t = 0; t + 1 < T; ++t) {
    // rows, H, tok (column t of out), tok_div, tok_stride, xg,
    // h_in, c_in (zero at t = 0), state_idx, state_div, wh, b, h_out, c_out
    const LstmArgs<W> a{n,       H, out + t, 1,  T, xg, l.h[cur], t ? l.c[cur] : nullptr,
                        nullptr, 1, wh,      b,  l.h[cur ^ 1], l.c[cur ^ 1]};
    ICRL_CHECK(launch_lstm(a, s));
    cur ^= 1;
    ICRL_CHECK((launch_linear<W, W, false>(n, H, V, l.h[cur], wo, bo, l.logits, s)));
    ICRL_CHECK(launch_sample_rows(top_k, top_p, n, V, temp, k, p, keys[2 * t], keys[2 * t + 1],
                                  l.logits, out + t + 1, T, s));
  }
  return 0;
}

}  // namespace
}  // namespace icrl

extern "C" {

// Sampled decode of n rows into out [n, T] (device), in the greedy decode's
// workspace (icrl_greedy_workspace_floats). keys: host memory, uint32
// [T - 1, 2], step t's subkey at keys[2 t], keys[2 t + 1]. Top-k (k) runs
// when use_top_k != 0, the nucleus (p) when use_top_p != 0; temp > 0. Weights
// and other pointers as in icrl_greedy_decode. Returns 0 or the first CUDA
// error raised by a launch.
int icrl_sample_decode(int n, int F, int E, int H, int V, int T, int bf16, int use_top_k,
                       int use_top_p, int k, float temp, float p, const unsigned* keys,
                       const float* feats, const int* start, const void* wc, const float* bc,
                       const float* xg, const void* w, const float* b, const void* wo,
                       const float* bo, int* out, float* ws, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    return sample<W>(n, F, E, H, V, T, use_top_k, use_top_p, k, temp, p, keys, feats, start,
                     (const W*)wc, bc, xg, (const W*)w, b, (const W*)wo, bo, out, ws, s);
  }
  return sample<float>(n, F, E, H, V, T, use_top_k, use_top_p, k, temp, p, keys, feats, start,
                       (const float*)wc, bc, xg, (const float*)w, b, (const float*)wo, bo, out,
                       ws, s);
}

}  // extern "C"
