// One step of the A2C rollout's frozen reward stream, shared by
// reward_stream.cu (the stream on its own, TPU kernel 5) and rollout.cu
// (the stream fused into the rollout's forward, as the TPU kernel's
// fuse_reward variant runs it). The design notes are reward_stream.cu's.
#pragma once

#include "common.cuh"

namespace icrl {
namespace {

// The GRU update of one unit from its input gates gi (a row of the table
// emb @ wi + bi) and recurrent gates gh (rnd(h) @ wh + bh), gate order
// r, z, n, as ops/rnn.gru_cell and the TPU kernel's _gru_step compose it;
// gru_unit reads unit j's gates from the rows gi and gh.
__device__ __forceinline__ float gru_update(const float (&gi)[3], const float (&gh)[3], float h) {
  const float r = sigmoid(gi[0] + gh[0]);
  const float z = sigmoid(gi[1] + gh[1]);
  const float n = tanhf(gi[2] + r * gh[2]);
  return (1.f - z) * n + z * h;
}

__device__ __forceinline__ float gru_unit(int H, int j, const float* gi, const float* gh,
                                          float h) {
  return gru_update({gi[j], gi[H + j], gi[2 * H + j]}, {gh[j], gh[H + j], gh[2 * H + j]}, h);
}

// One thread per (row, unit): the lookahead on the sampled action,
// after = gru(xg[act], gh, h), and, when h_out is given, the advance on the
// placed token, which is `after` itself where the token is the action.
__global__ void gru_pair_kernel(int n, int H, const int* __restrict__ act,
                                const int* __restrict__ tok, const float* __restrict__ xg,
                                const float* __restrict__ gh, const float* __restrict__ h_in,
                                float* __restrict__ after, float* __restrict__ h_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n * H) return;
  const size_t r = idx / H, G = 3 * (size_t)H;
  const int j = (int)(idx % H), a = act[r];
  const float* g = gh + r * G;
  const float h = h_in[idx];
  const float la = gru_unit(H, j, xg + (size_t)a * G, g, h);
  after[idx] = la;
  if (h_out) {
    const int t = tok[r];
    h_out[idx] = t == a ? la : gru_unit(H, j, xg + (size_t)t * G, g, h);
  }
}

// One warp per row: reward = sum(vn * se) / max(|se|, 1e-12), the cosine
// against the normalised visual embedding vn, composed as the TPU kernel
// composes it (pallas_rollout.py:192-194).
__global__ void __launch_bounds__(NT) cosine_rows_kernel(int n, int H,
                                                         const float* __restrict__ se,
                                                         const float* __restrict__ vn,
                                                         float* __restrict__ out) {
  const int lane = threadIdx.x % 32, r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (r >= n) return;
  const float* x = se + (size_t)r * H;
  const float* v = vn + (size_t)r * H;
  float ss = 0.f, dot = 0.f;
  for (int c = lane; c < H; c += 32) {
    ss += x[c] * x[c];
    dot += v[c] * x[c];
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    ss += __shfl_xor_sync(FULL, ss, off);
    dot += __shfl_xor_sync(FULL, dot, off);
  }
  if (lane == 0) out[r] = dot / fmaxf(sqrtf(ss), 1e-12f);
}

// The frozen reward network in the kernels' layout.
template <typename W>
struct RewardNet {
  const float* xg;     // [V, 3H] emb @ wi + bi
  const W* wh;         // [H, 3H]
  const float* bh;     // [3H]
  const W* sem_w;      // [H, H]
  const float* sem_b;  // [H]
  const float* vn;     // [n, H] normalised visual embedding of each row
};

// Scratch of one reward step, [n, 3H] and two [n, H].
struct RewardScratch {
  float *gh, *after, *se;
};

// One reward step: gh = rnd(h) @ wh + bh (once, for the lookahead and the
// advance), the lookahead on act, se = rnd(after) @ sem_w + sem_b, the
// cosine into rew; with tok given, the advance into h_out.
template <typename W>
int reward_step(int n, int H, const RewardNet<W>& net, const int* act, const int* tok,
                const float* h_in, float* h_out, const RewardScratch& ws, float* rew,
                cudaStream_t s) {
  const size_t NH = (size_t)n * H;
  ICRL_CHECK((launch_linear<W, float, true>(n, H, 3 * H, h_in, net.wh, net.bh, ws.gh, s)));
  gru_pair_kernel<<<cdiv(NH, 256), 256, 0, s>>>(n, H, act, tok, net.xg, ws.gh, h_in, ws.after,
                                                tok ? h_out : nullptr);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK((launch_linear<W, float, true>(n, H, H, ws.after, net.sem_w, net.sem_b, ws.se, s)));
  cosine_rows_kernel<<<cdiv(n, ROWS_PER_BLOCK), NT, 0, s>>>(n, H, ws.se, net.vn, rew);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace icrl
