// The A2C rollout's frozen reward stream on Hopper (forward only).
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_rollout.py
// (fused_reward_stream, body _reward_stream_kernel). Given the rollout's
// sampled actions and placed tokens [S, N], per step s:
//   gh    = rnd(h) @ wh + bh                       (the reward GRU's recurrent gates)
//   after = gru(xg[action], gh, h)                 (lookahead on the sampled action)
//   se    = rnd(after) @ sem_w + sem_b             (semantic_embed)
//   r[s]  = sum(vn * se) / max(|se|, 1e-12)        (cosine against the normalised
//                                                   visual embedding vn)
//   h     = gru(xg[token], gh, h)                  (advance on the placed token)
// from h = rew0, the GRU state after the start token. xg is the table
// emb @ wi + bi (token_gates.cu, once per call). The reward network is frozen
// and its output carries no gradient (quirk Q7), so there is no tape and no
// backward.
//
// Rounding points, as in the TPU kernel: h and `after` are cast to the weight
// type before their products; sums, gate math and the cosine are float32.
//
// What bounds it: per step two dependent products ([N, 512] x [512, 1536],
// [N, 512] x [512, 512]; at N = 512, 96 and 32 block tiles, under one wave
// of 132 SMs) and two small elementwise or row passes, so launch latency and
// the tile product's instruction rate (common.cuh) bound it, not bytes. What
// the design does about it: the TPU kernel computes gh twice per step, once
// in each _gru_step call, from the same h; here it is computed once and
// serves the lookahead and the advance, which is skipped where the token is
// the action (the advance then equals the lookahead) and on the last step
// (nothing reads it). The step loop runs on the host inside one C call.
#include "reward_stream.cuh"

namespace icrl {
namespace {

struct StreamLayout {
  float* h[2];
  RewardScratch r;
};

StreamLayout stream_layout(float* ws, int n, int H, size_t* used = nullptr) {
  Carver cv{ws};
  StreamLayout l;
  l.h[0] = cv.take((size_t)n * H);
  l.h[1] = cv.take((size_t)n * H);
  l.r.gh = cv.take((size_t)n * 3 * H);
  l.r.after = cv.take((size_t)n * H);
  l.r.se = cv.take((size_t)n * H);
  if (used) *used = cv.used;
  return l;
}

template <typename W>
int reward_stream(int n, int S, int H, const int* act, const int* tok, const RewardNet<W>& net,
                  const float* rew0, float* rewards, float* ws, cudaStream_t s) {
  const StreamLayout l = stream_layout(ws, n, H);
  for (int t = 0; t < S; ++t) {
    const float* h_in = t ? l.h[(t + 1) % 2] : rew0;
    ICRL_CHECK(reward_step(n, H, net, act + (size_t)t * n,
                           t + 1 < S ? tok + (size_t)t * n : nullptr, h_in, l.h[t % 2], l.r,
                           rewards + (size_t)t * n, s));
  }
  return 0;
}

}  // namespace
}  // namespace icrl

extern "C" {

// Float32 elements of the workspace icrl_reward_stream needs for n rows.
size_t icrl_reward_stream_workspace_floats(int n, int H) {
  size_t used = 0;
  icrl::stream_layout(nullptr, n, H, &used);
  return used;
}

// act, tok [S, n] int32 step-major; xg [V, 3H] float32 (emb @ wi + bi,
// icrl_token_gates); wh [H, 3H] and sem_w [H, H] bf16 when bf16 != 0, else
// float32; bh [3H], sem_b [H], vn and rew0 [n, H] float32; rewards [S, n]
// float32 out; ws the workspace. Returns 0 or the first CUDA error of a launch.
int icrl_reward_stream(int n, int S, int H, int bf16, const int* act, const int* tok,
                       const float* xg, const void* wh, const float* bh, const void* sem_w,
                       const float* sem_b, const float* vn, const float* rew0, float* rewards,
                       float* ws, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    const RewardNet<W> net{xg, static_cast<const W*>(wh), bh, static_cast<const W*>(sem_w),
                           sem_b, vn};
    return reward_stream(n, S, H, act, tok, net, rew0, rewards, ws, s);
  }
  const RewardNet<float> net{xg, static_cast<const float*>(wh), bh,
                             static_cast<const float*>(sem_w), sem_b, vn};
  return reward_stream(n, S, H, act, tok, net, rew0, rewards, ws, s);
}

}  // extern "C"
