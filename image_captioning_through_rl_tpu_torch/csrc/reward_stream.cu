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
// What bounds it: per step two dependent products ([N, 512] x [512, 1536]
// and [N, 512] x [512, 512] at COCO width, 1 GFLOP a step at N = 512, 2 MB
// of bf16 weights) and a row pass between them, so latency bounds it, not
// bytes or the tensor cores: a host loop of four launches a step spent most
// of its time launching and waiting. What the design does about it: the
// whole stream is one persistent cooperative launch, the rollout forward's
// reward-only mode (rollout_fwd.cuh, reward_stream_kernel): both weights
// are cut into column slices that stay in shared memory for all S steps
// (at COCO width, bf16: 16 slices of 128 columns x 8 row groups, one 64-row
// tile a block at N = 512), phase A multiplies step s's h by wh's slices and
// step s - 1's `after` by sem_w's (keeping each row's partial |se|^2 and
// vn . se), phase B combines the cosine of step s - 1 and runs the GRU's
// lookahead and advance, and one more pass takes the last reward: S + 1
// passes of two grid barriers each. gh is computed once a step and serves
// both GRU updates; the advance is skipped where the token is the action
// (it equals the lookahead) and on the last step (nothing reads it).
#include "rollout_fwd.cuh"

namespace icrl {
namespace {

// The workspace: the stream's scratch of RolloutFwdArgs (gh, the GRU state,
// the semantic partials sized for the narrowest slices, and the weight-typed
// copies of h and `after` that phase A stages).
struct RewardLayout {
  float *gh, *hr, *spart, *hwr, *aw;
  int hp;
};

RewardLayout reward_layout(float* ws, int n, int H, size_t* used = nullptr) {
  Carver cv{ws};
  RewardLayout l;
  const size_t NH = (size_t)n * H;
  l.hp = ceil_div(H, 32);
  l.gh = cv.take(3 * NH);
  l.hr = cv.take(NH);
  l.spart = cv.take((size_t)n * l.hp * 2);
  l.hwr = cv.take(NH);  // W-typed, float32 at most
  l.aw = cv.take(NH);
  if (used) *used = cv.used;
  return l;
}

}  // namespace
}  // namespace icrl

extern "C" {

// Float32 elements of the workspace icrl_reward_stream needs for n rows.
size_t icrl_reward_stream_workspace_floats(int n, int H) {
  size_t used = 0;
  icrl::reward_layout(nullptr, n, H, &used);
  return used;
}

// act, tok [S, n] int32 step-major (read only); xg [V, 3H] float32
// (emb @ wi + bi, icrl_token_gates); wh [H, 3H] and sem_w [H, H] bf16 when
// bf16 != 0, else float32; bh [3H], sem_b [H], vn and rew0 [n, H] float32;
// rewards [S, n] float32 out; ws the workspace. The plan (rows per tile,
// units, streaming or not, grid columns, row groups, shared bytes) must be
// rollout_plan's in the reward-only mode. clock is null or 2 + 4 (S + 1)
// zeros on the device, which the launch fills with the times of its phases
// (rollout_fwd.cuh clock_mark). Returns 0 or the CUDA error of the launch (a
// refused cooperative launch included).
int icrl_reward_stream(int n, int S, int H, int bf16, int rows_per_tile, int units, int stream,
                       int grid_x, int row_groups, int smem, const int* act, const int* tok,
                       const float* xg, const void* wh, const float* bh, const void* sem_w,
                       const float* sem_b, const float* vn, const float* rew0, float* rewards,
                       float* ws, unsigned long long* clock, void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const ChainPlan p = bf16 ? rollout_plan<__nv_bfloat16>(n, H, H, 0, true, device_sms(), true)
                           : rollout_plan<float>(n, H, H, 0, true, device_sms(), true);
  if (!plan_matches(p, rows_per_tile, units, stream, grid_x, row_groups, smem))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || S == 0) return 0;
  const RewardLayout L = reward_layout(ws, n, H);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    RolloutFwdArgs<W> a{};
    a.n = n;
    a.S = S;
    a.F = H;
    a.H = H;
    a.row_groups = p.row_groups;
    a.rnet = RewardNet<W>{xg, (const W*)wh, bh, (const W*)sem_w, sem_b, vn};
    a.rew0 = rew0;
    a.act = const_cast<int*>(act);  // the reward-only mode reads them
    a.tok = const_cast<int*>(tok);
    a.rewards = rewards;
    a.gh = L.gh;
    a.hr = L.hr;
    a.spart = L.spart;
    a.hp_stride = L.hp;
    a.hwr = (W*)L.hwr;
    a.aw = (W*)L.aw;
    a.clock = clock;
    return (int)launch_rollout_fwd<W, true>(p, a, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

}  // extern "C"
