// The A2C rollout's forward on Hopper: the C entry of the persistent
// cooperative launch in rollout_fwd.cuh (TPU kernel _rollout_fwd_kernel of
// image_captioning_through_rl_tpu/ops/pallas_rollout.py; the design notes
// are the header's).
#include "rollout_fwd.cuh"

namespace icrl {
namespace {

// The workspace: the scratch of RolloutFwdArgs, partials sized for the
// narrowest slices (32 columns).
struct FwdLayout {
  float *fw1, *pre_p, *pre_v, *gh, *hr, *lpart, *vpart, *spart, *w16[4];
  int lp, hp;
};

FwdLayout fwd_layout(float* ws, int n, int H, int Vp, size_t* used = nullptr) {
  Carver cv{ws};
  FwdLayout l;
  const size_t NH = (size_t)n * H;
  l.lp = ceil_div(Vp, 32);
  l.hp = ceil_div(H, 32);
  l.fw1 = cv.take(NH);
  l.pre_p = cv.take(4 * NH);
  l.pre_v = cv.take(4 * NH);
  l.gh = cv.take(3 * NH);
  l.hr = cv.take(NH);
  l.lpart = cv.take((size_t)n * l.lp * 5);
  l.vpart = cv.take((size_t)n * l.hp);
  l.spart = cv.take((size_t)n * l.hp * 2);
  for (auto& w : l.w16) w = cv.take(NH);  // W-typed, float32 at most
  if (used) *used = cv.used;
  return l;
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
// their first n rows. The plan (rows per tile, units, streaming or not, grid
// columns, row groups, shared bytes) must be rollout_plan's. clock is null or
// 2 + 4 (S + 1) zeros on the device, which the launch fills with the times of
// its phases (clock_mark). Returns 0 or the CUDA error of the launch (a
// refused cooperative launch included).
int icrl_rollout_fwd(int n, int S, int F, int E, int H, int V, int Vp, int curr, int bf16,
                     int rows_per_tile, int units, int stream, int grid_x, int row_groups,
                     int smem, const float* feats, const int* teach, const float* noise,
                     const float* p_xg, const void* p_w, const float* p_b, const void* hw,
                     const float* hb, const float* v_xg, const void* v_w, const float* v_b,
                     const void* w1, const float* b1, const void* w2, const float* b2,
                     const float* r_xg, const void* r_wh, const float* r_bh, const void* sem_w,
                     const float* sem_b, const float* vn, const float* rew0, float* values,
                     float* logp, int* act, int* tok, float* rewards, float* hp, float* cp,
                     float* gp, float* hv, float* cv, float* gv, float* v1, float* ws,
                     unsigned long long* clock, void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const bool reward = r_xg != nullptr;
  const ChainPlan p = bf16 ? rollout_plan<__nv_bfloat16>(n, F, H, Vp, reward, device_sms())
                           : rollout_plan<float>(n, F, H, Vp, reward, device_sms());
  if (!plan_matches(p, rows_per_tile, units, stream, grid_x, row_groups, smem))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || S == 0) return 0;
  const FwdLayout L = fwd_layout(ws, n, H, Vp);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    const RolloutFwdArgs<W> a{
        n, S, F, E, H, V, Vp, curr, p.row_groups, feats, teach, noise, p_xg, (const W*)p_w, p_b,
        (const W*)hw, hb, v_xg, (const W*)v_w, v_b, (const W*)w1, b1, (const W*)w2, b2,
        RewardNet<W>{r_xg, (const W*)r_wh, r_bh, (const W*)sem_w, sem_b, vn}, rew0, values,
        logp, act, tok, rewards, hp, cp, gp, hv, cv, gv, v1, L.fw1, L.pre_p, L.pre_v, L.gh,
        L.hr, L.lpart, L.vpart, L.spart, L.lp, L.hp, (W*)L.w16[0], (W*)L.w16[1],
        (W*)L.w16[2], (W*)L.w16[3], clock};
    return (int)launch_rollout_fwd<W, false>(p, a, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

}  // extern "C"
