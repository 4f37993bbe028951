// The teacher-forced LSTM chain's backward: lstm_chain.cu's note describes
// the chain. This file instantiates the backward's kernels once, for its C
// entry point and for the A2C rollout (rollout.cu, through
// lstm_chain_backward), apart from the forward's, so the two compile in
// parallel.
#include "lstm_chain.cuh"

namespace icrl {

int lstm_chain_backward(int n, int T, int E, int H, const int* tok, const float* dhs,
                        long dhs_row, long dhs_step, const float* hbuf, const float* cbuf,
                        const float* gates, const __nv_bfloat16* emb,
                        const __nv_bfloat16* w, float* dg, __nv_bfloat16* dg16,
                        __nv_bfloat16* h16, float* dh, float* dc, float* part, float* dw,
                        float* db, float* dx, cudaStream_t s) {
  return lstm_bwd(n, T, E, H, tok, dhs, dhs_row, dhs_step, hbuf, cbuf, gates, emb, w, dg, dg16,
                  h16, dh, dc, part, dw, db, dx, s);
}

int lstm_chain_backward(int n, int T, int E, int H, const int* tok, const float* dhs,
                        long dhs_row, long dhs_step, const float* hbuf, const float* cbuf,
                        const float* gates, const float* emb, const float* w, float* dg,
                        __nv_bfloat16* dg16, __nv_bfloat16* h16, float* dh, float* dc,
                        float* part, float* dw, float* db, float* dx, cudaStream_t s) {
  return lstm_bwd(n, T, E, H, tok, dhs, dhs_row, dhs_step, hbuf, cbuf, gates, emb, w, dg, dg16,
                  h16, dh, dc, part, dw, db, dx, s);
}

}  // namespace icrl

extern "C" {

// Backward. dhs [n, T, H] float32 upstream gradient of hs; hbuf,
// cbuf, gates as the forward left them; emb [V, E] and w = [wi; wh]
// [E + H, 4H] in the weight type. Scratch: dg [T n, 4H] float32, and for
// bf16 weights dg16 [T n, 4H] and h16 [T n, H] bf16; part [16, 4H]. Outputs:
// dh, dc [n, H] (dc zero on entry;
// dh0 and dc0 on return), dw [E + H, 4H], db [4H], dx [T n, E] (step-major
// rows). The plan is the backward's lstm_chain_plan.
int icrl_lstm_chain_bwd(int n, int T, int E, int H, int bf16, int rows_per_tile, int units,
                        int stream, int grid_x, int row_groups, int smem, const int* tok,
                        const float* dhs, const float* hbuf, const float* cbuf, const float* gates,
                        const void* emb, const void* w, float* dg, void* dg16, void* h16,
                        float* dh, float* dc, float* part, float* dw, float* db, float* dx,
                        void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const ChainPlan p = bf16 ? chain_plan<__nv_bfloat16, true, 4>(n, H, device_sms())
                           : chain_plan<float, true, 4>(n, H, device_sms());
  if (!plan_matches(p, rows_per_tile, units, stream, grid_x, row_groups, smem))
    return (int)cudaErrorInvalidValue;
  auto* d16 = static_cast<__nv_bfloat16*>(dg16);
  auto* h = static_cast<__nv_bfloat16*>(h16);
  if (bf16) {
    using W = __nv_bfloat16;
    return lstm_bwd(n, T, E, H, tok, dhs, (long)T * H, H, hbuf, cbuf, gates,
                    static_cast<const W*>(emb), static_cast<const W*>(w), dg, d16, h, dh, dc, part,
                    dw, db, dx, s);
  }
  return lstm_bwd(n, T, E, H, tok, dhs, (long)T * H, H, hbuf, cbuf, gates,
                  static_cast<const float*>(emb), static_cast<const float*>(w), dg, d16, h, dh, dc,
                  part, dw, db, dx, s);
}

}  // extern "C"
