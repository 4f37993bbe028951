// The x-gate table of an LSTM: xg[v, :] = emb[v] @ wi, float32 [V, 4H].
//
// Both TPU decode kernels (pallas_decode.py:_kernel, pallas_beam.py:_lstm_step)
// compute x @ wi every step, with x the bf16 embedding row of the previous
// token picked by a one-hot matmul. The product depends on the token alone, so
// the port computes it once per weights, for every token, with the tiled
// product of common.cuh (bf16 operands when the weights are bf16, float32
// sums, as on the TPU), and the decode kernels add the token's row to
// rnd(h) @ wh. That halves each policy cell's product and, in the beam, lets
// the B^2 critic cells share one h @ wh per parent.
#include "common.cuh"

extern "C" {

// emb [V, E] and w = [wi; wh] [E + H, 4H] are bf16 when bf16 != 0, else
// float32; xg is float32 [V, 4H]. Returns 0 or the launch's CUDA error.
int icrl_token_gates(int V, int E, int H, int bf16, const void* emb, const void* w,
                     float* xg, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    return (int)launch_linear<W, W, false>(V, E, 4 * H, (const W*)emb, (const W*)w, nullptr,
                                           xg, s);
  }
  return (int)launch_linear<float, float, false>(V, E, 4 * H, (const float*)emb,
                                                 (const float*)w, nullptr, xg, s);
}

const char* icrl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
