// The x-gate table of a recurrent cell: xg[v, :] = emb[v] @ wi (+ bias),
// float32 [V, G] (G = 4H for an LSTM, 3H for a GRU).
//
// The TPU kernels compute x @ wi every step, with x the bf16 embedding row of
// the token picked by a one-hot matmul (pallas_decode.py:_kernel,
// pallas_beam.py:_lstm_step, pallas_lstm.py:_fwd_kernel,
// pallas_gru.py:_fwd_kernel). The product depends on the token alone, so the
// port computes it once per weights, for every token, with the tiled product
// of common.cuh (bf16 operands when the weights are bf16, float32 sums, as on
// the TPU), and the step kernels add the token's row to rnd(h) @ wh. That
// halves each LSTM cell's product and, in the beam, lets the B^2 critic cells
// share one h @ wh per parent. The GRU's gi adds bi after the product, as the
// TPU kernel forms it; the table does the same.
#include "common.cuh"

extern "C" {

// emb [V, E] and w (its first E rows, [E, G], row stride G: wi, or the wi
// half of [wi; wh]) are bf16 when bf16 != 0, else float32; bias is float32
// [G] or null; xg is float32 [V, G]. Returns 0 or the launch's CUDA error.
int icrl_token_gates(int V, int E, int G, int bf16, const void* emb, const void* w,
                     const float* bias, float* xg, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    return (int)launch_linear<W, W, false>(V, E, G, (const W*)emb, (const W*)w, bias, xg, s);
  }
  return (int)launch_linear<float, float, false>(V, E, G, (const float*)emb, (const float*)w,
                                                 bias, xg, s);
}

const char* icrl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
