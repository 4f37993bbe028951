// The x-gate table of a recurrent cell: xg[v, :] = emb[v] @ wi (+ bias),
// float32 [V, G] (G = 4H for an LSTM, 3H for a GRU).
//
// The TPU kernels compute x @ wi every step, with x the bf16 embedding row of
// the token picked by a one-hot matmul (pallas_decode.py:_kernel,
// pallas_beam.py:_lstm_step, pallas_lstm.py:_fwd_kernel,
// pallas_gru.py:_fwd_kernel). The product depends on the token alone, so the
// port computes it once per weights, for every token, and the step kernels
// add the token's row to rnd(h) @ wh. That halves each LSTM cell's product
// and, in the beam, lets the B^2 critic cells share one h @ wh per parent.
// The GRU's gi adds bi after the product, as the TPU kernel forms it; the
// table does the same, in the product's epilogue.
//
// What bounds it: at COCO width ([1004, 512] x [512, 2048], 2.1 GFLOP, ~10 MB
// moved) the card's floor is ~3 us of bytes; one call is one wave of 128 x
// 128 output tiles (8 x 16 blocks for an LSTM's 4H, 8 x 12 for the GRU's
// 3H), ~17 MFLOP a block, so what it costs is the latency of filling the
// operand ring and the epilogue's stores. bf16 weights run on wgmma
// (wgmma.cuh): emb is read K-major, wi MN-major as it lies in [wi; wh] (no
// transposed copy), float32 sums, the bias in the epilogue. float32 weights
// keep the 64 x 64 CUDA-core tile of common.cuh (no bf16 tensor-core route).
#include "common.cuh"
#include "wgmma.cuh"

extern "C" {

// emb [V, E] and w (its first E rows, [E, G], row stride G: wi, or the wi
// half of [wi; wh]) are bf16 when bf16 != 0, else float32; bias is float32
// [G] or null; xg is float32 [V, G], all on CUDA device `device`, whose
// `stream` runs the launch (the caller's current device is restored after
// it). bf16 needs E and G multiples of 8 (the wrapper pads). Returns 0 or the
// launch's CUDA error.
int icrl_token_gates(int V, int E, int G, int bf16, const void* emb, const void* w,
                     const float* bias, float* xg, int device, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bf16) {
    using W = __nv_bfloat16;
    err = launch_wgmma_gemm<false, true>(V, G, E, DenseRows{(const W*)emb, V, E, E},
                                         DenseRows{(const W*)w, E, G, G}, xg, s, bias);
  } else {
    err = launch_linear(V, E, G, (const float*)emb, (const float*)w, bias, xg, s);
  }
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

const char* icrl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
