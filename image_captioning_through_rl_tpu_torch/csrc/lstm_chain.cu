// Teacher-forced LSTM chain on Hopper, forward and backward.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_lstm.py
// (fused_lstm_chain: _fwd_kernel and _bwd_kernel under the custom VJP of
// _make_chain). Over known tokens [N, T] from (h0, c0): the forward emits
// the per-step h (and the c and post-activation gate tape the backward
// reads); the backward runs in reverse time, carrying (dh, dc), and returns
// d[wi; wh], db, the per-step dx (scattered onto the embedding rows by the
// wrapper), dh0 and dc0.
//
// Rounding points, as in the TPU kernel: the embedding row x and h are cast
// to the weight type before every product, as are the gate gradients before
// the backward products; sums, gate math, h, c and the bias gradient (a sum
// of the unrounded gate gradients) stay float32.
//
// What bounds it here: each forward step is an [N, 512] x [512, 2048]
// product, and each backward step one more of that size, that depend on the
// step before. At N = 512 one step's product is ~1 GFLOP, a microsecond of
// the tensor cores' time; what a step costs is moving its operands into the
// SMs and the wait between steps. What the design does about it
// (lstm_chain.cuh):
//   * x @ wi depends on the token alone: the wrapper builds the x-gate
//     table emb @ wi once per call (token_gates.cu, the weights change every
//     step), so each forward step runs only rnd(h) @ wh. The gates add up as
//     (x @ wi) + (h @ wh) + b, not as one [x; h] @ [wi; wh] sum: a float32
//     sum-order change.
//   * Each direction's recurrence is one persistent cooperative launch:
//     each block keeps its units' slice of wh in shared memory for the whole
//     chain (wh is read from L2 once per call, not once per step and row
//     tile), streams only the step's rnd(h) (forward) or rnd(dg) (backward)
//     rows through a cp.async ring, finishes the cell in the same block, and
//     meets a grid-wide barrier: no launch per step, no host loop.
//   * The backward keeps only what recurs inside the loop: dh_prev =
//     rnd(dg) @ wh^T and the gate gradients of the step before. The products
//     that do not recur (d[wi; wh] over all T N rows, dx) run once after it
//     on wgmma (wgmma.cuh), db as fixed-order column sums.
//   * The plan (chain.cuh) picks the units per block from the width: the
//     widest slice (bf16: 32, 16 or 8 units; float32: 8) that fits shared
//     memory beside the ring while every slice keeps a block of its own;
//     past that (bf16: the forward from H = 1064, the backward from H =
//     1128) the weights stream through the ring with A at every step, still
//     in one cooperative launch, so no width is refused.
// Larger wgmma tiles and TMA multicast of the shared dg rows across a
// cluster are later work. The kernels are lstm_chain.cuh's; the backward's
// entry point is in lstm_chain_bwd.cu.
#include "lstm_chain.cuh"

extern "C" {

// Forward. tok [T, n] int32 step-major; xg [V, 4H] float32 (icrl_token_gates);
// wh [H, 4H] bf16 when bf16 != 0, else float32; b [4H]; h0, c0 [n, H]
// float32. Outputs: hbuf, cbuf [(T + 1) n, H] float32 (the state entering
// each step, h0 and c0 first), gates [T n, 4H], hs [n, T, H] (h leaving each
// step). Scratch: h16 [2, n, H] bf16 (bf16 only). The plan (rows per tile,
// units per slice, streaming or not, grid columns, row groups, shared bytes)
// must be lstm_chain_plan's. Returns 0 or the CUDA error of the launch (a
// refused cooperative launch included).
int icrl_lstm_chain_fwd(int n, int T, int H, int bf16, int rows_per_tile, int units, int stream,
                        int grid_x, int row_groups, int smem, const int* tok, const float* xg,
                        const void* wh, const float* b, const float* h0, const float* c0,
                        float* hbuf, float* cbuf, float* gates, float* hs, void* h16,
                        void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const ChainPlan p = bf16 ? chain_plan<__nv_bfloat16, false, 4>(n, H, device_sms())
                           : chain_plan<float, false, 4>(n, H, device_sms());
  if (!plan_matches(p, rows_per_tile, units, stream, grid_x, row_groups, smem))
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return lstm_fwd(n, T, H, tok, xg, static_cast<const __nv_bfloat16*>(wh), b, h0, c0, hbuf,
                    cbuf, gates, hs, static_cast<__nv_bfloat16*>(h16), s);
  return lstm_fwd(n, T, H, tok, xg, static_cast<const float*>(wh), b, h0, c0, hbuf, cbuf, gates,
                  hs, static_cast<__nv_bfloat16*>(h16), s);
}

}  // extern "C"
