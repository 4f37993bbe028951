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
// step before. At N = 512 one such product is 128 block tiles, one wave on
// 132 SMs, and a tile is bound by how fast it issues its staging and WMMA
// instructions and waits out each depth step (common.cuh), far below the
// tensor cores' rate: launch latency and the tile's instruction rate bound
// the chain, not bytes. What the design does about it:
//   * x @ wi depends on the token alone: the wrapper builds the x-gate
//     table emb @ wi once per call (token_gates.cu, the weights change every
//     step), so each forward step runs only rnd(h) @ wh, with the gate math
//     and the c/h update in its epilogue (one launch per step). The gates
//     then add up as (x @ wi) + (h @ wh) + b, not as one [x; h] @ [wi; wh]
//     sum: a float32 sum-order change.
//   * The backward keeps only what recurs inside the loop: per step, an
//     elementwise pass forms the gate gradients from the tape and
//     dh = carry + upstream, and one product forms dh_prev = rnd(dg) @ wh^T.
//     The products that do not recur (d[wi; wh] = rnd([x; h_prev])^T rnd(dg)
//     over all T N rows, db, dx = rnd(dg) @ wi^T) run once after the loop as
//     large tile products, from the float32 gate gradients of every step.
//   * The step loop runs on the host inside one C call per direction.
// A persistent, weights-stationary chain, wgmma and TMA are later work.
#include "lstm_chain.cuh"

extern "C" {

// Forward. tok [T, n] int32 step-major; xg [V, 4H] float32 (icrl_token_gates);
// wh [H, 4H] bf16 when bf16 != 0, else float32; b [4H]; hbuf, cbuf
// [(T + 1) n, H] float32 with h0, c0 in the first n rows (the rest is
// written); gates [T n, 4H]. Returns 0 or the first CUDA error of a launch.
int icrl_lstm_chain_fwd(int n, int T, int H, int bf16, const int* tok, const float* xg,
                        const void* wh, const float* b, float* hbuf, float* cbuf, float* gates,
                        void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return lstm_fwd(n, T, H, tok, xg, static_cast<const __nv_bfloat16*>(wh), b, hbuf, cbuf,
                    gates, s);
  return lstm_fwd(n, T, H, tok, xg, static_cast<const float*>(wh), b, hbuf, cbuf, gates, s);
}

// Backward. dhs [T, n, H] float32 upstream gradient of the per-step h; hbuf,
// cbuf, gates as the forward left them; emb [V, E] and w = [wi; wh]
// [E + H, 4H] in the weight type. Scratch: dg [T n, 4H], part
// [16, 4H]. Outputs: dh, dc [n, H] (zero on entry; dh0 and dc0 on return),
// dw [E + H, 4H], db [4H], dx [T n, E] (step-major rows).
int icrl_lstm_chain_bwd(int n, int T, int E, int H, int bf16, const int* tok, const float* dhs,
                        const float* hbuf, const float* cbuf, const float* gates,
                        const void* emb, const void* w, float* dg, float* dh, float* dc,
                        float* part, float* dw, float* db, float* dx, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    return lstm_bwd(n, T, E, H, tok, dhs, hbuf, cbuf, gates, static_cast<const W*>(emb),
                    static_cast<const W*>(w), dg, dh, dc, part, dw, db, dx, s);
  }
  return lstm_bwd(n, T, E, H, tok, dhs, hbuf, cbuf, gates, static_cast<const float*>(emb),
                  static_cast<const float*>(w), dg, dh, dc, part, dw, db, dx, s);
}

}  // extern "C"
