// Greedy caption decode on Hopper.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_decode.py
// (fused_greedy_decode, body _kernel): h0 = feats @ Wc + bc, c0 = 0, then
// max_len - 1 steps of (embed the previous token, LSTM cell, vocab head,
// first-index argmax). Output tokens [N, T] int32, column 0 the start token.
//
// Rounding points, as in the TPU kernel: the h0 product takes float32
// features (pallas_decode.py:83); x (an embedding row of the weight type)
// and h are in the weight type for every gate and head product; sums and
// gate math are float32.
//
// What bounds it here: the TPU kernel keeps every weight in VMEM for the
// whole loop; no SM can hold the ~6.5 MB of bf16 weights, so each step
// streams them from L2 (they fit in its 50 MB) once per 64-row tile, and
// the tile products of common.cuh (the LSTM cell, then the head) take most
// of each step. Design: x @ wi of a token is a row of the x-gate table
// (icrl_token_gates, once per weights), which halves the cell's product;
// the step loop runs on the host inside one C call (one Python call per
// decode), as three launches per step: the LSTM cell (rnd(h) @ wh with the
// gate math fused into its epilogue), the head product into a [N, V] logits
// scratch, and a warp-per-row first-index argmax that writes the token
// straight into the output column the next step reads.
#include "common.cuh"

namespace icrl {
namespace {

__global__ void fill_start_kernel(int n, int T, const int* __restrict__ start,
                                  int* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n) out[(size_t)r * T] = start[r];
}

// out[r * out_stride] = first index of the row maximum of logits[r, :V].
__global__ void __launch_bounds__(NT) argmax_rows_kernel(int M, int V,
                                                         const float* __restrict__ logits,
                                                         int* __restrict__ out, int out_stride) {
  const int lane = threadIdx.x % 32, r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (r >= M) return;
  const float* row = logits + (size_t)r * V;
  float v = -INFINITY;
  int idx = V;  // sentinel: loses every tie against a real column
  for (int c = lane; c < V; c += 32) {
    const float x = row[c];
    if (idx == V || x > v) {
      v = x;
      idx = c;
    }
  }
  warp_argmax(v, idx);
  if (lane == 0) out[(size_t)r * out_stride] = idx;
}

// h in the weight type (only ever read as a product's rounded operand), c
// and the logits in float32.
template <typename W>
struct GreedyLayout {
  W* h[2];
  float *c[2], *logits;
};

template <typename W>
GreedyLayout<W> greedy_layout(float* ws, int n, int H, int V, size_t* used = nullptr) {
  Carver cv{ws};
  GreedyLayout<W> l;
  for (int i = 0; i < 2; ++i) {
    l.h[i] = cv.take<W>((size_t)n * H);
    l.c[i] = cv.take((size_t)n * H);
  }
  l.logits = cv.take((size_t)n * V);
  if (used) *used = cv.used;
  return l;
}

template <typename W>
int greedy(int n, int F, int E, int H, int V, int T, const float* feats, const int* start,
           const W* wc, const float* bc, const float* xg, const W* w, const float* b,
           const W* wo, const float* bo, int* out, float* ws, cudaStream_t s) {
  const GreedyLayout<W> l = greedy_layout<W>(ws, n, H, V);
  const W* wh = w + (size_t)E * 4 * H;
  fill_start_kernel<<<cdiv(n, 256), 256, 0, s>>>(n, T, start, out);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK((launch_linear<W, float, false, W>(n, F, H, feats, wc, bc, l.h[0], s)));
  int cur = 0;
  for (int t = 0; t + 1 < T; ++t) {
    // rows, H, tok (column t of out), tok_div, tok_stride, xg,
    // h_in, c_in (zero at t = 0), state_idx, state_div, wh, b, h_out, c_out
    const LstmArgs<W> a{n,       H, out + t, 1,  T, xg, l.h[cur], t ? l.c[cur] : nullptr,
                        nullptr, 1, wh,      b,  l.h[cur ^ 1], l.c[cur ^ 1]};
    ICRL_CHECK(launch_lstm(a, s));
    cur ^= 1;
    ICRL_CHECK((launch_linear<W, W, false>(n, H, V, l.h[cur], wo, bo, l.logits, s)));
    argmax_rows_kernel<<<cdiv(n, ROWS_PER_BLOCK), NT, 0, s>>>(n, V, l.logits, out + t + 1, T);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

}  // namespace
}  // namespace icrl

extern "C" {

// Float32 elements of the workspace icrl_greedy_decode needs for n rows
// (bf16 as in icrl_greedy_decode).
size_t icrl_greedy_workspace_floats(int n, int H, int V, int bf16) {
  size_t used = 0;
  if (bf16)
    icrl::greedy_layout<__nv_bfloat16>(nullptr, n, H, V, &used);
  else
    icrl::greedy_layout<float>(nullptr, n, H, V, &used);
  return used;
}

// Returns 0 or the first CUDA error raised by a launch. All pointers are
// device pointers; wc, w ([wi; wh], [E + H, 4H]) and wo are bf16 when
// bf16 != 0, else float32; biases and the x-gate table xg (emb @ wi,
// [V, 4H], from icrl_token_gates) are float32.
int icrl_greedy_decode(int n, int F, int E, int H, int V, int T, int bf16, const float* feats,
                       const int* start, const void* wc, const float* bc, const float* xg,
                       const void* w, const float* b, const void* wo, const float* bo, int* out,
                       float* ws, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using W = __nv_bfloat16;
    return greedy<W>(n, F, E, H, V, T, feats, start, (const W*)wc, bc, xg, (const W*)w, b,
                     (const W*)wo, bo, out, ws, s);
  }
  return greedy<float>(n, F, E, H, V, T, feats, start, (const float*)wc, bc, xg,
                       (const float*)w, b, (const float*)wo, bo, out, ws, s);
}

}  // extern "C"
