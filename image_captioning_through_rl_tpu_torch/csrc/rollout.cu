// The A2C rollout's backward on Hopper.
//
// Replaces the TPU kernels image_captioning_through_rl_tpu/ops/pallas_rollout.py
// _policy_bwd_kernel and _value_bwd_kernel under the custom VJP of _make_core
// (fused_rollout). The forward (_rollout_fwd_kernel) is rollout_fwd.cu: one
// persistent cooperative launch; its note says what each step computes, where
// it rounds and what bounds it now. It leaves a float32 tape of S steps over
// n rows: h and c entering every step, the post-activation gates of the S - 1
// advances, and v1.
//
// The backward: only the recurrences are sequential, and the heads' backward
// needs the tape and the cotangents, not the reverse carry. So both heads run
// first, once over all S N rows:
//   policy: logits recomputed from the tape, dlogits = dlogp (onehot -
//     softmax), dhw = rnd(h_p)^T rnd(dlogits), dhb = column sums, dh_head =
//     rnd(dlogits) @ rnd(hw)^T. The recomputed logits are the tile product's
//     sums, the forward's are its mma.sync slices': they may differ in the
//     last bits, and with them the softmax, so the backward on the forward's
//     tape is held to the chains' bound (CHAIN_TOL), as the TPU kernel's
//     recomputation would be;
//   value: dv1 = rnd(dval) rnd(w2)^T, dw2 = rnd(v1)^T rnd(dval), db2,
//     dw1 = rnd([feats; h_v])^T rnd(dv1), db1, dfh = rnd(dv1) @ rnd(w1)^T,
//     split into dfeat (summed over the steps) and dh_head.
// Then each encoder's recurrence is the teacher-forced chain's backward
// (lstm_chain_backward, lstm_chain_bwd.cu) over the S - 1 advances: the
// chain's step t output h_p[t + 1] feeds the head at step t + 1, so its
// upstream gradient is dh_head[t + 1], and the cotangent of the start state
// is the chain's dh0 plus dh_head[0]. The rounding points of the TPU kernel's _cell_bwd and _outer
// (pallas_rollout.py:324-373) are the chain's, line by line: the gate
// gradients are formed in float32 from the taped gates and c (lstm_cell_bwd:
// do, dct, di, df, dg, dc_prev as in _cell_bwd), cast to the weight
// type before dh_prev = rnd(dg) @ rnd(wh)^T and dx = rnd(dg) @ rnd(wi)^T
// (_cell_bwd's dxh), and before d[wi; wh] = rnd([x; h])^T rnd(dg) (_outer);
// db sums them unrounded; the carried dh adds the head's dh as the TPU kernel
// adds dxh_h + dh_head.
//
// What differs from the TPU kernel in form: the vocabulary is padded to a
// multiple of 8 (zero head columns no reduction reads), not to 1024 with a
// -1e30 bias; no one-hot matmuls; the value head is a dot product, not 128
// padded columns; rows are sample-major within a step, with no batch
// padding. The gate tape holds the S - 1 advances only: the chain backward
// reads no last-step row, so none needs the TPU kernel's defined zeros.
//
// What bounds it: at N = 512, COCO width, ~180 GFLOP; the two recurrences are
// the chain's persistent kernel and its large products run on wgmma
// (lstm_chain.cuh); the heads' products still run on the 64 x 64 tile of
// common.cuh (launch_view), far from the tensor-core peak. PERF.md holds the
// times beside the bounds.
#include "lstm_chain.cuh"

namespace icrl {
namespace {

// Block-wide reductions over NT threads (8 warps) through shared memory;
// every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* sh) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += sh[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* sh) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = sh[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) t = fmaxf(t, sh[i]);
  return t;
}

// In place, one block per row of the [R, ldl] logits: dlogits = dlogp (onehot
// - softmax) on the first V columns (softmax = exp(l - max) / sum, as the TPU
// kernel forms it), zeros on the padding columns.
__global__ void __launch_bounds__(NT) softmax_grad_rows_kernel(int V, int ldl,
                                                               float* __restrict__ logits,
                                                               const int* __restrict__ act,
                                                               const float* __restrict__ dlogp) {
  __shared__ float sh[NT / 32];
  const int r = blockIdx.x;
  float* l = logits + (size_t)r * ldl;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < V; c += NT) m = fmaxf(m, l[c]);
  m = block_max(m, sh);
  float se = 0.f;
  for (int c = threadIdx.x; c < V; c += NT) se += expf(l[c] - m);
  se = block_sum(se, sh);
  const int a = act[r];
  const float d = dlogp[r];
  for (int c = threadIdx.x; c < ldl; c += NT)
    l[c] = c < V ? d * ((c == a ? 1.f : 0.f) - expf(l[c] - m) / se) : 0.f;
}

// Elementwise over [R, H]: dv1 = rnd(dval) rnd(w2), tmp = rnd(v1) rnd(dval)
// (its column sums are dw2), and ridx[r] = r % n, the feature row of
// tape row r.
template <typename W>
__global__ void value_grad_kernel(int R, int H, int n, const float* __restrict__ dval,
                                  const float* __restrict__ v1, const W* __restrict__ w2,
                                  float* __restrict__ dv1, float* __restrict__ tmp,
                                  int* __restrict__ ridx) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * H) return;
  const int r = (int)(idx / H), j = (int)(idx % H);
  const float d = rnd<W>(dval[r]);
  dv1[idx] = d * ld(w2 + j);
  tmp[idx] = rnd<W>(v1[idx]) * d;
  if (j == 0) ridx[r] = r % n;
}

// out [n, F] = sum over the steps, last first (the TPU kernel's reverse-time
// accumulation), of x [S n, F].
__global__ void step_sum_kernel(int n, int S, int F, const float* __restrict__ x,
                                float* __restrict__ out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x, NF = (size_t)n * F;
  if (idx >= NF) return;
  float t = 0.f;
  for (int s = S - 1; s >= 0; --s) t += x[s * NF + idx];
  out[idx] = t;
}

__global__ void add_kernel(size_t size, float* __restrict__ a, const float* __restrict__ b) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < size) a[idx] += b[idx];
}

template <typename W>
int rollout_policy_bwd(int n, int S, int E, int H, int V, int Vp, const int* tok, const int* act,
                       const float* dlogp, const float* hp, const float* cp, const float* gp,
                       const W* emb, const W* w, const W* hw, const float* hb, float* dlogits,
                       float* part, float* dg, __nv_bfloat16* dg16, __nv_bfloat16* h16, float* dhw,
                       float* dhb, float* dh_head, float* dh, float* dc, float* dw, float* db,
                       float* dx, cudaStream_t s) {
  const int R = S * n;
  const size_t NH = (size_t)n * H;
  ICRL_CHECK((launch_linear<W, float, true>(R, H, Vp, hp, hw, hb, dlogits, s)));
  softmax_grad_rows_kernel<<<R, NT, 0, s>>>(V, Vp, dlogits, act, dlogp);
  ICRL_CHECK(cudaGetLastError());
  // dhw = rnd(h_p)^T rnd(dlogits) [H, V]; dhb; dh_head = rnd(dlogits) @ rnd(hw)^T [R, H]
  ICRL_CHECK((launch_view<W, true, false>(H, V, R, hp, H, nullptr, dlogits, Vp, false, dhw, s)));
  ICRL_CHECK(launch_colsum(R, Vp, dlogits, part, dhb, s));
  ICRL_CHECK((launch_view<W, false, true>(R, H, Vp, dlogits, Vp, nullptr, hw, Vp, false, dh_head,
                                          s)));
  if (S > 1)
    ICRL_CHECK(lstm_chain_backward(n, S - 1, E, H, tok, dh_head + NH, H, (long)NH, hp, cp, gp,
                                   emb, w, dg, dg16, h16, dh, dc, part, dw, db, dx, s));
  add_kernel<<<cdiv(NH, 256), 256, 0, s>>>(NH, dh, dh_head);
  return (int)cudaGetLastError();
}

template <typename W>
int rollout_value_bwd(int n, int S, int F, int E, int H, const int* tok, const float* dval,
                      const float* feats, const float* hv, const float* cv, const float* gv,
                      const float* v1, const W* emb, const W* w, const W* w1, const W* w2,
                      int* ridx, float* tmp, float* dv1, float* part, float* dg,
                      __nv_bfloat16* dg16, __nv_bfloat16* h16, float* dfh, float* dw2, float* db2,
                      float* dw1, float* db1, float* dfeat,
                      float* dh_head, float* dh, float* dc, float* dw, float* db, float* dx,
                      cudaStream_t s) {
  const int R = S * n;
  const size_t NH = (size_t)n * H, RH = (size_t)R * H;
  value_grad_kernel<W><<<cdiv(RH, 256), 256, 0, s>>>(R, H, n, dval, v1, w2, dv1, tmp, ridx);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK(launch_colsum(R, H, tmp, part, dw2, s));
  ICRL_CHECK(launch_colsum(R, 1, dval, part, db2, s));
  // dw1 = rnd([feats; h_v])^T rnd(dv1): the feature rows through ridx
  ICRL_CHECK((launch_view<W, true, false>(F, H, R, feats, F, ridx, dv1, H, false, dw1, s)));
  ICRL_CHECK((launch_view<W, true, false>(H, H, R, hv, H, nullptr, dv1, H, false,
                                          dw1 + (size_t)F * H, s)));
  ICRL_CHECK(launch_colsum(R, H, dv1, part, db1, s));
  // dfh = rnd(dv1) @ rnd(w1)^T, as its feature half and its h half
  ICRL_CHECK((launch_view<W, false, true>(R, F, H, dv1, H, nullptr, w1, H, false, dfh, s)));
  ICRL_CHECK((launch_view<W, false, true>(R, H, H, dv1, H, nullptr, w1 + (size_t)F * H, H, false,
                                          dh_head, s)));
  step_sum_kernel<<<cdiv((size_t)n * F, 256), 256, 0, s>>>(n, S, F, dfh, dfeat);
  ICRL_CHECK(cudaGetLastError());
  if (S > 1)
    ICRL_CHECK(lstm_chain_backward(n, S - 1, E, H, tok, dh_head + NH, H, (long)NH, hv, cv, gv,
                                   emb, w, dg, dg16, h16, dh, dc, part, dw, db, dx, s));
  add_kernel<<<cdiv(NH, 256), 256, 0, s>>>(NH, dh, dh_head);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace icrl

extern "C" {

// Policy backward. tok, act [S, n]; dlogp [S, n]; the tape hp, cp, gp; emb
// [V, E], w = [wi; wh] [E + H, 4H] and hw [H, Vp] in the weight type; hb [Vp].
// Scratch: dlogits [S n, Vp], part [16, max(Vp, 4H)], dg [(S - 1) n, 4H], and
// for bf16 weights dg16 [(S - 1) n, 4H] and h16 [(S - 1) n, H] bf16.
// Outputs: dhw [H, V], dhb [Vp], dh_head [S n, H], dh and dc [n, H] (zero on
// entry; the start state's cotangents on return), dw [E + H, 4H], db [4H], dx
// [(S - 1) n, E].
int icrl_rollout_policy_bwd(int n, int S, int E, int H, int V, int Vp, int bf16, const int* tok,
                            const int* act, const float* dlogp, const float* hp, const float* cp,
                            const float* gp, const void* emb, const void* w, const void* hw,
                            const float* hb, float* dlogits, float* part, float* dg, void* dg16,
                            void* h16, float* dhw, float* dhb, float* dh_head, float* dh,
                            float* dc, float* dw, float* db, float* dx, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    return rollout_policy_bwd<W>(n, S, E, H, V, Vp, tok, act, dlogp, hp, cp, gp, (const W*)emb,
                                 (const W*)w, (const W*)hw, hb, dlogits, part, dg,
                                 (__nv_bfloat16*)dg16, (__nv_bfloat16*)h16, dhw, dhb, dh_head, dh,
                                 dc, dw, db, dx, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

// Value backward. tok [S, n]; dval [S, n]; feats [n, F]; the tape hv, cv, gv,
// v1; emb, w as the policy's; w1 [F + H, H], w2 [H] in the weight type.
// Scratch: ridx [S n] int32, tmp and dv1 [S n, H], part [16, 4H], dg, dg16 and
// h16 as the policy's, dfh [S n, F]. Outputs: dw2 [H], db2 [1], dw1 [F + H, H],
// db1 [H], dfeat [n, F], dh_head [S n, H], dh, dc, dw, db, dx as the policy's.
int icrl_rollout_value_bwd(int n, int S, int F, int E, int H, int bf16, const int* tok,
                           const float* dval, const float* feats, const float* hv,
                           const float* cv, const float* gv, const float* v1, const void* emb,
                           const void* w, const void* w1, const void* w2, int* ridx, float* tmp,
                           float* dv1, float* part, float* dg, void* dg16, void* h16, float* dfh,
                           float* dw2, float* db2, float* dw1, float* db1, float* dfeat,
                           float* dh_head, float* dh, float* dc, float* dw, float* db, float* dx,
                           void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto tag) {
    using W = decltype(tag);
    return rollout_value_bwd<W>(n, S, F, E, H, tok, dval, feats, hv, cv, gv, v1, (const W*)emb,
                                (const W*)w, (const W*)w1, (const W*)w2, ridx, tmp, dv1, part,
                                dg, (__nv_bfloat16*)dg16, (__nv_bfloat16*)h16, dfh, dw2, db2, dw1,
                                db1, dfeat, dh_head, dh, dc, dw, db, dx, s);
  };
  return bf16 ? run(__nv_bfloat16{}) : run(float{});
}

}  // extern "C"
