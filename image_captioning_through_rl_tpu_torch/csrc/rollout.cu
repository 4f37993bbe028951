// The A2C rollout's backward on Hopper.
//
// Replaces the TPU kernels image_captioning_through_rl_tpu/ops/pallas_rollout.py
// _policy_bwd_kernel and _value_bwd_kernel (_policy_bwd_pallas :537 and
// _value_bwd_pallas :603) under the custom VJP of _make_core (fused_rollout).
// The forward (_rollout_fwd_kernel) is rollout_fwd.cuh: one persistent
// cooperative launch; its note says what each step computes, where it rounds
// and what bounds it. It leaves a tape of S steps over n rows (R = S n rows,
// step-major; float32 unless a tape option says otherwise, below): h and c
// entering every step, the post-activation gates of the S - 1 advances, and
// v1.
//
// What the backward computes. Only the recurrences are sequential, and the
// heads' backward needs the tape and the cotangents, not the reverse carry.
// So both heads run first, once over all R rows:
//   policy: logits recomputed from the tape, dlogits = dlogp (onehot -
//     softmax), dhw = rnd(h_p)^T rnd(dlogits), dhb = column sums, dh_head =
//     rnd(dlogits) @ rnd(hw)^T. The recomputed logits are this product's
//     sums, the forward's are its mma.sync slices': they may differ in the
//     last bits, and with them the softmax, so the backward on the forward's
//     tape is held to the chains' bound (CHAIN_TOL), as the TPU kernel's
//     recomputation would be;
//   value: dv1 = rnd(dval) rnd(w2)^T, dw2 = rnd(v1)^T rnd(dval), db2,
//     dw1 = rnd([feats; h_v])^T rnd(dv1), db1, [dfh, dh_head] =
//     rnd(dv1) @ rnd(w1)^T, the feature half summed over the steps (last
//     step first, the TPU kernel's reverse-time order) into dfeat.
// Then each encoder's recurrence is the teacher-forced chain's backward
// (lstm_chain.cuh) over the S - 1 advances: the chain's step t output h[t + 1]
// feeds the head at step t + 1, so its upstream gradient is dh_head[t + 1],
// and the cotangent of the start state is the chain's dh0 plus dh_head[0].
// The rounding points of the TPU kernel's _cell_bwd and _outer
// (pallas_rollout.py:324-373) are the chain's, line by line: the gate
// gradients are formed in float32 from the taped gates and c, cast to the
// weight type before dh_prev = rnd(dg) @ rnd(wh)^T and dx = rnd(dg) @
// rnd(wi)^T, and before d[wi; wh] = rnd([x; h])^T rnd(dg); db sums them
// unrounded; the carried dh adds the head's dh as the TPU kernel adds
// dxh_h + dh_head. Every product rounds its operands (h_p, dlogits, dval,
// [feats; h_v], dv1, dg) to the weight type and sums in float32; the bias
// sums dhb, db1, db2 and db are of unrounded float32 values.
//
// What differs from the TPU kernel in form: the vocabulary is padded to a
// multiple of 8 (zero head columns no reduction reads), not to 1024 with a
// -1e30 bias; no one-hot matmuls; the value head is a dot product, not 128
// padded columns; rows are sample-major within a step, with no batch
// padding. The gate tape holds the S - 1 advances only: the chain backward
// reads no last-step row, so none needs the TPU kernel's defined zeros.
//
// bf16 weights (every trainer) run one C call of ten launches, whatever S
// (the default tape; without the gate tape, steps 6a and 6 once a block):
//   1. prep (one pass over the [R, H] tape): rnd(h_p) and rnd(h_v) in bf16
//      (the A operands of the heads' products and of d[wi; wh], whose rows
//      below (S - 1) n the chain would otherwise write again), rnd(dv1) in
//      bf16, the column sums of dw2 and db1 and the sum db2 in fixed-order
//      row parts, rnd(feats) in bf16, each chain's embedding rows of the
//      placed tokens (so d[wi; wh] reads x densely: a token lookup inside
//      the product stalls each slice's loads behind a dependent read), and
//      the chains' dc zeroed;
//   2. logits = rnd(h_p) @ hw + hb on wgmma (wgmma.cuh's group kernel, the
//      bias in its epilogue);
//   3. the softmax gradient, in place, with rnd(dlogits) in bf16 beside it;
//   4. dhw and dw1 on wgmma in one launch, both operands MN-major as they
//      lie (rnd([feats[r mod n]; h_v]) read through SplitRows, no gathered
//      copy). Their depth is K = R (8192 at N = 512) against only 32 output
//      tiles each, so the plan (rollout_bwd_plan, mirrored by
//      ops/fused_rollout.rollout_bwd_plan and checked here) cuts K into P
//      parts, enough to fill the card (P = 2 at COCO width: 128 blocks);
//      part p writes its own float32 slice, and the last launch adds the
//      parts in the order p = 0, 1, ...: no float atomics, so two calls give
//      the same bits;
//   5. dh_head = rnd(dlogits) @ rnd(hw)^T and [dfh, dh_head_v] = rnd(dv1) @
//      rnd(w1)^T (one product of width F + H) in one launch, K-major;
//   6. both encoders' recurrences in one cooperative launch (the pair
//      plan: chain_plan at half the SMs for each chain, blockIdx.z the
//      chain; at COCO width 16 slices x 4 row groups each, two row tiles a
//      block a step); the two chains do not depend on each other, and each
//      alone is bound by the latency of its step (a product from L2, the
//      cell, a grid barrier), not by the card's width. Each thread sums its
//      cells' gate gradients for db as it forms them (db parts, one row per
//      row group and thread row), so no float32 dg is written or read back;
//   7. both chains' d[wi; wh] = rnd([x; h])^T rnd(dg) as one batched wgmma
//      launch (same N = 4H, K = (S - 1) n), and 8. both dx = rnd(dg) @
//      rnd(wi)^T as another;
//   9. the column sums of dlogits in fixed-order row parts, and 10. one pass
//      that adds every set of parts in order (the split-K slices, the column
//      sums, the db parts), sums dfeat over the steps and adds dh_head[0] to
//      each chain's dh0.
// Float32 weights (the tests' path) keep the two heads on the CUDA-core tile
// product of common.cuh and each chain's own backward in turn
// (lstm_chain_backward), on the default tape only.
//
// The TPU kernel's two tape options (bf16 weights):
//   * a bf16 tape (tape_dtype=bfloat16): h and c (and the gates when taped)
//     arrive in bf16. The bf16 h tape is rnd(h) already, so it is the heads'
//     and d[wi; wh]'s A operand itself (no hp16 / hv16 copies); the
//     recurrence widens c and the gates as it loads them and forms c_new = f
//     c_prev + i g from them, as _cell_bwd does (the taped c_new would be
//     rounded once more);
//   * no gate tape (tape_gates=False): the gates are recomputed off the
//     serial path. The tape holds every h entering an advance, so the
//     pre-activations [x; rnd(h)] @ [wi; wh] + b of a block of steps are one
//     wgmma product (6a: both chains in one launch, the bias in its epilogue,
//     the A operand the gathered embedding rows and the h tape that step 7
//     reads too), and the recurrence applies the activations as it loads
//     them. The TPU kernel recomputes one step at a time inside its reverse
//     loop, which puts a product on the serial path. The blocks run last
//     first, RECOMPUTE_BLOCKS of them (ceil((S - 1) / 8) steps each), each a
//     product and then a launch of the recurrence pair over its steps (its
//     first carry from the dg16 of the block above, its db sums added to
//     theirs in the same order as one launch adds them), so the gate memory
//     is one block's [ceil((S - 1) / 8) n, 4H] float32 per chain, not the
//     tape's [(S - 1) n, 4H]. The products round their operands as the
//     forward does (bf16 embedding rows and rnd(h)) and sum in float32 in
//     another order than the x-gate table plus h @ wh, so the recomputed
//     gates differ from the taped ones by float noise; the same inputs give
//     the same bits every call (no atomics, no split-K).
//   The last step's advance is dead work in the forward, and no block reads
//   a gate of it: the recurrence covers the S - 1 advances only.
//
// What bounds it: at N = 512, COCO width, ~171 GFLOP (0.17 ms on the tensor
// cores). The products run on wgmma.cuh's 128 x 128 tile, which L2 caps
// near 350 TFLOP/s and whose pipeline reaches ~150-310 TFLOP/s here (short
// depths pay its fill and epilogue); the recurrences are latency-bound steps
// (~15 us a step, PERF.md), run side by side here; the rest moves ~0.3 GB
// (the tape, the float32 logits, the bf16 operands). PERF.md holds the times
// beside the bounds.
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
// kernel forms it), zeros on the padding columns; and, when l16 is not null,
// rnd(dlogits) in bf16 beside them (the products' operand; dhb sums the
// float32 values).
__global__ void __launch_bounds__(NT) softmax_grad_rows_kernel(int V, int ldl,
                                                               float* __restrict__ logits,
                                                               const int* __restrict__ act,
                                                               const float* __restrict__ dlogp,
                                                               __nv_bfloat16* __restrict__ l16) {
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
  __nv_bfloat16* l2 = l16 ? l16 + (size_t)r * ldl : nullptr;
  for (int c = threadIdx.x; c < ldl; c += NT) {
    const float v = c < V ? d * ((c == a ? 1.f : 0.f) - expf(l[c] - m) / se) : 0.f;
    l[c] = v;
    if (l2) l2[c] = __float2bfloat16_rn(v);
  }
}

// ---- Float32 weights: the heads on the CUDA-core tile, the chains in turn ----

// Elementwise over [R, H]: dv1 = dval w2, tmp = v1 dval (its column sums are
// dw2), and ridx[r] = r % n, the feature row of tape row r.
__global__ void value_grad_kernel(int R, int H, int n, const float* __restrict__ dval,
                                  const float* __restrict__ v1, const float* __restrict__ w2,
                                  float* __restrict__ dv1, float* __restrict__ tmp,
                                  int* __restrict__ ridx) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * H) return;
  const int r = (int)(idx / H), j = (int)(idx % H);
  const float d = dval[r];
  dv1[idx] = d * w2[j];
  tmp[idx] = v1[idx] * d;
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

// What the backward reads and writes (shapes in icrl_rollout_bwd's note).
// The tape (hp .. gv) is bf16 when tape16, else float32; gp and gv are null
// without the gate tape (then p_b and v_b are read, for the recompute).
struct BwdIn {
  int n, S, F, E, H, V, Vp;
  const int *tok, *act;
  const float *dlogp, *dval, *feats;
  const void *hp, *cp, *gp, *hv, *cv, *gv;
  int tape16;
  const float* v1;
  const void *p_emb, *p_w, *hw;
  const float* hb;
  const void *v_emb, *v_w, *w1, *w2;
  const float *p_b, *v_b;
};

struct BwdOut {
  float *dfeat, *dph1, *dpc1, *dvh1, *dvc1, *dpw, *dpb, *dhw, *dhb, *dvw, *dvb, *dw1, *db1,
      *dw2, *db2, *dxp, *dxv;
};

// The float32 path's scratch.
struct F32Layout {
  float *dlogits, *part, *dg, *tmp, *dv1, *dfh, *dh_head_p, *dh_head_v;
  int* ridx;
};

F32Layout f32_layout(float* ws, int n, int S, int F, int H, int Vp, size_t* used = nullptr) {
  Carver cv{ws};
  const size_t R = (size_t)S * n, RH = R * H;
  F32Layout l;
  l.dlogits = cv.take(R * Vp);
  l.part = cv.take((size_t)COLSUM_PARTS * std::max(Vp, 4 * H));
  l.dg = cv.take((size_t)std::max(S - 1, 1) * n * 4 * H);
  l.tmp = cv.take(RH);
  l.dv1 = cv.take(RH);
  l.dfh = cv.take(R * F);
  l.dh_head_p = cv.take(RH);
  l.dh_head_v = cv.take(RH);
  l.ridx = cv.take<int>(R);
  if (used) *used = cv.used;
  return l;
}

int rollout_bwd_f32(const BwdIn& in, const BwdOut& o, const F32Layout& L, cudaStream_t s) {
  const int n = in.n, S = in.S, F = in.F, E = in.E, H = in.H, G = 4 * H, R = S * n;
  const size_t NH = (size_t)n * H, RH = (size_t)R * H;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const float *hp = f(in.hp), *hv = f(in.hv);
  // the chains' dc enter as zeros; with S = 1 no chain runs
  ICRL_CHECK(cudaMemsetAsync(o.dpc1, 0, sizeof(float) * NH, s));
  ICRL_CHECK(cudaMemsetAsync(o.dvc1, 0, sizeof(float) * NH, s));
  if (S == 1) {
    const size_t WG = (size_t)(E + H) * G;
    ICRL_CHECK(cudaMemsetAsync(o.dph1, 0, sizeof(float) * NH, s));
    ICRL_CHECK(cudaMemsetAsync(o.dvh1, 0, sizeof(float) * NH, s));
    ICRL_CHECK(cudaMemsetAsync(o.dpw, 0, sizeof(float) * WG, s));
    ICRL_CHECK(cudaMemsetAsync(o.dvw, 0, sizeof(float) * WG, s));
    ICRL_CHECK(cudaMemsetAsync(o.dpb, 0, sizeof(float) * G, s));
    ICRL_CHECK(cudaMemsetAsync(o.dvb, 0, sizeof(float) * G, s));
  }
  // policy: logits, dlogits, dhw [H, V], dhb, dh_head = dlogits @ hw^T
  ICRL_CHECK((launch_linear(R, H, in.Vp, hp, f(in.hw), in.hb, L.dlogits, s)));
  softmax_grad_rows_kernel<<<R, NT, 0, s>>>(in.V, in.Vp, L.dlogits, in.act, in.dlogp, nullptr);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK((launch_view<float, true, false>(H, in.V, R, hp, H, nullptr, L.dlogits, in.Vp,
                                              false, o.dhw, s)));
  ICRL_CHECK(launch_colsum(R, in.Vp, L.dlogits, L.part, o.dhb, s));
  ICRL_CHECK((launch_view<float, false, true>(R, H, in.Vp, L.dlogits, in.Vp, nullptr, f(in.hw),
                                              in.Vp, false, L.dh_head_p, s)));
  if (S > 1)
    ICRL_CHECK(lstm_chain_backward(n, S - 1, E, H, in.tok, L.dh_head_p + NH, H, (long)NH, hp,
                                   f(in.cp), f(in.gp), f(in.p_emb), f(in.p_w), L.dg, o.dph1, o.dpc1,
                                   L.part, o.dpw, o.dpb, o.dxp, s));
  add_kernel<<<cdiv(NH, 256), 256, 0, s>>>(NH, o.dph1, L.dh_head_p);
  ICRL_CHECK(cudaGetLastError());
  // value: dv1, dw2, db2, dw1 = [feats; h_v]^T dv1 (the feature rows through
  // ridx), db1, dfh = dv1 @ w1^T as its feature half and its h half, dfeat
  value_grad_kernel<<<cdiv(RH, 256), 256, 0, s>>>(R, H, n, in.dval, in.v1, f(in.w2), L.dv1,
                                                  L.tmp, L.ridx);
  ICRL_CHECK(cudaGetLastError());
  ICRL_CHECK(launch_colsum(R, H, L.tmp, L.part, o.dw2, s));
  ICRL_CHECK(launch_colsum(R, 1, in.dval, L.part, o.db2, s));
  ICRL_CHECK((launch_view<float, true, false>(F, H, R, in.feats, F, L.ridx, L.dv1, H, false,
                                              o.dw1, s)));
  ICRL_CHECK((launch_view<float, true, false>(H, H, R, hv, H, nullptr, L.dv1, H, false,
                                              o.dw1 + (size_t)F * H, s)));
  ICRL_CHECK(launch_colsum(R, H, L.dv1, L.part, o.db1, s));
  ICRL_CHECK((launch_view<float, false, true>(R, F, H, L.dv1, H, nullptr, f(in.w1), H, false,
                                              L.dfh, s)));
  ICRL_CHECK((launch_view<float, false, true>(R, H, H, L.dv1, H, nullptr,
                                              f(in.w1) + (size_t)F * H, H, false, L.dh_head_v,
                                              s)));
  step_sum_kernel<<<cdiv((size_t)n * F, 256), 256, 0, s>>>(n, S, F, L.dfh, o.dfeat);
  ICRL_CHECK(cudaGetLastError());
  if (S > 1)
    ICRL_CHECK(lstm_chain_backward(n, S - 1, E, H, in.tok, L.dh_head_v + NH, H, (long)NH, hv,
                                   f(in.cv), f(in.gv), f(in.v_emb), f(in.v_w), L.dg, o.dvh1, o.dvc1,
                                   L.part, o.dvw, o.dvb, o.dxv, s));
  add_kernel<<<cdiv(NH, 256), 256, 0, s>>>(NH, o.dvh1, L.dh_head_v);
  return (int)cudaGetLastError();
}

// ---- bf16 weights: the heads on wgmma, both recurrences in one launch ----

using Bf = __nv_bfloat16;

// Row parts of the prep pass's column sums (dw2, db1, db2), the least depth
// of a split-K part in 64-deep slices, and the blocks of steps whose gates
// are recomputed at a time without the gate tape.
constexpr int PREP_PARTS = 32, SPLITK_MIN_SLICES = 4, RECOMPUTE_BLOCKS = 8;

// Steps of a recompute block: the S - 1 advances in RECOMPUTE_BLOCKS blocks.
inline int recompute_block_steps(int S) { return std::max(1, cdiv(S - 1, RECOMPUTE_BLOCKS)); }

// The plan; ops/fused_rollout.py:rollout_bwd_plan computes the same. Both
// products of depth K = R = S n (dhw, dw1) are cut into as many parts as
// keep the two products' tiles times their parts within the card's SMs (a
// part keeps at least SPLITK_MIN_SLICES slices); both recurrences share one
// launch, each planned on half the SMs.
struct RolloutBwdPlan {
  int parts;
  ChainPlan chain;
};

inline int splitk_parts(int tiles, int K, int sms) {
  const int nk = cdiv(K, wg::BK);
  return std::max(1, std::min(sms / std::max(tiles, 1), nk / SPLITK_MIN_SLICES));
}

RolloutBwdPlan rollout_bwd_plan(int n, int S, int F, int H, int Vp, int sms) {
  const int R = S * n;
  const int tiles = cdiv(H, wg::BM) * cdiv(Vp, wg::BN) + cdiv(F + H, wg::BM) * cdiv(H, wg::BN);
  return {splitk_parts(tiles, R, sms), chain_plan<Bf, true, 4>(n, H, sms / 2)};
}

// Rows of a chain's db parts (lstm_bwd_steps): one per row group and thread
// row of a block.
inline int db_rows(const ChainPlan& p) { return p.row_groups * (CHAIN_THREADS / p.units); }

// The bf16 path's scratch.
struct Bf16Layout {
  float *logits, *dhw_part, *dw1_part, *dh_head, *dfh, *db_part_p, *db_part_v, *cpart, *ppart,
      *pre_p, *pre_v;
  Bf *l16, *hp16, *hv16, *f16, *dv16, *px16, *vx16, *dg16_p, *dg16_v;
};

// db_rows: the recurrence pair's db parts per chain (db_rows(plan)). A bf16
// tape is its own rnd(h) (no hp16, hv16: null); without the gate tape, one
// recompute block's pre-activations per chain.
Bf16Layout bf16_layout(float* ws, int n, int S, int F, int E, int H, int Vp, int parts,
                       int db_rows, bool tape16, bool gates, size_t* used = nullptr) {
  Carver cv{ws};
  const size_t R = (size_t)S * n, RH = R * H, R1 = (size_t)(S - 1) * n, R1G = R1 * 4 * H;
  Bf16Layout l;
  l.logits = cv.take(R * Vp);
  l.l16 = cv.take<Bf>(R * Vp);
  l.hp16 = tape16 ? nullptr : cv.take<Bf>(RH);
  l.hv16 = tape16 ? nullptr : cv.take<Bf>(RH);
  l.f16 = cv.take<Bf>((size_t)n * F);
  l.dv16 = cv.take<Bf>(RH);
  l.dhw_part = cv.take((size_t)parts * H * Vp);
  l.dw1_part = cv.take((size_t)parts * (F + H) * H);
  l.dh_head = cv.take(RH);
  l.dfh = cv.take(R * (F + H));
  l.px16 = cv.take<Bf>(R1 * E);
  l.vx16 = cv.take<Bf>(R1 * E);
  l.dg16_p = cv.take<Bf>(R1G);
  l.dg16_v = cv.take<Bf>(R1G);
  l.db_part_p = cv.take((size_t)db_rows * 4 * H);
  l.db_part_v = cv.take((size_t)db_rows * 4 * H);
  l.cpart = cv.take((size_t)COLSUM_PARTS * Vp);
  l.ppart = cv.take((size_t)PREP_PARTS * (2 * H + 1));
  const size_t pre = gates ? 0 : (size_t)recompute_block_steps(S) * n * 4 * H;
  l.pre_p = pre ? cv.take(pre) : nullptr;
  l.pre_v = pre ? cv.take(pre) : nullptr;
  if (used) *used = cv.used;
  return l;
}

// hp, hv null (a bf16 tape): hp16, hv16 are the tape, not written.
struct PrepArgs {
  int n, R, R1, F, E, H;
  const float *hp, *hv, *v1, *dval, *feats;
  const int* tok;
  const Bf *w2, *p_emb, *v_emb;
  Bf *hp16, *hv16, *f16, *dv16, *px16, *vx16;
  float* part;  // [PREP_PARTS, 2H + 1]: dw2's column sums, db1's, db2
  float *dc_p, *dc_v;
};

// Block (x, y): 32 columns (a lane each) of rows part y, 8 warps striding the
// rows; the warps' sums then add in order. Then every thread of the grid
// takes a share of the rest: the features in bf16, each chain's embedding
// rows of the placed tokens (x = emb[tok] [(S - 1) n, E], so that d[wi; wh]
// reads its A operand densely, with no token lookup per chunk), dc zeroed.
__global__ void __launch_bounds__(NT) rollout_bwd_prep_kernel(PrepArgs a) {
  __shared__ float sh[3][NT / 32][33];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32, j = blockIdx.x * 32 + lane;
  const int per = (a.R + PREP_PARTS - 1) / PREP_PARTS, r0 = blockIdx.y * per;
  const int r1 = min(a.R, r0 + per);
  const bool col = j < a.H, first = blockIdx.x == 0 && lane == 0;
  const float w2 = col ? __bfloat162float(a.w2[j]) : 0.f;
  float sdw2 = 0.f, sdb1 = 0.f, sdb2 = 0.f;
  for (int r = r0 + g; r < r1; r += NT / 32) {
    const float dv = a.dval[r];
    if (col) {
      const size_t o = (size_t)r * a.H + j;
      if (a.hp) {
        a.hp16[o] = __float2bfloat16_rn(a.hp[o]);
        a.hv16[o] = __float2bfloat16_rn(a.hv[o]);
      }
      const float d = rnd<Bf>(dv), x = d * w2;
      a.dv16[o] = __float2bfloat16_rn(x);
      sdb1 += x;
      sdw2 += rnd<Bf>(a.v1[o]) * d;
    }
    if (first) sdb2 += dv;
  }
  sh[0][g][lane] = sdw2;
  sh[1][g][lane] = sdb1;
  sh[2][g][lane] = sdb2;
  __syncthreads();
  if (g == 0) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) {
      t0 += sh[0][i][lane];
      t1 += sh[1][i][lane];
      t2 += sh[2][i][lane];
    }
    float* p = a.part + (size_t)blockIdx.y * (2 * a.H + 1);
    if (col) {
      p[j] = t0;
      p[a.H + j] = t1;
    }
    if (first) p[2 * a.H] = t2;
  }
  const size_t tid = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NT + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * gridDim.y * NT;
  for (size_t i = tid; i < (size_t)a.n * a.F; i += stride)
    a.f16[i] = __float2bfloat16_rn(a.feats[i]);
  const int e8 = a.E / 8;  // 16-byte chunks of an embedding row
  for (size_t i = tid; i < (size_t)a.R1 * e8; i += stride) {
    const size_t r = i / e8, c = (i % e8) * 8, t = (size_t)__ldg(a.tok + r);
    *reinterpret_cast<uint4*>(a.px16 + r * a.E + c) =
        __ldg(reinterpret_cast<const uint4*>(a.p_emb + t * a.E + c));
    *reinterpret_cast<uint4*>(a.vx16 + r * a.E + c) =
        __ldg(reinterpret_cast<const uint4*>(a.v_emb + t * a.E + c));
  }
  for (size_t i = tid; i < (size_t)a.n * a.H; i += stride) {
    a.dc_p[i] = 0.f;
    a.dc_v[i] = 0.f;
  }
}

struct FinishArgs {
  int n, S, F, H, V, Vp, parts, db_rows;
  const float *dhw_part, *dw1_part, *db_part_p, *db_part_v, *cpart, *ppart, *dh_head, *dfh;
  float *dhw, *dw1, *dhb, *db_p, *db_v, *dw2, *db1, *db2, *dfeat, *dph1, *dvh1;
};

constexpr int FINISH_BLOCKS = 128;

// Every sum of parts, each in the order p = 0, 1, ...: blockIdx.y 0 dhw
// [H, V] from its split-K slices [P, H, Vp], 1 dw1, 2 the column sums (dhb;
// each chain's db from the recurrence's parts, zero when no chain ran;
// dw2, db1, db2); 3 dfeat over the steps (last first) and dh0 + dh_head[0]
// of each chain (dh_head[0] alone when no chain ran, S = 1).
__global__ void __launch_bounds__(NT) rollout_bwd_finish_kernel(FinishArgs a) {
  const size_t stride = (size_t)gridDim.x * NT, i0 = (size_t)blockIdx.x * NT + threadIdx.x;
  const int H = a.H, FH = a.F + H, G = 4 * H;
  if (blockIdx.y == 0) {
    const size_t slice = (size_t)H * a.Vp;
    for (size_t i = i0; i < (size_t)H * a.V; i += stride) {
      const size_t o = i / a.V * a.Vp + i % a.V;
      float t = 0.f;
      for (int p = 0; p < a.parts; ++p) t += a.dhw_part[p * slice + o];
      a.dhw[i] = t;
    }
  } else if (blockIdx.y == 1) {
    const size_t slice = (size_t)FH * H;
    for (size_t i = i0; i < slice; i += stride) {
      float t = 0.f;
      for (int p = 0; p < a.parts; ++p) t += a.dw1_part[p * slice + i];
      a.dw1[i] = t;
    }
  } else if (blockIdx.y == 2) {
    const int lp = 2 * H + 1, rows = a.S > 1 ? a.db_rows : 0;
    for (size_t i = i0; i < (size_t)(a.Vp + 2 * G + lp); i += stride) {
      float t = 0.f;
      float* dst;
      if (i < (size_t)a.Vp) {
        for (int p = 0; p < COLSUM_PARTS; ++p) t += a.cpart[(size_t)p * a.Vp + i];
        dst = a.dhb + i;
      } else if (i < (size_t)(a.Vp + 2 * G)) {
        const size_t c = (i - a.Vp) % G;
        const bool v = i >= (size_t)(a.Vp + G);
        const float* part = v ? a.db_part_v : a.db_part_p;
        for (int p = 0; p < rows; ++p) t += part[(size_t)p * G + c];
        dst = (v ? a.db_v : a.db_p) + c;
      } else {
        const size_t k = i - a.Vp - 2 * G;
        for (int p = 0; p < PREP_PARTS; ++p) t += a.ppart[(size_t)p * lp + k];
        dst = k < (size_t)H ? a.dw2 + k : k < (size_t)(2 * H) ? a.db1 + k - H : a.db2;
      }
      *dst = t;
    }
  } else {
    const size_t NF = (size_t)a.n * a.F, NH = (size_t)a.n * H;
    for (size_t i = i0; i < NF; i += stride) {
      const size_t r = i / a.F, f = i % a.F;
      float t = 0.f;
      for (int s = a.S - 1; s >= 0; --s) t += a.dfh[((size_t)s * a.n + r) * FH + f];
      a.dfeat[i] = t;
    }
    for (size_t i = i0; i < NH; i += stride) {
      const size_t r = i / H, j = i % H;
      const float cp = a.S > 1 ? a.dph1[i] : 0.f, cv = a.S > 1 ? a.dvh1[i] : 0.f;
      a.dph1[i] = cp + a.dh_head[i];
      a.dvh1[i] = cv + a.dfh[r * FH + a.F + j];
    }
  }
}

// Both encoders' backward recurrences in one cooperative launch: blockIdx.z
// picks the chain, (x, y) its slice and row group as in lstm_bwd_kernel.
// rnd(h) is already in each chain's h16 (the prep pass), so the recurrence
// does not write it; it sums db into db_part instead of writing a float32 dg.
template <typename W>
struct ChainPair {
  ChainBwdArgs<W> c[2];
  float* db_part[2];
};

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) lstm_bwd_pair_kernel(ChainPair<W> a) {
  extern __shared__ __align__(16) unsigned char pair_smem[];
  if (blockIdx.z)
    lstm_bwd_steps<W, U, kStream, true>(a.c[1], pair_smem, a.db_part[1]);
  else
    lstm_bwd_steps<W, U, kStream, true>(a.c[0], pair_smem, a.db_part[0]);
}

template <typename W>
struct LstmPairLaunch {
  template <int U, bool kStream>
  struct At {
    static cudaError_t run(const ChainPlan& p, const ChainPair<W>& a, cudaStream_t s) {
      return launch_chain(lstm_bwd_pair_kernel<W, U, kStream>, p, a, s, 2);
    }
  };
};

int rollout_bwd_bf16(const BwdIn& in, const BwdOut& o, Bf16Layout L,
                     const RolloutBwdPlan& plan, cudaStream_t s) {
  const int n = in.n, S = in.S, F = in.F, E = in.E, H = in.H, Vp = in.Vp;
  const int G = 4 * H, FH = F + H, R = S * n, R1 = (S - 1) * n;
  auto b = [](const void* p) { return static_cast<const Bf*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (in.tape16) {  // the bf16 tape is rnd(h) already
    L.hp16 = const_cast<Bf*>(b(in.hp));
    L.hv16 = const_cast<Bf*>(b(in.hv));
  }
  // 1. the bf16 operands, dw2 / db1 / db2's parts, dc = 0
  rollout_bwd_prep_kernel<<<dim3(cdiv(H, 32), PREP_PARTS), NT, 0, s>>>(
      PrepArgs{n, R, R1, F, E, H, in.tape16 ? nullptr : f(in.hp), in.tape16 ? nullptr : f(in.hv),
               in.v1, in.dval, in.feats, in.tok, b(in.w2), b(in.p_emb), b(in.v_emb), L.hp16,
               L.hv16, L.f16, L.dv16, L.px16, L.vx16, L.ppart, o.dpc1, o.dvc1});
  ICRL_CHECK(cudaGetLastError());
  // 2. logits = rnd(h_p) @ hw + hb
  ICRL_CHECK((launch_wgmma_group<false, true>(
      WgmmaGroup<SplitRows, SplitRows, 1>{{R}, {Vp}, {H}, {1}, {},
                                          {dense_rows(L.hp16, R, H, H)},
                                          {dense_rows(b(in.hw), H, Vp, Vp)}, {L.logits}, {in.hb}},
      s)));
  // 3. dlogits in place, rnd(dlogits) in bf16
  softmax_grad_rows_kernel<<<R, NT, 0, s>>>(in.V, Vp, L.logits, in.act, in.dlogp, L.l16);
  ICRL_CHECK(cudaGetLastError());
  // 4. dhw = rnd(h_p)^T rnd(dlogits), dw1 = rnd([feats; h_v])^T rnd(dv1):
  // split-K parts
  ICRL_CHECK((launch_wgmma_group<true, true>(
      WgmmaGroup<SplitRows, SplitRows, 2>{
          {H, FH}, {Vp, H}, {R, R}, {plan.parts, plan.parts}, {},
          {dense_rows(L.hp16, R, H, H), SplitRows{L.f16, L.hv16, R, FH, F, F, H, n}},
          {dense_rows(L.l16, R, Vp, Vp), dense_rows(L.dv16, R, H, H)},
          {L.dhw_part, L.dw1_part}, {nullptr, nullptr}},
      s)));
  // 5. dh_head = rnd(dlogits) @ rnd(hw)^T, [dfh, dh_head_v] = rnd(dv1) @ rnd(w1)^T
  ICRL_CHECK((launch_wgmma_group<false, false>(
      WgmmaGroup<SplitRows, SplitRows, 2>{
          {R, R}, {H, FH}, {Vp, H}, {1, 1}, {},
          {dense_rows(L.l16, R, Vp, Vp), dense_rows(L.dv16, R, H, H)},
          {dense_rows(b(in.hw), H, Vp, Vp), dense_rows(b(in.w1), FH, H, H)},
          {L.dh_head, L.dfh}, {nullptr, nullptr}},
      s)));
  if (S > 1) {
    // 6. both recurrences: upstream dh_head[t + 1] of the policy, the h half
    // of dfh of the value; without the gate tape in blocks of steps, last
    // first, each after 6a, its gates' recompute
    const size_t NH = (size_t)n * H, NFH = (size_t)n * FH;
    const bool recompute = in.gp == nullptr;
    ChainPair<Bf> pair{
        {ChainBwdArgs<Bf>{n, S - 1, H, plan.chain.row_groups, L.dh_head + NH, H, (long)NH,
                          f(in.hp), f(in.cp), recompute ? L.pre_p : f(in.gp),
                          b(in.p_w) + (size_t)E * G, nullptr, L.dg16_p, L.hp16, o.dph1, o.dpc1,
                          in.tape16, recompute, 0, 0},
         ChainBwdArgs<Bf>{n, S - 1, H, plan.chain.row_groups, L.dfh + NFH + F, FH, (long)NFH,
                          f(in.hv), f(in.cv), recompute ? L.pre_v : f(in.gv),
                          b(in.v_w) + (size_t)E * G, nullptr, L.dg16_v, L.hv16, o.dvh1, o.dvc1,
                          in.tape16, recompute, 0, 0}},
        {L.db_part_p, L.db_part_v}};
    const int block = recompute ? recompute_block_steps(S) : S - 1;
    for (int hi = S - 1; hi > 0; hi -= block) {
      const int lo = std::max(0, hi - block);
      if (recompute) {
        // 6a. the pre-activations of steps [lo, hi): [x; rnd(h)] @ [wi; wh] + b
        const int rows = (hi - lo) * n;
        const size_t x0 = (size_t)lo * n * E, h0 = (size_t)lo * NH;
        ICRL_CHECK((launch_wgmma_group<false, true>(
            WgmmaGroup<SplitRows, SplitRows, 2>{
                {rows, rows}, {G, G}, {E + H, E + H}, {1, 1}, {},
                {SplitRows{L.px16 + x0, L.hp16 + h0, rows, E + H, E, E, H, 0},
                 SplitRows{L.vx16 + x0, L.hv16 + h0, rows, E + H, E, E, H, 0}},
                {dense_rows(b(in.p_w), E + H, G, G), dense_rows(b(in.v_w), E + H, G, G)},
                {L.pre_p, L.pre_v}, {in.p_b, in.v_b}},
            s)));
        for (auto& c : pair.c) {
          c.t_lo = lo;
          c.t_hi = hi;
        }
      }
      ICRL_CHECK((launch_planned<Bf, true, 4, LstmPairLaunch<Bf>::template At>(plan.chain, pair,
                                                                                 s)));
    }
    // 7. d[wi; wh] = rnd([x; h_prev])^T rnd(dg) of both chains, x the
    // gathered embedding rows
    ICRL_CHECK((launch_wgmma_batch<true>(
        G, R1,
        WgmmaProblems<SplitRows, DenseRows, 2>{
            {E + H, E + H},
            {SplitRows{L.px16, L.hp16, R1, E + H, E, E, H, 0},
             SplitRows{L.vx16, L.hv16, R1, E + H, E, E, H, 0}},
            {DenseRows{L.dg16_p, R1, G, G}, DenseRows{L.dg16_v, R1, G, G}},
            {o.dpw, o.dvw},
            {nullptr, nullptr}},
        s)));
    // 8. dx = rnd(dg) @ rnd(wi)^T of both chains
    ICRL_CHECK((launch_wgmma_batch<false>(
        E, G,
        WgmmaProblems<DenseRows, DenseRows, 2>{
            {R1, R1},
            {DenseRows{L.dg16_p, R1, G, G}, DenseRows{L.dg16_v, R1, G, G}},
            {DenseRows{b(in.p_w), E, G, G}, DenseRows{b(in.v_w), E, G, G}},
            {o.dxp, o.dxv},
            {nullptr, nullptr}},
        s)));
  } else {
    ICRL_CHECK(cudaMemsetAsync(o.dpw, 0, sizeof(float) * (E + H) * G, s));
    ICRL_CHECK(cudaMemsetAsync(o.dvw, 0, sizeof(float) * (E + H) * G, s));
  }
  // 9. dhb's parts: the column sums of dlogits
  colsum_part_kernel<<<dim3(cdiv(Vp, 32), COLSUM_PARTS), NT, 0, s>>>(R, Vp, L.logits, L.cpart);
  ICRL_CHECK(cudaGetLastError());
  // 10. every sum of parts, dfeat, dh0 + dh_head[0]
  rollout_bwd_finish_kernel<<<dim3(FINISH_BLOCKS, 4), NT, 0, s>>>(
      FinishArgs{n, S, F, H, in.V, Vp, plan.parts, db_rows(plan.chain),
                 L.dhw_part, L.dw1_part, L.db_part_p, L.db_part_v, L.cpart, L.ppart, L.dh_head,
                 L.dfh, o.dhw, o.dw1, o.dhb, o.dpb, o.dvb, o.dw2, o.db1, o.db2, o.dfeat,
                 o.dph1, o.dvh1});
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace icrl

extern "C" {

// Float32 elements of the workspace icrl_rollout_bwd needs. parts: the bf16
// plan's split-K parts; db_rows: its recurrence pair's rows of db parts per
// chain, row_groups (256 / units) (both unused with float32 weights); tape16,
// gates: the tape's options, as icrl_rollout_bwd takes them.
size_t icrl_rollout_bwd_workspace_floats(int n, int S, int F, int E, int H, int Vp, int bf16,
                                         int parts, int db_rows, int tape16, int gates) {
  size_t used = 0;
  if (bf16)
    icrl::bf16_layout(nullptr, n, S, F, E, H, Vp, parts, db_rows, tape16, gates, &used);
  else
    icrl::f32_layout(nullptr, n, S, F, H, Vp, &used);
  return used;
}

// The rollout's backward, S >= 1 steps of n rows. tok, act [S, n] int32;
// dlogp, dval [S, n]; feats [n, F]; the tape hp, cp, hv, cv [S n, H] and gp,
// gv [(S - 1) n, 4H], bf16 when tape16 != 0, else float32, gp and gv both
// null without the gate tape (then p_b, v_b [4H] are read); v1 [S n, H]
// float32 (bf16 weights only take the options); p_emb, v_emb [V, E], p_w, v_w = [wi; wh] [E + H, 4H], hw
// [H, Vp] (zero columns past V), w1 [F + H, H], w2 [H] in the weight type
// (bf16 when bf16 != 0, else float32); hb [Vp]. ws: the workspace
// (icrl_rollout_bwd_workspace_floats). Outputs, float32, all written: dfeat
// [n, F]; dph1, dpc1, dvh1, dvc1 [n, H] (the start states' cotangents); dpw,
// dvw [E + H, 4H]; dpb, dvb [4H]; dhw [H, V]; dhb [Vp]; dw1 [F + H, H]; db1,
// dw2 [H]; db2 [1]; dxp, dxv [(S - 1) n, E]. With bf16 weights the plan
// (the split-K parts, then the recurrence pair's rows per tile, units,
// streaming, grid columns, row groups, shared bytes) must be
// rollout_bwd_plan's; float32 weights take none (zeros). Runs on CUDA device
// `device`, on `stream` (the caller's current device is restored after it).
// Returns 0 or the first CUDA error.
int icrl_rollout_bwd(int n, int S, int F, int E, int H, int V, int Vp, int bf16, int parts,
                     int rows_per_tile, int units, int stream, int grid_x,
                     int row_groups, int smem, const int* tok, const int* act,
                     const float* dlogp, const float* dval, const float* feats, int tape16,
                     const void* hp, const void* cp, const void* gp, const void* hv,
                     const void* cv, const void* gv, const float* v1, const void* p_emb,
                     const void* p_w, const float* p_b, const void* hw, const float* hb,
                     const void* v_emb, const void* v_w, const float* v_b, const void* w1,
                     const void* w2, float* ws, float* dfeat, float* dph1,
                     float* dpc1, float* dvh1, float* dvc1, float* dpw, float* dpb, float* dhw,
                     float* dhb, float* dvw, float* dvb, float* dw1, float* db1, float* dw2,
                     float* db2, float* dxp, float* dxv, int device, void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const BwdIn in{n,     S,   F,  E,  H,  V,   Vp, tok,   act, dlogp, dval, feats, hp, cp,
                 gp,    hv,  cv, gv, tape16, v1, p_emb, p_w, hw,  hb,   v_emb, v_w, w1, w2,
                 p_b,   v_b};
  const BwdOut o{dfeat, dph1, dpc1, dvh1, dvc1, dpw, dpb, dhw, dhb,
                 dvw,   dvb,  dw1,  db1,  dw2,  db2, dxp, dxv};
  int ret = 0;
  if ((gp == nullptr) != (gv == nullptr) || (!bf16 && (tape16 || gp == nullptr))) {
    ret = (int)cudaErrorInvalidValue;
  } else if (n == 0 || S == 0) {
    ret = 0;
  } else if (bf16) {
    const RolloutBwdPlan p = rollout_bwd_plan(n, S, F, H, Vp, device_sms());
    if (p.parts != parts ||
        !plan_matches(p.chain, rows_per_tile, units, stream, grid_x, row_groups, smem))
      ret = (int)cudaErrorInvalidValue;
    else
      ret = rollout_bwd_bf16(in, o,
                             bf16_layout(ws, n, S, F, E, H, Vp, parts, db_rows(p.chain), tape16,
                                         gp != nullptr),
                             p, s);
  } else {
    ret = rollout_bwd_f32(in, o, f32_layout(ws, n, S, F, H, Vp), s);
  }
  if (prev != device) cudaSetDevice(prev);
  return ret;
}

}  // extern "C"
