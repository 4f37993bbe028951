// The teacher-forced GRU chain's backward: gru_chain.cu's note describes the
// chain and its design; this file holds the backward's kernel and entry
// point apart so that its variants compile beside the forward's, in
// parallel.
#include "chain.cuh"

namespace icrl {
namespace {

template <typename W>
struct GruBwdArgs {
  int n, T, H, row_groups;
  const float* dhs;       // upstream gradient of the h leaving step t in row r:
  long dhs_row, dhs_step;  //   dhs[r dhs_row + t dhs_step + j]
  const float* hbuf;      // the forward's tape
  const float* gates;
  const float* ghn;
  const W* wh;            // [H, 3H]
  float* dgi;             // [T n, 3H] gate gradients of gi
  float* dgh;             // [T n, 3H] gate gradients of gh
  __nv_bfloat16* dgi16;   // the same rounded to bf16 (bf16 weights only)
  __nv_bfloat16* dgh16;
  float* dhz;             // [n, H] scratch: dh z of the step whose gradients were formed last
  float* dh;              // [n, H] dh0 on return
};

// What the gate gradients of one (step, row, unit) read besides the carry.
struct GruCellTape {
  float r, z, n, ghn, h_prev, dh_up;
};

template <typename W>
__device__ __forceinline__ GruCellTape gru_cell_tape(const GruBwdArgs<W>& a, int t, int row,
                                                     int j) {
  const int H = a.H;
  const size_t NH = (size_t)a.n * H, o = (size_t)row * H + j;
  const float* g = a.gates + ((size_t)t * a.n + row) * 3 * H + j;
  return {ld_early_nc(g),
          ld_early_nc(g + H),
          ld_early_nc(g + 2 * H),
          ld_early_nc(a.ghn + t * NH + o),
          ld_early_nc(a.hbuf + t * NH + o),
          ld_early_nc(a.dhs + (size_t)row * a.dhs_row + (size_t)t * a.dhs_step + j)};
}

// The gate gradients of step t for this thread's cells (unit j of rows
// row0 + tid / U + i ROWS) from their tape and dh = carry + upstream, as the
// TPU kernel's _bwd_kernel forms them; keeps dh z for the next carry. All
// cells' arithmetic first, then the stores of the cells that lie inside.
template <typename W, int U, int CELLS>
__device__ __forceinline__ void gru_cells_bwd(const GruBwdArgs<W>& a,
                                              const GruCellTape (&tp)[CELLS],
                                              const float (&carry)[CELLS], int t, int row0,
                                              int j) {
  constexpr int ROWS = CHAIN_THREADS / U;
  const int H = a.H, G = 3 * H;
  float dr[CELLS], dz[CELLS], dn[CELLS], dhz[CELLS];
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const GruCellTape& c = tp[q];
    const float dhv = carry[q] + c.dh_up;
    dn[q] = dhv * (1.f - c.z) * (1.f - c.n * c.n);
    dr[q] = dn[q] * c.ghn * c.r * (1.f - c.r);
    dz[q] = dhv * (c.h_prev - c.n) * c.z * (1.f - c.z);
    dhz[q] = dhv * c.z;
  }
  if (j >= H) return;
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int row = row0 + threadIdx.x / U + q * ROWS;
    if (row >= a.n) continue;
    const size_t r = ((size_t)t * a.n + row) * G + j;
    const float dnh = dn[q] * tp[q].r;
    a.dgi[r] = dr[q];
    a.dgi[r + H] = dz[q];
    a.dgi[r + 2 * H] = dn[q];
    a.dgh[r] = dr[q];
    a.dgh[r + H] = dz[q];
    a.dgh[r + 2 * H] = dnh;
    if constexpr (kIsBf16<W>) {
      a.dgi16[r] = __float2bfloat16_rn(dr[q]);
      a.dgi16[r + H] = __float2bfloat16_rn(dz[q]);
      a.dgi16[r + 2 * H] = __float2bfloat16_rn(dn[q]);
      a.dgh16[r] = __float2bfloat16_rn(dr[q]);
      a.dgh16[r + H] = __float2bfloat16_rn(dz[q]);
      a.dgh16[r + 2 * H] = __float2bfloat16_rn(dnh);
    }
    a.dhz[(size_t)row * H + j] = dhz[q];
  }
}

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) gru_bwd_kernel(GruBwdArgs<W> a) {
  using Tl = ChainTile<W, true, U, 3, kStream>;
  using S = ChainSmem<Tl>;
  constexpr int ROWS = CHAIN_THREADS / U, CELLS = CHAIN_BR / ROWS;
  extern __shared__ __align__(16) unsigned char gru_bwd_smem[];
  const int H = a.H, G = 3 * H, n = a.n, tid = threadIdx.x, u = tid % U;
  const S sm(gru_bwd_smem, G);
  const int slices = (H + U - 1) / U;
  if constexpr (!kStream) chain_load_weights<Tl>(sm, a.wh, H, blockIdx.x * U);
  const int tiles = (n + CHAIN_BR - 1) / CHAIN_BR;
  const W* dga;
  if constexpr (kIsBf16<W>)
    dga = reinterpret_cast<const W*>(a.dgh16);
  else
    dga = a.dgh;
  auto load_tape = [&](GruCellTape (&tp)[CELLS], int t, int row0, int jc) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i)
      tp[i] = gru_cell_tape(a, t, min(row0 + tid / U + i * ROWS, n - 1), jc);
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  // the last step has no carry
  for (int s = blockIdx.x; s < slices; s += gridDim.x) {
    const int j = s * U + u;
    for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
      GruCellTape tape[CELLS];
      float zero[CELLS] = {};
      load_tape(tape, a.T - 1, rt * CHAIN_BR, min(j, H - 1));
      gru_cells_bwd<W, U>(a, tape, zero, a.T - 1, rt * CHAIN_BR, j);
    }
  }
  // step t: the carry rnd(dgh_t) @ wh^T + dh z of this slice's units feeds
  // the gate gradients of step t - 1; after step 0 it is dh0
  for (int t = a.T - 1; t >= 0; --t) {
    grid.sync();
    for (int s = blockIdx.x; s < slices; s += gridDim.x) {
      const int j0 = s * U, j = j0 + u, jc = min(j, H - 1);
      for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
        const int row0 = rt * CHAIN_BR;
        GruCellTape tape[CELLS];
        float carry[CELLS];
#pragma unroll
        for (int i = 0; i < CELLS; ++i)  // this thread's own dh z, read after the product
          carry[i] = ld_early(a.dhz + (size_t)min(row0 + tid / U + i * ROWS, n - 1) * H + jc);
        if (t > 0) load_tape(tape, t - 1, row0, jc);
        chain_product<Tl>(sm, dga + (size_t)t * n * G, G, row0, n, G, a.wh, H, j0);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < CELLS; ++i) carry[i] += sm.Cs[(tid / U + i * ROWS) * S::CLD + u];
        if (t > 0) {
          gru_cells_bwd<W, U>(a, tape, carry, t - 1, row0, j);
        } else if (j < H) {
#pragma unroll
          for (int i = 0; i < CELLS; ++i) {
            const int row = row0 + tid / U + i * ROWS;
            if (row < n) a.dh[(size_t)row * H + j] = carry[i];
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename W>
struct GruBwdLaunch {
  template <int U, bool kStream>
  struct At {
    static cudaError_t run(const ChainPlan& p, const GruBwdArgs<W>& a, cudaStream_t s) {
      return launch_chain(gru_bwd_kernel<W, U, kStream>, p, a, s);
    }
  };
};

// One launch for the recurrence, then the column sums (two launches each)
// and the products (dwi and dwh in one launch, dx in another): seven
// launches whatever T is.
template <typename W>
int gru_bwd(int n, int T, int E, int H, const ChainPlan& p, const int* tok, const float* dhs,
            const float* hbuf, const float* gates, const float* ghn, const W* emb, const W* wi,
            const W* wh, const __nv_bfloat16* h16, float* dgi, float* dgh, __nv_bfloat16* dgi16,
            __nv_bfloat16* dgh16, float* dhz, float* dh, float* part, float* dwi, float* dwh,
            float* dbi, float* dbh, float* dx, cudaStream_t s) {
  const int G = 3 * H, R = T * n;
  if (n == 0) return 0;
  if (T == 0) {
    ICRL_CHECK(cudaMemsetAsync(dh, 0, sizeof(float) * n * H, s));
    ICRL_CHECK(cudaMemsetAsync(dwi, 0, sizeof(float) * (size_t)E * G, s));
    ICRL_CHECK(cudaMemsetAsync(dwh, 0, sizeof(float) * (size_t)H * G, s));
    ICRL_CHECK(cudaMemsetAsync(dbi, 0, sizeof(float) * G, s));
    return (int)cudaMemsetAsync(dbh, 0, sizeof(float) * G, s);
  }
  const GruBwdArgs<W> a{n,  T,   H,     p.row_groups, dhs,   (long)T * H, H,  hbuf, gates,
                        ghn, wh, dgi,   dgh,          dgi16, dgh16,       dhz, dh};
  ICRL_CHECK((launch_planned<W, true, 3, GruBwdLaunch<W>::template At>(p, a, s)));
  ICRL_CHECK(launch_colsum(R, G, dgi, part, dbi, s));
  ICRL_CHECK(launch_colsum(R, G, dgh, part, dbh, s));
  if constexpr (kIsBf16<W>) {
    // dwi = x^T rnd(dgi) and dwh = rnd(h_prev)^T rnd(dgh) in one launch
    const DenseRows dgir{dgi16, R, G, G};
    const WgmmaProblems<TokenStateRows, DenseRows, 2> dw{
        {E, H},
        {TokenStateRows{emb, tok, nullptr, R, E, 0},
         TokenStateRows{nullptr, nullptr, h16, R, 0, H}},
        {dgir, DenseRows{dgh16, R, G, G}},
        {dwi, dwh}};
    ICRL_CHECK((launch_wgmma_batch<true>(G, R, dw, s)));
    ICRL_CHECK((launch_wgmma_gemm<false>(R, E, G, dgir, DenseRows{wi, E, G, G}, dx, s)));
  } else {
    ICRL_CHECK((launch_view<W, true, false>(E, G, R, emb, E, tok, dgi, G, false, dwi, s)));
    ICRL_CHECK((launch_view<W, true, false>(H, G, R, hbuf, H, nullptr, dgh, G, false, dwh, s)));
    ICRL_CHECK((launch_view<W, false, true>(R, E, G, dgi, G, nullptr, wi, G, false, dx, s)));
  }
  return 0;
}

}  // namespace
}  // namespace icrl

extern "C" {

// Backward. dhs [n, T, H] float32 upstream gradient of hs; hbuf, gates, ghn
// and h16 as the forward left them; emb [V, E], wi [E, 3H], wh [H, 3H] in
// the weight type. Scratch: dgi, dgh [T n, 3H] float32, dgi16, dgh16
// [T n, 3H] bf16 (bf16 only), dhz [n, H], part [16, 3H]. Outputs: dh [n, H]
// (dh0), dwi [E, 3H], dwh [H, 3H], dbi, dbh [3H], dx [T n, E] (step-major
// rows). The plan is the backward's gru_chain_plan.
int icrl_gru_chain_bwd(int n, int T, int E, int H, int bf16, int rows_per_tile, int units,
                       int stream, int grid_x, int row_groups, int smem, const int* tok,
                       const float* dhs, const float* hbuf, const float* gates, const float* ghn,
                       const void* h16, const void* emb, const void* wi, const void* wh,
                       float* dgi, float* dgh, void* dgi16, void* dgh16, float* dhz, float* dh,
                       float* part, float* dwi, float* dwh, float* dbi, float* dbh, float* dx,
                       void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const ChainPlan p = bf16 ? chain_plan<__nv_bfloat16, true, 3>(n, H, device_sms())
                           : chain_plan<float, true, 3>(n, H, device_sms());
  if (!plan_matches(p, rows_per_tile, units, stream, grid_x, row_groups, smem))
    return (int)cudaErrorInvalidValue;
  const auto* h = static_cast<const __nv_bfloat16*>(h16);
  auto* di = static_cast<__nv_bfloat16*>(dgi16);
  auto* dhh = static_cast<__nv_bfloat16*>(dgh16);
  if (bf16) {
    using W = __nv_bfloat16;
    return gru_bwd(n, T, E, H, p, tok, dhs, hbuf, gates, ghn, static_cast<const W*>(emb),
                   static_cast<const W*>(wi), static_cast<const W*>(wh), h, dgi, dgh, di, dhh, dhz,
                   dh, part, dwi, dwh, dbi, dbh, dx, s);
  }
  return gru_bwd(n, T, E, H, p, tok, dhs, hbuf, gates, ghn, static_cast<const float*>(emb),
                 static_cast<const float*>(wi), static_cast<const float*>(wh), h, dgi, dgh, di,
                 dhh, dhz, dh, part, dwi, dwh, dbi, dbh, dx, s);
}

}  // extern "C"
