// Teacher-forced GRU chain on Hopper, forward and backward.
//
// Replaces the TPU kernel image_captioning_through_rl_tpu/ops/pallas_gru.py
// (fused_gru_chain: _fwd_kernel and _bwd_kernel under the custom VJP of
// _make_chain), the reward network's caption encoder in the VSE step. Per
// step, gate order r, z, n:
//   gi = rnd(x) @ rnd(wi) + bi,  gh = rnd(h) @ rnd(wh) + bh,
//   r = sigmoid(gi_r + gh_r),  z = sigmoid(gi_z + gh_z),
//   n = tanh(gi_n + r * gh_n),  h' = (1 - z) * n + z * h.
// The forward tapes r, z, n and gh_n; the backward runs in reverse time and
// returns dwi, dwh, dbi, dbh, the per-step dx, and dh0.
//
// Rounding points, as in the TPU kernel: x and h are cast to the weight type
// before their products, the gate gradients before the backward products;
// sums, gate math, h and the bias gradients (sums of the unrounded gate
// gradients) stay float32.
//
// What bounds it here: as in lstm_chain.cu, a chain of small dependent
// products ([N, 512] x [512, 1536] per step each way), a microsecond of the
// tensor cores' time each at N = 512; what a step costs is moving its
// operands into the SMs and the wait between steps. The design is the LSTM
// chain's (chain.cuh, lstm_chain.cu's note):
//   * gi depends on the token alone: the wrapper builds the table
//     emb @ wi + bi once per call (token_gates.cu), so each forward step runs
//     only rnd(h) @ wh.
//   * The forward's recurrence is one persistent cooperative launch: block
//     (slice, group) keeps the 3U gate-major columns of its U units of wh in
//     shared memory, streams the step's rnd(h) rows through the cp.async
//     ring into mma.sync, and runs the cell in the epilogue from the x-gate
//     rows it loaded before the product; a grid barrier ends each step. It
//     reads h0 itself and writes h (float32 tape and hs) and the bf16 rnd(h)
//     that the next step and the backward's products read.
//   * The backward's recurrence is one cooperative launch too: block (slice,
//     group) keeps its U rows of wh [U, 3H], streams rnd(dgh_t) (K = 3H) and
//     forms dh_prev = rnd(dgh_t) @ wh^T + dh z for its units, then the gate
//     gradients of step t - 1 from the tape: float32 dgi and dgh (the bias
//     sums) and their bf16 copies (the products).
//   * The products that do not recur run once after the loop over all T N
//     rows, on wgmma (wgmma.cuh) for bf16 weights: dwi = x^T rnd(dgi) with x
//     gathered through the tokens and dwh = rnd(h_prev)^T rnd(dgh) in one
//     launch (each alone fills only 48 of the 132 SMs at COCO width), dx =
//     rnd(dgi) @ rnd(wi)^T; dbi and dbh as fixed-order column sums. Float32
//     weights keep the CUDA-core tile products (common.cuh).
//   * Wide chains take the plan's streaming mode (chain.cuh).
// The backward's kernel and entry point are in gru_chain_bwd.cu.
#include "chain.cuh"

namespace icrl {
namespace {

template <typename W>
struct GruFwdArgs {
  int n, T, H, row_groups;
  const int* tok;       // [T, n] step-major tokens
  const float* xg;      // [V, 3H] table emb @ wi + bi
  const W* wh;          // [H, 3H]
  const float* bh;      // [3H]
  const float* h0;      // [n, H] initial state
  float* hbuf;          // [(T + 1) n, H]: h entering step t in rows t n .. t n + n
  float* gates;         // [T n, 3H] r, z, n
  float* ghn;           // [T n, H] gh_n = (rnd(h) @ wh + bh)[:, 2H:]
  float* hs;            // [n, T, H] h leaving each step
  __nv_bfloat16* h16;   // [(T + 1) n, H] rnd(h) as hbuf (bf16 weights only)
};

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) gru_fwd_kernel(GruFwdArgs<W> a) {
  using Tl = ChainTile<W, false, U, 3, kStream>;
  using S = ChainSmem<Tl>;
  constexpr int ROWS = CHAIN_THREADS / U, CELLS = CHAIN_BR / ROWS;
  extern __shared__ __align__(16) unsigned char gru_fwd_smem[];
  const int H = a.H, G = 3 * H, n = a.n, tid = threadIdx.x, u = tid % U;
  const S sm(gru_fwd_smem, H);
  const int slices = (H + U - 1) / U;
  if constexpr (!kStream) chain_load_weights<Tl>(sm, a.wh, H, blockIdx.x * U);
  const size_t NH = (size_t)n * H;
  const int tiles = (n + CHAIN_BR - 1) / CHAIN_BR;
  // this thread's cells: unit j of rows row0 + tid / U + i ROWS; loads read
  // a valid row and unit (the last ones) where the cell lies outside
  auto cell_row = [&](int row0, int i) { return row0 + tid / U + i * ROWS; };
  int tk[CELLS];
  auto load_tokens = [&](int t, int rt) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i)
      tk[i] = ld_early_nc(a.tok + (size_t)t * n + min(cell_row(rt * CHAIN_BR, i), n - 1));
  };
  load_tokens(0, blockIdx.y);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int t = 0; t < a.T; ++t) {
    for (int s = blockIdx.x; s < slices; s += gridDim.x) {
      const int j0 = s * U, j = j0 + u, jc = min(j, H - 1);
      float bias[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) bias[g] = j < H ? a.bh[g * H + j] : 0.f;
      for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
        const int row0 = rt * CHAIN_BR;
        float xv[CELLS][3], hv[CELLS];
#pragma unroll
        for (int i = 0; i < CELLS; ++i) {
          const float* x = a.xg + (size_t)tk[i] * G + jc;
#pragma unroll
          for (int g = 0; g < 3; ++g) xv[i][g] = ld_early_nc(x + g * H);
          const size_t o = (size_t)min(cell_row(row0, i), n - 1) * H + jc;
          hv[i] = t == 0 ? ld_early_nc(a.h0 + o) : ld_early(a.hbuf + t * NH + o);
        }
        if (rt + a.row_groups < tiles)
          load_tokens(t, rt + a.row_groups);
        else if (s + (int)gridDim.x < slices)
          load_tokens(t, blockIdx.y);
        else if (t + 1 < a.T)
          load_tokens(t + 1, blockIdx.y);
        // rnd(h_t): the float32 h0 at t = 0 (rounded as it is staged), then
        // the bf16 copy the step before wrote; float32 weights read the tape
        if (t == 0)
          chain_product<Tl>(sm, a.h0, H, row0, n, H, a.wh, H, j0);
        else if constexpr (kIsBf16<W>)
          chain_product<Tl>(sm, a.h16 + t * NH, H, row0, n, H, a.wh, H, j0);
        else
          chain_product<Tl>(sm, a.hbuf + t * NH, H, row0, n, H, a.wh, H, j0);
        __syncthreads();
        // the cells' gate math first, without branches; then the stores
        float rg[CELLS], zg[CELLS], ng[CELLS], ghn[CELLS], hn[CELLS];
#pragma unroll
        for (int i = 0; i < CELLS; ++i) {
          const float* acc = sm.Cs + (cell_row(0, i)) * S::CLD + u;
          const float gh_r = acc[0] + bias[0], gh_z = acc[U] + bias[1];
          ghn[i] = acc[2 * U] + bias[2];
          rg[i] = sigmoid(xv[i][0] + gh_r);
          zg[i] = sigmoid(xv[i][1] + gh_z);
          ng[i] = tanhf(xv[i][2] + rg[i] * ghn[i]);
          hn[i] = (1.f - zg[i]) * ng[i] + zg[i] * hv[i];
        }
        if (j < H) {
#pragma unroll
          for (int i = 0; i < CELLS; ++i) {
            const int row = cell_row(row0, i);
            if (row >= n) continue;
            const size_t o = (size_t)row * H + j;
            if (t == 0) {  // the tape starts with the initial state
              a.hbuf[o] = hv[i];
              if constexpr (kIsBf16<W>) a.h16[o] = __float2bfloat16_rn(hv[i]);
            }
            a.hbuf[(t + 1) * NH + o] = hn[i];
            a.hs[((size_t)row * a.T + t) * H + j] = hn[i];
            if constexpr (kIsBf16<W>) a.h16[(t + 1) * NH + o] = __float2bfloat16_rn(hn[i]);
            float* gp = a.gates + ((size_t)t * n + row) * G + j;
            gp[0] = rg[i];
            gp[H] = zg[i];
            gp[2 * H] = ng[i];
            a.ghn[(size_t)t * NH + o] = ghn[i];
          }
        }
        __syncthreads();  // Cs serves the next row tile
      }
    }
    if (t + 1 < a.T) grid.sync();
  }
}

template <typename W>
struct GruFwdLaunch {
  template <int U, bool kStream>
  struct At {
    static cudaError_t run(const ChainPlan& p, const GruFwdArgs<W>& a, cudaStream_t s) {
      return launch_chain(gru_fwd_kernel<W, U, kStream>, p, a, s);
    }
  };
};

// One launch whatever T is.
template <typename W>
int gru_fwd(int n, int T, int H, const ChainPlan& p, const int* tok, const float* xg,
            const W* wh, const float* bh, const float* h0, float* hbuf, float* gates, float* ghn,
            float* hs, __nv_bfloat16* h16, cudaStream_t s) {
  if (n == 0 || T == 0) return 0;
  const GruFwdArgs<W> a{n, T, H, p.row_groups, tok, xg, wh, bh, h0, hbuf, gates, ghn, hs, h16};
  return (int)launch_planned<W, false, 3, GruFwdLaunch<W>::template At>(p, a, s);
}

}  // namespace
}  // namespace icrl

extern "C" {

// Forward. tok [T, n] int32 step-major; xg [V, 3H] float32 (emb @ wi + bi,
// icrl_token_gates); wh [H, 3H] bf16 when bf16 != 0, else float32; bh [3H];
// h0 [n, H] float32. Outputs: hbuf [(T + 1) n, H] float32 (the state
// entering each step, h0 first), gates [T n, 3H], ghn [T n, H], hs [n, T, H]
// (h leaving each step), h16 [(T + 1) n, H] bf16 (bf16 only: rnd(hbuf)).
// The plan (rows per tile, units per slice, streaming or not, grid columns,
// row groups, shared bytes) must be gru_chain_plan's. Returns 0 or the CUDA
// error of the launch (a refused cooperative launch included).
int icrl_gru_chain_fwd(int n, int T, int H, int bf16, int rows_per_tile, int units, int stream,
                       int grid_x, int row_groups, int smem, const int* tok, const float* xg,
                       const void* wh, const float* bh, const float* h0, float* hbuf,
                       float* gates, float* ghn, float* hs, void* h16, void* stream_) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream_);
  const ChainPlan p = bf16 ? chain_plan<__nv_bfloat16, false, 3>(n, H, device_sms())
                           : chain_plan<float, false, 3>(n, H, device_sms());
  if (!plan_matches(p, rows_per_tile, units, stream, grid_x, row_groups, smem))
    return (int)cudaErrorInvalidValue;
  auto* h = static_cast<__nv_bfloat16*>(h16);
  if (bf16)
    return gru_fwd(n, T, H, p, tok, xg, static_cast<const __nv_bfloat16*>(wh), bh, h0, hbuf,
                   gates, ghn, hs, h, s);
  return gru_fwd(n, T, H, p, tok, xg, static_cast<const float*>(wh), bh, h0, hbuf, gates, ghn, hs,
                 h, s);
}

}  // extern "C"
