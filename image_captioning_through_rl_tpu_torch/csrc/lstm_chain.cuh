// The teacher-forced LSTM chain's kernels and host functions, forward and
// backward (lstm_fwd, lstm_bwd), shared by lstm_chain.cu (the chain's C entry
// points) and rollout.cu (the A2C rollout, whose encoders' backward is this
// chain's backward). The design notes are lstm_chain.cu's.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "wgmma.cuh"

namespace icrl {
namespace {

// ---- The persistent, weights-stationary chain kernels ----
//
// Both directions run as one cooperative launch of at most one block per
// SM. Block (slice, group) owns the hidden units [slice U, slice U + U) and
// the row tiles group, group + row_groups, ... of CHAIN_BR rows; it keeps
// its slice of wh in shared memory (Bs, ChainSmem) for the whole chain, and
// a grid-wide barrier ends each step. Per step and row
// tile it streams the tile's A rows ([CHAIN_BR, K]) from L2 through a ring
// of cp.async slices, multiplies them against Bs into a float32 tile Cs
// [CHAIN_BR][NC], and finishes the cell from Cs, whose other operands (the
// x-gate rows and tape) it loaded before the product, so their latency
// hides behind it:
//   forward:  A = rnd(h_t), K = H, NC = 4U (the four gate columns of its
//             units, gate-major), the cell's gate math and c/h update;
//   backward: A = rnd(dg_t), K = 4H, NC = U (dh_prev = rnd(dg_t) @ wh^T for
//             its units), then the gate gradients of step t - 1.
// bf16 weights multiply on the tensor cores (mma.sync m16n8k16 from
// ldmatrix, float32 sums; WM x WN warps over the tile, each of KS of them
// taking every KS-th 16-deep step, their partial tiles then added in order
// KS = 0, 1, ...), float32 weights on the CUDA cores (fmaf, no rounding):
// every sum has a fixed order, so every output is the same from run to run.
template <typename W, bool kBwd>
struct ChainTile;
template <>
struct ChainTile<__nv_bfloat16, false> {
  static constexpr int U = 32, NC = 128, KC = 128, STAGES = 5, WM = 2, WN = 4, KS = 1;
};
template <>
struct ChainTile<__nv_bfloat16, true> {
  static constexpr int U = 32, NC = 32, KC = 128, STAGES = 5, WM = 2, WN = 1, KS = 4;
};
template <>
struct ChainTile<float, false> {
  static constexpr int U = 16, NC = 64, KC = 32, STAGES = 4, WM = 0, WN = 0, KS = 1;
};
template <>
struct ChainTile<float, true> {
  static constexpr int U = 16, NC = 16, KC = 32, STAGES = 4, WM = 0, WN = 0, KS = 1;
};
constexpr int CHAIN_BR = 64, CHAIN_THREADS = 256;
// H100: shared memory per SM, the most one block may opt in to, and what
// the runtime reserves per block.
constexpr long SMEM_PER_SM = 233472, SMEM_PER_BLOCK = 232448, SMEM_RESERVED = 1024;

// The launch plan; ops/fused_lstm.py:lstm_chain_plan computes the same.
struct ChainPlan {
  int rows_per_tile, units, slices, row_groups;
  long smem;
};

template <typename W, bool kBwd>
ChainPlan chain_plan(int n, int H, int sms) {
  using Tl = ChainTile<W, kBwd>;
  const long e = sizeof(W), pad = 16 / e, K = kBwd ? 4L * H : H;
  const long Kp = (K + Tl::KC - 1) / Tl::KC * Tl::KC;
  ChainPlan p;
  p.rows_per_tile = CHAIN_BR;
  p.units = Tl::U;
  p.slices = cdiv(H, Tl::U);
  p.smem = ((kBwd ? Tl::NC * (Kp + pad) : Kp * (Tl::NC + pad)) +
            (long)Tl::STAGES * CHAIN_BR * (Tl::KC + pad)) * e;
  const long per_sm = p.smem > SMEM_PER_BLOCK ? 0 : SMEM_PER_SM / (p.smem + SMEM_RESERVED);
  const long groups = sms * per_sm / p.slices;
  p.row_groups = (int)std::max(1L, std::min<long>(cdiv(std::max(n, 1), CHAIN_BR), groups));
  return p;
}

inline int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Loads issued where they stand: a volatile asm is not moved past the
// product's barriers and copies, so the epilogue's operands arrive while the
// product runs. ``nc``: through the read-only path, for data no block of
// this launch writes.
__device__ __forceinline__ float ld_early(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_early_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int ld_early_nc(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The shared-memory regions of a chain kernel: the weight slice Bs and the
// A ring [STAGES][CHAIN_BR][ALD], which the float32 product tile Cs
// [CHAIN_BR][NC + 4] (after KS > 1 partial tiles of that shape) overlays
// once the product is done. Bs holds B(k, n) at bidx(n, k): [NC][Kp + PAD]
// for the backward (rows of wh as they lie in memory), [Kp][NC + PAD] for
// the forward (columns of wh, so each row of the slice is four 16-byte
// aligned runs of wh's row k); the padding keeps ldmatrix's eight row
// addresses on distinct banks.
template <typename W, bool kBwd>
struct ChainSmem {
  using Tl = ChainTile<W, kBwd>;
  static constexpr int PAD = 16 / sizeof(W), ALD = Tl::KC + PAD, CLD = Tl::NC + 4;
  static constexpr int PARTS = Tl::KS > 1 ? Tl::KS * CHAIN_BR * CLD : 0;
  static_assert(Tl::STAGES * CHAIN_BR * ALD * sizeof(W) >=
                    (PARTS + CHAIN_BR * CLD) * sizeof(float),
                "the partial tiles and Cs overlay the ring");
  int Kp, BLD;
  W *Bs, *ring;
  float *part, *Cs;
  __device__ ChainSmem(unsigned char* base, int K) {
    Kp = (K + Tl::KC - 1) / Tl::KC * Tl::KC;
    BLD = kBwd ? Kp + PAD : Tl::NC + PAD;
    Bs = reinterpret_cast<W*>(base);
    ring = Bs + (size_t)(kBwd ? Tl::NC : Kp) * BLD;
    part = reinterpret_cast<float*>(ring);
    Cs = part + PARTS;
  }
  __device__ __forceinline__ int bidx(int n, int k) const {
    return kBwd ? n * BLD + k : k * BLD + n;
  }
};

// Bs from wh [H, 4H] (W), with 16-byte cp.async copies, zeros outside it:
// the backward's rows wh[j0 + n, :], the forward's columns {gate H + j0 + u}
// for the gate-major local column n = gate U + u. Waits for the copies.
template <typename W, bool kBwd>
__device__ void chain_load_weights(const ChainSmem<W, kBwd>& sm, const W* __restrict__ wh, int H,
                                   int j0) {
  using Tl = ChainTile<W, kBwd>;
  constexpr int VEC = 16 / sizeof(W);
  const int G = 4 * H;
  if constexpr (kBwd) {
    const int per_row = sm.Kp / VEC;
    for (int v = threadIdx.x; v < Tl::NC * per_row; v += CHAIN_THREADS) {
      const int c = v / per_row, k = (v % per_row) * VEC;
      const W* src = j0 + c < H && k < G ? wh + (size_t)(j0 + c) * G + k : nullptr;
      wg::cp16(wg::smem_addr(sm.Bs + sm.bidx(c, k)), src, wh);
    }
  } else {
    constexpr int per_row = Tl::NC / VEC;
    for (int v = threadIdx.x; v < sm.Kp * per_row; v += CHAIN_THREADS) {
      const int k = v / per_row, c = (v % per_row) * VEC, j = j0 + c % Tl::U;
      const W* src = k < H && j < H ? wh + (size_t)k * G + (c / Tl::U) * H + j : nullptr;
      wg::cp16(wg::smem_addr(sm.Bs + sm.bidx(c, k)), src, wh);
    }
  }
  wg::cp_commit();
  wg::cp_wait<0>();
  __syncthreads();
}

// Cs[r][c] = sum_{k < K} A(row0 + r, k) Bs[c][k], A(row, k) = a[row lda + k]
// (zero for row >= nrows), rounded to W as it is staged (an AT = float
// source with bf16 weights: the forward's float32 h0).
template <typename W, bool kBwd, typename AT>
__device__ void chain_product(const ChainSmem<W, kBwd>& sm, const AT* __restrict__ a, int lda,
                              int row0, int nrows, int K) {
  using Tl = ChainTile<W, kBwd>;
  using S = ChainSmem<W, kBwd>;
  constexpr int VEC = 16 / sizeof(W), CPR = Tl::KC / VEC, PER = CHAIN_BR * CPR / CHAIN_THREADS;
  const int tid = threadIdx.x, nk = sm.Kp / Tl::KC;
  auto issue = [&](int kc) {
    W* slot = sm.ring + (size_t)(kc % Tl::STAGES) * CHAIN_BR * S::ALD;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = tid + i * CHAIN_THREADS, r = q / CPR, c = q % CPR, k = kc * Tl::KC + c * VEC;
      const int row = row0 + r;
      const AT* src = row < nrows && k < K ? a + (size_t)row * lda + k : nullptr;
      W* dst = slot + r * S::ALD + c * VEC;
      if constexpr (std::is_same<AT, W>::value) {
        wg::cp16(wg::smem_addr(dst), src, a);
      } else {
        *reinterpret_cast<uint4*>(dst) = src ? load8_bf16(src) : make_uint4(0, 0, 0, 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < Tl::STAGES - 1; ++s) {
    if (s < nk) issue(s);
    wg::cp_commit();
  }
  if constexpr (kIsBf16<W>) {
    constexpr int WTM = CHAIN_BR / Tl::WM, WTN = Tl::NC / Tl::WN, MT = WTM / 16, NT = WTN / 8;
    static_assert(Tl::WM * Tl::WN * Tl::KS * 32 == CHAIN_THREADS, "one warp per tile and part");
    const int lane = tid % 32, warp = tid / 32, wn = warp % Tl::WN;
    const int wm = warp / Tl::WN % Tl::WM, kpart = warp / (Tl::WN * Tl::WM);
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      wg::cp_wait<Tl::STAGES - 2>();
      __syncthreads();
      if (kc + Tl::STAGES - 1 < nk) issue(kc + Tl::STAGES - 1);
      wg::cp_commit();
      const W* slot = sm.ring + (size_t)(kc % Tl::STAGES) * CHAIN_BR * S::ALD;
#pragma unroll
      for (int k16 = 0; k16 < Tl::KC / 16 / Tl::KS; ++k16) {
        const int ks = k16 * Tl::KS + kpart;
        unsigned af[MT][4], bf[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(af[i], slot + (wm * WTM + i * 16 + lane % 16) * S::ALD + ks * 16 +
                                 (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
          unsigned r[4];
          const W* bp = sm.Bs + sm.bidx(wn * WTN + j * 8 + (lane / 16) * 8 + (kBwd ? lane % 8 : 0),
                                        kc * Tl::KC + ks * 16 + ((lane / 8) % 2) * 8 +
                                            (kBwd ? 0 : lane % 8));
          if constexpr (kBwd)
            ldmatrix_x4(r, bp);
          else
            ldmatrix_x4_trans(r, bp);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
      }
    }
    // accumulator v of (i, j): row wm WTM + 16 i + lane / 4 (+ 8 for v >= 2),
    // column wn WTN + 8 j + 2 (lane % 4) (+ 1 for odd v), into Cs (KS = 1) or
    // this warp's partial tile; both overlay the ring
    wg::cp_wait<0>();
    __syncthreads();
    float* out = Tl::KS > 1 ? sm.part + kpart * CHAIN_BR * S::CLD : sm.Cs;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wm * WTM + i * 16 + lane / 4, c = wn * WTN + j * 8 + 2 * (lane % 4);
        out[r * S::CLD + c] = acc[i][j][0];
        out[r * S::CLD + c + 1] = acc[i][j][1];
        out[(r + 8) * S::CLD + c] = acc[i][j][2];
        out[(r + 8) * S::CLD + c + 1] = acc[i][j][3];
      }
    if constexpr (Tl::KS > 1) {
      __syncthreads();
      for (int e = tid; e < CHAIN_BR * Tl::NC; e += CHAIN_THREADS) {
        const int o = (e / Tl::NC) * S::CLD + e % Tl::NC;
        float v = sm.part[o];
#pragma unroll
        for (int q = 1; q < Tl::KS; ++q) v += sm.part[q * CHAIN_BR * S::CLD + o];
        sm.Cs[o] = v;
      }
    }
  } else {
    // 16 x 16 threads: rows ty + 16 i, columns tx + 16 j
    constexpr int RM = CHAIN_BR / 16, CN = Tl::NC / 16;
    const int tx = tid % 16, ty = tid / 16;
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      wg::cp_wait<Tl::STAGES - 2>();
      __syncthreads();
      if (kc + Tl::STAGES - 1 < nk) issue(kc + Tl::STAGES - 1);
      wg::cp_commit();
      const W* slot = sm.ring + (size_t)(kc % Tl::STAGES) * CHAIN_BR * S::ALD;
#pragma unroll 8
      for (int kk = 0; kk < Tl::KC; ++kk) {
        float av[RM], bv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = slot[(ty + 16 * i) * S::ALD + kk];
#pragma unroll
        for (int j = 0; j < CN; ++j) bv[j] = sm.Bs[sm.bidx(tx + 16 * j, kc * Tl::KC + kk)];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    wg::cp_wait<0>();
    __syncthreads();  // Cs overlays the ring
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sm.Cs[(ty + 16 * i) * S::CLD + tx + 16 * j] = acc[i][j];
  }
}

template <typename W>
struct ChainFwdArgs {
  int n, T, H, row_groups;
  const int* tok;       // [T, n] step-major tokens
  const float* xg;      // [V, 4H] x-gate table emb @ wi
  const W* wh;          // [H, 4H]
  const float* b;       // [4H]
  const float* h0;      // [n, H] initial state
  const float* c0;
  float* hbuf;          // [(T + 1) n, H]: h entering step t in rows t n .. t n + n
  float* cbuf;          // the same for c
  float* gates;         // [T n, 4H] post-activation i, f, g, o
  float* hs;            // [n, T, H] h leaving each step, or null
  __nv_bfloat16* h16;   // [2, n, H] rnd(h) for the next step (bf16 weights only)
};

template <typename W>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) lstm_fwd_kernel(ChainFwdArgs<W> a) {
  using Tl = ChainTile<W, false>;
  constexpr int U = Tl::U, ROWS = CHAIN_THREADS / U, CELLS = CHAIN_BR / ROWS;
  extern __shared__ __align__(16) unsigned char chain_fwd_smem[];
  const int H = a.H, G = 4 * H, n = a.n, tid = threadIdx.x;
  const ChainSmem<W, false> sm(chain_fwd_smem, H);
  // this thread's cells: unit j of rows row0 + tid / U + i ROWS; loads read
  // a valid row and unit (the last ones) where the cell lies outside
  const int j0 = blockIdx.x * U, u = tid % U, j = j0 + u, jc = min(j, H - 1);
  chain_load_weights(sm, a.wh, H, j0);
  float bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = j < H ? a.b[g * H + j] : 0.f;
  const size_t NH = (size_t)n * H;
  const int tiles = (n + CHAIN_BR - 1) / CHAIN_BR;
  auto cell_row = [&](int row0, int i) { return row0 + tid / U + i * ROWS; };
  // the tokens of the cells of (step t, row tile rt), loaded one tile ahead
  int tk[CELLS];
  auto load_tokens = [&](int t, int rt) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i)
      tk[i] = ld_early_nc(a.tok + (size_t)t * n + min(cell_row(rt * CHAIN_BR, i), n - 1));
  };
  load_tokens(0, blockIdx.y);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int t = 0; t < a.T; ++t) {
    for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
      const int row0 = rt * CHAIN_BR;
      float xv[CELLS][4], cv[CELLS];
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        const float* x = a.xg + (size_t)tk[i] * G + jc;
#pragma unroll
        for (int g = 0; g < 4; ++g) xv[i][g] = ld_early_nc(x + g * H);
        const size_t o = (size_t)min(cell_row(row0, i), n - 1) * H + jc;
        cv[i] = t == 0 ? ld_early_nc(a.c0 + o) : ld_early(a.cbuf + t * NH + o);
      }
      if (rt + a.row_groups < tiles)
        load_tokens(t, rt + a.row_groups);
      else if (t + 1 < a.T)
        load_tokens(t + 1, blockIdx.y);
      // rnd(h_t): the float32 h0 at t = 0 (rounded as it is staged), then
      // the bf16 copy the step before wrote; float32 weights read the tape
      if (t == 0)
        chain_product(sm, a.h0, H, row0, n, H);
      else if constexpr (kIsBf16<W>)
        chain_product(sm, a.h16 + (t % 2) * NH, H, row0, n, H);
      else
        chain_product(sm, a.hbuf + t * NH, H, row0, n, H);
      __syncthreads();
      // every cell's gate math first, without branches, so the eight cells'
      // dependent transcendental chains interleave; then the stores
      float gv[CELLS][4], cn[CELLS], hn[CELLS];
#pragma unroll
      for (int i = 0; i < CELLS; ++i) {
        const float* acc = sm.Cs + (cell_row(0, i)) * ChainSmem<W, false>::CLD + u;
        gv[i][0] = sigmoid(xv[i][0] + acc[0] + bias[0]);
        gv[i][1] = sigmoid(xv[i][1] + acc[U] + bias[1]);
        gv[i][2] = tanhf(xv[i][2] + acc[2 * U] + bias[2]);
        gv[i][3] = sigmoid(xv[i][3] + acc[3 * U] + bias[3]);
        cn[i] = gv[i][1] * cv[i] + gv[i][0] * gv[i][2];
        hn[i] = gv[i][3] * tanhf(cn[i]);
      }
      if (j < H) {
#pragma unroll
        for (int i = 0; i < CELLS; ++i) {
          const int row = cell_row(row0, i);
          if (row >= n) continue;
          const size_t o = (size_t)row * H + j;
          if (t == 0) {  // the tape starts with the initial state
            a.hbuf[o] = a.h0[o];
            a.cbuf[o] = cv[i];
          }
          a.cbuf[(t + 1) * NH + o] = cn[i];
          a.hbuf[(t + 1) * NH + o] = hn[i];
          if (a.hs) a.hs[((size_t)row * a.T + t) * H + j] = hn[i];
          if constexpr (kIsBf16<W>) a.h16[((t + 1) % 2) * NH + o] = __float2bfloat16_rn(hn[i]);
          float* gp = a.gates + ((size_t)t * n + row) * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) gp[g * H] = gv[i][g];
        }
      }
      __syncthreads();  // Cs serves the next row tile
    }
    if (t + 1 < a.T) grid.sync();
  }
}

template <typename W>
struct ChainBwdArgs {
  int n, T, H, row_groups;
  const float* dhs;     // upstream gradient of the h leaving step t in row r:
  long dhs_row, dhs_step;  //   dhs[r dhs_row + t dhs_step + j]
  const float* hbuf;    // the forward's tape
  const float* cbuf;
  const float* gates;
  const W* wh;          // [H, 4H]
  float* dg;            // [T n, 4H] gate gradients
  __nv_bfloat16* dg16;  // the same rounded to bf16, and rnd(h) entering
  __nv_bfloat16* h16;   //   each step [T n, H] (bf16 weights only)
  float* dh;            // [n, H] dh0 on return
  float* dc;            // [n, H] zero on entry, dc0 on return
};

// What the gate gradients of one (step, row, unit) read besides the carry.
struct CellTape {
  float i, f, g, o, c_new, c_prev, dh_up, dc, h;
};

template <typename W>
__device__ __forceinline__ CellTape lstm_cell_tape(const ChainBwdArgs<W>& a, int t, int row,
                                                   int j) {
  const int H = a.H;
  const size_t NH = (size_t)a.n * H, o = (size_t)row * H + j;
  const float* g = a.gates + ((size_t)t * a.n + row) * 4 * H + j;
  return {ld_early_nc(g),
          ld_early_nc(g + H),
          ld_early_nc(g + 2 * H),
          ld_early_nc(g + 3 * H),
          ld_early_nc(a.cbuf + (t + 1) * NH + o),
          ld_early_nc(a.cbuf + t * NH + o),
          ld_early_nc(a.dhs + (size_t)row * a.dhs_row + (size_t)t * a.dhs_step + j),
          ld_early(a.dc + o),
          kIsBf16<W> ? ld_early_nc(a.hbuf + t * NH + o) : 0.f};
}

// The gate gradients of step t for this thread's cells (unit j of rows
// row0 + tid / U + i ROWS) from their tape and dh = carry + upstream, as the
// TPU kernel's _bwd_kernel forms them; carries dc. All cells' arithmetic
// first, then the stores of the cells that lie inside.
template <typename W, int U, int CELLS>
__device__ __forceinline__ void lstm_cells_bwd(const ChainBwdArgs<W>& a,
                                               const CellTape (&tp)[CELLS],
                                               const float (&carry)[CELLS], int t, int row0,
                                               int j) {
  constexpr int ROWS = CHAIN_THREADS / U;
  const int H = a.H, G = 4 * H;
  float d[CELLS][4], dcn[CELLS];
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const CellTape& c = tp[q];
    const float tc = tanhf(c.c_new);
    const float dhv = carry[q] + c.dh_up;
    const float d_o = dhv * tc;
    const float dct = dhv * c.o * (1.f - tc * tc) + c.dc;
    const float di = dct * c.g, dgg = dct * c.i, df = dct * c.c_prev;
    d[q][0] = di * c.i * (1.f - c.i);
    d[q][1] = df * c.f * (1.f - c.f);
    d[q][2] = dgg * (1.f - c.g * c.g);
    d[q][3] = d_o * c.o * (1.f - c.o);
    dcn[q] = dct * c.f;
  }
  if (j >= H) return;
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int row = row0 + threadIdx.x / U + q * ROWS;
    if (row >= a.n) continue;
    const size_t r = (size_t)t * a.n + row;
    float* dp = a.dg + r * G + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) dp[g * H] = d[q][g];
    if constexpr (kIsBf16<W>) {
      __nv_bfloat16* dq = a.dg16 + r * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) dq[g * H] = __float2bfloat16_rn(d[q][g]);
      a.h16[r * H + j] = __float2bfloat16_rn(tp[q].h);
    }
    a.dc[(size_t)row * H + j] = dcn[q];
  }
}

template <typename W>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) lstm_bwd_kernel(ChainBwdArgs<W> a) {
  using Tl = ChainTile<W, true>;
  constexpr int U = Tl::U, ROWS = CHAIN_THREADS / U, CELLS = CHAIN_BR / ROWS;
  extern __shared__ __align__(16) unsigned char chain_bwd_smem[];
  const int H = a.H, G = 4 * H, n = a.n, tid = threadIdx.x;
  const ChainSmem<W, true> sm(chain_bwd_smem, G);
  const int j0 = blockIdx.x * U, u = tid % U, j = j0 + u, jc = min(j, H - 1);
  chain_load_weights(sm, a.wh, H, j0);
  const int tiles = (n + CHAIN_BR - 1) / CHAIN_BR;
  const W* dga;
  if constexpr (kIsBf16<W>)
    dga = reinterpret_cast<const W*>(a.dg16);
  else
    dga = a.dg;
  // the tape of this thread's cells of step t in row tile row0 (a valid row
  // and unit, the last ones, where the cell lies outside)
  auto load_tape = [&](CellTape (&tp)[CELLS], int t, int row0) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i)
      tp[i] = lstm_cell_tape(a, t, min(row0 + tid / U + i * ROWS, n - 1), jc);
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  // the last step has no carry
  for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
    CellTape tape[CELLS];
    float zero[CELLS] = {};
    load_tape(tape, a.T - 1, rt * CHAIN_BR);
    lstm_cells_bwd<W, U>(a, tape, zero, a.T - 1, rt * CHAIN_BR, j);
  }
  // step t: the carry rnd(dg_t) @ wh^T of this slice's units feeds the gate
  // gradients of step t - 1; after step 0 it is dh0
  for (int t = a.T - 1; t >= 0; --t) {
    grid.sync();
    for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
      const int row0 = rt * CHAIN_BR;
      CellTape tape[CELLS];
      if (t > 0) load_tape(tape, t - 1, row0);  // loaded now, read after the product
      chain_product(sm, dga + (size_t)t * n * G, G, row0, n, G);
      __syncthreads();
      float carry[CELLS];
#pragma unroll
      for (int i = 0; i < CELLS; ++i)
        carry[i] = sm.Cs[(tid / U + i * ROWS) * ChainSmem<W, true>::CLD + u];
      if (t > 0) {
        lstm_cells_bwd<W, U>(a, tape, carry, t - 1, row0, j);
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

template <typename Kernel, typename Args>
cudaError_t launch_chain(Kernel kernel, const ChainPlan& p, Args args, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  void* argv[] = {&args};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.slices, p.row_groups),
                                     dim3(CHAIN_THREADS), argv, (size_t)p.smem, s);
}

// hbuf, cbuf: [(T + 1) n, H], the state entering step t in rows t n .. t n + n
// (the kernel copies h0, c0 [n, H] into the first n rows). hs: [n, T, H],
// the per-step h in the caller's layout, or null. h16: [2, n, H] bf16
// scratch (bf16 weights only). One launch whatever T is.
template <typename W>
int lstm_fwd(int n, int T, int H, const int* tok, const float* xg, const W* wh, const float* b,
             const float* h0, const float* c0, float* hbuf, float* cbuf, float* gates, float* hs,
             __nv_bfloat16* h16, cudaStream_t s) {
  if (n == 0 || T == 0) return 0;
  const ChainPlan p = chain_plan<W, false>(n, H, device_sms());
  const ChainFwdArgs<W> a{n, T, H, p.row_groups, tok, xg, wh, b, h0, c0, hbuf, cbuf, gates, hs,
                          h16};
  return (int)launch_chain(lstm_fwd_kernel<W>, p, a, s);
}

// The backward (dhs[r dhs_row + t dhs_step + j] the upstream gradient of h
// leaving step t): one launch for the recurrence (the gate gradients dg of
// every step, dh0 and dc0), then the products that do not recur, over all
// T n rows: d[wi; wh] = rnd([x; h_prev])^T rnd(dg), db = the column sums of
// dg, dx = rnd(dg) @ rnd(wi)^T. bf16 weights run the products on wgmma
// (wgmma.cuh), from the bf16 dg16 and h16 the recurrence wrote and x
// gathered through the tokens; float32 weights on the CUDA-core tile
// product (common.cuh), from dg and the tape. Five launches whatever T is.
template <typename W>
int lstm_bwd(int n, int T, int E, int H, const int* tok, const float* dhs, long dhs_row,
             long dhs_step, const float* hbuf, const float* cbuf, const float* gates,
             const W* emb, const W* w, float* dg, __nv_bfloat16* dg16, __nv_bfloat16* h16,
             float* dh, float* dc, float* part, float* dw, float* db, float* dx, cudaStream_t s) {
  const int G = 4 * H, R = T * n;
  if (n == 0) return 0;
  if (T == 0) {
    ICRL_CHECK(cudaMemsetAsync(dh, 0, sizeof(float) * n * H, s));
    ICRL_CHECK(cudaMemsetAsync(dw, 0, sizeof(float) * (size_t)(E + H) * G, s));
    return (int)cudaMemsetAsync(db, 0, sizeof(float) * G, s);
  }
  const ChainPlan p = chain_plan<W, true>(n, H, device_sms());
  const ChainBwdArgs<W> a{n,    T,    H,     p.row_groups, dhs, dhs_row, dhs_step, hbuf,
                          cbuf, gates, w + (size_t)E * G, dg, dg16, h16,     dh,       dc};
  ICRL_CHECK(launch_chain(lstm_bwd_kernel<W>, p, a, s));
  ICRL_CHECK(launch_colsum(R, G, dg, part, db, s));
  if constexpr (kIsBf16<W>) {
    const DenseRows dgr{dg16, R, G, G};
    ICRL_CHECK((launch_wgmma_gemm<true>(E + H, G, R, TokenStateRows{emb, tok, h16, R, E, H}, dgr,
                                        dw, s)));
    ICRL_CHECK((launch_wgmma_gemm<false>(R, E, G, dgr, DenseRows{w, E, G, G}, dx, s)));
  } else {
    ICRL_CHECK((launch_view<W, true, false>(E, G, R, emb, E, tok, dg, G, false, dw, s)));
    ICRL_CHECK((launch_view<W, true, false>(H, G, R, hbuf, H, nullptr, dg, G, false,
                                            dw + (size_t)E * G, s)));
    ICRL_CHECK((launch_view<W, false, true>(R, E, G, dg, G, nullptr, w, G, false, dx, s)));
  }
  return 0;
}

}  // namespace
}  // namespace icrl
