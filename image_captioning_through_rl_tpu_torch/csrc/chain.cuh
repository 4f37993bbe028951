// The persistent, weights-stationary recurrence shared by the teacher-forced
// chains: the LSTM (lstm_chain.cuh) and the GRU (gru_chain.cu). The design
// notes are lstm_chain.cu's; this file holds the launch plan, the shared
// memory layout, the staging of the weight slice and the per-step product.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"
#include "wgmma.cuh"

namespace icrl {
namespace {

// Each direction of a chain runs as one cooperative launch of at most one
// block per SM. Block (x, group) owns the hidden-unit slices x, x + gridDim.x,
// ... of U units each and the row tiles group, group + row_groups, ... of
// CHAIN_BR rows. A step's product for a (slice, row tile) streams the tile's
// A rows ([CHAIN_BR, K]) from L2 through a ring of cp.async slices,
// multiplies them against the slice's weight columns into a float32 tile Cs
// [CHAIN_BR][NC], and the kernel finishes the cell from Cs; a grid-wide
// barrier ends each step:
//   forward:  A = rnd(h_t), K = H, NC = GATES U (the gate columns of the
//             slice's units, gate-major);
//   backward: A = rnd(dg_t), K = GATES H, NC = U (rnd(dg_t) @ wh^T for the
//             slice's units).
// Where a slice of wh fits in shared memory beside the ring and every slice
// has a block of its own (the stationary mode), the block loads its slice
// once and keeps it for the whole chain (Bs). Otherwise (the streaming mode:
// wide chains, from H = 1064 up) each ring slot carries the slice's weight
// rows for its depth beside the A rows, so the weights come from L2 at every
// step, and a block walks several slices in turn.
// bf16 weights multiply on the tensor cores (mma.sync m16n8k16 from
// ldmatrix, float32 sums; WM x WN warps over the tile, each of KS of them
// taking every KS-th 16-deep step, their partial tiles then added in order
// KS = 0, 1, ...), float32 weights on the CUDA cores (fmaf, no rounding):
// every sum has a fixed order, so every output is the same from run to run.
constexpr int CHAIN_BR = 64, CHAIN_THREADS = 256;
// H100: shared memory per SM, the most one block may opt in to, and what
// the runtime reserves per block.
constexpr long SMEM_PER_SM = 233472, SMEM_PER_BLOCK = 232448, SMEM_RESERVED = 1024;

// Per weight type: the depth of a staged slice, the slots of the ring, and
// the units per slice the plan tries, widest first.
template <typename W>
struct ChainRing;
template <>
struct ChainRing<__nv_bfloat16> {
  static constexpr int KC = 128, STAGES = 5, NUNITS = 3;
  static constexpr int UNITS[NUNITS] = {32, 16, 8};
};
template <>
struct ChainRing<float> {
  static constexpr int KC = 32, STAGES = 4, NUNITS = 1;
  static constexpr int UNITS[NUNITS] = {8};
};

// Whether the plan of W ever picks slices of u units (a kernel variant to
// build).
template <typename W>
constexpr bool plans_units(int u) {
  for (int i = 0; i < ChainRing<W>::NUNITS; ++i)
    if (ChainRing<W>::UNITS[i] == u) return true;
  return false;
}

template <typename WT, bool kBwd, int U, int GATES, bool kStream>
struct ChainTile {
  using W = WT;
  static constexpr bool BWD = kBwd, STREAM = kStream;
  static constexpr int UNITS = U, NGATES = GATES;
  static constexpr int KC = ChainRing<WT>::KC, STAGES = ChainRing<WT>::STAGES;
  static constexpr int NC = kBwd ? U : GATES * U;
  // bf16: the forward splits the columns over as many warps as whole 8-wide
  // tiles allow; the backward (K = GATES H, NC = U) splits the depth
  static constexpr int WM = 2, WN = kBwd ? 1 : (NC % 32 == 0 ? 4 : NC % 16 == 0 ? 2 : 1);
  static constexpr int KS = 4 / WN;
  // float32: TX x TY threads over the tile's columns and rows
  static constexpr int TX = NC % 16 == 0 ? 16 : 8, TY = CHAIN_THREADS / TX;
  static_assert(U % 8 == 0, "whole 8-wide tiles per slice");
};

// The host's view of the shared memory a tile's block opts in to: the
// stationary slice and the ring, or the streaming ring alone.
template <typename W>
constexpr long chain_smem(bool bwd, int gates, int units, bool stream, long Kp) {
  const long e = sizeof(W), pad = 16 / e, kc = ChainRing<W>::KC, st = ChainRing<W>::STAGES;
  const long cols = bwd ? units : (long)gates * units, a = CHAIN_BR * (kc + pad);
  if (stream) return st * (a + (bwd ? cols * (kc + pad) : kc * (cols + pad))) * e;
  return ((bwd ? cols * (Kp + pad) : Kp * (cols + pad)) + st * a) * e;
}

// The widest slice whose streaming ring fits one block.
template <typename W, bool kBwd, int GATES>
constexpr int stream_units() {
  for (int i = 0; i < ChainRing<W>::NUNITS; ++i)
    if (chain_smem<W>(kBwd, GATES, ChainRing<W>::UNITS[i], true, 0) <= SMEM_PER_BLOCK)
      return ChainRing<W>::UNITS[i];
  return 0;
}

// The launch plan; ops/fused_lstm.py:chain_plan computes the same.
struct ChainPlan {
  int rows_per_tile, units, stream, slices, grid_x, row_groups;
  long smem;
};

template <typename W, bool kBwd, int GATES>
ChainPlan chain_plan(int n, int H, int sms) {
  constexpr int kc = ChainRing<W>::KC;
  const long K = kBwd ? (long)GATES * H : H, Kp = (K + kc - 1) / kc * kc;
  const long tiles = cdiv(std::max(n, 1), CHAIN_BR);
  // one block per SM (__launch_bounds__(CHAIN_THREADS, 1) lets a kernel
  // take every register)
  auto co_resident = [&](long smem) {
    return smem > SMEM_PER_BLOCK ? 0L
                                 : sms * std::min(1L, SMEM_PER_SM / (smem + SMEM_RESERVED));
  };
  ChainPlan p{CHAIN_BR, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < ChainRing<W>::NUNITS && !p.units; ++i) {
    const int units = ChainRing<W>::UNITS[i];
    const long smem = chain_smem<W>(kBwd, GATES, units, false, Kp), co = co_resident(smem);
    if (co >= cdiv(H, units)) {
      p.units = units;
      p.smem = smem;
    }
  }
  if (!p.units) {
    p.units = stream_units<W, kBwd, GATES>();
    p.stream = 1;
    p.smem = chain_smem<W>(kBwd, GATES, p.units, true, Kp);
  }
  const long co = co_resident(p.smem);
  p.slices = cdiv(H, p.units);
  p.grid_x = (int)std::min<long>(p.slices, co);
  p.row_groups = (int)std::max(1L, std::min<long>(tiles, co / std::max(p.grid_x, 1)));
  return p;
}

// The wrapper's plan (ops/fused_lstm.py:chain_plan) against this file's: a
// mismatch is a bug in one of the two, not a shape to run.
inline bool plan_matches(const ChainPlan& p, int rows_per_tile, int units, int stream, int grid_x,
                         int row_groups, int smem) {
  return p.rows_per_tile == rows_per_tile && p.units == units && p.stream == stream &&
         p.grid_x == grid_x && p.row_groups == row_groups && p.smem == smem;
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

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// The shared-memory regions of a chain kernel: the stationary weight slice
// Bs (none when streaming) and the ring [STAGES] of slots, each the A rows
// [CHAIN_BR][ALD] and, when streaming, the slot's weight rows [SB]; the
// float32 product tile Cs [CHAIN_BR][NC + 4] (after KS > 1 partial tiles of
// that shape) overlays the ring once the product is done. B(k, n) lies at
// bidx(n, k) in Bs: [NC][Kp + PAD] for the backward (rows of wh as they lie
// in memory), [Kp][NC + PAD] for the forward (columns of wh, so each row of
// the slice is GATES 16-byte aligned runs of wh's row k); a streamed slot
// holds the same for its KC depths. The padding keeps ldmatrix's eight row
// addresses on distinct banks.
template <class Tl>
struct ChainSmem {
  using W = typename Tl::W;
  static constexpr bool kBwd = Tl::BWD, kStream = Tl::STREAM;
  static constexpr int PAD = 16 / sizeof(W), ALD = Tl::KC + PAD, CLD = Tl::NC + 4;
  static constexpr int SLD = kBwd ? Tl::KC + PAD : Tl::NC + PAD;
  static constexpr int SB = kStream ? (kBwd ? Tl::NC * SLD : Tl::KC * SLD) : 0;
  static constexpr int SLOT = CHAIN_BR * ALD + SB;
  static constexpr int PARTS = kIsBf16<W> && Tl::KS > 1 ? Tl::KS * CHAIN_BR * CLD : 0;
  static_assert(Tl::STAGES * SLOT * sizeof(W) >= (PARTS + CHAIN_BR * CLD) * sizeof(float),
                "the partial tiles and Cs overlay the ring");
  int Kp, BLD;
  W *Bs, *ring;
  float *part, *Cs;
  __device__ ChainSmem(unsigned char* base, int K) {
    Kp = (K + Tl::KC - 1) / Tl::KC * Tl::KC;
    BLD = kBwd ? Kp + PAD : Tl::NC + PAD;
    Bs = reinterpret_cast<W*>(base);
    ring = Bs + (kStream ? 0 : (size_t)(kBwd ? Tl::NC : Kp) * BLD);
    part = reinterpret_cast<float*>(ring);
    Cs = part + PARTS;
  }
  __device__ __forceinline__ int bidx(int n, int k) const {
    return kBwd ? n * BLD + k : k * BLD + n;
  }
};

// The weight source of unit slice j0 of wh [H, GATES H] (W), 16 bytes at
// local column n, depth k, or null outside wh: the backward's rows
// wh[j0 + n, k], the forward's columns {gate H + j0 + u} for the gate-major
// local column n = gate U + u at row k.
template <class Tl>
__device__ __forceinline__ const typename Tl::W* chain_weight_src(const typename Tl::W* wh,
                                                                 int H, int j0, int n, int k) {
  const int G = Tl::NGATES * H;
  if constexpr (Tl::BWD) {
    return j0 + n < H && k < G ? wh + (size_t)(j0 + n) * G + k : nullptr;
  } else {
    const int j = j0 + n % Tl::UNITS;
    return k < H && j < H ? wh + (size_t)k * G + (n / Tl::UNITS) * H + j : nullptr;
  }
}

// The weight slice j0 of wh as a source of 16-byte chunks: src(n, k) is
// chain_weight_src's, src.base() a valid address for a zero-filled copy.
// Other slice shapes (the rollout's column slices, rollout_fwd.cuh) pass
// their own source with the same two members.
template <class Tl>
struct GateSlice {
  const typename Tl::W* wh;
  int H, j0;
  __device__ __forceinline__ const typename Tl::W* operator()(int n, int k) const {
    return chain_weight_src<Tl>(wh, H, j0, n, k);
  }
  __device__ __forceinline__ const void* base() const { return wh; }
};

// Bs from the slice source with 16-byte cp.async copies, zeros outside it
// (stationary mode). Waits for the copies.
template <class Tl, class Src>
__device__ void chain_load_slice(const ChainSmem<Tl>& sm, const Src& src) {
  using W = typename Tl::W;
  constexpr int VEC = 16 / sizeof(W);
  if constexpr (Tl::BWD) {
    const int per_row = sm.Kp / VEC;
    for (int v = threadIdx.x; v < Tl::NC * per_row; v += CHAIN_THREADS) {
      const int c = v / per_row, k = (v % per_row) * VEC;
      wg::cp16(wg::smem_addr(sm.Bs + sm.bidx(c, k)), src(c, k), src.base());
    }
  } else {
    constexpr int per_row = Tl::NC / VEC;
    for (int v = threadIdx.x; v < sm.Kp * per_row; v += CHAIN_THREADS) {
      const int k = v / per_row, c = (v % per_row) * VEC;
      wg::cp16(wg::smem_addr(sm.Bs + sm.bidx(c, k)), src(c, k), src.base());
    }
  }
  wg::cp_commit();
  wg::cp_wait<0>();
  __syncthreads();
}

// Bs from the slice j0 of wh.
template <class Tl>
__device__ void chain_load_weights(const ChainSmem<Tl>& sm, const typename Tl::W* __restrict__ wh,
                                   int H, int j0) {
  chain_load_slice(sm, GateSlice<Tl>{wh, H, j0});
}

// Cs[r][c] = sum_{k < K} A(row0 + r, k) B(k, c), A(row, k) = a[row lda + k]
// (zero for row >= nrows), rounded to W as it is staged (an AT = float
// source with bf16 weights: the forward's float32 h0); B the slice of the
// source src (Bs, or streamed with A from src when Tl::STREAM).
template <class Tl, typename AT, class Src>
__device__ void chain_product_src(const ChainSmem<Tl>& sm, const AT* __restrict__ a, int lda,
                                  int row0, int nrows, int K, const Src& src) {
  using W = typename Tl::W;
  using S = ChainSmem<Tl>;
  constexpr int VEC = 16 / sizeof(W), CPR = Tl::KC / VEC, PER = CHAIN_BR * CPR / CHAIN_THREADS;
  const int tid = threadIdx.x, nk = sm.Kp / Tl::KC;
  auto slot_of = [&](int kc) { return sm.ring + (size_t)(kc % Tl::STAGES) * S::SLOT; };
  auto issue = [&](int kc) {
    W* slot = slot_of(kc);
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
    if constexpr (Tl::STREAM) {
      W* sb = slot + CHAIN_BR * S::ALD;
      constexpr int BPR = Tl::BWD ? Tl::KC / VEC : Tl::NC / VEC;  // chunks per slot row
      constexpr int BROWS = Tl::BWD ? Tl::NC : Tl::KC;
      for (int v = tid; v < BROWS * BPR; v += CHAIN_THREADS) {
        const int rr = v / BPR, cc = (v % BPR) * VEC;
        const int n = Tl::BWD ? rr : cc, kk = Tl::BWD ? cc : rr;
        wg::cp16(wg::smem_addr(sb + rr * S::SLD + cc), src(n, kc * Tl::KC + kk), src.base());
      }
    }
  };
  // B(n, local depth kk) of slice kc
  auto bptr = [&](int kc, int n, int kk) -> const W* {
    if constexpr (Tl::STREAM) {
      const W* sb = slot_of(kc) + CHAIN_BR * S::ALD;
      return sb + (Tl::BWD ? n * S::SLD + kk : kk * S::SLD + n);
    } else {
      return sm.Bs + sm.bidx(n, kc * Tl::KC + kk);
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
    static_assert(WTN % 8 == 0 && NT >= 1, "whole 8-wide tiles per warp");
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
      const W* slot = slot_of(kc);
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
          // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15);
          // the last two only where a second 8-wide tile follows
          const W* bp = bptr(kc, wn * WTN + j * 8 + (lane / 16) * 8 + (Tl::BWD ? lane % 8 : 0),
                             ks * 16 + ((lane / 8) % 2) * 8 + (Tl::BWD ? 0 : lane % 8));
          if (j + 1 < NT) {
            unsigned r[4];
            if constexpr (Tl::BWD)
              ldmatrix_x4(r, bp);
            else
              ldmatrix_x4_trans(r, bp);
            bf[j][0] = r[0];
            bf[j][1] = r[1];
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          } else {
            unsigned r[2];
            if constexpr (Tl::BWD)
              ldmatrix_x2(r, bp);
            else
              ldmatrix_x2_trans(r, bp);
            bf[j][0] = r[0];
            bf[j][1] = r[1];
          }
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
    // TX x TY threads: rows ty + TY i, columns tx + TX j
    constexpr int RM = CHAIN_BR / Tl::TY, CN = Tl::NC / Tl::TX;
    const int tx = tid % Tl::TX, ty = tid / Tl::TX;
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
      const W* slot = slot_of(kc);
#pragma unroll 8
      for (int kk = 0; kk < Tl::KC; ++kk) {
        float av[RM], bv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) av[i] = slot[(ty + Tl::TY * i) * S::ALD + kk];
#pragma unroll
        for (int j = 0; j < CN; ++j) bv[j] = *bptr(kc, tx + Tl::TX * j, kk);
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
      for (int j = 0; j < CN; ++j) sm.Cs[(ty + Tl::TY * i) * S::CLD + tx + Tl::TX * j] = acc[i][j];
  }
}

// chain_product_src on the slice j0 of wh.
template <class Tl, typename AT>
__device__ void chain_product(const ChainSmem<Tl>& sm, const AT* __restrict__ a, int lda,
                              int row0, int nrows, int K, const typename Tl::W* __restrict__ wh,
                              int H, int j0) {
  chain_product_src(sm, a, lda, row0, nrows, K, GateSlice<Tl>{wh, H, j0});
}

// chains: how many chains of the same plan share the launch, one per
// blockIdx.z (the rollout's two encoders, rollout.cu).
template <typename Kernel, typename Args>
cudaError_t launch_chain(Kernel kernel, const ChainPlan& p, Args args, cudaStream_t s,
                         int chains = 1) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  void* argv[] = {&args};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(p.grid_x, p.row_groups, chains),
                                     dim3(CHAIN_THREADS), argv, (size_t)p.smem, s);
}

// Launches kernel<U, kStream> for the plan's units and mode: Launcher is a
// class template over (U, kStream) whose static run(plan, args, stream)
// launches its kernel.
template <typename W, bool kBwd, int GATES, template <int, bool> class Launcher, typename Args>
cudaError_t launch_planned(const ChainPlan& p, const Args& a, cudaStream_t s) {
  constexpr int SU = stream_units<W, kBwd, GATES>();
  static_assert(SU > 0, "the smallest streaming slice fits one block");
  if (p.stream) return Launcher<SU, true>::run(p, a, s);
  switch (p.units) {
    case 8:
      if constexpr (plans_units<W>(8)) return Launcher<8, false>::run(p, a, s);
      break;
    case 16:
      if constexpr (plans_units<W>(16)) return Launcher<16, false>::run(p, a, s);
      break;
    case 32:
      if constexpr (plans_units<W>(32)) return Launcher<32, false>::run(p, a, s);
      break;
  }
  return cudaErrorInvalidValue;
}

// ---- Shared by the persistent launches that slice several weights by columns
// (rollout_fwd.cuh, beam_search.cu) ----

// Per weight type, the units (NC = 4U columns per slice) a plan that deals
// several weights' columns out as slices tries, widest first, before it
// streams.
template <typename W>
struct SliceUnits;
template <>
struct SliceUnits<__nv_bfloat16> {
  static constexpr int N = 3;
  static constexpr int U[N] = {32, 16, 8};
};
template <>
struct SliceUnits<float> {
  static constexpr int N = 2;
  static constexpr int U[N] = {16, 8};
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Columns [c0, c0 + NC) of a row-major [K, C] weight (row stride ld) as a
// chain slice source.
template <typename W>
struct ColSlice {
  const W* w;
  int K, C, ld, c0;
  __device__ __forceinline__ const W* operator()(int n, int k) const {
    return k < K && c0 + n < C ? w + (size_t)k * ld + c0 + n : nullptr;
  }
  __device__ __forceinline__ const void* base() const { return w; }
};

__device__ __forceinline__ float sum4(float v) {  // over the 4 lanes of a row
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// 16-byte accesses of four consecutive floats (plain, coherent loads: the
// data may have been written earlier in this launch).
__device__ __forceinline__ void ld4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// A block's staging of its slices and its product of a row tile, on
// chain.cuh's mma.sync from ldmatrix: load(src, K) stages the stationary
// slice of depth K (no-op when streaming), product(a, lda, row0, nrows, K,
// src) returns the float32 tile Cs [ROWS][CLD] of rows row0 .., scratch()
// phase B's few ints.
template <class Tl>
struct ChainStage {
  static constexpr int ROWS = CHAIN_BR, CLD = ChainSmem<Tl>::CLD;
  unsigned char* base;
  int H;
  template <class Src>
  __device__ void load(const Src& src, int K) const {
    if constexpr (!Tl::STREAM) chain_load_slice(ChainSmem<Tl>(base, K), src);
  }
  template <typename AT, class Src>
  __device__ float* product(const AT* a, int lda, int row0, int nrows, int K,
                            const Src& src) const {
    const ChainSmem<Tl> sm(base, K);
    chain_product_src<Tl>(sm, a, lda, row0, nrows, K, src);
    return sm.Cs;
  }
  __device__ int* scratch() const { return reinterpret_cast<int*>(ChainSmem<Tl>(base, H).Cs); }
};

// Raises clock[k] to the %globaltimer nanoseconds now (thread 0 of the
// block; a null clock costs a branch): every block marking slot k leaves the
// latest block's time there. The persistent decodes' optional phase clocks.
__device__ __forceinline__ void clock_mark(unsigned long long* clock, int k) {
  if (clock && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    atomicMax(clock + k, ns);
  }
}

// ---- The per-row picks and the LSTM cell of the persistent decodes
// (beam_search.cu, decode.cu) ----

// (v, i) ranks before (v2, i2): a larger value, or an equal one at a lower
// index, as lax.top_k orders them.
// (Bitwise, not short-circuit: the compiler turns || and && on data into
// branches and reconvergence points, which made the beam's top-B rounds take
// five times as long.)
__device__ __forceinline__ bool ranks_before(float v, int i, float v2, int i2) {
  return (v > v2) | ((v == v2) & (i < i2));
}

// (value, lowest index) over the lanes whose xor masks are below ``width``.
__device__ __forceinline__ void argmax_width(float& v, int& i, int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, off);
    const int i2 = __shfl_xor_sync(FULL, i, off);
    const bool take = ranks_before(v2, i2, v, i);
    v = take ? v2 : v;
    i = take ? i2 : i;
  }
}

// The gate parts of four consecutive units j .. j + 3 of one row, [gate][unit]:
// the x-gate row, the recurrent pre-activation, the bias (each 4 x 4 from
// four 16-byte loads) and c.
struct Cell4 {
  float x[4][4], p[4][4], b[4][4], c[4];
};

__device__ __forceinline__ void ld_gates(float (&v)[4][4], int H, const float* p) {
#pragma unroll
  for (int g = 0; g < 4; ++g) ld4(v[g], p + g * H);
}

__device__ __forceinline__ void zero4(float (&v)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = 0.f;
}

// A cell's operands: p null for a zero state's product, c_in null for c = 0.
__device__ __forceinline__ void cell_load(Cell4& in, int H, const float* x, const float* p,
                                          const float* b, const float* c_in) {
  ld_gates(in.x, H, x);
  ld_gates(in.b, H, b);
  if (p) {
    ld_gates(in.p, H, p);
  } else {
#pragma unroll
    for (int g = 0; g < 4; ++g) zero4(in.p[g]);
  }
  if (c_in)
    ld4(in.c, c_in);
  else
    zero4(in.c);
}

// The LSTM advance from gate pre-activations x + p + b (the TPU kernel's
// order) -> h and c. Where two phases compute the same cell from the same
// operands, so both get the same bits (explicit fmaf: no contraction choice
// left to the compiler).
__device__ __forceinline__ void cell_math(const float (&x)[4][4], const Cell4& in, float (&h)[4],
                                          float (&c)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float gi = sigmoid(x[0][u] + in.p[0][u] + in.b[0][u]);
    const float gf = sigmoid(x[1][u] + in.p[1][u] + in.b[1][u]);
    const float gg = tanhf(x[2][u] + in.p[2][u] + in.b[2][u]);
    const float go = sigmoid(x[3][u] + in.p[3][u] + in.b[3][u]);
    c[u] = fmaf(gf, in.c[u], gi * gg);
    h[u] = go * tanhf(c[u]);
  }
}

// cell_math on loaded operands, h stored in the weight type and c in float32.
template <typename W>
__device__ __forceinline__ void cell_store(const Cell4& in, W* h_out, float* c_out) {
  float h[4], c[4];
  cell_math(in.x, in, h, c);
  st4(h_out, h);
  st4(c_out, c);
}

// A recurrent product's epilogue: the tile's columns [c0, c0 + lim) to the
// pre-activation scratch out [nrows, ld], four consecutive columns a thread.
template <class Tl>
__device__ void pre_epilogue(float* out, int ld, int nrows, const float* Cs, int cld, int c0,
                             int lim, int row0) {
  constexpr int Q = Tl::NC / 4, RS = CHAIN_THREADS / Q;
  const int c = threadIdx.x % Q * 4;
  if (c >= lim) return;
  for (int r = threadIdx.x / Q; r < CHAIN_BR && row0 + r < nrows; r += RS) {
    float v[4];
    ld4(v, Cs + r * cld + c);
    st4(out + (size_t)(row0 + r) * ld + c0 + c, v);
  }
}

// Calls f(slice, row tile) for this block's items of a phase: stationary, the
// row tiles group, group + groups, ... of its own slice (none when the block
// serves the other phase); streaming, the items blockIdx.x, + gridDim.x, ...
// of all slices x tiles.
template <bool kStream, class Fn>
__device__ __forceinline__ void for_items(int my_slice, int group, int groups, int slices,
                                          int tiles, const Fn& f) {
  if constexpr (kStream) {
    for (int i = blockIdx.x; i < slices * tiles; i += gridDim.x) f(i % slices, i / slices);
  } else {
    if (my_slice < 0) return;
    for (int rt = group; rt < tiles; rt += groups) f(my_slice, rt);
  }
}

}  // namespace
}  // namespace icrl
