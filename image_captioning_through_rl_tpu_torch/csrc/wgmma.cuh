// A bf16 matrix product on Hopper's warpgroup MMA (wgmma), for the large
// products of the chains' backward (lstm_chain.cuh, gru_chain.cu): the LSTM's
// d[wi; wh] = rnd([x; h_prev])^T rnd(dg) over all T N rows and dx =
// rnd(dg) @ rnd(wi)^T, the GRU's dwi, dwh and dx alike; the x-gate tables
// emb @ wi (+ b) of every recurrent kernel (token_gates.cu); and the A2C
// rollout backward's head products (rollout.cu, through the group kernel).
//
// out [M, N] float32 = A [M, K] @ B [K, N] (+ bias [N]), bf16 operands,
// float32 sums, the bias added after them. A
// block owns a 128 x 128 output tile: two consumer warpgroups, each issuing
// wgmma m64n64k16 (two per 16-deep slice, one per 64-column half) on
// operands in shared memory. The operands arrive through a ring of STAGES
// 64-deep slices (32 KB each), filled with cp.async by all 256 threads,
// STAGES - 2 slices ahead of the one being multiplied, one wgmma group kept
// in flight. Every slice lies in shared memory in the 128-byte swizzled
// layout wgmma reads (16-byte chunk c of a 128-byte row r at chunk
// c ^ (r % 8), 1024-byte aligned atoms of 8 rows):
//   K-major (dx's two operands, the table's emb): A row m (B row n) holds
//     64 consecutive k; the operand is [128 rows][128 bytes];
//   MN-major (d[wi; wh]'s two operands, the table's wi): each k row holds 64
//     consecutive m (or n); the operand is two panels [64 k][64 m] of 8 KB,
//     one per 64-wide half, read with that operand's transpose flag set.
// Each operand has its own flag (kAMN, kBMN): its slot layout, descriptor
// and transpose immediate follow it, so a row-major [K, N] weight is read
// as it lies, with no transposed copy.
// Out-of-range rows, columns and depths are zero-filled by cp.async (source
// size 0), and stores are masked, so any M, N and K (multiples of 8) work.
//
// Two launchers: wgmma_gemm_kernel takes one or two products of the same N
// and K (blockIdx.z picks one); wgmma_group_kernel takes a few products of
// any shapes in one flat grid and may cut each one's depth into parts (a
// split-K: part p's sums go to its own float32 slice of the output, which
// the caller adds in the order p = 0, 1, ..., so two calls give the same
// bits). A product whose K is much deeper than its output is wide (the
// rollout's dhw and dw1: 32 tiles each, K = S N) would fill a quarter of
// the card in one piece.
//
// What bounds it: at the chain's shapes (M = 1024, N = 2048, K = 8192 for
// d[wi; wh]; M = 8192, N = 512, K = 2048 for dx) each block reads 64 FLOP
// per byte from L2, so the L2 rate (~5.5 TB/s) caps it near 350 TFLOP/s,
// below the 989 TFLOP/s of the tensor cores; larger tiles, TMA with
// multicast and a producer warp are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace icrl {
namespace {

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 5, THREADS = 256;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when src is null (no byte is read from
// ``valid``, which only stands in for the address).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, const void* valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src ? src : valid), "r"(src ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void mma64x64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void fence_operands(float (&d)[2][32]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[h][i])::"memory");
}

}  // namespace wg

// The operands' sources, by 16-byte chunk: row ``row`` of an operand as it
// lies in memory (an m or n row when K-major, a k row when MN-major) and
// the first of its 8 columns ``col``; null outside the product.
//
// A row of a bf16 row-major [rows, cols] array.
struct DenseRows {
  const __nv_bfloat16* p;
  int rows, cols, ld;
  __device__ __forceinline__ const __nv_bfloat16* operator()(int row, int col) const {
    return row < rows && col < cols ? p + (size_t)row * ld + col : nullptr;
  }
};

// Row k of rnd([x; h_prev]) for d[wi; wh]: columns [0, E) are the embedding
// row of token tok[k], columns [E, E + H) row k of the bf16 h_prev.
struct TokenStateRows {
  const __nv_bfloat16* emb;
  const int* tok;
  const __nv_bfloat16* h;
  int rows, E, H;
  __device__ __forceinline__ const __nv_bfloat16* operator()(int row, int col) const {
    if (row >= rows || col >= E + H) return nullptr;
    return col < E ? emb + (size_t)__ldg(tok + row) * E + col : h + (size_t)row * H + col - E;
  }
};

// Row ``row`` of two bf16 arrays side by side: columns [0, split) from p0,
// whose row is ``row % wrap`` (wrap > 0: rows that repeat, as the rollout's
// features repeat every n tape rows) or ``row``, columns [split, cols) from
// p1. With split = cols it is one dense array.
struct SplitRows {
  const __nv_bfloat16 *p0, *p1;
  int rows, cols, split, ld0, ld1, wrap;
  __device__ __forceinline__ const __nv_bfloat16* operator()(int row, int col) const {
    if (row >= rows || col >= cols) return nullptr;
    if (col >= split) return p1 + (size_t)row * ld1 + col - split;
    return p0 + (size_t)(wrap ? row % wrap : row) * ld0 + col;
  }
};

// A dense bf16 row-major [rows, cols] array with row stride ld, as SplitRows.
inline SplitRows dense_rows(const __nv_bfloat16* p, int rows, int cols, int ld) {
  return SplitRows{p, p, rows, cols, cols, ld, ld, 0};
}

// One or two products that share N and K, one per blockIdx.z: two small
// products (the GRU backward's dwi and dwh, 48 blocks each at COCO width)
// share one launch, so their partial waves of blocks run side by side.
// bias: float32 [N] added to each output column, or null.
template <class ASrc, class BSrc, int NB>
struct WgmmaProblems {
  static_assert(NB == 1 || NB == 2, "one or two products");
  int M[NB];
  ASrc a[NB];
  BSrc b[NB];
  float* out[NB];
  const float* bias[NB];
};

template <int NB, class T>
__device__ __forceinline__ T pick(const T (&v)[NB], int z) {
  // constant indices only: the kernel's parameters stay where they are
  T r = v[0];
#pragma unroll
  for (int i = 1; i < NB; ++i)
    if (z == i) r = v[i];
  return r;
}

// The sums of the output tile (m0, n0) over the 64-deep slices [kc0, kc1)
// of the depth, into acc (zeroed first). base: the ring, 1024-byte aligned;
// valid: any readable address (the source of zero-filled copies).
template <bool kAMN, bool kBMN, class ASrc, class BSrc>
__device__ __forceinline__ void wgmma_tile(uint32_t base, const ASrc& asrc, const BSrc& bsrc,
                                           int M, int N, int K, int m0, int n0, int kc0,
                                           int kc1, const void* valid, float (&acc)[2][32]) {
  const int tid = threadIdx.x, wgi = tid / 128;
  const int nk = kc1 - kc0;

  // one 64-deep slice of both operands into ring slot ``slot``: 1024 chunks
  // of 16 bytes per operand, in the operand's own layout
  auto load = [&](int kc, int slot) {
    const uint32_t sa = base + slot * wg::STAGE_BYTES, sb = sa + wg::A_BYTES;
    const int k0 = kc * wg::BK;
    auto chunk = [&](auto mn_major, uint32_t dst, const auto& src, int i0, int lim, int q) {
      if constexpr (decltype(mn_major)::value) {
        const int kk = q / 16, c = q % 16, p = c / 8, cc = c % 8;  // k row, 16 chunks of m
        const uint32_t off = p * 8192 + kk * 128 + ((cc ^ (kk & 7)) << 4);
        wg::cp16(dst + off, k0 + kk < K && i0 + 8 * c < lim ? src(k0 + kk, i0 + 8 * c) : nullptr,
                 valid);
      } else {
        const int r = q / 8, c = q % 8;  // a 128-byte row of 64 k, chunk c
        const uint32_t off = r * 128 + ((c ^ (r & 7)) << 4);
        wg::cp16(dst + off, k0 + 8 * c < K ? src(i0 + r, k0 + 8 * c) : nullptr, valid);
      }
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tid + i * wg::THREADS;
      chunk(std::integral_constant<bool, kAMN>{}, sa, asrc, m0, M, q);
      chunk(std::integral_constant<bool, kBMN>{}, sb, bsrc, n0, N, q);
    }
  };

#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

#pragma unroll
  for (int s = 0; s < wg::STAGES - 2; ++s) {
    if (s < nk) load(kc0 + s, s);
    wg::cp_commit();
  }
  for (int i = 0; i < nk; ++i) {
    wg::cp_wait<wg::STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the slot refilled now was last read by the wgmma group of i - 2,
    // which every warpgroup waited out before this barrier
    if (i + wg::STAGES - 2 < nk) load(kc0 + i + wg::STAGES - 2, (i + wg::STAGES - 2) % wg::STAGES);
    wg::cp_commit();
    const uint32_t sa = base + (i % wg::STAGES) * wg::STAGE_BYTES, sb = sa + wg::A_BYTES;
    wg::fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < wg::BK / 16; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // K-major: rows of this warpgroup's 64 (A) / this half's 64 (B),
        // depth s. MN-major: the panel of this warpgroup's 64 m (A) / this
        // half's 64 n (B), k rows 16 s ..; its stride offset steps between
        // groups of 8 k rows, its leading offset between 64-wide panels (one
        // panel per instruction here, so that one is not read)
        const uint64_t da = kAMN ? wg::desc(sa + wgi * 8192 + s * 2048, 1024, 1024)
                                 : wg::desc(sa + wgi * 8192 + s * 32, 16, 1024);
        const uint64_t db = kBMN ? wg::desc(sb + h * 8192 + s * 2048, 1024, 1024)
                                 : wg::desc(sb + h * 8192 + s * 32, 16, 1024);
        wg::mma64x64<kAMN, kBMN>(acc[h], da, db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    wg::fence_operands(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg::fence_operands(acc);
  wg::cp_wait<0>();
}

// The tile's sums into out [M, N] (+ bias [N], or null), masked to the
// product.
__device__ __forceinline__ void wgmma_store(const float (&acc)[2][32], float* __restrict__ out,
                                            int M, int N, int m0, int n0,
                                            const float* __restrict__ bias) {
  const int tid = threadIdx.x, wgi = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  // accumulator i of half h: row 16 warp + lane / 4 (+ 8), column
  // 64 h + 8 (i / 4) + 2 (lane % 4) (+ 1)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = m0 + wgi * 64 + warp * 16 + lane / 4 + 8 * ((i % 4) / 2);
      const int c = n0 + h * 64 + 8 * (i / 4) + 2 * (lane % 4);
      if (r < M && c < N)
        *reinterpret_cast<float2*>(out + (size_t)r * N + c) =
            bias ? make_float2(acc[h][i] + bias[c], acc[h][i + 1] + bias[c + 1])
                 : make_float2(acc[h][i], acc[h][i + 1]);
    }
}

template <bool kAMN, bool kBMN, class ASrc, class BSrc, int NB>
__global__ void __launch_bounds__(wg::THREADS, 1)
    wgmma_gemm_kernel(int N, int K, WgmmaProblems<ASrc, BSrc, NB> pr) {
  extern __shared__ uint8_t wg_smem[];
  const int z = NB > 1 ? (int)blockIdx.z : 0;
  const int M = pick<NB>(pr.M, z);
  float* __restrict__ out = pick<NB>(pr.out, z);
  const int m0 = blockIdx.x * wg::BM, n0 = blockIdx.y * wg::BN;
  if (m0 >= M) return;  // past the shorter product's rows
  const uint32_t base = (wg::smem_addr(wg_smem) + 1023u) & ~1023u;
  float acc[2][32];
  wgmma_tile<kAMN, kBMN>(base, pick<NB>(pr.a, z), pick<NB>(pr.b, z), M, N, K, m0, n0, 0,
                         (K + wg::BK - 1) / wg::BK, out, acc);
  wgmma_store(acc, out, M, N, m0, n0, pick<NB>(pr.bias, z));
}

// A few products of any shapes in one launch (up to NP; an unused one has
// M = 0), each with its depth cut into parts[z] pieces of whole 64-deep
// slices, balanced: part p takes slices [p nk / parts, (p + 1) nk / parts)
// of the nk = ceil(K / 64) (ops/fused_rollout.py:split_k_ranges mirrors
// it). Product z owns the blocks [first[z], first[z + 1]), part-major
// (the blocks in flight together share their depth range), then its tiles
// m-fastest; part p writes its sums to out[z] + p M N. A bias takes one part.
template <class ASrc, class BSrc, int NP>
struct WgmmaGroup {
  int M[NP], N[NP], K[NP], parts[NP], first[NP + 1];
  ASrc a[NP];
  BSrc b[NP];
  float* out[NP];
  const float* bias[NP];
};

template <bool kAMN, bool kBMN, class ASrc, class BSrc, int NP>
__global__ void __launch_bounds__(wg::THREADS, 1)
    wgmma_group_kernel(WgmmaGroup<ASrc, BSrc, NP> g) {
  extern __shared__ uint8_t wg_smem[];
  const int bid = blockIdx.x;
  int z = 0, start = 0;
#pragma unroll
  for (int i = 1; i < NP; ++i)
    if (bid >= g.first[i]) {  // an empty product ends where the next starts
      z = i;
      start = g.first[i];
    }
  const int M = pick<NP>(g.M, z), N = pick<NP>(g.N, z), K = pick<NP>(g.K, z);
  const int parts = pick<NP>(g.parts, z);
  const int local = bid - start;
  const int mt = (M + wg::BM - 1) / wg::BM, tiles = mt * ((N + wg::BN - 1) / wg::BN);
  const int p = local / tiles, t = local % tiles;
  const int m0 = (t % mt) * wg::BM, n0 = (t / mt) * wg::BN;
  const int nk = (K + wg::BK - 1) / wg::BK;
  float* __restrict__ out = pick<NP>(g.out, z) + (size_t)p * M * N;
  const uint32_t base = (wg::smem_addr(wg_smem) + 1023u) & ~1023u;
  float acc[2][32];
  wgmma_tile<kAMN, kBMN>(base, pick<NP>(g.a, z), pick<NP>(g.b, z), M, N, K, m0, n0,
                         (int)((long)p * nk / parts), (int)((long)(p + 1) * nk / parts), out,
                         acc);
  wgmma_store(acc, out, M, N, m0, n0, pick<NP>(g.bias, z));
}

// The shared-memory opt-in of a kernel, once per device (small calls, an
// x-gate table takes ~11 us, should not pay a driver call each); ``opted``
// is the kernel's own record, one bit per device.
inline cudaError_t wgmma_opt_in(const void* kernel, std::atomic<unsigned long long>& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (opted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (err == cudaSuccess) opted.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// kAMN, kBMN: whether A, B are MN-major (a k row of the operand holds
// consecutive m or n), else K-major; B follows A unless given.
template <bool kAMN, bool kBMN = kAMN, class ASrc, class BSrc, int NB>
cudaError_t launch_wgmma_batch(int N, int K, const WgmmaProblems<ASrc, BSrc, NB>& pr,
                               cudaStream_t s) {
  auto kernel = wgmma_gemm_kernel<kAMN, kBMN, ASrc, BSrc, NB>;
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = wgmma_opt_in((const void*)kernel, opted);
  if (err != cudaSuccess) return err;
  int m = 0;
  for (int i = 0; i < NB; ++i) m = pr.M[i] > m ? pr.M[i] : m;
  const dim3 grid((m + wg::BM - 1) / wg::BM, (N + wg::BN - 1) / wg::BN, NB);
  kernel<<<grid, wg::THREADS, wg::SMEM_BYTES, s>>>(N, K, pr);
  return cudaGetLastError();
}

template <bool kAMN, bool kBMN = kAMN, class ASrc, class BSrc>
cudaError_t launch_wgmma_gemm(int M, int N, int K, const ASrc& a, const BSrc& b, float* out,
                              cudaStream_t s, const float* bias = nullptr) {
  return launch_wgmma_batch<kAMN, kBMN>(
      N, K, WgmmaProblems<ASrc, BSrc, 1>{{M}, {a}, {b}, {out}, {bias}}, s);
}

// The group's launch: first[] from the shapes and parts (set here), one
// flat grid of every product's tiles and parts.
template <bool kAMN, bool kBMN, class ASrc, class BSrc, int NP>
cudaError_t launch_wgmma_group(WgmmaGroup<ASrc, BSrc, NP> g, cudaStream_t s) {
  auto kernel = wgmma_group_kernel<kAMN, kBMN, ASrc, BSrc, NP>;
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = wgmma_opt_in((const void*)kernel, opted);
  if (err != cudaSuccess) return err;
  g.first[0] = 0;
  for (int i = 0; i < NP; ++i) {
    if (g.M[i] > 0 && (g.parts[i] < 1 || (g.bias[i] && g.parts[i] != 1)))
      return cudaErrorInvalidValue;
    const int tiles = g.M[i] > 0 ? ((g.M[i] + wg::BM - 1) / wg::BM) *
                                       ((g.N[i] + wg::BN - 1) / wg::BN) * g.parts[i]
                                 : 0;
    g.first[i + 1] = g.first[i] + tiles;
  }
  if (g.first[NP] == 0) return cudaSuccess;
  kernel<<<g.first[NP], wg::THREADS, wg::SMEM_BYTES, s>>>(g);
  return cudaGetLastError();
}

}  // namespace
}  // namespace icrl
