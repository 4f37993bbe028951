// A bf16 matrix product on Hopper's warpgroup MMA (wgmma), for the large
// products of the chains' backward (lstm_chain.cuh, gru_chain.cu): the LSTM's
// d[wi; wh] = rnd([x; h_prev])^T rnd(dg) over all T N rows and dx =
// rnd(dg) @ rnd(wi)^T, the GRU's dwi, dwh and dx alike; and the x-gate
// tables emb @ wi (+ b) of every recurrent kernel (token_gates.cu).
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
  if constexpr (NB == 1)
    return v[0];
  else
    return z ? v[1] : v[0];
}

template <bool kAMN, bool kBMN, class ASrc, class BSrc, int NB>
__global__ void __launch_bounds__(wg::THREADS, 1)
    wgmma_gemm_kernel(int N, int K, WgmmaProblems<ASrc, BSrc, NB> pr) {
  extern __shared__ uint8_t wg_smem[];
  const int z = NB > 1 ? (int)blockIdx.z : 0;
  const int M = pick<NB>(pr.M, z);
  const ASrc asrc = pick<NB>(pr.a, z);
  const BSrc bsrc = pick<NB>(pr.b, z);
  float* __restrict__ out = pick<NB>(pr.out, z);
  const float* __restrict__ bias = pick<NB>(pr.bias, z);
  const uint32_t base = (wg::smem_addr(wg_smem) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wgi = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int m0 = blockIdx.x * wg::BM, n0 = blockIdx.y * wg::BN;
  if (m0 >= M) return;  // past the shorter product's rows
  const int nk = (K + wg::BK - 1) / wg::BK;

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
                 out);
      } else {
        const int r = q / 8, c = q % 8;  // a 128-byte row of 64 k, chunk c
        const uint32_t off = r * 128 + ((c ^ (r & 7)) << 4);
        wg::cp16(dst + off, k0 + 8 * c < K ? src(i0 + r, k0 + 8 * c) : nullptr, out);
      }
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tid + i * wg::THREADS;
      chunk(std::integral_constant<bool, kAMN>{}, sa, asrc, m0, M, q);
      chunk(std::integral_constant<bool, kBMN>{}, sb, bsrc, n0, N, q);
    }
  };

  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

#pragma unroll
  for (int s = 0; s < wg::STAGES - 2; ++s) {
    if (s < nk) load(s, s);
    wg::cp_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    wg::cp_wait<wg::STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the slot refilled now was last read by the wgmma group of kc - 2,
    // which every warpgroup waited out before this barrier
    if (kc + wg::STAGES - 2 < nk) load(kc + wg::STAGES - 2, (kc + wg::STAGES - 2) % wg::STAGES);
    wg::cp_commit();
    const uint32_t sa = base + (kc % wg::STAGES) * wg::STAGE_BYTES, sb = sa + wg::A_BYTES;
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

// kAMN, kBMN: whether A, B are MN-major (a k row of the operand holds
// consecutive m or n), else K-major; B follows A unless given.
template <bool kAMN, bool kBMN = kAMN, class ASrc, class BSrc, int NB>
cudaError_t launch_wgmma_batch(int N, int K, const WgmmaProblems<ASrc, BSrc, NB>& pr,
                               cudaStream_t s) {
  auto kernel = wgmma_gemm_kernel<kAMN, kBMN, ASrc, BSrc, NB>;
  // the shared-memory opt-in, once per device for this kernel: small calls
  // (an x-gate table takes ~11 us) should not pay a driver call each
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wg::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
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

}  // namespace
}  // namespace icrl
