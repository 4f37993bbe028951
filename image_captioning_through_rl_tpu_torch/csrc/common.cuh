// Building blocks shared by the persistent launches (chain.cuh: the training
// chains, the rollout forward, the beam search, the greedy and sampling
// decodes) and the rest.
//
// The products outside the persistent launches (the float32 x-gate table,
// the float32 chains' products after the loop and the rollout backward's
// float32 heads) run through a 64 x 64 block tile with float32
// accumulation: linear_kernel on the CUDA cores (gemm_tile), view_kernel on
// the tensor cores (WMMA, gemm_view_tc) when both operands are bf16 values,
// else on the CUDA cores. Weights are float or
// __nv_bfloat16 (template W); the activation operand is rounded to W where
// the TPU kernel casts it, so a product of two bf16 values is exact in
// float32 and only the order of the float32 sums differs from the plain
// PyTorch versions.
//
// Bound on Hopper: a tile's time is set by how fast it can dispatch its
// staging and WMMA instructions and wait out each depth step, far below the
// tensor cores' rate (about 90 TFLOP/s for a large bf16 product on an
// H100). The design
// keeps the staging short: each thread resolves the rows and column it
// stages (a gathered state row, a gate-strided weight column) once per tile,
// moves bf16 operands in 16-byte and 4-byte words, and loads the next depth
// step while this one's products run. wgmma, TMA and a deeper pipeline are
// later work.
//
// Everything here lives in an anonymous namespace: each .cu file that
// includes it gets its own copy, so the files link into one library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

#include <type_traits>

namespace icrl {
namespace {

constexpr int BM = 64;          // rows per block tile
constexpr int BN = 64;          // output columns per block tile
constexpr int BK = 16;          // reduction depth per shared-memory stage
constexpr int NT = 256;         // threads per block: 16 x 16, 4 x 4 outputs each
constexpr unsigned FULL = 0xffffffffu;

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

inline size_t align64(size_t x) { return (x + 63) & ~size_t(63); }

// Carves typed regions out of one float32 workspace the wrapper allocated
// (each region starts on a 256-byte boundary).
struct Carver {
  float* base;
  size_t used = 0;
  template <typename T = float>
  T* take(size_t count) {
    T* p = reinterpret_cast<T*>(base + used);
    used += align64((count * sizeof(T) + sizeof(float) - 1) / sizeof(float));
    return p;
  }
};

// A float or bf16 element as float32.
template <typename W> __device__ __forceinline__ float ld(const W* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round to the weight type and back: the TPU kernels' ``x.astype(wdtype)``.
template <typename W> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The block tile product, acc[i][j] = sum_k A[m, k] * B[k, c] for the tile
// row m = ty + 16 i and column c = tx + 16 j, (tx, ty) = (threadIdx.x % 16,
// threadIdx.x / 16). Row m of A is row arow(m) of the row-major [*, lda]
// array a (-1: a row of zeros); column c of B is column bcol(c) of the
// row-major [K, ldb] array w (-1: a column of zeros). Each thread stages
// the same A rows and B column at every depth step, so it resolves them
// once, before the depth loop; inside it only the depth offset moves.
//
// On the CUDA cores, for float32 operands (and a float32 activation
// against bf16 weights): float32 products, no rounding.
template <class AT, class W, class ARow, class BCol>
__device__ __forceinline__ void gemm_tile(float (&acc)[4][4], int K, const AT* __restrict__ a,
                                          int lda, const ARow& arow, const W* __restrict__ w,
                                          int ldb, const BCol& bcol) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  constexpr int A_ROWS = BM * BK / NT, B_ROWS = BK * BN / NT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int akk = tid % BK, am0 = tid / BK, bc = tid % BN, bkk0 = tid / BN;
  int arows[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) arows[i] = arow(am0 + i * (NT / BK));
  const int col = bcol(bc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int k = k0 + akk;
      As[akk][am0 + i * (NT / BK)] =
          arows[i] >= 0 && k < K ? ld(a + (size_t)arows[i] * lda + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int kk = bkk0 + i * (NT / BN), k = k0 + kk;
      Bs[kk][bc] = col >= 0 && k < K ? ld(w + (size_t)k * ldb + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Eight consecutive values of a row of A as bf16, in one 16-byte word (the
// pointer is 16-byte aligned): a bf16 row as it is, a float32 row rounded.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ uint4 load8_bf16(const float* p) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w), pack_bf16x2(y.x, y.y),
                    pack_bf16x2(y.z, y.w));
}

// The depth of a staged slice of the WMMA view products below.
constexpr int TBK = 64;

template <typename W>
constexpr bool kIsBf16 = std::is_same<W, __nv_bfloat16>::value;

// out[r, c] = sum_k A[r, k] * w[k, c] (+ bias[c]), float32 throughout
// (A [M, K], w [K, N], bias may be null, out [M, N]): the x-gate table of
// float32 weights and the rollout backward's recomputed logits.
__global__ void __launch_bounds__(NT) linear_kernel(int M, int K, int N,
                                                    const float* __restrict__ A,
                                                    const float* __restrict__ w,
                                                    const float* __restrict__ bias,
                                                    float* __restrict__ out) {
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  auto arow = [&](int m) { return row0 + m < M ? row0 + m : -1; };
  auto bcol = [&](int c) { return col0 + c < N ? col0 + c : -1; };
  float acc[4][4];
  gemm_tile(acc, K, A, K, arow, w, N, bcol);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < M && c < N) out[(size_t)r * N + c] = bias ? acc[i][j] + bias[c] : acc[i][j];
    }
  }
}

inline cudaError_t launch_linear(int M, int K, int N, const float* A, const float* w,
                                 const float* bias, float* out, cudaStream_t s) {
  linear_kernel<<<dim3(cdiv(M, BM), cdiv(N, BN)), NT, 0, s>>>(M, K, N, A, w, bias, out);
  return cudaGetLastError();
}

// ---- Products with transposed operands (the chains' backward passes) ----
//
// out[m, n] = sum_k A(m, k) * B(k, n), an [M, N] block tile at (m0, n0), with
//   A(m, k) = a[arow(m) * lda + k]   (kAT = false: A row-major, rows through arow)
//   A(m, k) = a[arow(k) * lda + m]   (kAT = true: A = X^T for the array X whose
//                                     row k is row arow(k) of a, as in rnd(x)^T dg)
//   B(k, n) = b[k * ldb + n]         (kBT = false)
//   B(k, n) = b[n * ldb + k]         (kBT = true: B = Y^T, as in dg @ rnd(w)^T)
// arow takes the absolute row index (kAT = false) or depth index (kAT = true)
// and returns -1 outside the product, which reads as zeros.
//
// gemm_view_tc: both operands rounded to bf16 as they are staged (exact for
// bf16 sources), products on the tensor cores (WMMA m16n16k16, float32
// sums). A transposed operand is staged as it lies in memory and read by a
// col_major fragment. Every operand moves in 16-byte chunks of 8 values
// along its contiguous dimension: that dimension's extent and leading
// dimension must be multiples of 8 and the arrays 16-byte aligned (the
// wrappers check the widths).
template <bool kAT, bool kBT, class AT, class BT, class ARow>
__device__ __forceinline__ void gemm_view_tc(float (&acc)[4][4], int M, int N, int K, int m0,
                                             int n0, const AT* __restrict__ a, int lda,
                                             const ARow& arow, const BT* __restrict__ b,
                                             int ldb) {
  namespace wmma = nvcuda::wmma;
  static_assert(BM == TBK && BN == TBK, "the staged tiles are square");
  constexpr int CPR = TBK / 8;               // chunks per staged row
  constexpr int PER = BM * CPR / NT;         // chunks per thread and operand
  __shared__ __align__(128) __nv_bfloat16 As[BM][TBK + 8];  // [m][k], [k][m] if kAT
  __shared__ __align__(128) __nv_bfloat16 Bs[TBK][BN + 8];  // [k][n], [n][k] if kBT
  __shared__ __align__(128) float Cs[BM][BN + 4];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = (warp / 2) * 16, wc = (warp % 2) * 32;
  uint4 ra[PER], rb[PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = tid + i * NT, row = q / CPR, col = (q % CPR) * 8;
      const AT* pa = nullptr;
      if constexpr (kAT) {
        const int r = arow(k0 + row);
        if (r >= 0 && m0 + col < M) pa = a + (size_t)r * lda + m0 + col;
      } else {
        const int r = arow(m0 + row);
        if (r >= 0 && k0 + col < K) pa = a + (size_t)r * lda + k0 + col;
      }
      ra[i] = pa ? load8_bf16(pa) : make_uint4(0, 0, 0, 0);
      const BT* pb = nullptr;
      if constexpr (kBT) {
        if (n0 + row < N && k0 + col < K) pb = b + (size_t)(n0 + row) * ldb + k0 + col;
      } else {
        if (k0 + row < K && n0 + col < N) pb = b + (size_t)(k0 + row) * ldb + n0 + col;
      }
      rb[i] = pb ? load8_bf16(pb) : make_uint4(0, 0, 0, 0);
    }
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TBK) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int q = tid + i * NT, row = q / CPR, col = (q % CPR) * 8;
      *reinterpret_cast<uint4*>(&As[row][col]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[row][col]) = rb[i];
    }
    __syncthreads();
    if (k0 + TBK < K) fetch(k0 + TBK);
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      if constexpr (kAT) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, &As[ks][wr], BM + 8);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if constexpr (kBT) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, &Bs[wc + 16 * f][ks], TBK + 8);
            wmma::mma_sync(c[f], fa, fb, c[f]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, &Bs[ks][wc + 16 * f], BN + 8);
            wmma::mma_sync(c[f], fa, fb, c[f]);
          }
        }
      } else {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &As[wr][ks], TBK + 8);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if constexpr (kBT) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, &Bs[wc + 16 * f][ks], TBK + 8);
            wmma::mma_sync(c[f], fa, fb, c[f]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, &Bs[ks][wc + 16 * f], BN + 8);
            wmma::mma_sync(c[f], fa, fb, c[f]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(&Cs[wr][wc + 16 * f], c[f], BN + 4, wmma::mem_row_major);
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Cs[ty + 16 * i][tx + 16 * j];
}

// gemm_view_tc on the CUDA cores, for float32 weights: no rounding. Each
// operand is staged with neighbouring threads on neighbouring addresses of
// its contiguous dimension.
template <bool kAT, bool kBT, class AT, class BT, class ARow>
__device__ __forceinline__ void gemm_view_f32(float (&acc)[4][4], int M, int N, int K, int m0,
                                              int n0, const AT* __restrict__ a, int lda,
                                              const ARow& arow, const BT* __restrict__ b,
                                              int ldb) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  constexpr int PER = BM * BK / NT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float v = 0.f;
      int m, kk;
      if constexpr (kAT) {
        m = tid % BM, kk = tid / BM + i * (NT / BM);
        const int r = arow(k0 + kk);
        if (r >= 0 && m0 + m < M) v = ld(a + (size_t)r * lda + m0 + m);
      } else {
        kk = tid % BK, m = tid / BK + i * (NT / BK);
        const int r = arow(m0 + m);
        if (r >= 0 && k0 + kk < K) v = ld(a + (size_t)r * lda + k0 + kk);
      }
      As[kk][m] = v;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float v = 0.f;
      int n, kk;
      if constexpr (kBT) {
        kk = tid % BK, n = tid / BK + i * (NT / BK);
        if (n0 + n < N && k0 + kk < K) v = ld(b + (size_t)(n0 + n) * ldb + k0 + kk);
      } else {
        n = tid % BN, kk = tid / BN + i * (NT / BN);
        if (k0 + kk < K && n0 + n < N) v = ld(b + (size_t)(k0 + kk) * ldb + n0 + n);
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// out [M, N] = A @ B (+ out when accumulate), with A and B as in
// gemm_view_tc; aidx (or null for the identity) maps A's gathered index to
// a row of a. On the tensor cores for bf16 weights, else on the CUDA cores.
template <typename W, bool kAT, bool kBT, class AT, class BT>
__global__ void __launch_bounds__(NT) view_kernel(int M, int N, int K, const AT* __restrict__ a,
                                                  int lda, const int* __restrict__ aidx,
                                                  const BT* __restrict__ b, int ldb,
                                                  int accumulate, float* out) {
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lim = kAT ? K : M;
  auto arow = [&](int i) { return i < lim ? (aidx ? aidx[i] : i) : -1; };
  float acc[4][4];
  if constexpr (kIsBf16<W>)
    gemm_view_tc<kAT, kBT>(acc, M, N, K, m0, n0, a, lda, arow, b, ldb);
  else
    gemm_view_f32<kAT, kBT>(acc, M, N, K, m0, n0, a, lda, arow, b, ldb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        float* o = out + (size_t)r * N + c;
        *o = accumulate ? *o + acc[i][j] : acc[i][j];
      }
    }
  }
}

template <typename W, bool kAT, bool kBT, class AT, class BT>
cudaError_t launch_view(int M, int N, int K, const AT* a, int lda, const int* aidx, const BT* b,
                        int ldb, bool accumulate, float* out, cudaStream_t s) {
  view_kernel<W, kAT, kBT, AT, BT><<<dim3(cdiv(M, BM), cdiv(N, BN)), NT, 0, s>>>(
      M, N, K, a, lda, aidx, b, ldb, accumulate ? 1 : 0, out);
  return cudaGetLastError();
}

// Column sums of a float32 [R, C] array, in a fixed order: COLSUM_PARTS
// blocks of rows each sum their share of 32 columns (8 warps over the rows,
// then across the warps in shared memory) into part [COLSUM_PARTS, C], and
// a second pass adds the parts. A bias gradient is the column sum of the
// unrounded gate gradients, as in the TPU kernels.
constexpr int COLSUM_PARTS = 16;

__global__ void __launch_bounds__(NT) colsum_part_kernel(int R, int C, const float* __restrict__ x,
                                                         float* __restrict__ part) {
  __shared__ float sh[NT / 32][33];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32, c = blockIdx.x * 32 + lane;
  const int per = (R + COLSUM_PARTS - 1) / COLSUM_PARTS;
  const int r0 = blockIdx.y * per, r1 = min(R, r0 + per);
  float s = 0.f;
  if (c < C)
    for (int r = r0 + g; r < r1; r += NT / 32) s += x[(size_t)r * C + c];
  sh[g][lane] = s;
  __syncthreads();
  if (g == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) t += sh[i][lane];
    part[(size_t)blockIdx.y * C + c] = t;
  }
}

__global__ void colsum_finish_kernel(int C, const float* __restrict__ part, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float t = 0.f;
  for (int p = 0; p < COLSUM_PARTS; ++p) t += part[(size_t)p * C + c];
  out[c] = t;
}

cudaError_t launch_colsum(int R, int C, const float* x, float* part, float* out, cudaStream_t s) {
  colsum_part_kernel<<<dim3(cdiv(C, 32), COLSUM_PARTS), NT, 0, s>>>(R, C, x, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_finish_kernel<<<cdiv(C, 256), 256, 0, s>>>(C, part, out);
  return cudaGetLastError();
}

// Return the CUDA error code (a cudaError_t, or the int a host loop
// returns) of expr from the enclosing function unless it is 0.
#define ICRL_CHECK(expr)                          \
  do {                                            \
    const int err_ = (int)(expr);                 \
    if (err_ != 0) return err_;                   \
  } while (0)

}  // namespace
}  // namespace icrl
