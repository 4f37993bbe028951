// Building blocks shared by the decode kernels (greedy_decode.cu,
// beam_search.cu, sample_decode.cu) and the training chains (lstm_chain.cu,
// gru_chain.cu).
//
// Every product the TPU kernels compute in their own bodies (the h0 projection,
// the LSTM and GRU gates, the vocab head, the critic cell, the value MLP),
// except the training chains' (their persistent kernels and wgmma products,
// chain.cuh and wgmma.cuh; with float32 weights their products after the
// loop still run here), runs through
// a 64 x 64 block tile with float32 accumulation: on the tensor
// cores (WMMA, gemm_tile_tc) when both operands are bf16 values, else on the
// CUDA cores (gemm_tile). Weights are float or __nv_bfloat16 (template W);
// the activation operand is rounded to W where the TPU kernel casts it, so
// a product of two bf16 values is exact in float32 and only the order of
// the float32 sums differs from the plain PyTorch versions.
//
// Bound on Hopper: at decode batch sizes each step streams the weights
// (about 6.5 MB in bf16 at COCO width) from L2 once per 64-row tile, and a
// tile's time is set by how fast it can dispatch its staging and WMMA
// instructions and wait out each depth step, far below the tensor cores'
// rate (about 90 TFLOP/s for a large bf16 product on an H100). The design
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
constexpr int UNITS = BN / 4;   // hidden units per LSTM block (four gate columns each)
constexpr int ROWS_PER_BLOCK = NT / 32;  // row kernels: one warp per row
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

// Store a float32 value as T (rounding to bf16 for T = __nv_bfloat16).
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The block tile product, acc[i][j] = sum_k A[m, k] * B[k, c] for the tile
// row m = ty + 16 i and column c = tx + 16 j, (tx, ty) = (threadIdx.x % 16,
// threadIdx.x / 16). Row m of A is row arow(m) of the row-major [*, lda]
// array a (-1: a row of zeros); column c of B is column bcol(c) of the
// row-major [K, ldb] array w (-1: a column of zeros). Each thread stages
// the same A rows and B column at every depth step, so it resolves them
// once, before the depth loop; inside it only the depth offset moves.
//
// On the CUDA cores, for float32 operands (and greedy's float32-feature h0
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

// gemm_tile on the tensor cores, for bf16 weights: A is rounded to bf16 as
// it is staged, which is the TPU kernels' cast of the activation before a
// product (exact for A already in bf16), so every product is of two bf16
// values, exact in float32. Each depth step stages a 64 x 64 slice of A and
// a 64 x 64 slice of B in shared memory; the 8 warps (4 x 2) each own a
// 16 x 32 block of the tile and run WMMA m16n16k16 with float32
// accumulators, which go back through shared memory into gemm_tile's
// acc[i][j] layout, so every epilogue stays as it is.
//
// Staging is vectorised, because address arithmetic and one load per
// element made the depth step instruction-bound (~580 instructions per
// warp for 16 HMMA): a thread moves A as 16-byte chunks of 8 depths of one
// row, and B as bf16 pairs of two adjacent columns, from pointers resolved
// once per tile, and loads the next depth step into registers while this
// one's products run. That needs K % 8 == 0, lda % 8 == 0 (bf16 A) or
// % 4 == 0 (float32 A), 16-byte aligned A, an even ldb, and
// bcol(2p + 1) == bcol(2p) + 1 with bcol(2p) even: the wrappers check the
// widths.
constexpr int TBK = 64;

template <class AT, class ARow, class BCol>
__device__ __forceinline__ void gemm_tile_tc(float (&acc)[4][4], int K, const AT* __restrict__ a,
                                             int lda, const ARow& arow,
                                             const __nv_bfloat16* __restrict__ w, int ldb,
                                             const BCol& bcol) {
  namespace wmma = nvcuda::wmma;
  constexpr int KC = TBK / 8;                // 16-byte chunks per slice row of A
  constexpr int A_CHUNKS = BM * KC / NT;     // chunks per thread
  constexpr int PAIRS = BN / 2;              // column pairs per slice row of B
  constexpr int B_ROWS = TBK * PAIRS / NT;   // B rows per thread
  __shared__ __align__(128) __nv_bfloat16 As[BM][TBK + 8];
  __shared__ __align__(128) __nv_bfloat16 Bs[TBK][BN + 8];
  __shared__ __align__(128) float Cs[BM][BN + 4];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = (warp / 2) * 16, wc = (warp % 2) * 32;
  const int kc = tid % KC, am0 = tid / KC;      // A: chunk kc of rows am0 + i * NT / KC
  const int bp = tid % PAIRS, bk0 = tid / PAIRS;  // B: pair bp of rows bk0 + i * NT / PAIRS
  const AT* ap[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int r = arow(am0 + i * (NT / KC));
    ap[i] = r >= 0 ? a + (size_t)r * lda + kc * 8 : nullptr;
  }
  const int col = bcol(2 * bp);
  const __nv_bfloat16* bptr = col >= 0 ? w + (size_t)bk0 * ldb + col : nullptr;
  const size_t bstep = (size_t)(NT / PAIRS) * ldb;
  // the next depth step's slice is loaded into registers while this one's
  // products run
  uint4 ra[A_CHUNKS];
  unsigned rb[B_ROWS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i)
      ra[i] = ap[i] && k0 + kc * 8 < K ? load8_bf16(ap[i] + k0) : make_uint4(0, 0, 0, 0);
    const __nv_bfloat16* bk = bptr ? bptr + (size_t)k0 * ldb : nullptr;
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i)
      rb[i] = bk && k0 + bk0 + i * (NT / PAIRS) < K
                  ? __ldg(reinterpret_cast<const unsigned*>(bk + i * bstep))
                  : 0u;
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += TBK) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i)
      *reinterpret_cast<uint4*>(&As[am0 + i * (NT / KC)][kc * 8]) = ra[i];
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i)
      *reinterpret_cast<unsigned*>(&Bs[bk0 + i * (NT / PAIRS)][2 * bp]) = rb[i];
    __syncthreads();
    if (k0 + TBK < K) fetch(k0 + TBK);
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &As[wr][ks], TBK + 8);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &Bs[ks][wc + 16 * f], BN + 8);
        wmma::mma_sync(c[f], fa, fb, c[f]);
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

template <typename W>
constexpr bool kIsBf16 = std::is_same<W, __nv_bfloat16>::value;

// The tile product on the tensor cores (kTC: bf16 weights, A rounded to
// bf16), else on the CUDA cores (no rounding).
template <bool kTC, class AT, class W, class ARow, class BCol>
__device__ __forceinline__ void gemm(float (&acc)[4][4], int K, const AT* a, int lda,
                                     const ARow& arow, const W* w, int ldb, const BCol& bcol) {
  if constexpr (kTC) {
    static_assert(kIsBf16<W>, "the tensor-core tile takes bf16 weights");
    gemm_tile_tc(acc, K, a, lda, arow, w, ldb, bcol);
  } else {
    gemm_tile(acc, K, a, lda, arow, w, ldb, bcol);
  }
}

// out[r, c] = sum_k A[r, k] * w[k, c] (+ bias[c])   (A [M, K] of AT, w [K, N] of W;
// bias may be null; out [M, N] of OT). kRoundA rounds A to W first (the TPU
// kernels' cast of the activation); it has an effect only for bf16 weights
// and runs the product on the tensor cores, as does A already in bf16.
// OT = W stores the result rounded to W, for an output that is only ever
// read as a product's rounded operand (an h0).
template <typename W, typename AT, bool kRoundA, typename OT = float>
__global__ void __launch_bounds__(NT) linear_kernel(int M, int K, int N,
                                                    const AT* __restrict__ A,
                                                    const W* __restrict__ w,
                                                    const float* __restrict__ bias,
                                                    OT* __restrict__ out) {
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  auto arow = [&](int m) { return row0 + m < M ? row0 + m : -1; };
  auto bcol = [&](int c) { return col0 + c < N ? col0 + c : -1; };
  float acc[4][4];
  gemm<(kIsBf16<W> && (kRoundA || std::is_same<AT, W>::value))>(acc, K, A, K, arow, w, N,
                                                                 bcol);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < M && c < N) st(out + (size_t)r * N + c, bias ? acc[i][j] + bias[c] : acc[i][j]);
    }
  }
}

template <typename W, typename AT, bool kRoundA, typename OT = float>
cudaError_t launch_linear(int M, int K, int N, const AT* A, const W* w, const float* bias,
                          OT* out, cudaStream_t s) {
  linear_kernel<W, AT, kRoundA, OT><<<dim3(cdiv(M, BM), cdiv(N, BN)), NT, 0, s>>>(M, K, N, A, w,
                                                                                  bias, out);
  return cudaGetLastError();
}

// The gate math and c/h update of one LSTM cell, from the gate pre-activation
// parts x_part (token row of the x-gate table xg = emb @ wi) and h_part
// (rnd(h) @ wh), added in the TPU kernels' order: x_part + h_part + b. The
// new h is stored in the weight type HT: every later read of it is a
// product's operand, which the TPU kernels round to that type first.
template <typename HT>
__device__ __forceinline__ void lstm_update(int H, int j, const float* x_part,
                                            const float (&h_part)[4], const float* b,
                                            float c, HT* h_out, float* c_out) {
  const float gi = sigmoid(x_part[j] + h_part[0] + b[j]);
  const float gf = sigmoid(x_part[H + j] + h_part[1] + b[H + j]);
  const float gg = tanhf(x_part[2 * H + j] + h_part[2] + b[2 * H + j]);
  const float go = sigmoid(x_part[3 * H + j] + h_part[3] + b[3 * H + j]);
  const float c_new = gf * c + gi * gg;
  *c_out = c_new;
  st(h_out, go * tanhf(c_new));
}

// One LSTM cell over ``rows`` rows. The input product x @ wi of a token is a
// row of the x-gate table xg [V, 4H], computed once per weights (the TPU
// kernels compute it every step from a one-hot matmul); the recurrent product
// rnd(h) @ wh runs here:
//   token of row r: tok[(r / tok_div) * tok_stride];
//   state row s = state_idx ? state_idx[r] : r / state_div, h = h_in[s],
//   c = c_in[s]; null h_in / c_in are zeros (then no product runs).
// h is kept in the weight type W (rounded, as the products read it), c in
// float32.
// A block owns 64 rows and 16 hidden units j, i.e. the four gate columns
// {j, H+j, 2H+j, 3H+j} of wh; each thread then holds all four gates of one
// (row, j) and applies the gate math and the c/h update in its epilogue.
template <typename W>
struct LstmArgs {
  int rows, H;
  const int* tok;
  int tok_div, tok_stride;
  const float* xg;      // [V, 4H] x-gate table
  const W* h_in;        // [*, H] or null
  const float* c_in;    // [*, H] or null
  const int* state_idx; // [rows] or null
  int state_div;
  const W* wh;          // [H, 4H]
  const float* b;       // [4H]
  W* h_out;             // [rows, H]
  float* c_out;         // [rows, H]
};

template <typename W>
__global__ void __launch_bounds__(NT) lstm_kernel(LstmArgs<W> a) {
  __shared__ int s_tok[BM];
  __shared__ int s_state[BM];
  const int row0 = blockIdx.x * BM, j0 = blockIdx.y * UNITS, G = 4 * a.H;
  if (threadIdx.x < BM) {
    const int r = row0 + threadIdx.x;
    s_tok[threadIdx.x] = r < a.rows ? a.tok[(size_t)(r / a.tok_div) * a.tok_stride] : -1;
    s_state[threadIdx.x] = r < a.rows ? (a.state_idx ? a.state_idx[r] : r / a.state_div) : 0;
  }
  __syncthreads();
  auto arow = [&](int m) { return s_tok[m] < 0 ? -1 : s_state[m]; };
  auto bcol = [&](int c) {  // tile column c = gate * UNITS + unit
    const int j = j0 + c % UNITS;
    return j < a.H ? (c / UNITS) * a.H + j : -1;
  };
  float acc[4][4];
  gemm<kIsBf16<W>>(acc, a.h_in ? a.H : 0, a.h_in, a.H, arow, a.wh, G, bcol);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, j = j0 + tx;
  if (j >= a.H) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i, r = row0 + m;
    if (r >= a.rows) continue;
    const float c = a.c_in ? a.c_in[(size_t)s_state[m] * a.H + j] : 0.f;
    lstm_update(a.H, j, a.xg + (size_t)s_tok[m] * G, acc[i], a.b, c,
                a.h_out + (size_t)r * a.H + j, a.c_out + (size_t)r * a.H + j);
  }
}

template <typename W>
cudaError_t launch_lstm(const LstmArgs<W>& a, cudaStream_t s) {
  lstm_kernel<W><<<dim3(cdiv(a.rows, BM), cdiv(a.H, UNITS)), NT, 0, s>>>(a);
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

// Warp-wide (max value, lowest index) reduction: ties go to the lower index,
// as jnp.argmax and lax.top_k break them.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, off);
    const int i2 = __shfl_xor_sync(FULL, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

// ---- The decode loops' shared pieces (greedy_decode.cu, sample_decode.cu) ----

// out[r, 0] = start[r] for the [n, T] token output.
__global__ void fill_start_kernel(int n, int T, const int* __restrict__ start,
                                  int* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n) out[(size_t)r * T] = start[r];
}

// The decode loops' workspace: h in the weight type (only ever read as a
// product's rounded operand), c and the logits in float32.
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

// Return the CUDA error code (a cudaError_t, or the int a host loop
// returns) of expr from the enclosing function unless it is 0.
#define ICRL_CHECK(expr)                          \
  do {                                            \
    const int err_ = (int)(expr);                 \
    if (err_ != 0) return err_;                   \
  } while (0)

}  // namespace
}  // namespace icrl
