// The teacher-forced LSTM chain's kernels and host functions, forward and
// backward (lstm_fwd, lstm_bwd), shared by lstm_chain.cu (the chain's C entry
// points) and rollout.cu (the A2C rollout, whose encoders' backward is this
// chain's backward). The design notes are lstm_chain.cu's.
#pragma once

#include "chain.cuh"

namespace icrl {
namespace {

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

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) lstm_fwd_kernel(ChainFwdArgs<W> a) {
  using Tl = ChainTile<W, false, U, 4, kStream>;
  using S = ChainSmem<Tl>;
  constexpr int ROWS = CHAIN_THREADS / U, CELLS = CHAIN_BR / ROWS;
  extern __shared__ __align__(16) unsigned char chain_fwd_smem[];
  const int H = a.H, G = 4 * H, n = a.n, tid = threadIdx.x, u = tid % U;
  const S sm(chain_fwd_smem, H);
  const int slices = (H + U - 1) / U;
  if constexpr (!kStream) chain_load_weights<Tl>(sm, a.wh, H, blockIdx.x * U);
  const size_t NH = (size_t)n * H;
  const int tiles = (n + CHAIN_BR - 1) / CHAIN_BR;
  // this thread's cells: unit j of rows row0 + tid / U + i ROWS; loads read
  // a valid row and unit (the last ones) where the cell lies outside
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
    for (int s = blockIdx.x; s < slices; s += gridDim.x) {
      const int j0 = s * U, j = j0 + u, jc = min(j, H - 1);
      float bias[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) bias[g] = j < H ? a.b[g * H + j] : 0.f;
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
        else if (s + (int)gridDim.x < slices)
          load_tokens(t, blockIdx.y);
        else if (t + 1 < a.T)
          load_tokens(t + 1, blockIdx.y);
        // rnd(h_t): the float32 h0 at t = 0 (rounded as it is staged), then
        // the bf16 copy the step before wrote; float32 weights read the tape
        if (t == 0)
          chain_product<Tl>(sm, a.h0, H, row0, n, H, a.wh, H, j0);
        else if constexpr (kIsBf16<W>)
          chain_product<Tl>(sm, a.h16 + (t % 2) * NH, H, row0, n, H, a.wh, H, j0);
        else
          chain_product<Tl>(sm, a.hbuf + t * NH, H, row0, n, H, a.wh, H, j0);
        __syncthreads();
        // every cell's gate math first, without branches, so the cells'
        // dependent transcendental chains interleave; then the stores
        float gv[CELLS][4], cn[CELLS], hn[CELLS];
#pragma unroll
        for (int i = 0; i < CELLS; ++i) {
          const float* acc = sm.Cs + (cell_row(0, i)) * S::CLD + u;
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
  float* dg;            // [T n, 4H] gate gradients (not with kSumDb)
  __nv_bfloat16* dg16;  // the same rounded to bf16, and rnd(h) entering
  __nv_bfloat16* h16;   //   each step [T n, H] (bf16 weights only; with
                        //   kSumDb h16 is an input)
  float* dh;            // [n, H] dh0 on return
  float* dc;            // [n, H] zero on entry, dc0 on return
  // The A2C rollout's tape options (rollout.cu; read with kSumDb only; zeros
  // give the default): tape16, cbuf and a gate tape in bf16; pre_gates, gates
  // holds the float32 pre-activations (bias in) of steps t_lo .. t_hi - 1
  // only, recomputed for this launch; either way c_new is f c_prev + i g from
  // the gates, as the TPU kernel's _cell_bwd forms it. This launch takes the
  // steps [t_lo, t_hi) (t_hi 0: all T): below the last step, its first carry
  // comes from the dg16 of step t_hi that the launch before wrote, and it
  // adds its db sums to theirs.
  int tape16, pre_gates, t_lo, t_hi;
};

// What the gate gradients of one (step, row, unit) read besides the carry.
struct CellTape {
  float i, f, g, o, c_new, c_prev, dh_up, dc, h;
};

// kSumDb false (the chain's own backward): the recurrence writes rnd(h) into
// h16 and the float32 dg (whose column sums are db). true (the A2C rollout's
// backward, rollout.cu, which has written h16 before): it writes neither and
// sums db itself.
__device__ __forceinline__ float ld_early_nc(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return __uint_as_float((unsigned)v << 16);
}

template <typename W, bool kSumDb>
__device__ __forceinline__ CellTape lstm_cell_tape(const ChainBwdArgs<W>& a, int t, int row,
                                                   int j) {
  const int H = a.H;
  const size_t NH = (size_t)a.n * H, o = (size_t)row * H + j;
  if constexpr (kSumDb) {
    if (a.tape16 || a.pre_gates) {
      const auto* c16 = reinterpret_cast<const __nv_bfloat16*>(a.cbuf);
      const float c_prev = a.tape16 ? ld_early_nc(c16 + t * NH + o) : ld_early_nc(a.cbuf + t * NH + o);
      float q[4];
      if (a.pre_gates) {
        const float* g = a.gates + ((size_t)(t - a.t_lo) * a.n + row) * 4 * H + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = ld_early_nc(g + k * H);
        q[0] = sigmoid(q[0]);
        q[1] = sigmoid(q[1]);
        q[2] = tanhf(q[2]);
        q[3] = sigmoid(q[3]);
      } else {
        const auto* g = reinterpret_cast<const __nv_bfloat16*>(a.gates) +
                        ((size_t)t * a.n + row) * 4 * H + j;
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = ld_early_nc(g + k * H);
      }
      return {q[0], q[1], q[2], q[3], q[1] * c_prev + q[0] * q[2], c_prev,
              ld_early_nc(a.dhs + (size_t)row * a.dhs_row + (size_t)t * a.dhs_step + j),
              ld_early(a.dc + o), 0.f};
    }
  }
  const float* g = a.gates + ((size_t)t * a.n + row) * 4 * H + j;
  return {ld_early_nc(g),
          ld_early_nc(g + H),
          ld_early_nc(g + 2 * H),
          ld_early_nc(g + 3 * H),
          ld_early_nc(a.cbuf + (t + 1) * NH + o),
          ld_early_nc(a.cbuf + t * NH + o),
          ld_early_nc(a.dhs + (size_t)row * a.dhs_row + (size_t)t * a.dhs_step + j),
          ld_early(a.dc + o),
          kIsBf16<W> && !kSumDb ? ld_early_nc(a.hbuf + t * NH + o) : 0.f};
}

// The gate gradients of step t for this thread's cells (unit j of rows
// row0 + tid / U + i ROWS) from their tape and dh = carry + upstream, as the
// TPU kernel's _bwd_kernel forms them; carries dc. All cells' arithmetic
// first, then the stores of the cells that lie inside. With kSumDb the
// cells' gate gradients add into db (per gate) instead of going to dg.
template <typename W, int U, int CELLS, bool kSumDb>
__device__ __forceinline__ void lstm_cells_bwd(const ChainBwdArgs<W>& a,
                                               const CellTape (&tp)[CELLS],
                                               const float (&carry)[CELLS], int t, int row0,
                                               int j, float (&db)[4]) {
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
    if constexpr (kSumDb) {
#pragma unroll
      for (int g = 0; g < 4; ++g) db[g] += d[q][g];
    } else {
      float* dp = a.dg + r * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) dp[g * H] = d[q][g];
    }
    if constexpr (kIsBf16<W>) {
      __nv_bfloat16* dq = a.dg16 + r * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) dq[g * H] = __float2bfloat16_rn(d[q][g]);
      if constexpr (!kSumDb) a.h16[r * H + j] = __float2bfloat16_rn(tp[q].h);
    }
    a.dc[(size_t)row * H + j] = dcn[q];
  }
}

// The backward recurrence of one chain on this block's slices and row tiles
// (the body of lstm_bwd_kernel, and of the rollout's kernel that runs both
// encoders' chains in one launch, rollout.cu). With kSumDb, db_part
// [row_groups (CHAIN_THREADS / U), 4H] receives each thread's sums of its
// cells' gate gradients over its row tiles and steps, in a fixed order (row
// (g, tid / U) of block (x, g); each entry has one owner); the caller adds
// its rows in order.
template <typename W, int U, bool kStream, bool kSumDb>
__device__ __forceinline__ void lstm_bwd_steps(const ChainBwdArgs<W>& a, unsigned char* smem,
                                               float* db_part) {
  using Tl = ChainTile<W, true, U, 4, kStream>;
  using S = ChainSmem<Tl>;
  constexpr int ROWS = CHAIN_THREADS / U, CELLS = CHAIN_BR / ROWS;
  const int H = a.H, G = 4 * H, n = a.n, tid = threadIdx.x, u = tid % U;
  const S sm(smem, G);
  const int slices = (H + U - 1) / U;
  if constexpr (!kStream) chain_load_weights<Tl>(sm, a.wh, H, blockIdx.x * U);
  const int tiles = (n + CHAIN_BR - 1) / CHAIN_BR;
  const W* dga;
  if constexpr (kIsBf16<W>)
    dga = reinterpret_cast<const W*>(a.dg16);
  else
    dga = a.dg;
  // the tape of this thread's cells of step t in row tile row0 (a valid row
  // and unit, the last ones, where the cell lies outside)
  auto load_tape = [&](CellTape (&tp)[CELLS], int t, int row0, int jc) {
#pragma unroll
    for (int i = 0; i < CELLS; ++i)
      tp[i] = lstm_cell_tape<W, kSumDb>(a, t, min(row0 + tid / U + i * ROWS, n - 1), jc);
  };
  // this thread's db sums of one slice into its db_part row: stored on the
  // first step the recurrence forms (T - 1), added after
  auto flush_db = [&](const float (&db)[4], int j, bool first) {
    if constexpr (kSumDb) {
      if (j >= H) return;
      float* p = db_part + ((size_t)blockIdx.y * ROWS + tid / U) * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) p[g * H] = first ? db[g] : p[g * H] + db[g];
    }
  };
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  // this launch's steps [lo, hi) (kSumDb: a block of them, ChainBwdArgs)
  const int lo = kSumDb ? a.t_lo : 0, hi = kSumDb && a.t_hi ? a.t_hi : a.T;
  // the last step has no carry
  if (hi == a.T) {
    for (int s = blockIdx.x; s < slices; s += gridDim.x) {
      const int j = s * U + u;
      float db[4] = {};
      for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
        CellTape tape[CELLS];
        float zero[CELLS] = {};
        load_tape(tape, a.T - 1, rt * CHAIN_BR, min(j, H - 1));
        lstm_cells_bwd<W, U, CELLS, kSumDb>(a, tape, zero, a.T - 1, rt * CHAIN_BR, j, db);
      }
      flush_db(db, j, true);
    }
  }
  // step t: the carry rnd(dg_t) @ wh^T of this slice's units feeds the gate
  // gradients of step t - 1 (while t - 1 is this launch's); after step 0 it
  // is dh0
  for (int t = hi == a.T ? a.T - 1 : hi; t > lo || t == 0; --t) {
    grid.sync();
    for (int s = blockIdx.x; s < slices; s += gridDim.x) {
      const int j0 = s * U, j = j0 + u;
      float db[4] = {};
      for (int rt = blockIdx.y; rt < tiles; rt += a.row_groups) {
        const int row0 = rt * CHAIN_BR;
        CellTape tape[CELLS];
        if (t > lo) load_tape(tape, t - 1, row0, min(j, H - 1));  // read after the product
        chain_product<Tl>(sm, dga + (size_t)t * n * G, G, row0, n, G, a.wh, H, j0);
        __syncthreads();
        float carry[CELLS];
#pragma unroll
        for (int i = 0; i < CELLS; ++i) carry[i] = sm.Cs[(tid / U + i * ROWS) * S::CLD + u];
        if (t > lo) {
          lstm_cells_bwd<W, U, CELLS, kSumDb>(a, tape, carry, t - 1, row0, j, db);
        } else if (j < H) {
#pragma unroll
          for (int i = 0; i < CELLS; ++i) {
            const int row = row0 + tid / U + i * ROWS;
            if (row < n) a.dh[(size_t)row * H + j] = carry[i];
          }
        }
        __syncthreads();
      }
      if (t > lo) flush_db(db, j, false);
    }
  }
}

template <typename W, int U, bool kStream>
__global__ void __launch_bounds__(CHAIN_THREADS, 1) lstm_bwd_kernel(ChainBwdArgs<W> a) {
  extern __shared__ __align__(16) unsigned char chain_bwd_smem[];
  lstm_bwd_steps<W, U, kStream, false>(a, chain_bwd_smem, nullptr);
}

template <typename W>
struct LstmFwdLaunch {
  template <int U, bool kStream>
  struct At {
    static cudaError_t run(const ChainPlan& p, const ChainFwdArgs<W>& a, cudaStream_t s) {
      return launch_chain(lstm_fwd_kernel<W, U, kStream>, p, a, s);
    }
  };
};

template <typename W>
struct LstmBwdLaunch {
  template <int U, bool kStream>
  struct At {
    static cudaError_t run(const ChainPlan& p, const ChainBwdArgs<W>& a, cudaStream_t s) {
      return launch_chain(lstm_bwd_kernel<W, U, kStream>, p, a, s);
    }
  };
};

// hbuf, cbuf: [(T + 1) n, H], the state entering step t in rows t n .. t n + n
// (the kernel copies h0, c0 [n, H] into the first n rows). hs: [n, T, H],
// the per-step h in the caller's layout, or null. h16: [2, n, H] bf16
// scratch (bf16 weights only). One launch whatever T is.
template <typename W>
int lstm_fwd(int n, int T, int H, const int* tok, const float* xg, const W* wh, const float* b,
             const float* h0, const float* c0, float* hbuf, float* cbuf, float* gates, float* hs,
             __nv_bfloat16* h16, cudaStream_t s) {
  if (n == 0 || T == 0) return 0;
  const ChainPlan p = chain_plan<W, false, 4>(n, H, device_sms());
  const ChainFwdArgs<W> a{n, T, H, p.row_groups, tok, xg, wh, b, h0, c0, hbuf, cbuf, gates, hs,
                          h16};
  return (int)launch_planned<W, false, 4, LstmFwdLaunch<W>::template At>(p, a, s);
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
  const ChainPlan p = chain_plan<W, true, 4>(n, H, device_sms());
  const ChainBwdArgs<W> a{n,    T,    H,     p.row_groups, dhs, dhs_row, dhs_step, hbuf,
                          cbuf, gates, w + (size_t)E * G, dg, dg16, h16,     dh,       dc};
  ICRL_CHECK((launch_planned<W, true, 4, LstmBwdLaunch<W>::template At>(p, a, s)));
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

// lstm_bwd for float32 weights, compiled once (lstm_chain_bwd.cu) for the A2C
// rollout's float32 backward (rollout.cu); bf16 weights run the rollout's
// recurrences as one launch of both chains there.
int lstm_chain_backward(int n, int T, int E, int H, const int* tok, const float* dhs,
                        long dhs_row, long dhs_step, const float* hbuf, const float* cbuf,
                        const float* gates, const float* emb, const float* w, float* dg,
                        float* dh, float* dc, float* part, float* dw, float* db, float* dx,
                        cudaStream_t s);
}  // namespace icrl
