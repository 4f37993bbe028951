// What follows each of VGG16's 13 convolutions on the card: its bias, its
// ReLU and, where the convolution closes a block, the 2x2 max-pool, in one
// pass over cuDNN's channels-last (NHWC) output.
//
// Replaces no TPU kernel: the JAX package leaves the stack to XLA
// (image_captioning_through_rl_tpu/models/vgg.py, lax.conv_general_dilated),
// which fuses these into its convolutions. The port's convolutions stay on
// cuDNN; without this pass PyTorch adds the bias after cuDNN as a broadcast
// over NCHW, runs the ReLU and the NCHW pool as passes of their own, and
// cuDNN's sm90 kernels, which read and write NHWC, transpose every input in
// and every output back.
//
// What bounds it: bytes. Each element is read once and each output written
// once, with a handful of float operations between: at the batch of 64 the 13
// passes read 867 M and write 574 M bf16 values (2.88 GB, 0.86 ms at 3.35
// TB/s). The design: a thread owns 16 bytes of contiguous channels at one
// output pixel (8 bf16 or 4 float32 values), loads those channels' bias once,
// reads its input with read-only 16-byte loads (four, one a pixel of the 2x2
// window, when it pools), and writes one 16-byte store; one such group a
// thread, as many blocks as the output has groups to cover.
//
// Numerics: relu(x + b) in float32, rounded once to the input's type. A
// pooled output is relu(max over the window(x) + b): rounding and ReLU are
// monotonic, so that equals the maximum of the rounded relu(x + b), bit for
// bit. The ReLU and the maximum are PyTorch's (clamp_min and max_pool2d): a
// NaN passes through, -0 stays -0.
#include "common.cuh"

namespace icrl {
namespace {

constexpr int EPI_THREADS = 256;

// 16 bytes of T as float32 lanes, and back (rounded to nearest even).
template <typename T> struct Lanes;
template <> struct Lanes<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[N]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  // element 2k in the low half of word k, 2k + 1 in the high half
  static __device__ __forceinline__ void split(unsigned w, float& lo, float& hi) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ unsigned join(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[N]) {
    split(v.x, f[0], f[1]);
    split(v.y, f[2], f[3]);
    split(v.z, f[4], f[5]);
    split(v.w, f[6], f[7]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(join(f[0], f[1]), join(f[2], f[3]), join(f[4], f[5]), join(f[6], f[7]));
  }
};

// max_pool2d's comparison: a NaN wins
__device__ __forceinline__ float pool_max(float m, float v) { return v > m || v != v ? v : m; }
// clamp_min(x, 0), PyTorch's ReLU: a NaN and -0 pass through
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// out[i] for the `total` 16-byte groups of the NHWC output (groups channel
// groups a pixel, the fastest index), one a thread: relu(x + b), or with
// kPool the 2x2 window's maximum of x at output pixel (n, h, w) of a
// w_out-wide output, whose input is twice as tall and wide.
template <typename T, bool kPool>
__global__ void __launch_bounds__(EPI_THREADS)
    conv_epilogue_kernel(const uint4* __restrict__ x, const uint4* __restrict__ bias,
                         uint4* __restrict__ out, long long total, int groups, int w_out) {
  using L = Lanes<T>;
  const long long i = (long long)blockIdx.x * EPI_THREADS + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % groups);
  float b[L::N], v[L::N];
  L::unpack(__ldg(bias + g), b);
  if constexpr (kPool) {
    const long long p = i / groups;       // output pixel (n * h_out + h) * w_out + w
    const long long row = p / w_out;      // n * h_out + h: input row 2 row
    const long long w = p - row * w_out;  // input column 2 w
    const long long line = 2LL * w_out * groups;
    const uint4* q = x + (2 * row * line + 2 * w * groups + g);
    const uint4 a0 = __ldg(q), a1 = __ldg(q + groups), a2 = __ldg(q + line),
                a3 = __ldg(q + line + groups);
    float f[L::N];
    L::unpack(a0, v);
    L::unpack(a1, f);
#pragma unroll
    for (int k = 0; k < L::N; ++k) v[k] = pool_max(v[k], f[k]);
    L::unpack(a2, f);
#pragma unroll
    for (int k = 0; k < L::N; ++k) v[k] = pool_max(v[k], f[k]);
    L::unpack(a3, f);
#pragma unroll
    for (int k = 0; k < L::N; ++k) v[k] = pool_max(v[k], f[k]);
  } else {
    L::unpack(__ldg(x + i), v);
  }
#pragma unroll
  for (int k = 0; k < L::N; ++k) v[k] = relu(v[k] + b[k]);
  out[i] = L::pack(v);
}

template <typename T, bool kPool>
int launch_epilogue(long long total, int groups, int w_out, const void* x, const void* bias,
                    void* out, cudaStream_t stream) {
  const long long blocks = (total + EPI_THREADS - 1) / EPI_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  conv_epilogue_kernel<T, kPool><<<(unsigned)blocks, EPI_THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(bias), static_cast<uint4*>(out),
      total, groups, w_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace icrl

extern "C" {

// x: a channels-last [n, c, h, w] tensor (NHWC in memory) of bf16 values
// when bf16 != 0, else float32; bias [c] of the same type; out [n, c, h / 2,
// w / 2] channels-last when pool != 0, else [n, c, h, w] (not x itself).
// c a multiple of 8, h and w even when pool != 0, every pointer 16-byte
// aligned (the wrapper checks). Launches on `stream`, on the current device.
// Returns 0 or the launch's CUDA error.
int icrl_conv_epilogue(int n, int c, int h, int w, int bf16, int pool, const void* x,
                       const void* bias, void* out, void* stream) {
  using namespace icrl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = c / (bf16 ? 8 : 4);
  const int h_out = pool ? h / 2 : h, w_out = pool ? w / 2 : w;
  const long long total = (long long)n * h_out * w_out * groups;
  if (total == 0) return 0;
  if (bf16)
    return pool ? launch_epilogue<__nv_bfloat16, true>(total, groups, w_out, x, bias, out, s)
                : launch_epilogue<__nv_bfloat16, false>(total, groups, w_out, x, bias, out, s);
  return pool ? launch_epilogue<float, true>(total, groups, w_out, x, bias, out, s)
              : launch_epilogue<float, false>(total, groups, w_out, x, bias, out, s);
}

}  // extern "C"
