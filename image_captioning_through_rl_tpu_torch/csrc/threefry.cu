// JAX's threefry random bits and Gumbel noise on Hopper.
//
// Not a TPU kernel of its own: the CUDA form of the two helpers of the TPU
// kernel image_captioning_through_rl_tpu/ops/pallas_sample.py
// (threefry2x32_bits, gumbel_from_bits, lines 90-140), which make
// jax.random.gumbel's noise under partitionable threefry element by
// element. The A2C rollout reads its [S, N, V] noise from here; the sampling
// decode (TPU kernel fused_sample_decode) will call the same device
// functions.
//
// Element c of key s's draw is the 20-round threefry-2x32 hash of the 64-bit
// counter (hi 0, lo c) under keys[s], output y0 ^ y1; the Gumbel map is
// jax.random.gumbel's mode "low": the mantissa-fill uniform
// f = bitcast((bits >> 9) | 0x3f800000) - 1 in [0, 1),
// u = max(tiny, f * (1 - tiny) + tiny), then -log(-log(u)). The hash is native
// uint32 arithmetic, bit for bit JAX's; the logs are logf (not __logf, whose
// error is larger), which may round one ulp away from XLA's log.
//
// What bounds it: per element ~80 integer and float operations and one
// 4-byte store. At [16, 512, 1004] (8.2 M elements, 33 MB) the two bounds
// are about equal (~10 us each on an H100); the design keeps it one pass,
// one thread per element, keys passed by value (no copy, no sync).
#include <algorithm>

#include "common.cuh"

namespace icrl {
namespace {

constexpr int MAX_KEYS = 32;  // keys per launch (kernel parameters, by value)
constexpr float TINY = 1.17549435e-38f;  // np.finfo(np.float32).tiny

struct Keys {
  unsigned k[2 * MAX_KEYS];
};

__device__ __forceinline__ unsigned rotl(unsigned x, int d) { return (x << d) | (x >> (32 - d)); }

// threefry2x32 of the counter (x0, x1) under (k0, k1): 5 groups of 4 rounds
// with a key injection after each group (jax._src.prng.threefry2x32).
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1, unsigned& x0,
                                             unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

__device__ __forceinline__ unsigned random_bits(unsigned k0, unsigned k1, unsigned c) {
  unsigned x0 = 0u, x1 = c;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float gumbel_from_bits(unsigned bits) {
  const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.f;
  const float u = fmaxf(TINY, f * (1.f - TINY) + TINY);
  return -logf(-logf(u));
}

// out[s, c] for s < keys, c < plane: Gumbel noise (float) or the raw bits.
template <bool kGumbel>
__global__ void threefry_kernel(Keys keys, int nkeys, unsigned plane, void* out) {
  const size_t total = (size_t)nkeys * plane;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int s = (int)(i / plane);
    const unsigned bits = random_bits(keys.k[2 * s], keys.k[2 * s + 1], (unsigned)(i % plane));
    if constexpr (kGumbel)
      static_cast<float*>(out)[i] = gumbel_from_bits(bits);
    else
      static_cast<unsigned*>(out)[i] = bits;
  }
}

}  // namespace
}  // namespace icrl

extern "C" {

// nkeys draws of `plane` elements each (plane < 2^32), key s at
// keys[2 s], keys[2 s + 1] (host memory, uint32); out (device) is float32
// Gumbel noise when gumbel != 0, else the uint32 bits, [nkeys, plane].
// Returns 0 or the first CUDA error of a launch.
int icrl_threefry(int nkeys, const unsigned* keys, long long plane, int gumbel, void* out,
                  void* stream) {
  using namespace icrl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k0 = 0; k0 < nkeys; k0 += MAX_KEYS) {
    const int nk = std::min(MAX_KEYS, nkeys - k0);
    Keys kv;
    for (int i = 0; i < 2 * nk; ++i) kv.k[i] = keys[2 * k0 + i];
    const size_t total = (size_t)nk * (size_t)plane;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 64);
    const size_t offset = (size_t)k0 * (size_t)plane;
    if (gumbel)
      threefry_kernel<true><<<blocks, 256, 0, st>>>(kv, nk, (unsigned)plane,
                                                   static_cast<float*>(out) + offset);
    else
      threefry_kernel<false><<<blocks, 256, 0, st>>>(kv, nk, (unsigned)plane,
                                                    static_cast<unsigned*>(out) + offset);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
