// JAX's partitionable threefry bits and its Gumbel map, as device functions.
//
// The CUDA form of the two helpers of the TPU kernel
// image_captioning_through_rl_tpu/ops/pallas_sample.py (threefry2x32_bits,
// gumbel_from_bits, lines 90-140). Shared by the noise kernel (threefry.cu)
// and the sampling decode (decode.cu), which recomputes each
// element's noise where it needs it.
//
// Element c of a key's draw is the 20-round threefry-2x32 hash of the 64-bit
// counter (hi 0, lo c) under the key, output y0 ^ y1; the Gumbel map is
// jax.random.gumbel's mode "low": the mantissa-fill uniform
// f = bitcast((bits >> 9) | 0x3f800000) - 1 in [0, 1),
// u = max(tiny, f * (1 - tiny) + tiny), then -log(-log(u)). The hash is native
// uint32 arithmetic, bit for bit JAX's; the logs are logf (not __logf, whose
// error is larger), which may round one ulp away from XLA's log.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace icrl {
namespace {

constexpr float TINY = 1.17549435e-38f;  // np.finfo(np.float32).tiny

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

}  // namespace
}  // namespace icrl
