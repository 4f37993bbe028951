// JAX's threefry random bits and Gumbel noise on Hopper.
//
// Not a TPU kernel of its own: it draws whole arrays of the noise that the
// TPU kernel image_captioning_through_rl_tpu/ops/pallas_sample.py makes
// element by element with its helpers threefry2x32_bits and
// gumbel_from_bits (lines 90-140), whose CUDA form is threefry.cuh. The A2C
// rollout reads its [S, N, V] noise from here; the sampling decode
// (decode.cu) computes its noise inline from the same header.
//
// What bounds it: per element ~80 integer and float operations and one
// 4-byte store. At [16, 512, 1004] (8.2 M elements, 33 MB) the two bounds
// are about equal (~10 us each on an H100); the design keeps it one pass,
// one thread per element, keys passed by value (no copy, no sync).
#include <algorithm>

#include "common.cuh"
#include "threefry.cuh"

namespace icrl {
namespace {

constexpr int MAX_KEYS = 32;  // keys per launch (kernel parameters, by value)
struct Keys {
  unsigned k[2 * MAX_KEYS];
};

// out[s, c] for s < keys, c < plane: Gumbel noise (float) or the raw bits of
// counter counter0 + c (counter0: the first global row's first counter, so a
// rank's rows of a larger draw hash as in the whole draw).
template <bool kGumbel>
__global__ void threefry_kernel(Keys keys, int nkeys, unsigned plane, unsigned counter0,
                                void* out) {
  const size_t total = (size_t)nkeys * plane;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int s = (int)(i / plane);
    const unsigned bits = random_bits(keys.k[2 * s], keys.k[2 * s + 1],
                                      counter0 + (unsigned)(i % plane));
    if constexpr (kGumbel)
      static_cast<float*>(out)[i] = gumbel_from_bits(bits);
    else
      static_cast<unsigned*>(out)[i] = bits;
  }
}

}  // namespace
}  // namespace icrl

extern "C" {

// nkeys draws of `plane` elements each, key s at keys[2 s], keys[2 s + 1]
// (host memory, uint32), element c hashing counter counter0 + c
// (counter0 + plane <= 2^32: the caller checks the global draw); out (device) is float32
// Gumbel noise when gumbel != 0, else the uint32 bits, [nkeys, plane].
// Returns 0 or the first CUDA error of a launch.
int icrl_threefry(int nkeys, const unsigned* keys, long long plane, long long counter0,
                  int gumbel, void* out, void* stream) {
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
      threefry_kernel<true><<<blocks, 256, 0, st>>>(kv, nk, (unsigned)plane, (unsigned)counter0,
                                                   static_cast<float*>(out) + offset);
    else
      threefry_kernel<false><<<blocks, 256, 0, st>>>(kv, nk, (unsigned)plane, (unsigned)counter0,
                                                    static_cast<unsigned*>(out) + offset);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
