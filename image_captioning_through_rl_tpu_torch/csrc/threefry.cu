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
//
// A column window: a draw can be columns [col0, col0 + cols) of a global
// draw whose rows are `width` wide (a rank's vocabulary block of a
// vocab-sharded head). Element (r, c) of a plane then hashes counter
// counter0 + r * width + c, with counter0 = the first global row's first
// counter plus col0; a whole-width draw (cols == width) is the contiguous
// plane counter0 + i, its own instantiation with no division.
#include <algorithm>

#include "common.cuh"
#include "threefry.cuh"

namespace icrl {
namespace {

constexpr int MAX_KEYS = 32;  // keys per launch (kernel parameters, by value)
struct Keys {
  unsigned k[2 * MAX_KEYS];
};

// out[s, j] for s < keys, j < plane: Gumbel noise (float) or the raw bits of
// the counter of element j = r * cols + c, counter0 + r * width + c
// (counter0: the first global row's first counter plus the window's first
// column, so a rank's rows and columns of a larger draw hash as in the whole
// draw); kWindow false: cols == width, the counter counter0 + j.
template <bool kGumbel, bool kWindow>
__global__ void threefry_kernel(Keys keys, int nkeys, unsigned plane, unsigned counter0,
                                unsigned cols, unsigned width, void* out) {
  const size_t total = (size_t)nkeys * plane;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int s = (int)(i / plane);
    const unsigned j = (unsigned)(i % plane);
    const unsigned counter = kWindow ? counter0 + (j / cols) * width + j % cols : counter0 + j;
    const unsigned bits = random_bits(keys.k[2 * s], keys.k[2 * s + 1], counter);
    if constexpr (kGumbel)
      static_cast<float*>(out)[i] = gumbel_from_bits(bits);
    else
      static_cast<unsigned*>(out)[i] = bits;
  }
}

}  // namespace
}  // namespace icrl

extern "C" {

// nkeys draws of `plane` elements each (rows of `cols` columns), key s at
// keys[2 s], keys[2 s + 1] (host memory, uint32), element r * cols + c
// hashing counter counter0 + r * width + c (the last counter < 2^32: the
// caller checks the global draw); out (device) is float32 Gumbel noise when
// gumbel != 0, else the uint32 bits, [nkeys, plane]. Returns 0 or the first
// CUDA error of a launch.
int icrl_threefry(int nkeys, const unsigned* keys, long long plane, long long counter0,
                  long long cols, long long width, int gumbel, void* out, void* stream) {
  using namespace icrl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k0 = 0; k0 < nkeys; k0 += MAX_KEYS) {
    const int nk = std::min(MAX_KEYS, nkeys - k0);
    Keys kv;
    for (int i = 0; i < 2 * nk; ++i) kv.k[i] = keys[2 * k0 + i];
    const size_t total = (size_t)nk * (size_t)plane;
    const int blocks = (int)std::min<size_t>((total + 255) / 256, 132 * 64);
    const size_t offset = (size_t)k0 * (size_t)plane;
    const unsigned p = (unsigned)plane, c0 = (unsigned)counter0, c = (unsigned)cols,
                   w = (unsigned)width;
    float* f = static_cast<float*>(out) + offset;
    unsigned* u = static_cast<unsigned*>(out) + offset;
    if (gumbel && cols == width)
      threefry_kernel<true, false><<<blocks, 256, 0, st>>>(kv, nk, p, c0, c, w, f);
    else if (gumbel)
      threefry_kernel<true, true><<<blocks, 256, 0, st>>>(kv, nk, p, c0, c, w, f);
    else if (cols == width)
      threefry_kernel<false, false><<<blocks, 256, 0, st>>>(kv, nk, p, c0, c, w, u);
    else
      threefry_kernel<false, true><<<blocks, 256, 0, st>>>(kv, nk, p, c0, c, w, u);
    ICRL_CHECK(cudaGetLastError());
  }
  return 0;
}

}  // extern "C"
