// The A2C rollout's frozen reward network as the persistent rollout forward
// (rollout_fwd.cuh) runs it: fused into the rollout, and alone in its
// reward-only mode (reward_stream.cu, TPU kernel 5). The design notes are
// reward_stream.cu's.
#pragma once

#include "common.cuh"

namespace icrl {
namespace {

// The GRU update of one unit from its input gates gi (a row of the table
// emb @ wi + bi) and recurrent gates gh (rnd(h) @ wh + bh), gate order
// r, z, n, as ops/rnn.gru_cell and the TPU kernel's _gru_step compose it.
__device__ __forceinline__ float gru_update(const float (&gi)[3], const float (&gh)[3], float h) {
  const float r = sigmoid(gi[0] + gh[0]);
  const float z = sigmoid(gi[1] + gh[1]);
  const float n = tanhf(gi[2] + r * gh[2]);
  return (1.f - z) * n + z * h;
}

// The frozen reward network in the kernels' layout.
template <typename W>
struct RewardNet {
  const float* xg;     // [V, 3H] emb @ wi + bi
  const W* wh;         // [H, 3H]
  const float* bh;     // [3H]
  const W* sem_w;      // [H, H]
  const float* sem_b;  // [H]
  const float* vn;     // [n, H] normalised visual embedding of each row
};

}  // namespace
}  // namespace icrl
