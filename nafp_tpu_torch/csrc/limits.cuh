// The mask value, the row order and the limits that every kernel of csrc/
// shares (mma_tile.cuh, warp_select.cuh and the scans built on them).
#pragma once

namespace nafp {

constexpr float NEG = -1e30f;        // additive mask value of the TPU kernels
constexpr int NO_ROW = 0x7fffffff;   // row of an empty top-k slot
constexpr int MAX_K = 128;
constexpr int MAX_D = 256;

// Order: (score, row) pairs compare by score, then by lower row, as
// jax.lax.top_k resolves ties.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

}  // namespace nafp
