// Shared device code of the three k-NN index kernels: the dedup top-k selection.
//
// `kround_select` is the GPU form of `kround_merge` in the JAX package
// (src/repro/kernels/sweep_merge.py): k rounds of "take the candidate with the
// smallest distance, ties to the smaller id, then drop every candidate that
// carries the selected id". Candidates live in shared memory as one packed
// 64-bit key each, (float bits of the distance << 32) | id. Distances on this
// path are non-negative float32 (sums of edge weights), whose bit patterns
// order like unsigned integers, so ONE unsigned 64-bit min per round gives
// distance-then-smaller-id. A candidate that is invalid (id < 0), infinitely
// far, NaN or negative packs to the dead key, which sorts last; a round whose
// min is the dead key emits (-1, +inf), the table's pad sentinel.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

typedef unsigned long long key_t;

constexpr uint32_t kInfBits = 0x7f800000u;
constexpr key_t kDeadKey = (static_cast<key_t>(kInfBits) << 32) | 0xffffffffull;
// shared-memory words the selection needs beside the candidate list:
// one partial min per warp (at most 32 warps) plus the broadcast slot
constexpr int kRedSlots = 33;

__device__ __forceinline__ key_t pack_key(int id, float d) {
  if (id < 0) return kDeadKey;
  const uint32_t bits = __float_as_uint(__fadd_rn(d, 0.0f));  // -0.0 -> +0.0
  if (bits >= kInfBits) return kDeadKey;  // +inf, NaN, negative
  return (static_cast<key_t>(bits) << 32) | static_cast<uint32_t>(id);
}

__device__ __forceinline__ int key_id(key_t key) {
  return key == kDeadKey ? -1 : static_cast<int>(static_cast<uint32_t>(key));
}

__device__ __forceinline__ float key_dist(key_t key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ key_t warp_min(key_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const key_t other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other < v ? other : v;
  }
  return v;
}

// Block-wide selection over keys[0..c). Every thread of the block calls it;
// blockDim.x is a multiple of 32. `red` is kRedSlots words of shared scratch,
// `sel` receives the k selected keys (dead key once the list is exhausted).
// Thread t owns candidates t, t + blockDim.x, ...: it alone rewrites them, so
// the mask pass of round r is folded into the scan of round r + 1. Returns
// after a barrier, so every thread may read `sel`.
__device__ __forceinline__ void kround_select(key_t* keys, int c, int k,
                                              key_t* red, key_t* sel) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarp = nthr >> 5;
  uint32_t last = 0xffffffffu;  // no valid id: matches only dead keys
  __syncthreads();              // the candidate list is complete
  for (int r = 0; r < k; ++r) {
    key_t best = kDeadKey;
    for (int i = tid; i < c; i += nthr) {
      key_t key = keys[i];
      if (static_cast<uint32_t>(key) == last) {
        key = kDeadKey;
        keys[i] = key;
      }
      best = key < best ? key : best;
    }
    best = warp_min(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      key_t v = lane < nwarp ? red[lane] : kDeadKey;
      v = warp_min(v);
      if (lane == 0) {
        red[kRedSlots - 1] = v;
        sel[r] = v;
      }
    }
    __syncthreads();
    last = static_cast<uint32_t>(red[kRedSlots - 1]);
  }
  __syncthreads();
}

}  // namespace knn
