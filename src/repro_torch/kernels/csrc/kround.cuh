// Shared device code of the k-NN index kernels K1 (topk_merge) and K2
// (sweep_merge): the dedup top-k selection, one warp a row.
//
// `select_rounds` is the GPU form of `kround_merge` in the JAX package
// (src/repro/kernels/sweep_merge.py): k rounds of "take the candidate with the
// smallest distance, ties to the smaller id, then drop every candidate that
// carries the selected id". Lane l of the warp holds candidates l, l + 32, ...
// in registers, as one packed 64-bit key each, (float bits of the distance <<
// 32) | id. Distances on this path are non-negative float32 (sums of edge
// weights), whose bit patterns order like unsigned integers, so the key order
// is distance-then-smaller-id. A candidate that is invalid (id < 0),
// infinitely far, NaN or negative packs to the dead key, which sorts last; a
// round whose min is the dead key ends the row, and its remaining slots are
// (-1, +inf), the table's pad sentinel. No block barrier is crossed: a round is
// a tree min over the lane's registers and two `redux.sync` over the warp.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace knn {

typedef unsigned long long key_t;

constexpr uint32_t kInfBits = 0x7f800000u;
constexpr key_t kDeadKey = (static_cast<key_t>(kInfBits) << 32) | 0xffffffffull;
// OR-ed into a key whose id was selected: it then sorts after the dead key
constexpr key_t kDropped = 0xffffffff00000000ull;
constexpr int kMaxRegs = 24;  // candidate keys a lane may hold
constexpr int kMaxCands = kMaxRegs * 32;

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

// The warp's min key: the min distance bits (one redux), then the min id
// among the lanes that hold it (a second).
__device__ __forceinline__ key_t warp_min_key(key_t v) {
  const unsigned hi = __reduce_min_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  const unsigned lo = __reduce_min_sync(
      0xffffffffu, static_cast<unsigned>(v >> 32) == hi ? static_cast<unsigned>(v) : 0xffffffffu);
  return (static_cast<key_t>(hi) << 32) | lo;
}

// k rounds of `kround_merge` over the warp's candidates in `key` (REGS a
// lane): drop the last selected id, take each lane's min by a tree, then
// the warp's; `sel` (this warp's k slots of shared memory) receives the k
// keys, dead keys once the candidates run out.
template <int REGS>
__device__ __forceinline__ void select_rounds(key_t (&key)[REGS], int k, key_t* sel) {
  const int lane = threadIdx.x & 31;
  uint32_t last = 0xffffffffu;  // no valid id: matches only dead keys
  int r = 0;
  for (; r < k; ++r) {
    key_t m[REGS];
#pragma unroll
    for (int s = 0; s < REGS; ++s) {
      // a dropped key keeps its id and gets distance bits above the dead key's
      if (static_cast<uint32_t>(key[s]) == last) key[s] |= kDropped;
      m[s] = key[s];
    }
#pragma unroll
    for (int w = 1; w < REGS; w *= 2)
#pragma unroll
      for (int s = 0; s + w < REGS; s += 2 * w) m[s] = m[s + w] < m[s] ? m[s + w] : m[s];
    const key_t best = warp_min_key(m[0]);
    if (best >= kDeadKey) break;  // warp-uniform: the rest are dead too
    if (lane == 0) sel[r] = best;
    last = static_cast<uint32_t>(best);
  }
  for (int x = r + lane; x < k; x += 32) sel[x] = kDeadKey;
  __syncwarp();
}

// c packed keys in device memory (written by other warps of the same
// launch) merged by one warp into `sel`: their dedup top-k. Read through L2
// (`__ldcg`): L1 may hold stale lines.
template <int REGS>
__device__ void merge_parts(const key_t* parts, int c, int k, key_t* sel) {
  const int lane = threadIdx.x & 31;
  key_t key[REGS];
#pragma unroll
  for (int s = 0; s < REGS; ++s) {
    const int idx = s * 32 + lane;
    key[s] = idx < c ? __ldcg(parts + idx) : kDeadKey;
  }
  select_rounds<REGS>(key, k, sel);
}

// The k selected keys of `sel` written as one (ids, dists) row.
__device__ __forceinline__ void store_row(const key_t* sel, int k, int* wr_ids, float* wr_d,
                                          size_t row) {
  for (int r = threadIdx.x & 31; r < k; r += 32) {
    wr_ids[row * k + r] = key_id(sel[r]);
    wr_d[row * k + r] = key_dist(sel[r]);
  }
}

}  // namespace knn
