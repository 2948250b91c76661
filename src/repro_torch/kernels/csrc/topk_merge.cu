// K1 topk_merge: per row, the k smallest-distance distinct ids among C
// (id, dist) candidates; ties go to the smaller id, id < 0 is invalid,
// exhausted slots are (-1, +inf).
//
// Replaces the TPU kernel `topk_merge_pallas` / `_topk_merge_kernel`
// (src/repro/kernels/topk_merge.py), which ran the k rounds over a
// (128, C) tile with C padded to the 128-lane width.
//
// What bounds it on an H100: bytes. The call must read B*C*8 bytes and write
// B*k*8 (0.033 ms at B = 131,072, C = 84, k = 20); the selection's k rounds
// over C candidates are far below the card's ratio of operations to bytes.
//
// What held the first design back: one block a row, C packed keys in shared
// memory, and each of the k rounds a rescan of shared memory, a reduction
// through a shared slot and two block barriers: 40 barriers a row at k = 20
// with almost no work between them, 26x off the byte bound.
//
// The design: a warp a row, 8 rows a block, and K2's selection
// (`select_rounds`, kround.cuh): lane l holds candidates l, l + 32, ... in
// registers (REGS of them: 4, 8, 16 or 24, picked per C by the wrapper), so
// a round is a tree min over the lane's registers and two `redux.sync` over
// the warp, and no block barrier is crossed. Candidates are read once, each
// load coalesced along the row, and a group's loads are all issued before
// any is used (loading a distance only once its id was known to be valid
// put two dependent latencies a register in line). Rows wider than the
// registers hold (C > 768) are walked in groups of `group` candidates, each
// merged together with the running k best of the groups before (the dedup
// top-k of a union is the dedup top-k of one part's dedup top-k with the
// other part), so C needs no shared memory and has no limit; only the warp's
// k selected keys live in shared memory. Neither B nor C is padded; C < k
// simply exhausts early.
#include "kround.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// largest k: the carried k best and at least kMaxCands / 2 new candidates
// fill a group's registers
constexpr int kMaxK = knn::kMaxCands / 2;

// Warp w of block b selects row b * kWarps + w: its candidates in groups of
// `group`, the groups after the first carrying the running k best.
template <int REGS>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const int* __restrict__ ids, const float* __restrict__ d,
                  int* __restrict__ out_ids, float* __restrict__ out_d, int b, int c, int k,
                  int group) {
  extern __shared__ knn::key_t sel_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (row >= static_cast<size_t>(b)) return;  // whole warp leaves
  knn::key_t* sel = sel_all + warp * k;
  const int* rid = ids + row * c;
  const float* rd = d + row * c;
  for (int g0 = 0;; g0 += group) {
    const int body = min(group, c - g0);
    const int tail = g0 > 0 ? k : 0;
    // every load first, without a branch (a place past the group reads its
    // last candidate and is dropped), so that they are all in flight at once
    int cid[REGS];
    float cd[REGS];
    if (body > 0) {
#pragma unroll
      for (int s = 0; s < REGS; ++s) {
        const int at = g0 + min(s * 32 + lane, body - 1);
        cid[s] = __ldg(rid + at);
        cd[s] = __ldg(rd + at);
      }
    }
    knn::key_t key[REGS];
#pragma unroll
    for (int s = 0; s < REGS; ++s) {
      const int idx = s * 32 + lane;
      key[s] = knn::kDeadKey;
      if (idx < body) key[s] = knn::pack_key(cid[s], cd[s]);
      else if (idx - body < tail) key[s] = sel[idx - body];
    }
    __syncwarp();  // every lane has read the carried keys before they are rewritten
    knn::select_rounds<REGS>(key, k, sel);
    if (g0 + group >= c) break;
  }
  knn::store_row(sel, k, out_ids, out_d, row);
}

}  // namespace

// The kernel's geometry: which = 0 -> candidates a warp holds in registers,
// 1 -> the largest k it takes.
extern "C" int knn_topk_geometry(int which) { return which == 0 ? knn::kMaxCands : kMaxK; }

// ids, d: (b, c) row-major; out_ids, out_d: (b, k). regs: 4, 8, 16 or 24 keys
// a lane, with group + (k if group < c) <= 32 * regs; 1 <= k <= kMaxK.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_topk_merge(const int* ids, const float* d, int* out_ids, float* out_d, int b,
                              int c, int k, int regs, int group, void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > kMaxK || group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * k * sizeof(knn::key_t);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(b) + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (regs) {
    case 4:
      topk_merge_kernel<4><<<blocks, kThreads, smem, st>>>(ids, d, out_ids, out_d, b, c, k, group);
      break;
    case 8:
      topk_merge_kernel<8><<<blocks, kThreads, smem, st>>>(ids, d, out_ids, out_d, b, c, k, group);
      break;
    case 16:
      topk_merge_kernel<16><<<blocks, kThreads, smem, st>>>(ids, d, out_ids, out_d, b, c, k, group);
      break;
    case knn::kMaxRegs:
      topk_merge_kernel<knn::kMaxRegs>
          <<<blocks, kThreads, smem, st>>>(ids, d, out_ids, out_d, b, c, k, group);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
