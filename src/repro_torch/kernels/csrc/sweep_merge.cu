// K2 sweep_merge: for each target row verts[i], gather the k-lists of its
// neighbours nbr[i, :] from the read tables, add the edge weight w[i, j] to
// every gathered distance, append the row's E extra candidates ex[verts[i]],
// keep the k closest distinct ids, and store the row.
//
// Replaces the TPU kernel `sweep_merge_pallas` / `_sweep_merge_kernel`
// (src/repro/kernels/sweep_merge.py). That kernel walked a sequential
// (CHUNK, T) grid, one (1, k) row copy per step, carrying a candidate scratch
// from step to step, with nbr/verts prefetched as scalars, one call per
// level. Here blocks run in parallel and carry nothing, and the (S, T*k+E)
// candidate tensor never exists in device memory.
//
// What bounds it on an H100. The bytes a call must move (S*T*8 of schedule,
// the distinct neighbour rows at k*8 bytes, S*E*8 of extras, S*k*8 written)
// take microseconds for a level and ~0.15 ms at a 131,072-row batch, so two
// other things decide: the selection's latency, and, for a construction
// sweep, the number of dependent steps (levels: ~900 a direction on a
// 147,456-vertex road network, most of them a few hundred rows).
//
// The design:
// - One warp per target row, and a selection that crosses no block barrier.
//   Lane l holds candidates l, l + 32, ... in registers as packed 64-bit keys
//   (kround.cuh: distance bits << 32 | id; invalid, +inf, NaN and negative
//   distances pack to the dead key), at most 24 a lane; the register count is
//   a template argument picked per row width (4, 8, 16 or 24), so narrow rows
//   do not scan empty registers. The selection (`select_rounds` in
//   kround.cuh, shared with K1) is k rounds of `kround_merge`: each lane drops the last selected id from its keys and
//   takes its min by a tree, two `redux.sync` give the warp's min (distance
//   bits, then the smallest id holding them), which is the next entry; a
//   round whose min is the dead key ends the row, and its remaining slots are
//   (-1, +inf). Every candidate is scanned each round, so a rounding tie
//   inside one neighbour's list (two of its distances made equal by + w, the
//   later one carrying the smaller id) is still resolved by id. A
//   neighbour's row is read by consecutive lanes: 80 contiguous bytes at
//   k = 20.
// - Rows wider than the registers (T up to ~700) are walked in groups of
//   neighbours, each group's candidates together with the running k best of
//   the groups before: the dedup top-k of a union is the dedup top-k of one
//   part's dedup top-k with the other part. The running k best sit in the
//   warp's own k slots of shared memory. A group whose neighbour slots are
//   all empty (padding of a wide bucket) costs its loads and no rounds.
// - `knn_sweep_merge`: one call, one repair round: 8 rows a block, a warp a
//   row, the merged rows written to an (S, k) tile (the tables are only
//   read, so rows that read each other all see the pre-round tables).
// - `knn_sweep_levels`: a whole construction sweep in ONE cooperative launch
//   of as many blocks as fit on the card at once. It walks a device level
//   table (bucket, first row, row count) and a bucket table (nbr, w, verts
//   pointers and width t); each level's rows are spread over every warp of
//   the grid, then a grid barrier, written by hand (an arrival counter and a
//   generation word, fences on both sides) so that no -rdc is needed. A
//   level's time is its slowest row's, and the top of a road network's
//   hierarchy is hundreds of levels of one to a few rows with 100-600
//   neighbours each, which one warp (or one SM) would walk group after
//   group. So in a level of few rows wider than one group, the (row, group)
//   pairs are spread over the grid's warps, up to 38 parts a row: each warp
//   writes its part's dedup top-k to a scratch row, fences, and counts it on
//   the row's counter; the warp that counts the last part merges the row's
//   parts (still no block barrier). Levels of many rows keep a warp a row.
//
// L1 is not coherent across SMs, and a grid barrier does not invalidate it:
// a row is 80 bytes at k = 20, so one 128-byte line spans two rows written at
// different levels, and an SM that read row u at level L could later hit a
// stale copy of row u + 1. So the live tables are read with `__ldcg` (L2
// only), never through `__ldg` or a `const __restrict__` pointer; only
// arrays this launch never writes (schedule, extras, level table) go through
// L1. The dummy row n is never stored: padded rows all aim at it, and row n
// must stay (-1, +inf) because pad slots read it.
#include "kround.cuh"

namespace {

constexpr int kWarps = 8;  // rows a block of the one-level kernel holds at once
constexpr int kThreads = kWarps * 32;
using knn::kMaxCands;
using knn::kMaxRegs;
using knn::merge_parts;
using knn::select_rounds;
using knn::store_row;

// Neighbours a group may hold: its candidates plus the tail (E extras in the
// first group, the k carried in later ones) must fit the warp's registers.
__host__ __device__ __forceinline__ int group_cap(int k, int e) {
  return (kMaxCands - (e > k ? e : k)) / k;
}

// One warp's part of a row: its neighbour groups g_first, g_first + g_step,
// ... (t_group neighbours each, of nbr_i[0..t)), the first of them with the
// row's E extras when `extras` (the other groups carry the running k best).
// A group whose neighbour slots are all empty is skipped once there is a
// carried selection. `sel` receives the part's dedup top-k.
template <int REGS>
__device__ void select_groups(const int* nbr_i, const float* w_i, int t, int t_group,
                              int g_first, int g_step, bool extras, const int* ex_ids,
                              const float* ex_d, int e, size_t ex_row, const int* rd_ids,
                              const float* rd_d, int k, knn::key_t* sel) {
  const int lane = threadIdx.x & 31;
  bool carry = false;
  for (int g = g_first;; g += g_step) {
    const int j0 = g * t_group;
    const int body = max(0, min(t_group, t - j0)) * k;
    const int tail = carry ? k : (extras ? e : 0);
    knn::key_t key[REGS];
    bool any = false;
    // neighbour slots in chunks, loads without branches (an empty slot reads
    // row 0 and is dropped): first each slot's neighbour and weight, then
    // each slot's gathered entry, so that a chunk's loads are in flight
    // together
    constexpr int kChunk = REGS < 8 ? REGS : 8;
    const int last_j = j0 + max(0, body / k - 1);
#pragma unroll
    for (int s = 0; s < REGS; ++s) key[s] = knn::kDeadKey;
#pragma unroll
    for (int c0 = 0; c0 < REGS && body > 0; c0 += kChunk) {
      long long at[kChunk];
      float wj[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int idx = (c0 + c) * 32 + lane;
        const int q = idx / k;
        const int j = min(j0 + q, last_j);
        const int u = __ldg(nbr_i + j);
        wj[c] = __ldg(w_i + j);
        at[c] = idx < body && u >= 0 ? static_cast<long long>(u) * k + (idx - q * k) : -1;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const long long a = at[c] < 0 ? 0 : at[c];
        const int id = __ldcg(rd_ids + a);
        const float dist = __fadd_rn(wj[c], __ldcg(rd_d + a));
        any |= at[c] >= 0;
        key[c0 + c] = at[c] >= 0 ? knn::pack_key(id, dist) : knn::kDeadKey;
      }
    }
#pragma unroll
    for (int s = 0; s < REGS; ++s) {  // the tail: extras, or the carried k best
      const int x = s * 32 + lane - body;
      if (x >= 0 && x < tail)
        key[s] = carry ? sel[x] : knn::pack_key(__ldg(ex_ids + ex_row * e + x),
                                                __ldg(ex_d + ex_row * e + x));
    }
    __syncwarp();  // every lane has read the carried keys before they are rewritten
    if (__any_sync(0xffffffffu, any) || !carry) select_rounds<REGS>(key, k, sel);
    carry = true;
    if ((g + g_step) * t_group >= t) break;
  }
}

// The register count for groups of t_group neighbours plus a tail of
// max(E, k), then the walk.
__device__ __forceinline__ void merge_part(const int* nbr_i, const float* w_i, int t,
                                           int t_group, int g_first, int g_step, bool extras,
                                           const int* ex_ids, const float* ex_d, int e,
                                           size_t ex_row, const int* rd_ids, const float* rd_d,
                                           int k, knn::key_t* sel) {
  const int cands = min(t_group, t) * k + (e > k ? e : k);
  if (cands <= 4 * 32)
    select_groups<4>(nbr_i, w_i, t, t_group, g_first, g_step, extras, ex_ids, ex_d, e, ex_row,
                     rd_ids, rd_d, k, sel);
  else if (cands <= 8 * 32)
    select_groups<8>(nbr_i, w_i, t, t_group, g_first, g_step, extras, ex_ids, ex_d, e, ex_row,
                     rd_ids, rd_d, k, sel);
  else if (cands <= 16 * 32)
    select_groups<16>(nbr_i, w_i, t, t_group, g_first, g_step, extras, ex_ids, ex_d, e, ex_row,
                      rd_ids, rd_d, k, sel);
  else
    select_groups<kMaxRegs>(nbr_i, w_i, t, t_group, g_first, g_step, extras, ex_ids, ex_d, e,
                            ex_row, rd_ids, rd_d, k, sel);
}

// One call: warp w of block b merges row b * kWarps + w into tile row i.
__global__ void __launch_bounds__(kThreads)
sweep_merge_kernel(const int* __restrict__ nbr, const int* __restrict__ verts,
                   const float* __restrict__ w, const int* ex_ids, const float* ex_d,
                   const int* rd_ids, const float* rd_d, int* out_ids, float* out_d, int s, int t,
                   int k, int e, int t_group) {
  extern __shared__ knn::key_t sel_all[];
  const int warp = threadIdx.x >> 5;
  const size_t i = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (i >= static_cast<size_t>(s)) return;  // whole warp leaves
  knn::key_t* sel = sel_all + warp * k;
  merge_part(nbr + i * t, w + i * t, t, t_group, 0, 1, true, ex_ids, ex_d, e,
             static_cast<size_t>(verts[i]), rd_ids, rd_d, k, sel);
  store_row(sel, k, out_ids, out_d, i);
}

// Grid-wide barrier for a cooperative launch. bar[0] counts arrivals,
// bar[1] is the generation the waiting blocks watch. The fence before the
// arrival publishes this block's stores (cumulative over the block through
// the __syncthreads before it); the fence after the wait orders the reads
// that follow.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// A whole sweep: levels (n_levels, 3) = (bucket, first row, rows);
// buckets (n_buckets, 4) = (nbr, w, verts pointers, t). In place on ids/d.
__global__ void __launch_bounds__(kThreads)
sweep_levels_kernel(const int* __restrict__ levels, int n_levels,
                    const long long* __restrict__ buckets, const int* __restrict__ ex_ids,
                    const float* __restrict__ ex_d, int* ids, float* d, int k, int e, int n,
                    knn::key_t* scratch, unsigned* counts, unsigned* bar) {
  extern __shared__ knn::key_t sel_all[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  knn::key_t* sel = sel_all + warp * k;
  const int first = blockIdx.x * kWarps + warp;
  const int stride = gridDim.x * kWarps;
  const int cap = group_cap(k, e);
  for (int lv = 0; lv < n_levels; ++lv) {
    const int* entry = levels + 3 * lv;
    const long long* bk = buckets + 4 * entry[0];
    const int* nbr = reinterpret_cast<const int*>(bk[0]);
    const float* w = reinterpret_cast<const float*>(bk[1]);
    const int* verts = reinterpret_cast<const int*>(bk[2]);
    const int t = static_cast<int>(bk[3]);
    const int t_group = max(1, min(t, cap));
    const int end = entry[1] + entry[2];
    const int groups = (t + t_group - 1) / t_group;
    // a level of few rows wider than one group: its rows' groups are spread
    // over the grid, one (row, group) item a warp; the warp that finishes a
    // row's last part merges the row's parts
    const int spread = groups > 1 && 2 * entry[2] <= stride
                           ? min(kMaxCands / k, stride / max(1, entry[2])) : 1;
    const int t_part = (t + spread - 1) / spread;
    if (spread > 1 && t_part <= t_group) {
      const int parts = (t + t_part - 1) / t_part;
      const int items = entry[2] * parts;
      for (int q = first; q < items; q += stride) {
        const int row = q / parts, g = q - (q / parts) * parts;
        const int i = entry[1] + row;
        const int v = verts[i];
        if (v == n) continue;
        merge_part(nbr + static_cast<size_t>(i) * t, w + static_cast<size_t>(i) * t, t, t_part,
                   g, parts, g == 0, ex_ids, ex_d, e, static_cast<size_t>(v), ids, d, k, sel);
        knn::key_t* mine = scratch + static_cast<size_t>(q) * k;
        for (int r = lane; r < k; r += 32) mine[r] = sel[r];
        __threadfence();  // this part is visible before it is counted
        __syncwarp();
        unsigned done = 0;
        if (lane == 0) done = atomicAdd(counts + row, 1u);
        done = __shfl_sync(0xffffffffu, done, 0);
        if (done + 1 == static_cast<unsigned>(parts)) {  // the row's last part: merge
          __threadfence();
          const knn::key_t* all = scratch + static_cast<size_t>(row) * parts * k;
          const int c = parts * k;
          if (c <= 4 * 32)
            merge_parts<4>(all, c, k, sel);
          else if (c <= 8 * 32)
            merge_parts<8>(all, c, k, sel);
          else if (c <= 16 * 32)
            merge_parts<16>(all, c, k, sel);
          else
            merge_parts<kMaxRegs>(all, c, k, sel);
          store_row(sel, k, ids, d, static_cast<size_t>(v));
          if (lane == 0) counts[row] = 0;  // for a later level, after the barrier
        }
      }
    } else {  // a warp a row, its groups one after the other
      for (int i = entry[1] + first; i < end; i += stride) {
        const int v = verts[i];
        if (v == n) continue;
        merge_part(nbr + static_cast<size_t>(i) * t, w + static_cast<size_t>(i) * t, t, t_group,
                   0, 1, true, ex_ids, ex_d, e, static_cast<size_t>(v), ids, d, k, sel);
        store_row(sel, k, ids, d, static_cast<size_t>(v));
      }
    }
    if (lv + 1 < n_levels) grid_barrier(bar, gridDim.x);
  }
}

}  // namespace

// Most neighbours one group may hold at (k, E); 0 if k and E leave no room.
extern "C" int knn_sweep_group_cap(int k, int e) {
  const int cap = k > 0 ? group_cap(k, e) : 0;
  return cap > 0 ? cap : 0;
}

// The kernels' geometry: which = 0 -> warps a block (the sweep's scratch
// holds k keys and one counter for each warp of its grid), 1 -> candidates
// a warp holds in registers.
extern "C" int knn_sweep_geometry(int which) { return which == 0 ? kWarps : kMaxCands; }

// nbr, w: (s, t); verts: (s,); ex_*: (n+1, e); rd_*: (n+1, k) read tables;
// out_*: an (s, k) tile. 1 <= t_group <= knn_sweep_group_cap(k, e).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_sweep_merge(const int* nbr, const int* verts, const float* w,
                               const int* ex_ids, const float* ex_d, const int* rd_ids,
                               const float* rd_d, int* out_ids, float* out_d, int s, int t, int k,
                               int e, int t_group, void* stream) {
  if (s == 0) return 0;
  const size_t smem = static_cast<size_t>(kWarps) * k * sizeof(knn::key_t);
  const int blocks = (s + kWarps - 1) / kWarps;
  sweep_merge_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr, verts, w, ex_ids, ex_d, rd_ids, rd_d, out_ids, out_d, s, t, k, e, t_group);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one cooperative sweep launch: as many as fit on the card at once.
// Returns 0 if the runtime reports none (or an error).
static size_t levels_smem(int k) {
  return static_cast<size_t>(kWarps) * k * sizeof(knn::key_t);
}

extern "C" int knn_sweep_levels_grid(int k) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_levels_kernel, kThreads,
                                                    levels_smem(k)) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// levels: (n_levels, 3) int32, buckets: (n_buckets, 4) int64, both on the
// device; ex_*: (n+1, e), ids/d: (n+1, k) live tables, written in place;
// grid: knn_sweep_levels_grid(k); scratch: grid * kWarps * k keys; counts:
// grid * kWarps zeroed words; bar: two zeroed words. Returns the CUDA error code
// (0 = launched); a cooperative launch the runtime refuses is returned as such.
extern "C" int knn_sweep_levels(const int* levels, int n_levels, const long long* buckets,
                                const int* ex_ids, const float* ex_d, int* ids, float* d, int k,
                                int e, int n, int grid, unsigned long long* scratch,
                                unsigned* counts, unsigned* bar, void* stream) {
  if (n_levels == 0) return 0;
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const size_t smem = levels_smem(k);
  void* args[] = {&levels, &n_levels, &buckets, &ex_ids, &ex_d, &ids, &d, &k, &e, &n,
                  &scratch, &counts, &bar};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)sweep_levels_kernel, grid, kThreads, args, smem,
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
