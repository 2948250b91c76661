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
//   Candidates are packed 64-bit keys (kround.cuh: distance bits << 32 | id;
//   invalid, +inf, NaN and negative distances pack to the dead key). The
//   selection (`select_rounds` in kround.cuh, shared with K1) is k rounds of
//   `kround_merge` over keys in registers, lane l holding keys l, l + 32,
//   ..., at most 24 a lane: each lane drops the last selected id from its
//   keys and takes its min by a tree, two `redux.sync` give the warp's min
//   (distance bits, then the smallest id holding them), which is the next
//   entry; a round whose min is the dead key ends the row, and its remaining
//   slots are (-1, +inf). Every key is scanned each round, so a rounding tie
//   inside one neighbour's list (two of its distances made equal by + w, the
//   later one carrying the smaller id) is still resolved by id.
// - A round costs as many registers as the keys it walks, k rounds a
//   selection, so the candidates a row's rounds walk are cut first. Before
//   any round the warp takes a bound on what the row can select
//   (`row_bound`: the least k-th distance, after + w, of the full source
//   lists it walks, the extras' among them); the candidates are then
//   gathered (consecutive lanes read a neighbour's row: 80 bytes at k = 20),
//   and each one that is dead or above the bound is dropped on the spot. The survivors are compacted (ballot, popc) into the warp's buffer
//   of 768 keys in shared memory, and a full buffer is selected on the
//   fewest registers (4, 8, 16 or 24) that hold it, together with the
//   running k best of the selections before: the dedup top-k of a union is
//   the dedup top-k of one part's dedup top-k with the other part. Those k
//   stay at the buffer's head, and once they are k live keys the k-th of
//   them bounds the row too. So a wide row's selections walk its live
//   candidates at or below its bounds, and a row's padded slots cost loads
//   and no rounds. Each warp counts the candidates it gathered and kept
//   into two words of the sweep's scratch.
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
//   neighbours each, which one warp (or one SM) would walk selection after
//   selection. So a level of few rows wider than one group (`group_cap`:
//   the neighbours whose candidates fill the registers with the tail) is
//   spread over the grid's warps, one (row, part) pair a warp, each part
//   bounded by its own lists and walked through the warp's buffer, however
//   wide. A row takes as many parts as the grid has warps for it, up to
//   max(F, its groups), where F = kMaxCands / k is the fan-in of one merge
//   (38 lists at k = 20, 7 at k = 100). Its parts' dedup top-k lists are
//   merged back by a tree of fan-in F: each warp writes its list to the
//   row's scratch, fences, and counts it on its parent node's counter; the
//   warp that completes a node merges its children's lists, writes the
//   node's list and counts it in turn, and the warp that completes the root
//   stores the row (no block barrier, nothing waits). A row of at most F
//   parts takes one merge. Levels of many rows keep a warp a row.
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
// The levels kernel plans its spread of few-row levels in such groups.
__host__ __device__ __forceinline__ int group_cap(int k, int e) {
  return (kMaxCands - (e > k ? e : k)) / k;
}

constexpr unsigned kFull = 0xffffffffu;

// A bound on the keys a row can select, known before any round: the least
// k-th distance, after + w, of source lists of the row that hold k live
// entries (the neighbours' rows in slots [j0, j1) of the read tables, and
// the row's extras where E >= k), as the largest key at that distance;
// kDeadKey - 1 where no such list is full. It rests on every list being a
// row as `store_row` writes it: distinct ids, distances ascending, dead
// entries last. A full list (its k-th live as stored) then holds k distinct
// live ids at distances up to its k-th (+ w with w >= 0 keeps the order, and
// the gather rounds alike), so the row's dedup top-k ends at or below the
// bound, and a candidate above it is never selected and drops no other
// candidate. The tables K2 writes are such rows, and so are its extras: one
// object a row bottom-up, the V_k^< rows top-down, the live tables
// themselves in a repair round. The k-th's distance bounds, not its key: a
// rounding tie can give an earlier entry of the list the same distance and
// a larger id.
__device__ knn::key_t row_bound(const int* nbr_i, const float* w_i, int j0, int j1,
                                const int* ex_ids, const float* ex_d, int e, size_t ex_row,
                                const int* rd_ids, const float* rd_d, int k) {
  const int lane = threadIdx.x & 31;
  unsigned bits = knn::kInfBits;  // a dead key's distance bits
#pragma unroll 4
  for (int j = j0 + lane; j < j1; j += 32) {  // loads without branches, in flight together
    const int u = __ldg(nbr_i + j);
    const float wj = __ldg(w_i + j);
    const size_t a = static_cast<size_t>(u < 0 ? 0 : u) * k + (k - 1);
    const float dk = __ldcg(rd_d + a);
    const knn::key_t kth = knn::pack_key(__ldcg(rd_ids + a), __fadd_rn(wj, dk));
    // a negative k-th is dead as stored, whatever + w makes it
    if (u >= 0 && wj >= 0.0f && dk >= 0.0f) bits = min(bits, static_cast<unsigned>(kth >> 32));
  }
  if (lane == 0 && e >= k) {
    const size_t x = ex_row * e + (k - 1);
    const knn::key_t kth = knn::pack_key(__ldg(ex_ids + x), __ldg(ex_d + x));
    bits = min(bits, static_cast<unsigned>(kth >> 32));
  }
  bits = __reduce_min_sync(kFull, bits);
  return bits < knn::kInfBits ? (static_cast<knn::key_t>(bits) << 32) | 0xffffffffu
                              : knn::kDeadKey - 1;
}

template <int REGS>
__device__ __forceinline__ void select_from(const knn::key_t* buf, int n, int k,
                                            knn::key_t* sel) {
  const int lane = threadIdx.x & 31;
  knn::key_t key[REGS];
#pragma unroll
  for (int s = 0; s < REGS; ++s) {
    const int idx = s * 32 + lane;
    key[s] = idx < n ? buf[idx] : knn::kDeadKey;
  }
  select_rounds<REGS>(key, k, sel);
}

// The dedup top-k of the n keys of the warp's buffer, on the fewest
// registers that hold them, into `sel`; its live keys are then carried to
// the buffer's head, and their count returned. Not inlined: each of a
// part's `offer` sites may call it.
__device__ __noinline__ int select_buffer(knn::key_t* buf, int n, int k, knn::key_t* sel) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // every lane's keys are in the buffer
  if (n <= 4 * 32)
    select_from<4>(buf, n, k, sel);
  else if (n <= 8 * 32)
    select_from<8>(buf, n, k, sel);
  else if (n <= 16 * 32)
    select_from<16>(buf, n, k, sel);
  else
    select_from<kMaxRegs>(buf, n, k, sel);
  int carried = 0;  // the live keys are a prefix of sel
  for (int x0 = 0; x0 < k; x0 += 32) {
    const int x = x0 + lane;
    const bool live = x < k && sel[x] < knn::kDeadKey;
    if (live) buf[x] = sel[x];
    carried += __popc(__ballot_sync(kFull, live));
  }
  __syncwarp();
  return carried;
}

// A warp's walk over one part of a row. Each candidate comes to one lane
// (`offer`, every lane at once); a dead one or one above `lim` is dropped,
// and the rest are compacted (ballot, popc) into the warp's buffer of
// shared memory. A buffer that would pass `limit` keys is selected into
// `sel`, the part's running k best, which stay at the buffer's head; once
// they are k live keys the k-th of them bounds the row too. `finish` selects
// what no selection has seen yet, so a part ends with its dedup top-k in
// `sel`; a buffer that gained nothing since the last selection costs no
// rounds.
struct Walk {
  knn::key_t* buf;  // the warp's kMaxCands slots of shared memory
  knn::key_t* sel;  // the warp's k slots
  int k, limit;
  knn::key_t lim;      // the largest key the row may still select
  int n = 0;           // keys in the buffer, the carried ones first
  bool fresh = true;   // the buffer holds keys no selection has seen (or none ran yet)
  unsigned gathered = 0, kept = 0;  // this lane's candidates, and those kept

  __device__ __forceinline__ void select() {
    n = select_buffer(buf, n, k, sel);
    const knn::key_t kth = sel[k - 1];
    if (kth < lim) lim = kth;  // a dead k-th leaves lim as it is
    fresh = false;
  }

  __device__ __forceinline__ void offer(knn::key_t key, bool real) {
    const int lane = threadIdx.x & 31;
    const bool keep = key <= lim;
    gathered += real;
    kept += keep;
    unsigned m = __ballot_sync(kFull, keep);
    while (m) {
      if (n == limit) select();
      const int room = limit - n;
      const bool mine = (m >> lane & 1u) && __popc(m & ((1u << lane) - 1u)) < room;
      if (mine) buf[n + __popc(m & ((1u << lane) - 1u))] = key;
      n += min(__popc(m), room);
      m &= ~__ballot_sync(kFull, mine);
      fresh = true;
    }
  }

  __device__ __forceinline__ void finish() {
    if (fresh) select();
  }
};

// One warp's part of a row: the candidates of neighbour slots [j0, j1) of
// nbr_i, and the row's E extras when `extras`, through `walk`; `walk.sel`
// receives the part's dedup top-k. The part is bounded by its own slots'
// lists and the row's extras: the whole row's lists, in each of a spread
// row's parts, would put a serial walk of up to 1,024 slots on the path.
__device__ void merge_part(const int* nbr_i, const float* w_i, int j0, int j1, bool extras,
                           const int* ex_ids, const float* ex_d, int e, size_t ex_row,
                           const int* rd_ids, const float* rd_d, int k, Walk& walk) {
  const int lane = threadIdx.x & 31;
  walk.lim = row_bound(nbr_i, w_i, j0, j1, ex_ids, ex_d, e, ex_row, rd_ids, rd_d, k);
  if (extras)
    for (int x0 = 0; x0 < e; x0 += 32) {
      const size_t x = ex_row * e + min(x0 + lane, e - 1);
      const knn::key_t key = knn::pack_key(__ldg(ex_ids + x), __ldg(ex_d + x));
      walk.offer(x0 + lane < e ? key : knn::kDeadKey, x0 + lane < e);
    }
  // the gathered entries in chunks of 8 a lane, loads without branches (an
  // empty slot reads row 0 and is dropped): first each slot's neighbour and
  // weight, then each slot's entry, so that a chunk's loads are in flight
  // together. Consecutive lanes read a neighbour's row: 80 bytes at k = 20.
  constexpr int kChunk = 8;
  const int body = (j1 - j0) * k;
  for (int c0 = 0; c0 < body; c0 += kChunk * 32) {
    long long at[kChunk];
    float wj[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int idx = c0 + c * 32 + lane;
      const int q = idx / k;
      const int j = min(j0 + q, j1 - 1);
      const int u = __ldg(nbr_i + j);
      wj[c] = __ldg(w_i + j);
      at[c] = idx < body && u >= 0 ? static_cast<long long>(u) * k + (idx - q * k) : -1;
    }
    knn::key_t key[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const long long a = at[c] < 0 ? 0 : at[c];
      const int id = __ldcg(rd_ids + a);
      const float dist = __fadd_rn(wj[c], __ldcg(rd_d + a));
      key[c] = at[c] >= 0 ? knn::pack_key(id, dist) : knn::kDeadKey;
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) walk.offer(key[c], at[c] >= 0);
  }
  walk.finish();
}

// The warps' shared memory: k slots each for the running k best, then
// kMaxCands each for the buffer.
__host__ __device__ __forceinline__ size_t warps_smem(int k) {
  return static_cast<size_t>(kWarps) * (k + kMaxCands) * sizeof(knn::key_t);
}

// One call: warp w of block b merges row b * kWarps + w into tile row i,
// selecting at most `limit` keys at a time.
__global__ void __launch_bounds__(kThreads)
sweep_merge_kernel(const int* __restrict__ nbr, const int* __restrict__ verts,
                   const float* __restrict__ w, const int* ex_ids, const float* ex_d,
                   const int* rd_ids, const float* rd_d, int* out_ids, float* out_d, int s, int t,
                   int k, int e, int limit) {
  extern __shared__ knn::key_t smem[];
  const int warp = threadIdx.x >> 5;
  const size_t i = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (i >= static_cast<size_t>(s)) return;  // whole warp leaves
  const int* nbr_i = nbr + i * t;
  const float* w_i = w + i * t;
  const size_t v = static_cast<size_t>(verts[i]);
  Walk walk{smem + kWarps * k + warp * kMaxCands, smem + warp * k, k, limit};
  merge_part(nbr_i, w_i, 0, t, true, ex_ids, ex_d, e, v, rd_ids, rd_d, k, walk);
  store_row(walk.sel, k, out_ids, out_d, i);
}

// Lists of k keys, and counters, that the levels kernel's scratch holds for
// each warp of its grid. A level spread in p parts a row, R rows on at most
// W warps (R p <= W, p >= 2), keeps each row's p leaves and the nodes of its
// tree of fan-in F >= 2: ceil(p / F^l) at level l, at most (p - 1) / (F - 1)
// + depth <= 2p - 2 above the leaves, so R (3p - 2) < 3W of each.
constexpr int kScratchPerWarp = 3;

// The dedup top-k of the c keys at `all` (lists other warps wrote to the
// sweep's scratch) on the fewest registers that hold them, into `sel`.
__device__ __noinline__ void merge_lists(const knn::key_t* all, int c, int k, knn::key_t* sel) {
  if (c <= 4 * 32)
    merge_parts<4>(all, c, k, sel);
  else if (c <= 8 * 32)
    merge_parts<8>(all, c, k, sel);
  else if (c <= 16 * 32)
    merge_parts<16>(all, c, k, sel);
  else
    merge_parts<kMaxRegs>(all, c, k, sel);
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
// tally[0], tally[1] gain the candidates the warps gathered and kept.
__global__ void __launch_bounds__(kThreads)
sweep_levels_kernel(const int* __restrict__ levels, int n_levels,
                    const long long* __restrict__ buckets, const int* __restrict__ ex_ids,
                    const float* __restrict__ ex_d, int* ids, float* d, int k, int e, int n,
                    knn::key_t* scratch, unsigned* counts, unsigned* bar,
                    unsigned long long* tally) {
  extern __shared__ knn::key_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  knn::key_t* sel = smem + warp * k;
  knn::key_t* buf = smem + kWarps * k + warp * kMaxCands;
  const int first = blockIdx.x * kWarps + warp;
  const int stride = gridDim.x * kWarps;
  const int cap = group_cap(k, e);
  const int fan = kMaxCands / k;  // lists one merge holds: 38 at k = 20, 7 at k = 100
  unsigned gathered = 0, kept = 0;
  for (int lv = 0; lv < n_levels; ++lv) {
    const int* entry = levels + 3 * lv;
    const long long* bk = buckets + 4 * entry[0];
    const int* nbr = reinterpret_cast<const int*>(bk[0]);
    const float* w = reinterpret_cast<const float*>(bk[1]);
    const int* verts = reinterpret_cast<const int*>(bk[2]);
    const int t = static_cast<int>(bk[3]);
    const int t_group = max(1, min(t, cap));
    const int rows = entry[2];
    const int end = entry[1] + rows;
    const int groups = (t + t_group - 1) / t_group;
    // a level of few rows wider than one group: its rows' neighbour slots are
    // spread over the grid in parts, one (row, part) item a warp, as many
    // parts a row as the grid has warps for, up to max(F, groups); the
    // parts' lists are merged back by a tree of fan-in F
    const int spread = fan > 1 && groups > 1 && 2 * rows <= stride
                           ? min(stride / max(1, rows), max(fan, groups)) : 1;
    if (spread > 1) {
      const int t_part = (t + spread - 1) / spread;
      const int parts = (t + t_part - 1) / t_part;
      int nodes = 1;  // a row's tree: the leaves, then each level above, the root last
      for (int m = parts; m > 1; m = (m + fan - 1) / fan) nodes += m;
      const int items = rows * parts;
      for (int q = first; q < items; q += stride) {
        const int row = q / parts, g = q - (q / parts) * parts;
        const int i = entry[1] + row;
        const int v = verts[i];
        if (v == n) continue;
        const int* nbr_i = nbr + static_cast<size_t>(i) * t;
        const float* w_i = w + static_cast<size_t>(i) * t;
        Walk walk{buf, sel, k, kMaxCands};
        merge_part(nbr_i, w_i, g * t_part, min(t, (g + 1) * t_part), g == 0, ex_ids, ex_d, e,
                   static_cast<size_t>(v), ids, d, k, walk);
        gathered += walk.gathered;
        kept += walk.kept;
        // climb the row's tree from leaf g: write the node's list and count it
        // on its parent; the warp that completes the parent merges its
        // children's lists and climbs on, and the one that completes the
        // root stores the row
        knn::key_t* lists = scratch + static_cast<size_t>(row) * nodes * k;
        unsigned* count = counts + static_cast<size_t>(row) * nodes;
        for (int at = 0, m = parts, j = g;;) {  // the level's first node, its nodes, this node
          knn::key_t* mine = lists + static_cast<size_t>(at + j) * k;
          for (int r = lane; r < k; r += 32) mine[r] = sel[r];
          __threadfence();  // this list is visible before it is counted
          __syncwarp();
          const int up = at + m, parent = j / fan, kids = min(fan, m - parent * fan);
          unsigned done = 0;
          if (lane == 0) done = atomicAdd(count + up + parent, 1u);
          done = __shfl_sync(kFull, done, 0);
          if (done + 1 != static_cast<unsigned>(kids)) break;  // a sibling's warp merges
          __threadfence();
          merge_lists(lists + static_cast<size_t>(at + parent * fan) * k, kids * k, k, sel);
          if (lane == 0) count[up + parent] = 0;  // for a later level, after the barrier
          if (m <= fan) {  // the root
            store_row(sel, k, ids, d, static_cast<size_t>(v));
            break;
          }
          at = up;
          m = (m + fan - 1) / fan;
          j = parent;
        }
      }
    } else {  // a warp a row
      for (int i = entry[1] + first; i < end; i += stride) {
        const int v = verts[i];
        if (v == n) continue;
        const int* nbr_i = nbr + static_cast<size_t>(i) * t;
        const float* w_i = w + static_cast<size_t>(i) * t;
        Walk walk{buf, sel, k, kMaxCands};
        merge_part(nbr_i, w_i, 0, t, true, ex_ids, ex_d, e, static_cast<size_t>(v), ids, d, k,
                   walk);
        gathered += walk.gathered;
        kept += walk.kept;
        store_row(sel, k, ids, d, static_cast<size_t>(v));
      }
    }
    if (lv + 1 < n_levels) grid_barrier(bar, gridDim.x);
  }
  gathered = __reduce_add_sync(kFull, gathered);
  kept = __reduce_add_sync(kFull, kept);
  if (lane == 0) {
    atomicAdd(tally, static_cast<unsigned long long>(gathered));
    atomicAdd(tally + 1, static_cast<unsigned long long>(kept));
  }
}

}  // namespace

// Most neighbours one group may hold at (k, E); 0 if k and E leave no room.
extern "C" int knn_sweep_group_cap(int k, int e) {
  const int cap = k > 0 ? group_cap(k, e) : 0;
  return cap > 0 ? cap : 0;
}

// The kernels' geometry: which = 0 -> warps a block, 1 -> candidates a
// warp holds in registers, 2 -> lists of k keys and counters that the
// levels kernel's scratch holds for each warp of its grid.
extern "C" int knn_sweep_geometry(int which) {
  return which == 0 ? kWarps : which == 1 ? kMaxCands : kScratchPerWarp;
}

// nbr, w: (s, t); verts: (s,); ex_*: (n+1, e); rd_*: (n+1, k) read tables;
// out_*: an (s, k) tile. 1 <= t_group <= knn_sweep_group_cap(k, e): a row's
// candidates are selected at most t_group * k + max(e, k) at a time.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_sweep_merge(const int* nbr, const int* verts, const float* w,
                               const int* ex_ids, const float* ex_d, const int* rd_ids,
                               const float* rd_d, int* out_ids, float* out_d, int s, int t, int k,
                               int e, int t_group, void* stream) {
  if (s == 0) return 0;
  const size_t smem = warps_smem(k);
  cudaError_t err = cudaFuncSetAttribute(sweep_merge_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = t_group * k + (e > k ? e : k);
  const int limit = group < kMaxCands ? group : kMaxCands;
  const int blocks = (s + kWarps - 1) / kWarps;
  sweep_merge_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr, verts, w, ex_ids, ex_d, rd_ids, rd_d, out_ids, out_d, s, t, k, e, limit);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one cooperative sweep launch: as many as fit on the card at once.
// Returns 0 if the runtime reports none (or an error).
extern "C" int knn_sweep_levels_grid(int k) {
  int dev = 0, sms = 0, per_sm = 0;
  const size_t smem = warps_smem(k);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(sweep_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_levels_kernel, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// levels: (n_levels, 3) int32, buckets: (n_buckets, 4) int64, both on the
// device; ex_*: (n+1, e), ids/d: (n+1, k) live tables, written in place;
// grid: knn_sweep_levels_grid(k); with W = grid * kWarps warps, scratch:
// kScratchPerWarp * W * k keys; counts: kScratchPerWarp * W zeroed words;
// bar: two zeroed words; tally: two zeroed 64-bit words, which gain the
// candidates gathered and kept. Returns the CUDA error code (0 = launched); a cooperative launch
// the runtime refuses is returned as such.
extern "C" int knn_sweep_levels(const int* levels, int n_levels, const long long* buckets,
                                const int* ex_ids, const float* ex_d, int* ids, float* d, int k,
                                int e, int n, int grid, unsigned long long* scratch,
                                unsigned* counts, unsigned* bar, unsigned long long* tally,
                                void* stream) {
  if (n_levels == 0) return 0;
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const size_t smem = warps_smem(k);
  const cudaError_t set = cudaFuncSetAttribute(
      sweep_levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (set != cudaSuccess) return static_cast<int>(set);
  void* args[] = {&levels, &n_levels, &buckets, &ex_ids, &ex_d, &ids, &d, &k, &e, &n,
                  &scratch, &counts, &bar, &tally};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)sweep_levels_kernel, grid, kThreads, args, smem,
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
