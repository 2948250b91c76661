// K3 frontier_relax: one pruned-relaxation round of the batched insert
// frontier. For receiver row v = rows[i] and source column c,
//   new[v, c] = min(dist[v, c], min over u in nbr(i), gate(u, c) of
//                                   w(i, j) + dist[u, c])
//   gate(u, c) = dist[u, c] < kth[u]  or  u == src[c]
// with padded neighbour slots (u < 0) skipped.
//
// Replaces the TPU kernel `frontier_relax_pallas` / `_frontier_relax_kernel`
// (src/repro/kernels/frontier_relax.py), a sequential (R, T) grid that copied
// one (1, B) neighbour row per step into a running-min scratch and got its
// Jacobi reads from a second, non-aliased operand.
//
// What bounds it on an H100: bytes. The call must read R*T*8 bytes of
// schedule, the distinct neighbour rows and the R own rows (B*4 bytes each),
// and write R*B*4; it does 3 operations per (row, neighbour, column). The
// neighbour rows are random rows of an (n+1, B) matrix (4 GiB at n = 2^24,
// B = 64), so what decides is the rate at which the card serves random
// 256-byte reads, and a row read by several receivers is read again unless
// L2 still holds it.
//
// What held the first design back: one block a receiver row with B threads
// (two warps at B = 64), each walking the T neighbours in a loop whose every
// step was a chain of dependent loads (the slot's id, then kth[u] and
// dist[u, c]): ~2T device-memory latencies a row with a few hundred bytes in
// flight, and every thread reloading the same schedule. Around it the engine
// gathered the (R, T) schedule slices first and derived the changed mask
// after, five torch launches a bucket part.
//
// The design:
// - A warp a receiver row, 8 warps a block. The warp covers the B columns in
//   chunks of 32*V, V = 1, 2 or 4 consecutive columns a lane, read as one
//   vector load where B and the matrix's address allow it. When the
//   receivers are fewer than the warps the card holds (a round's
//   highest-degree bucket: a few thousand rows of hundreds of neighbours),
//   each (row, chunk) gets a warp of its own instead, each reading the
//   schedule itself; the wrapper picks V and the split
//   (`ops.frontier_plan`). On the card this halved such a bucket's time;
//   splitting every row cost 8-23% where the rows fill the card already
//   (`tools/k3_variants.py`).
// - The row's schedule is read 32 slots at a time by the lanes in parallel:
//   lane j loads slot j's id, weight and kth[u], coalesced. A ballot gives
//   the slots that hold a neighbour; padded slots are skipped by the whole
//   warp, so nothing diverges.
// - The neighbour rows are read in batches of kBatch: slot ids come from
//   their lanes by `__shfl_sync`, the batch's row loads are issued without
//   a branch (an empty batch place reads the own row and is dropped), then
//   the weights and bounds follow. On the card batches of 2 were the
//   fastest of 2, 4 and 8 at the usa shape and a flush's narrow buckets, and
//   within 8% of 4 at its highest-degree bucket (`tools/k3_variants.py`):
//   the rows are random reads of a matrix larger than L2, so the card's
//   memory, not one warp's latency, decides, and fewer registers keep more
//   warps resident, with fewer dropped loads.
// - Jacobi: the kernel only READS the (n+1, B) matrix and writes row i of a
//   separate (R, B) tile, so every read sees pre-round values whatever the
//   receiver set; the caller scatters the tile afterwards.
// - Two entries share the kernel. `knn_frontier_relax` takes the (R, T)
//   schedule slices (the JAX package's signature). `knn_frontier_relax_rows`
//   reads row rows[i] of the (n+1, t) bucket tables directly, with no
//   gather, and also flags each row whose new values fall below its old
//   ones: the own row is in registers already.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 2;  // neighbour rows a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  typedef float T;
};
template <>
struct Vec<2> {
  typedef float2 T;
};
template <>
struct Vec<4> {
  typedef float4 T;
};

template <int V>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[V]) {
  const typename Vec<V>::T y = __ldg(reinterpret_cast<const typename Vec<V>::T*>(p));
  const float* f = reinterpret_cast<const float*>(&y);
#pragma unroll
  for (int e = 0; e < V; ++e) x[e] = f[e];
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[V]) {
  typename Vec<V>::T y;
  float* f = reinterpret_cast<float*>(&y);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = x[e];
  *reinterpret_cast<typename Vec<V>::T*>(p) = y;
}

// Warp w of block b relaxes item = b * kWarps + w: receiver i = item and
// all its column chunks of 32 * V, or, with SPLIT, receiver i = item /
// chunks and its one chunk item % chunks. Its schedule is row `by_row ?
// rows[i] : i` of nbr/w (stride t); `changed`, if given (zeroed by the
// caller), gets a 1 where any of the row's new values is below its old one.
template <int V, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
frontier_relax_kernel(const int* __restrict__ nbr, const float* __restrict__ w,
                      const int* __restrict__ rows, int by_row, const float* __restrict__ dist,
                      const float* __restrict__ kth, const int* __restrict__ src,
                      float* __restrict__ out, unsigned char* __restrict__ changed, int r, int t,
                      int b, int chunks) {
  const int lane = threadIdx.x & 31;
  const unsigned item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t i = SPLIT ? item / chunks : item;
  if (i >= static_cast<size_t>(r)) return;  // whole warp leaves
  const int c_first = SPLIT ? static_cast<int>(item - i * chunks) * 32 * V : 0;
  const int c_end = SPLIT ? min(b, c_first + 32 * V) : b;
  const size_t v = static_cast<size_t>(rows[i]);
  const size_t srow = by_row ? v : i;
  const int* nbr_i = nbr + srow * t;
  const float* w_i = w + srow * t;
  bool below = false;
  for (int c0 = c_first; c0 < c_end; c0 += 32 * V) {
    const int c = c0 + lane * V;
    const bool live = c < c_end;      // b % V == 0: a lane's V columns are all in or all out
    const size_t col = live ? c : 0;  // a dead lane reads column 0 and stores nothing
    float acc[V], old[V];
    int s[V];
    load_cols<V>(dist + v * b + col, old);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc[e] = old[e];
      s[e] = live ? __ldg(src + col + e) : -1;
    }
    for (int j0 = 0; j0 < t; j0 += 32) {
      const int j = j0 + lane;
      const int u = j < t ? __ldg(nbr_i + j) : -1;
      const float wj = u >= 0 ? __ldg(w_i + j) : 0.0f;
      const float kj = u >= 0 ? __ldg(kth + u) : 0.0f;
      unsigned todo = __ballot_sync(kFull, u >= 0);
      while (todo) {  // warp-uniform
        int slot[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          slot[q] = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1;
        }
        // the rows' loads first, so that they are in flight beside the
        // bounds' loads of the pass; then the weights and bounds
        int uq[kBatch];
        float nd[kBatch][V];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          uq[q] = __shfl_sync(kFull, u, slot[q] < 0 ? 0 : slot[q]);
          const size_t ru = slot[q] < 0 ? v : static_cast<size_t>(uq[q]);
          load_cols<V>(dist + ru * b + col, nd[q]);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (slot[q] < 0) break;  // warp-uniform
          const float wq = __shfl_sync(kFull, wj, slot[q]);
          const float kq = __shfl_sync(kFull, kj, slot[q]);
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (nd[q][e] < kq || s[e] == uq[q]) acc[e] = fminf(acc[e], __fadd_rn(wq, nd[q][e]));
        }
      }
    }
    if (live) {
      store_cols<V>(out + i * b + c, acc);
#pragma unroll
      for (int e = 0; e < V; ++e) below |= acc[e] < old[e];
    }
  }
  if (changed != nullptr && __any_sync(kFull, below) && lane == 0) changed[i] = 1;
}

template <int V>
void launch_v(bool split, unsigned blocks, cudaStream_t st, const int* nbr, const float* w,
              const int* rows, int by_row, const float* dist, const float* kth, const int* src,
              float* out, unsigned char* changed, int r, int t, int b, int chunks) {
  if (split)
    frontier_relax_kernel<V, true><<<blocks, kThreads, 0, st>>>(
        nbr, w, rows, by_row, dist, kth, src, out, changed, r, t, b, chunks);
  else
    frontier_relax_kernel<V, false><<<blocks, kThreads, 0, st>>>(
        nbr, w, rows, by_row, dist, kth, src, out, changed, r, t, b, chunks);
}

int launch(const int* nbr, const float* w, const int* rows, int by_row, const float* dist,
           const float* kth, const int* src, float* out, unsigned char* changed, int r, int t,
           int b, int vec, int split, void* stream) {
  if (r == 0 || b == 0) return 0;
  if (t < 0 || (vec != 1 && vec != 2 && vec != 4) || b % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (b + 32 * vec - 1) / (32 * vec);
  const long long items = static_cast<long long>(r) * (split ? chunks : 1);
  if (items + kWarps > 0xffffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 1)
    launch_v<1>(split, blocks, st, nbr, w, rows, by_row, dist, kth, src, out, changed, r, t, b,
                chunks);
  else if (vec == 2)
    launch_v<2>(split, blocks, st, nbr, w, rows, by_row, dist, kth, src, out, changed, r, t, b,
                chunks);
  else
    launch_v<4>(split, blocks, st, nbr, w, rows, by_row, dist, kth, src, out, changed, r, t, b,
                chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nbr, w: (r, t) schedule slices; rows: (r,); dist: (n+1, b); kth: (n+1,);
// src: (b,); out: (r, b). vec: columns a lane loads at once (1, 2 or 4;
// b % vec == 0 and dist 4 * vec-byte aligned); split: 1 for a warp a
// (receiver, chunk of 32 * vec columns), 0 for a warp a receiver. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int knn_frontier_relax(const int* nbr, const int* rows, const float* w,
                                  const float* dist, const float* kth, const int* src, float* out,
                                  int r, int t, int b, int vec, int split, void* stream) {
  return launch(nbr, w, rows, 0, dist, kth, src, out, nullptr, r, t, b, vec, split, stream);
}

// nbr_tab, w_tab: (n+1, t) bucket tables, row rows[i] read for receiver i;
// changed: (r,) bytes, zeroed by the caller; 1 where the row's new values
// are below its old ones. The rest as knn_frontier_relax.
extern "C" int knn_frontier_relax_rows(const int* nbr_tab, const float* w_tab, const int* rows,
                                       const float* dist, const float* kth, const int* src,
                                       float* out, unsigned char* changed, int r, int t, int b,
                                       int vec, int split, void* stream) {
  return launch(nbr_tab, w_tab, rows, 1, dist, kth, src, out, changed, r, t, b, vec, split,
                stream);
}
