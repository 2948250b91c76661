// K2 sweep_merge: for each target row verts[i], gather the k-lists of its
// neighbours nbr[i, :] from the read tables, add the edge weight w[i, j] to
// every gathered distance, append the row's E extra candidates ex[verts[i]],
// keep the k closest distinct ids, and store the row.
//
// Replaces the TPU kernel `sweep_merge_pallas` / `_sweep_merge_kernel`
// (src/repro/kernels/sweep_merge.py). That kernel walked a sequential
// (CHUNK, T) grid, one (1, k) row copy per step, carrying a candidate scratch
// from step to step, with nbr/verts prefetched as scalars. Here blocks run in
// parallel and carry nothing: one block per target row loads its own
// nbr[i, :] and verts[i], loops over the T neighbours itself, fills the
// candidate list in shared memory and runs `kround_select` on it. The
// (S, T*k+E) candidate tensor never exists in device memory.
//
// Read and write tables are separate pointers. Construction passes the same
// buffers for both (a level's neighbour rows and target rows are disjoint, so
// in place is safe). A repair round, whose rows read each other, asks for
// `compact` output instead: block i writes row i of an (S, k) tile and the
// live tables are only read. In scatter mode the store is masked for
// verts[i] == n: padded rows all aim at the dummy row n, which would be
// concurrent stores, and row n must stay (-1, +inf) because pad slots read it.
//
// Shared memory is (t_group*k + max(E, k) + 33 + k) * 8 bytes. When all T
// neighbours do not fit in what a block may have, the caller passes
// t_group < T and the block walks the neighbours in groups, carrying the
// running k best into the next group as extra candidates (the dedup top-k of
// a union is the dedup top-k of one part's top-k with the other part).
//
// Bound on an H100: bytes. The call must read S*T*8 bytes of schedule, the
// distinct neighbour rows (k*8 bytes each) and S*E*8 of extras, and write
// S*k*8; the selection does about 2*k*(T*k+E) integer compare/selects per
// row, under the card's operations-to-bytes ratio at k = 20. Each gathered
// row is k contiguous values (80 bytes at k = 20), read once.
#include "kround.cuh"

namespace {

__global__ void sweep_merge_kernel(
    const int* __restrict__ nbr, const int* __restrict__ verts,
    const float* __restrict__ w, const int* ex_ids, const float* ex_d,
    const int* rd_ids, const float* rd_d, int* wr_ids, float* wr_d, int t,
    int k, int e, int n, int t_group, int compact) {
  extern __shared__ knn::key_t smem[];
  const int tail_cap = e > k ? e : k;
  knn::key_t* keys = smem;
  knn::key_t* red = keys + t_group * k + tail_cap;
  knn::key_t* sel = red + knn::kRedSlots;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t i = blockIdx.x;
  const int v = verts[i];
  if (!compact && v == n) return;  // whole block leaves together
  const int* nbr_i = nbr + i * t;
  const float* w_i = w + i * t;

  int j0 = 0;
  do {
    const int tg = min(t_group, t - j0);
    const int body = tg * k;
    for (int idx = tid; idx < body; idx += nthr) {
      const int j = j0 + idx / k;
      const int col = idx - (idx / k) * k;
      const int u = nbr_i[j];
      knn::key_t key = knn::kDeadKey;
      if (u >= 0) {
        const size_t at = static_cast<size_t>(u) * k + col;
        key = knn::pack_key(rd_ids[at], __fadd_rn(w_i[j], rd_d[at]));
      }
      keys[idx] = key;
    }
    int tail;
    if (j0 == 0) {  // first group: the row's own extra candidates
      tail = e;
      for (int idx = tid; idx < e; idx += nthr) {
        const size_t at = static_cast<size_t>(v) * e + idx;
        keys[body + idx] = knn::pack_key(ex_ids[at], ex_d[at]);
      }
    } else {        // later groups: the running k best of the groups before
      tail = k;
      for (int idx = tid; idx < k; idx += nthr) keys[body + idx] = sel[idx];
    }
    knn::kround_select(keys, body + tail, k, red, sel);
    j0 += t_group;
  } while (j0 < t);

  const size_t out_row = compact ? i : static_cast<size_t>(v);
  for (int r = tid; r < k; r += nthr) {
    wr_ids[out_row * k + r] = knn::key_id(sel[r]);
    wr_d[out_row * k + r] = knn::key_dist(sel[r]);
  }
}

}  // namespace

// Shared-memory bytes one block needs when it holds t_group neighbours.
extern "C" long long knn_sweep_merge_smem(int t_group, int k, int e) {
  const int tail_cap = e > k ? e : k;
  return static_cast<long long>(t_group * k + tail_cap + knn::kRedSlots + k) *
         sizeof(knn::key_t);
}

// nbr, w: (s, t); verts: (s,); ex_*: (n+1, e); rd_*: (n+1, k) read tables;
// wr_*: (n+1, k) tables (compact = 0) or an (s, k) tile (compact = 1).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_sweep_merge(const int* nbr, const int* verts, const float* w,
                               const int* ex_ids, const float* ex_d,
                               const int* rd_ids, const float* rd_d,
                               int* wr_ids, float* wr_d, int s, int t, int k,
                               int e, int n, int t_group, int compact,
                               int threads, void* stream) {
  if (s == 0) return 0;
  const size_t smem = knn_sweep_merge_smem(t_group, k, e);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sweep_merge_kernel<<<s, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr, verts, w, ex_ids, ex_d, rd_ids, rd_d, wr_ids, wr_d, t, k, e, n,
      t_group, compact);
  return static_cast<int>(cudaGetLastError());
}
