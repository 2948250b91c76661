// K3 frontier_relax: one pruned-relaxation round of the batched insert
// frontier. For receiver row v = rows[i] and source column c,
//   new[v, c] = min(dist[v, c], min over u in nbr[i, :], gate(u, c) of
//                                   w[i, j] + dist[u, c])
//   gate(u, c) = dist[u, c] < kth[u]  or  u == src[c]
// with padded neighbour slots (u < 0) skipped.
//
// Replaces the TPU kernel `frontier_relax_pallas` / `_frontier_relax_kernel`
// (src/repro/kernels/frontier_relax.py), a sequential (R, T) grid that copied
// one (1, B) neighbour row per step into a running-min scratch and got its
// Jacobi reads from a second, non-aliased operand. Here: one block per
// receiver row, threads across the B source columns (so each neighbour row is
// one coalesced read), a loop over the T neighbours inside the thread, the
// running min in a register. The kernel only READS the (n+1, B) matrix and
// writes block i's result to row i of a separate (R, B) tile, so every read
// sees pre-round values whatever the receiver set; the caller scatters the
// tile afterwards.
//
// Bound on an H100: bytes. The call must read R*T*8 bytes of schedule, the
// distinct neighbour rows and the R own rows (B*4 bytes each), and write
// R*B*4; it does 3 operations per (row, neighbour, column).
#include <cuda_runtime.h>

namespace {

__global__ void frontier_relax_kernel(
    const int* __restrict__ nbr, const int* __restrict__ rows,
    const float* __restrict__ w, const float* __restrict__ dist,
    const float* __restrict__ kth, const int* __restrict__ src,
    float* __restrict__ out, int t, int b) {
  const size_t i = blockIdx.x;
  const size_t v = static_cast<size_t>(rows[i]);
  const int* nbr_i = nbr + i * t;
  const float* w_i = w + i * t;
  for (int c = threadIdx.x; c < b; c += blockDim.x) {
    float acc = dist[v * b + c];
    const int s = src[c];
    for (int j = 0; j < t; ++j) {
      const int u = nbr_i[j];
      if (u < 0) continue;
      const float nd = dist[static_cast<size_t>(u) * b + c];
      if (nd < kth[u] || s == u) acc = fminf(acc, __fadd_rn(w_i[j], nd));
    }
    out[i * b + c] = acc;
  }
}

}  // namespace

// nbr, w: (r, t); rows: (r,); dist: (n+1, b); kth: (n+1,); src: (b,);
// out: (r, b). Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_frontier_relax(const int* nbr, const int* rows,
                                  const float* w, const float* dist,
                                  const float* kth, const int* src, float* out,
                                  int r, int t, int b, int threads,
                                  void* stream) {
  if (r == 0 || b == 0) return 0;
  frontier_relax_kernel<<<r, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr, rows, w, dist, kth, src, out, t, b);
  return static_cast<int>(cudaGetLastError());
}
