// K1 topk_merge: per row, the k smallest-distance distinct ids among C
// (id, dist) candidates; ties go to the smaller id, id < 0 is invalid,
// exhausted slots are (-1, +inf).
//
// Replaces the TPU kernel `topk_merge_pallas` / `_topk_merge_kernel`
// (src/repro/kernels/topk_merge.py), which ran the k rounds over a
// (128, C) tile with C padded to the 128-lane width. Here: one block per row,
// the row's candidates packed into shared memory once, `kround_select` on
// them. No padding of B or C; C < k simply exhausts early.
//
// Bound on an H100: bytes. The call must read B*C*8 bytes and write B*k*8;
// the selection does about 2*k*C integer compare/selects per row, which at
// k = 20 is far below the card's ratio of operations to bytes. The design
// reads every candidate from device memory exactly once (coalesced along the
// row) and keeps the k rounds in shared memory and registers.
#include "kround.cuh"

namespace {

__global__ void topk_merge_kernel(const int* __restrict__ ids,
                                  const float* __restrict__ d,
                                  int* __restrict__ out_ids,
                                  float* __restrict__ out_d, int c, int k) {
  extern __shared__ knn::key_t smem[];
  knn::key_t* keys = smem;
  knn::key_t* red = keys + c;
  knn::key_t* sel = red + knn::kRedSlots;
  const size_t row = blockIdx.x;
  const int* rid = ids + row * c;
  const float* rd = d + row * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    keys[i] = knn::pack_key(rid[i], rd[i]);
  knn::kround_select(keys, c, k, red, sel);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    out_ids[row * k + r] = knn::key_id(sel[r]);
    out_d[row * k + r] = knn::key_dist(sel[r]);
  }
}

}  // namespace

// Shared-memory bytes one block needs for C candidates and k outputs.
extern "C" long long knn_topk_merge_smem(int c, int k) {
  return static_cast<long long>(c + knn::kRedSlots + k) * sizeof(knn::key_t);
}

// ids, d: (b, c) row-major; out_ids, out_d: (b, k). Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int knn_topk_merge(const int* ids, const float* d, int* out_ids,
                              float* out_d, int b, int c, int k, int threads,
                              void* stream) {
  if (b == 0) return 0;
  const size_t smem = knn_topk_merge_smem(c, k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  topk_merge_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      ids, d, out_ids, out_d, c, k);
  return static_cast<int>(cudaGetLastError());
}
