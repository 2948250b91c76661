// K4 minplus: the tropical (min, +) matrix product
//   C[i, j] = min over t of (A[i, t] + B[t, j])
// in float32, +inf inert, NaN propagating (as jnp.minimum / jnp.min do).
//
// Replaces the TPU kernel `minplus_matmul_pallas` / `_minplus_kernel`
// (src/repro/kernels/minplus.py), a (M/128, N/128, K/128) grid whose
// innermost, sequential axis carried the running min of one (128, 128) output
// block across K steps, on inputs the wrapper padded to 128 with +inf. Here:
// one block of 256 threads per 128 x 128 output tile, the K loop inside the
// block, (128 x 8) slices of A and (8 x 128) slices of B staged through shared
// memory, and an 8 x 8 register micro-tile per thread whose rows are
// {4*ty .. 4*ty+3, 64+4*ty .. 64+4*ty+3} (columns the same with tx), so the
// shared-memory reads are 16-byte vectors that a warp serves without bank
// conflicts. Out-of-range rows, columns and t read as +inf (a padded t is
// +inf on both sides, so it adds +inf and never wins), so no host padding.
//
// Bound on an H100: operations. The tensor cores cannot evaluate the
// tropical semiring, so every (i, t, j) term is one FADD and one min on the
// CUDA cores: 2*M*K*N operations against 67e12 float32 operations/s, while
// the bytes (each input read once, the output written once) are a few
// milliseconds of HBM time even at the certificate's n = 19,881. The add and
// the min do not fuse into one FMA, so a perfect kernel reaches about half of
// that rate. The design keeps 64 accumulators in registers per thread and
// reads 16 shared-memory values per 64 terms.
//
// Exactness: one add (round to nearest, never contracted) and a min per term,
// with no order to differ in, so the result is bit-equal to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 8;    // t per shared-memory stage
constexpr int THREADS = 256;

// min that returns NaN when either operand is NaN (fminf would return the
// other operand): PTX min.NaN, sm_80 and later.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int tile_off(int q, int lane) {
  return (q < 4 ? 0 : 64) + 4 * lane + (q & 3);
}

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ c, int m, int kd, int n) {
  __shared__ __align__(16) float as[BK][BM];  // A slice, t-major
  __shared__ __align__(16) float bs[BK][BN];
  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // which slice elements this thread stages: A row tid/2, t (tid%2)*4..+3;
  // B t tid/32, columns (tid%32)*4..+3
  const int a_r = tid / 2, a_t = (tid % 2) * 4;
  const int b_t = tid / 32, b_c = (tid % 32) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = inf;

  for (int t0 = 0; t0 < kd; t0 += BK) {
    const int gr = row0 + a_r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gt = t0 + a_t + q;
      as[a_t + q][a_r] =
          (gr < m && gt < kd) ? a[static_cast<size_t>(gr) * kd + gt] : inf;
    }
    const int bt = t0 + b_t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gc = col0 + b_c + q;
      bs[b_t][b_c + q] =
          (bt < kd && gc < n) ? b[static_cast<size_t>(bt) * n + gc] : inf;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < BK; ++tt) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[tt][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[tt][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[tt][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[tt][64 + 4 * tx]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = min_nan(acc[i][j], __fadd_rn(ra[i], rb[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + tile_off(i, ty);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gc = col0 + tile_off(j, tx);
      if (gc < n) c[static_cast<size_t>(gr) * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

// a: (m, k), b: (k, n), c: (m, n), all float32 row-major. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int knn_minplus(const float* a, const float* b, float* c, int m,
                           int k, int n, void* stream) {
  if (m == 0 || n == 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  minplus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
