// K4 minplus: the tropical (min, +) matrix product
//   C[i, j] = min over t of (A[i, t] + B[t, j])
// in float32, +inf inert, NaN propagating (as jnp.minimum / jnp.min do).
//
// Replaces the TPU kernel `minplus_matmul_pallas` / `_minplus_kernel`
// (src/repro/kernels/minplus.py), a (M/128, N/128, K/128) grid whose
// innermost, sequential axis carried the running min of one (128, 128) output
// block across K steps, on inputs the wrapper padded to 128 with +inf.
//
// What bounds it on an H100. Each (i, t, j) term is one FADD and one min on
// the CUDA cores: the tensor cores cannot evaluate the tropical semiring, and
// Hopper has no fused add-min, so a dense product costs 2*M*K*N issue slots,
// 2*M*K*N / (16,896 lanes x clock) at best. But the product's one caller on a
// path, the BN-Graph certificate, squares an adjacency with ~13 finite entries
// a row: there nearly every term is +inf + something, which cannot lower a
// min. What such an input needs is its bytes (A and B read once, C written
// once) and the few terms that are finite on both sides.
//
// The design, two kernels:
// 1. `slice_bits_kernel` marks every slice of A (128 rows x 32 t) and of B
//    (32 t x 128 columns) with two bits: kAllPinf, every entry is exactly
//    +inf; kPoison, the slice holds a NaN or a -inf. Out-of-range rows,
//    columns and t count as +inf. The pair (A slice, B slice) of one output
//    tile and one t slice is inert iff
//        (all_pinf(A) and not poison(B)) or (all_pinf(B) and not poison(A)):
//    then every term is +inf + (a finite value or +inf) = +inf. A predicate on
//    "all +inf" alone would be wrong: +inf + (-inf) and +inf + NaN are NaN,
//    and NaN must still spread.
// 2. `minplus_kernel`, one block of 256 threads per 128 x 128 output tile,
//    first lists the t slices whose pair is live (block-wide ballots, in t
//    order), then walks only those: 16-byte `cp.async` copies (4-byte ones
//    where a row is not 16-byte aligned) into a ring of three shared-memory
//    stages, so that two slices are in flight while one is computed; an 8 x 8
//    register micro-tile per thread, rows {4*ty .. +3, 64+4*ty .. +3}
//    (columns the same with tx), so each 8-byte read of A and 16-byte read of
//    B is a broadcast or conflict-free, 12 shared-memory reads per 128 terms.
//    A tile with no live pair stores +inf, so the output is written whole.
//    Blocks take tiles in the order the wrapper gives (most live slices
//    first), so that the heavy tiles of a banded input do not finish last.
// Out-of-range elements are written to shared memory as +inf (a padded t is
// +inf on both sides, so it adds +inf and never wins): no host padding.
//
// Exactness: one add (round to nearest, never contracted) and a min per term,
// with no order to differ in, and the skipped terms are +inf: the result is
// bit-equal to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows per block, A slice rows
constexpr int BN = 128;  // output columns per block, B slice columns
constexpr int BK = 32;   // t per slice (one ring stage)
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int A_STAGE = BM * BK;  // floats: [row][t]
constexpr int B_STAGE = BK * BN;  // floats: [t][column]
constexpr int RING_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;
constexpr uint8_t kAllPinf = 1;
constexpr uint8_t kPoison = 2;

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One block per (sr x sc) slice of a row-major (rows, cols) matrix:
// bits[by * gridDim.x + bx] = kAllPinf if every in-range entry is +inf,
// | kPoison if one is NaN or -inf.
__global__ void __launch_bounds__(THREADS)
slice_bits_kernel(const float* __restrict__ x, int rows, int cols, int sr, int sc,
                  uint8_t* __restrict__ bits) {
  const float inf = __int_as_float(0x7f800000);
  const int r0 = blockIdx.y * sr;
  const int c0 = blockIdx.x * sc;
  int pinf = 1, poison = 0;
  for (int e = threadIdx.x; e < sr * sc; e += THREADS) {
    const int r = r0 + e / sc;
    const int c = c0 + e % sc;
    if (r < rows && c < cols) {
      const float v = x[static_cast<size_t>(r) * cols + c];
      pinf &= v == inf;
      poison |= (v != v) | (v == -inf);
    }
  }
  pinf = __syncthreads_and(pinf);
  poison = __syncthreads_or(poison);
  if (threadIdx.x == 0)
    bits[blockIdx.y * gridDim.x + blockIdx.x] = (pinf ? kAllPinf : 0) | (poison ? kPoison : 0);
}

// Stage the A slice (rows row0.., t t0..) and the B slice (t t0.., columns
// col0..) into one ring stage. VEC: 16-byte copies (kd and n multiples of 4,
// so a float4 is wholly in or out of range); else 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_slice(const float* a, const float* b, float* sa, float* sb,
                                           int m, int kd, int n, int row0, int col0, int t0) {
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  if (VEC) {
#pragma unroll 1
    for (int q = 0; q < A_STAGE / 4 / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / (BK / 4), t = (e % (BK / 4)) * 4;
      float* dst = sa + r * BK + t;
      if (row0 + r < m && t0 + t < kd)
        cp_async16(dst, a + static_cast<size_t>(row0 + r) * kd + t0 + t);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(inf, inf, inf, inf);
    }
#pragma unroll 1
    for (int q = 0; q < B_STAGE / 4 / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int t = e / (BN / 4), c = (e % (BN / 4)) * 4;
      float* dst = sb + t * BN + c;
      if (t0 + t < kd && col0 + c < n)
        cp_async16(dst, b + static_cast<size_t>(t0 + t) * n + col0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(inf, inf, inf, inf);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < A_STAGE / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK, t = e % BK;
      float* dst = sa + r * BK + t;
      if (row0 + r < m && t0 + t < kd)
        cp_async4(dst, a + static_cast<size_t>(row0 + r) * kd + t0 + t);
      else
        *dst = inf;
    }
#pragma unroll 4
    for (int q = 0; q < B_STAGE / THREADS; ++q) {
      const int e = tid + q * THREADS;
      const int t = e / BN, c = e % BN;
      float* dst = sb + t * BN + c;
      if (t0 + t < kd && col0 + c < n)
        cp_async4(dst, b + static_cast<size_t>(t0 + t) * n + col0 + c);
      else
        *dst = inf;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
               int m, int kd, int n, const uint8_t* __restrict__ a_bits,
               const uint8_t* __restrict__ b_bits, const int* __restrict__ order,
               unsigned long long* pairs) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                      // STAGES x [BM][BK]
  float* bs = smem + STAGES * A_STAGE;   // STAGES x [BK][BN]
  int* live = reinterpret_cast<int*>(bs + STAGES * B_STAGE);  // live t slices
  __shared__ int warp_live[THREADS / 32];
  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int ncb = (n + BN - 1) / BN;
  const int nts = (kd + BK - 1) / BK;
  const int tile = order[blockIdx.x];
  const int rb = tile / ncb, cb = tile - (tile / ncb) * ncb;
  const int row0 = rb * BM;
  const int col0 = cb * BN;

  // the live t slices of this tile, in t order
  int count = 0;
  for (int base = 0; base < nts; base += THREADS) {
    const int ts = base + tid;
    bool is_live = false;
    if (ts < nts) {
      const uint8_t x = a_bits[static_cast<size_t>(rb) * nts + ts];
      const uint8_t y = b_bits[static_cast<size_t>(ts) * ncb + cb];
      const bool inert = ((x & kAllPinf) && !(y & kPoison)) || ((y & kAllPinf) && !(x & kPoison));
      is_live = !inert;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, is_live);
    if (lane == 0) warp_live[warp] = __popc(ball);
    __syncthreads();
    int at = count;
    for (int w = 0; w < THREADS / 32; ++w) {
      at += w < warp ? warp_live[w] : 0;
      count += warp_live[w];
    }
    if (is_live) live[at + __popc(ball & ((1u << lane) - 1u))] = ts;
    __syncthreads();
  }
  if (pairs != nullptr && tid == 0 && count > 0)
    atomicAdd(pairs, static_cast<unsigned long long>(count));

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = inf;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count)
      load_slice<VEC>(a, b, as + s * A_STAGE, bs + s * B_STAGE, m, kd, n, row0, col0,
                      live[s] * BK);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<STAGES - 2>();  // slice `it` has landed (this thread's copies)
    __syncthreads();              // ... and every thread's; stage it-1 is free
    const int nxt = it + STAGES - 1;
    if (nxt < count)
      load_slice<VEC>(a, b, as + (nxt % STAGES) * A_STAGE, bs + (nxt % STAGES) * B_STAGE, m, kd,
                      n, row0, col0, live[nxt] * BK);
    cp_async_commit();
    const float* sa = as + (it % STAGES) * A_STAGE;
    const float* sb = bs + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int t2 = 0; t2 < BK; t2 += 2) {
      float2 ra[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ra[i] = *reinterpret_cast<const float2*>(sa + tile_off(i, ty) * BK + t2);
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const float4 b0 = *reinterpret_cast<const float4*>(sb + (t2 + tt) * BN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(sb + (t2 + tt) * BN + 64 + 4 * tx);
        const float rbv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = tt == 0 ? ra[i].x : ra[i].y;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = min_nan(acc[i][j], __fadd_rn(av, rbv[j]));
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + tile_off(i, ty);
    if (gr >= m) continue;
    float* crow = c + static_cast<size_t>(gr) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + h * 64 + 4 * tx;
      if (VEC) {
        if (gc < n)
          *reinterpret_cast<float4*>(crow + gc) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gc + q < n) crow[gc + q] = acc[i][4 * h + q];
      }
    }
  }
}

}  // namespace

// The kernel's geometry: which = 0 -> tile rows/columns (128), 1 -> t per
// slice (32), 2 -> bytes of the shared-memory ring (its list of live t
// slices, 4 bytes each, comes on top). The wrapper shapes the bit arrays and
// checks the shared memory with these.
extern "C" int knn_minplus_geometry(int which) {
  return which == 0 ? BM : which == 1 ? BK : RING_BYTES;
}

// a: (m, k), b: (k, n) float32 row-major. a_bits: (ceil(m/128), ceil(k/32)),
// b_bits: (ceil(k/32), ceil(n/128)) bytes. Returns the CUDA error code.
extern "C" int knn_minplus_bits(const float* a, const float* b, int m, int k, int n,
                                uint8_t* a_bits, uint8_t* b_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > 0 && k > 0) {
    const dim3 grid((k + BK - 1) / BK, (m + BM - 1) / BM);
    slice_bits_kernel<<<grid, THREADS, 0, st>>>(a, m, k, BM, BK, a_bits);
  }
  if (k > 0 && n > 0) {
    const dim3 grid((n + BN - 1) / BN, (k + BK - 1) / BK);
    slice_bits_kernel<<<grid, THREADS, 0, st>>>(b, k, n, BK, BN, b_bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// c: (m, n) float32. order: the ceil(m/128) * ceil(n/128) output tiles
// (row block * column blocks + column block) in the order blocks take them.
// pairs: if not null, the (tile, t slice) pairs walked are added to it.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_minplus(const float* a, const float* b, float* c, int m, int k, int n,
                           const uint8_t* a_bits, const uint8_t* b_bits, const int* order,
                           unsigned long long* pairs, void* stream) {
  if (m == 0 || n == 0) return 0;
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const size_t smem = RING_BYTES + static_cast<size_t>((k + BK - 1) / BK) * sizeof(int);
  const bool vec = k % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(minplus_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    minplus_kernel<true><<<tiles, THREADS, smem, st>>>(a, b, c, m, k, n, a_bits, b_bits, order,
                                                       pairs);
  } else {
    err = cudaFuncSetAttribute(minplus_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    minplus_kernel<false><<<tiles, THREADS, smem, st>>>(a, b, c, m, k, n, a_bits, b_bits, order,
                                                        pairs);
  }
  return static_cast<int>(cudaGetLastError());
}
