// K5 retrieval_topk: per row of a (B, N) score matrix, the k largest scores
// and their column indices; ties go to the smaller column, a -inf score (and a
// NaN, read as -inf) gives (-1, -inf), and a row with fewer than k such
// columns is padded with (-1, -inf). Scores are float32, float16 or bfloat16;
// the selection is done in float32.
//
// Replaces the TPU kernel `retrieval_topk_pallas` / `_retrieval_topk_kernel`
// (src/repro/kernels/retrieval_topk.py), whose grid walked N in order and
// carried the running (block_b, k) best set from one tile to the next, on
// inputs padded to its tile with -inf. On the GPU a row of the retrieval cell
// (B = 1, N = 10^6) would then run on one SM. Here N is split across blocks:
// one block of 1024 threads per (row, tile of 8192 columns) selects the tile's
// k best into a (B, tiles, k) buffer of packed keys, and the same kernel runs
// again over that buffer (8192 keys per block) until one tile is left, whose
// block writes the answer. Each pass is one launch; at N = 10^6 and k = 100
// there are three. Columns past N read as -inf, so nothing is padded.
//
// Order: each candidate is one 64-bit key, (order-preserving bits of the
// float32 score) << 32 | (0xffffffff - column). A larger key is a larger
// score, or the same score at a smaller column, so one unsigned compare gives
// the order; the key 0 is "no candidate" and sorts last. Keys are distinct
// (columns are), so the answer does not depend on the order of the selection.
//
// Selection inside a block, without k rounds over the whole tile: every
// thread holds 8 keys in registers and its maximum goes to shared memory. The
// k-th largest of the 1024 maxima, theta, is at most the tile's k-th largest
// key (it is the k-th largest of 1024 distinct tile keys). So the tile's k
// best are among the keys >= theta, and at most k threads own such keys, at
// most 8 each: at most 8k survivors. A bitonic sort of the maxima and one of
// the survivors (in shared memory) give the k best in order.
//
// Bound on an H100: bytes. The call must read B*N scores once and write B*k
// ids and scores; the selection does a few compares per score. The design
// reads each score once, coalesced, and keeps everything else on chip; at the
// retrieval cell's 4 MB the launches, not the bytes, set the time.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long topk_key;

constexpr int THREADS = 1024;
constexpr int PER_THREAD = 8;
constexpr int TILE = THREADS * PER_THREAD;  // columns (or keys) per block

enum { kF32 = 0, kF16 = 1, kBF16 = 2, kKeys = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ topk_key pack(float s, uint32_t col) {
  const uint32_t u = __float_as_uint(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0
  if (s != s || u == 0xff800000u) return 0;               // NaN, -inf
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<topk_key>(ord) << 32) | (0xffffffffu - col);
}

__device__ __forceinline__ int key_col(topk_key key) {
  return key == 0 ? -1 : static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ float key_score(topk_key key) {
  if (key == 0) return __int_as_float(0xff800000);
  const uint32_t ord = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// Sorts s[0..p) into descending order; p is a power of two. Every thread of
// the block calls it; returns after a barrier.
__device__ void bitonic_desc(topk_key* s, int p) {
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const topk_key a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// in: (rows, width) scores of type In, or keys. A pass that is not the last
// writes each block's k best keys to out_keys (rows, tiles, k); the last pass
// (tiles == 1) writes ids and float32 scores (rows, k).
template <typename In, bool KEYS>
__global__ void __launch_bounds__(THREADS)
retrieval_topk_kernel(const In* __restrict__ in, int width, int k,
                      topk_key* __restrict__ out_keys, int* __restrict__ out_ids,
                      float* __restrict__ out_s) {
  extern __shared__ topk_key smem[];
  topk_key* maxes = smem;           // THREADS
  topk_key* cand = smem + THREADS;  // cand_cap(k) keys
  __shared__ int count;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const size_t row = blockIdx.y;
  const In* rin = in + row * static_cast<size_t>(width);
  const int base = tile * TILE;

  topk_key v[PER_THREAD];
  topk_key mine = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int col = base + j * THREADS + tid;
    topk_key key = 0;
    if (col < width) {
      if constexpr (KEYS) {
        key = rin[col];
      } else {
        key = pack(to_f32(rin[col]), static_cast<uint32_t>(col));
      }
    }
    v[j] = key;
    mine = key > mine ? key : mine;
  }
  maxes[tid] = mine;
  if (tid == 0) count = 0;
  bitonic_desc(maxes, THREADS);
  const topk_key theta = maxes[k - 1];

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    if (v[j] != 0 && v[j] >= theta) cand[atomicAdd(&count, 1)] = v[j];
  }
  __syncthreads();
  const int n = count;
  int p = 1;
  while (p < n || p < k) p <<= 1;
  for (int i = n + tid; i < p; i += THREADS) cand[i] = 0;
  bitonic_desc(cand, p);

  if (tiles > 1) {
    topk_key* o = out_keys + (row * tiles + tile) * static_cast<size_t>(k);
    for (int r = tid; r < k; r += THREADS) o[r] = cand[r];
  } else {
    for (int r = tid; r < k; r += THREADS) {
      out_ids[row * k + r] = key_col(cand[r]);
      out_s[row * k + r] = key_score(cand[r]);
    }
  }
}

// Survivor-buffer length: a power of two that holds min(TILE, 8k) keys and
// the k outputs.
int cand_cap(int k) {
  const int need = k * PER_THREAD < TILE ? k * PER_THREAD : TILE;
  int p = 1;
  while (p < need || p < k) p <<= 1;
  return p;
}

template <typename In, bool KEYS>
int launch(const void* in, int rows, int width, int k, topk_key* out_keys,
           int* out_ids, float* out_s, cudaStream_t stream) {
  const int tiles = width > 0 ? (width + TILE - 1) / TILE : 1;
  const size_t smem = static_cast<size_t>(THREADS + cand_cap(k)) * sizeof(topk_key);
  auto kernel = retrieval_topk_kernel<In, KEYS>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(tiles, rows), THREADS, smem, stream>>>(
      static_cast<const In*>(in), width, k, out_keys, out_ids, out_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Columns (or keys) one block takes; a pass over `width` has
// ceil(width / knn_retrieval_tile()) blocks per row.
extern "C" int knn_retrieval_tile() { return TILE; }

// One pass. in: (rows, width) of type `dtype` (0 float32, 1 float16,
// 2 bfloat16, 3 keys of an earlier pass), row-major. With more than one tile
// the pass writes out_keys (rows, tiles, k); with one, out_ids and out_s
// (rows, k). k <= 1024, rows <= 65535. Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int knn_retrieval_topk(const void* in, int dtype, int rows, int width,
                                  int k, void* out_keys, int* out_ids, float* out_s,
                                  void* stream) {
  if (rows == 0) return 0;
  if (k < 1 || k > THREADS) return static_cast<int>(cudaErrorInvalidValue);
  topk_key* keys = static_cast<topk_key*>(out_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float, false>(in, rows, width, k, keys, out_ids, out_s, s);
    case kF16: return launch<__half, false>(in, rows, width, k, keys, out_ids, out_s, s);
    case kBF16:
      return launch<__nv_bfloat16, false>(in, rows, width, k, keys, out_ids, out_s, s);
    case kKeys: return launch<topk_key, true>(in, rows, width, k, keys, out_ids, out_s, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
