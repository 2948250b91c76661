// K6 flash_attention: the attention forward pass
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] / sqrt(D)) v[b, j, g]
// with g = h / (H / Hkv) (grouped-query attention), j <= i when causal
// (absolute positions from 0), q (B, S, H, D), k and v (B, T, Hkv, D), all
// float32 or all bfloat16, the output in q's type. A row whose every column is
// masked comes out 0.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention.py), a (B*H, S/bq, T/bk) grid whose
// innermost, sequential axis carried the running max m, sum l and float32
// accumulator of one query block across the kv blocks in VMEM scratch, with
// the kv head chosen by the BlockSpec index map. Here: one block of 256
// threads per (b, h, 64-row query tile); the kv loop runs inside the block over
// 64-row kv tiles staged in shared memory, and (m, l, acc) stay in registers.
// The kv head is index math, so K and V are never repeated. Under the causal
// mask the loop stops at the tile's last row: later kv tiles are all masked
// and would change nothing. Out-of-range query rows read 0 and are not
// stored; out-of-range kv columns score -inf. So any S and T work, unpadded.
//
// Arithmetic as the Pallas body: scores in float32 from q and k widened to
// float32, times the scale; p = 0 where the new max is -inf, the correction
// 0 where the old max is -inf; l sums p in float32, and p is rounded to v's
// type before the PV product (float32 accumulation); out = acc / max(l, 1e-30).
//
// Bound on an H100: operations. 4*B*H*S*T*D flops (halved under the causal
// mask) against the tensor cores' 989 TFLOP/s in bf16, while the bytes (q, k,
// v read once, the output written once) take microseconds. This first kernel
// does the products with float32 FMAs on the CUDA cores (4 x 4 scores and
// 4 x D/16 outputs per thread, float4 reads of shared memory), so it cannot
// come within 15x of that bound; wgmma is the step after.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 128;       // head dim (every model the port serves)
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // kv rows per stage
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4*ty..4*ty+3, tx columns
constexpr int KPAD = 4;      // kv row padding (floats): conflict-free float4 reads
constexpr int PPAD = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p as the PV product sees it: rounded to v's type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * D + BK * (D + KPAD) + BQ * (BK + PPAD));

// Stages rows [r0, r0 + nrows) of one head of x (row stride `stride`
// elements) into dst (nrows x ld floats); rows at or past `limit` read 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* x, size_t stride,
                                      int r0, int nrows, int limit) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * ld + c] = gr < limit ? to_f32(x[static_cast<size_t>(gr) * stride + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int t_len, int h, int hkv, int causal, float scale) {
  constexpr int CPT = D / 16;  // output columns per thread: CPT/4 float4 groups
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // BQ x D
  float* kv = qs + BQ * D;           // BK x (D + KPAD): K, then V, of one stage
  float* ps = kv + BK * (D + KPAD);  // BQ x (BK + PPAD)
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int g = head / (h / hkv);
  const size_t q_stride = static_cast<size_t>(h) * D;
  const size_t kv_stride = static_cast<size_t>(hkv) * D;
  const T* qh = q + (static_cast<size_t>(b) * s_len * h + head) * D;
  const T* kh = k + (static_cast<size_t>(b) * t_len * hkv + g) * D;
  const T* vh = v + (static_cast<size_t>(b) * t_len * hkv + g) * D;
  const float neg_inf = __int_as_float(0xff800000);

  stage<T>(qs, D, qh, q_stride, q0, BQ, s_len);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  const int kv_end = causal ? min(t_len, q0 + BQ) : t_len;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous stage's PV product is done with kv and ps
    stage<T>(kv, D + KPAD, kh, kv_stride, k0, BK, t_len);
    __syncthreads();

    // scores of rows 4*ty+i, columns tx + 16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * D + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * (D + KPAD) + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += qa[i].x * ka[j].x + qa[i].y * ka[j].y + qa[i].z * ka[j].z +
                      qa[i].w * ka[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < t_len && (!causal || qi >= kj);
        sc[i][j] = keep ? sc[i][j] * scale : neg_inf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      const bool live = isfinite(m_new);
      const float corr = isfinite(m[i]) ? expf(m[i] - m_new) : 0.0f;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live ? expf(sc[i][j] - m_new) : 0.0f;
        psum += p;
        ps[(4 * ty + i) * (BK + PPAD) + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + group16_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // scores done with K; p complete
    stage<T>(kv, D + KPAD, vh, kv_stride, k0, BK, t_len);
    __syncthreads();

    // acc[i][4*gi + e] is output column 64*gi + 4*tx + e
#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * (BK + PPAD) + jj]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int gi = 0; gi < CPT / 4; ++gi) {
          const float4 vb =
              *reinterpret_cast<const float4*>(&kv[(jj + u) * (D + KPAD) + 64 * gi + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
            acc[i][4 * gi + 0] += p * vb.x;
            acc[i][4 * gi + 1] += p * vb.y;
            acc[i][4 * gi + 2] += p * vb.z;
            acc[i][4 * gi + 3] += p * vb.w;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= s_len) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * s_len + qi) * q_stride +
           static_cast<size_t>(head) * D;
#pragma unroll
    for (int gi = 0; gi < CPT / 4; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[64 * gi + 4 * tx + e] = from_f32<T>(acc[i][4 * gi + e] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_len,
           int t_len, int h, int hkv, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));  // 82 KB, over 48 KB
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s_len + BQ - 1) / BQ, h, b);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_len, t_len, h, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (b, s, h, d); k, v: (b, t, hkv, d); row-major, all float32
// (dtype 0) or all bfloat16 (dtype 1); d is 128 and h a multiple of hkv.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int dtype, int b, int s_len, int t_len, int h, int hkv,
                                   int d, int causal, float scale, void* stream) {
  if (b == 0 || s_len == 0 || h == 0) return 0;
  if (hkv <= 0 || h % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != D) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
