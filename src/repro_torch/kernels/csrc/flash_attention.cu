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
// the kv head chosen by the BlockSpec index map. Here the kv loop runs inside
// a block, (m, l, acc) stay in registers, and the kv head is index math, so K
// and V are never repeated. Under the causal mask the loop stops at the query
// tile's last row: later kv tiles are all masked and would change nothing.
// Out-of-range query rows are not stored and out-of-range kv columns score
// -inf, so any S and T work, unpadded.
//
// Arithmetic as the Pallas body: scores in float32, times the scale; p = 0
// where the new max is -inf, the correction 0 where the old max is -inf; l
// sums p in float32, and p is rounded to v's type before the PV product
// (float32 accumulation); out = acc / max(l, 1e-30).
//
// Bound on an H100: operations. 4*B*H*S*T*D flops (halved under the causal
// mask) against the tensor cores' 989 TFLOP/s in bf16, while the bytes (q, k,
// v read once, the output written once) take microseconds. Head dims D in
// {8, 16, 32, 64, 128}; two routes, by dtype and D (knn_flash_attention below):
//
// - bfloat16 at D = 64 and D = 128 (namespace hopper, one template over D):
//   the tensor cores. wgmma for both products, tiles brought by TMA into a
//   ring by one loader warp, two consumer warpgroups; a three-stage ring and
//   one block an SM at both D (see there).
// - float32 at every D, and bfloat16 at D in {8, 16, 32} (namespace simt):
//   the CUDA cores. Hopper's tensor cores take float32 only as TF32 (a 10-bit
//   mantissa), too coarse for the float32 contract, and a bf16 row under 64
//   columns is narrower than a 128-byte swizzle atom, so it would need a
//   layout of its own for the few smoke and example configs that use it. One
//   block of 256 threads per (b, h, 64-row query tile), 64-row kv tiles staged
//   in shared memory as float32 (bf16 widened on the way in), float32 FMAs
//   (4 x 4 scores a thread, float4 reads of shared memory). A thread holds 4
//   query rows times D/16 output columns; at D < 64 that is fewer than one
//   float4, so the PV product reads V one column a thread (at D = 8 half the
//   threads hold no column). In bf16, p is rounded to bf16 before the PV
//   product and the output rounded once at the store, as the plain version
//   does.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

namespace simt {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // kv rows per stage
constexpr int THREADS = 256;  // 16 x 16: ty owns rows 4*ty..4*ty+3, tx columns
constexpr int KPAD = 4;      // kv row padding (floats): conflict-free float4 reads
constexpr int PPAD = 4;

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

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the element type T (round to nearest even), as T and as float
template <typename T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (sizeof(T) == 4) return x;
  else return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return widen(narrow<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + KPAD) + BQ * (BK + PPAD));
}

// Stages rows [r0, r0 + nrows) of one head of x (row stride `stride`
// elements) into dst (nrows x ld floats); rows at or past `limit` read 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* x, size_t stride, int r0,
                                      int nrows, int limit) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * ld + c] = gr < limit ? widen(x[static_cast<size_t>(gr) * stride + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s_len,
                       int t_len, int h, int hkv, int causal, float scale) {
  static_assert(D % 8 == 0 && D <= 128, "float4 rows of Q and K");
  // output columns a thread holds: NG groups of VEC adjacent columns,
  // acc[i][VEC*gi + e] is column 16*VEC*gi + VEC*tx + e (at D = 8 the
  // columns >= D of threads tx >= 8 are never read or stored)
  constexpr int VEC = D >= 64 ? 4 : 1;
  constexpr int NG = (D + 16 * VEC - 1) / (16 * VEC);
  constexpr int CPT = NG * VEC;
  constexpr int LD = D + KPAD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;           // BQ x D
  float* kv = qs + BQ * D;    // BK x LD: K, then V, of one stage
  float* ps = kv + BK * LD;   // BQ x (BK + PPAD)
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

  stage<T, D>(qs, D, qh, q_stride, q0, BQ, s_len);

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
    stage<T, D>(kv, LD, kh, kv_stride, k0, BK, t_len);
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
        ka[j] = *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * LD + d]);
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
        psum += p;  // l sums p unrounded; the PV product takes it in T
        ps[(4 * ty + i) * (BK + PPAD) + tx + 16 * j] = rounded<T>(p);
      }
      l[i] = l[i] * corr + group16_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // scores done with K; p complete
    stage<T, D>(kv, LD, vh, kv_stride, k0, BK, t_len);
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < BK; jj += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(4 * ty + i) * (BK + PPAD) + jj]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const int col = 16 * VEC * gi + VEC * tx;
          const float* row = &kv[(jj + u) * LD + col];
          float vb[VEC];
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(row);
            vb[0] = x.x, vb[1] = x.y, vb[2] = x.z, vb[3] = x.w;
          } else {
            vb[0] = col < D ? *row : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][VEC * gi + e] += p * vb[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * s_len + qi) * q_stride + static_cast<size_t>(head) * D;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = 16 * VEC * gi + VEC * tx + e;
        if (col < D) o[col] = narrow<T>(acc[i][VEC * gi + e] / den);
      }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b, int s_len,
             int t_len, int h, int hkv, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t SMEM_BYTES = smem_bytes<D>();  // 82 KB at D = 128, over 48 KB
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(SMEM_BYTES));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((s_len + BQ - 1) / BQ, h, b);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_len, t_len, h, hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_len, int t_len,
           int h, int hkv, int d, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_d<T, 8>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, stream);
    case 16: return launch_d<T, 16>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (sm_90a), one template over the head dim D in
// {64, 128}
//
// One block of nine warps per (b, h, 128-row query tile): two consumer
// warpgroups of 64 query rows each and one loader warp. One thread of the
// loader brings Q once, then K and V tiles of 128 kv rows into a ring of
// STAGES stages, each tile as D / 64 TMA boxes of 64 columns (128 bytes, one
// swizzle atom wide) x 128 rows, completing on an mbarrier per stage and
// operand. Per kv tile a consumer warpgroup computes
//   S = Q K^T   D/16 x wgmma.m64n128k16, Q and K both K-major in shared memory;
//   the online softmax on S in registers (a row spans the 4 threads of a quad);
//   O += P V    8 x wgmma.m64nDk16 with P from registers (the accumulator
//               fragment of S, rounded to bf16 in place, is the A fragment as
//               it is) and V read in its (kv, d) layout through the
//               descriptor's transpose bit, never transposed in memory;
// then gives the stage back to the loader (one arrive per warp). The two
// consumer warpgroups run unsynchronised, so one's softmax overlaps the
// other's products.
//
// What bounds it: the softmax's instructions on the CUDA cores, not the
// products. A kv tile is 64 scores a thread at either D (an ex2, an FFMA, a
// max and an add each, and a pack to bf16 per pair); the products per tile are
// 2 * 64 * 128 * 2D flops a warpgroup, which at D = 64 take about as long on
// the tensor cores as the tile's 8,192 ex2 take on the special-function
// units, so halving D halves the products and leaves the softmax. So 2^x is
// one ex2.approx, a row that is masked everywhere is guarded once per row and
// not per score, the accumulator is rescaled only where a row's max moved,
// and p is packed over the first half of S's registers.
//
// Shared memory and registers, by D: Q + STAGES x (K + V) tiles of 128 rows x
// D; S takes 64 floats a thread and O D/2, P (32 bf16 pairs) is packed over
// S[0..31], so the peak is S + O (156 registers at D = 128, 134 at D = 64, no
// spills, on an H100 with CUDA 12.8).
//
// - D = 128: Q 32 KB + 3 x (K 32 KB + V 32 KB) = 224 KB: one block an SM.
// - D = 64: Q 16 KB + 3 x (K 16 KB + V 16 KB) = 112 KB, and one block an SM
//   all the same. Two blocks would fit in shared memory only at two stages,
//   and 2 x 9 warps put five on one of the SM's four schedulers, whose 16,384
//   registers leave 96 a thread: ptxas then spilled ~500 bytes a thread and
//   serialised the wgmma, and the kernel ran 2.1x slower. The rings that
//   fit one block (two, three, four stages) time within 10% of each other;
//   three, as at D = 128.
//   tools/k6_variants.py builds copies of this file at other depths and
//   blocks an SM, and prints ptxas's registers and spills and their times.
//
// A quarter of the register file holds three of the nine warps, so ptxas
// allocates at most 168 a thread; setmaxnreg (24 for a loading warpgroup,
// 240 for the consumers) was tried at D = 128 with twelve warps and spilled,
// so the loader is one warp and there is no setmaxnreg.
//
// Layout contract, the one place a wrong bit gives wrong numbers and no
// fault: TMA writes each box with CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk c
// of row r lands at chunk c ^ (r % 8)), keyed on address bits 4-9, so every
// tile starts on 1024 bytes; the wgmma descriptors say "128-byte swizzle"
// (layout type 1). K-major (Q, K; the same at both D): 8-row groups 1024 bytes
// apart (SBO), a k16 step advances the start by 32 bytes within the atom, and
// k >= 64 (D = 128 only) moves to the second box; LBO is not read. MN-major
// (V): 8-row k groups 1024 bytes apart (SBO), a k16 step is 2048 bytes, and
// LBO is the step from one 64-column atom of the N dimension to the next:
// 16 KB, one box, at D = 128 (N = 128, two atoms). At D = 64, N = 64 is one
// atom, so LBO is never read; it is given the same 16 KB.
//
// Ragged edges: TMA zero-fills rows past S or T; a zero K row would score 0,
// so columns >= T are masked to -inf (only in the tile that holds T, and in
// the diagonal tile under the causal mask); query rows >= S are not stored.
// Query tiles run heaviest first (blockIdx.y reversed), so the causal grid's
// tail is short. The query heads sharing a kv head are adjacent in
// blockIdx.x and reread its tiles from L2; packing them into one block (one
// K/V load for several heads) was not tried.
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int BQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;         // kv rows per tile
constexpr int THREADS = 288;    // warpgroups 0 and 1 compute, warp 8 loads
constexpr int BOX = 64;         // columns of a TMA box: 64 bf16, one 128-byte swizzle atom
constexpr uint32_t BOX_BYTES = 128 * BOX * 2;   // 128 rows x 128 bytes
static_assert(BQ == 128 && BK == 128, "one box shape serves Q, K and V");

// The ring's depth at head dim D; one block an SM at either D.
template <int D>
struct Cfg;
template <>
struct Cfg<128> {
  static constexpr int STAGES = 3;
};
template <>
struct Cfg<64> {
  static constexpr int STAGES = 3;
};

template <int D>
constexpr uint32_t tile_bytes() {
  static_assert(D % BOX == 0, "a tile is whole boxes");
  return (D / BOX) * BOX_BYTES;  // 128 rows x D
}
// Q, the K and V rings, 1 + 3 * STAGES mbarriers, and room to align to 1024
template <int D>
constexpr size_t smem_bytes() {
  return (1 + 2 * Cfg<D>::STAGES) * tile_bytes<D>() + 8 * (1 + 3 * Cfg<D>::STAGES) + 1024;
}
static_assert(smem_bytes<128>() <= 232448 && smem_bytes<64>() <= 232448,
              "a block fits an SM's shared memory");
// a wait longer than this many cycles (~9 s at 1.98 GHz) traps instead of hanging
constexpr long long WAIT_LIMIT = 1ll << 34;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT) __trap();
}

// One box: coordinates innermost first (column, head, row, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand: start address, leading and
// stride byte offsets (16-byte units), layout type 1 (128-byte swizzle) in
// bits 62-63, base offset 0 (atoms on 1024 bytes).
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define HOPPER_D32                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),          \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define HOPPER_D64                                                                     \
  HOPPER_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),    \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),    \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_R64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 128), A and
// B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : HOPPER_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers) B (16 x N), B
// MN-major in shared memory (transpose bit set); N = 128 or 64, by d's size.
// a0..a3 are bf16 pairs carried in float registers (pack_bf16).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], float a0, float a1, float a2, float a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : HOPPER_D64
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], float a0, float a1, float a2, float a3,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : HOPPER_D32
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "l"(b), "r"(1));
}

#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_R32
#undef HOPPER_R64

// two floats rounded to a bf16 pair (lo in the low half), as the bits of a float
__device__ __forceinline__ float pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return __uint_as_float(*reinterpret_cast<const uint32_t*>(&v));
}

// 2^x on the special-function unit; results under 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory addresses of one block: Q, the K and V rings, then the
// mbarriers (q_full, k_full[], v_full[], empty[]).
template <int D>
struct Smem {
  static constexpr uint32_t TILE = tile_bytes<D>();
  static constexpr int STAGES = Cfg<D>::STAGES;
  uint32_t q, bars;
  __device__ uint32_t k(int st) const { return q + TILE * (1 + st); }
  __device__ uint32_t v(int st) const { return q + TILE * (1 + STAGES + st); }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int st) const { return bars + 8u * (1 + st); }
  __device__ uint32_t v_full(int st) const { return bars + 8u * (1 + STAGES + st); }
  __device__ uint32_t empty(int st) const { return bars + 8u * (1 + 2 * STAGES + st); }
};

// The loader thread: Q once, then K and V tile by tile into the ring, each
// stage reused once both consumer warpgroups have given it back.
template <int D>
__device__ __forceinline__ void load_tiles(const Smem<D>& sm, const CUtensorMap* q_map,
                                           const CUtensorMap* k_map, const CUtensorMap* v_map,
                                           int b, int head, int g, int q0, int n_kv) {
  constexpr int STAGES = Cfg<D>::STAGES;
  mbar_expect_tx(sm.q_full(), Smem<D>::TILE);
#pragma unroll
  for (int x = 0; x < D / BOX; ++x)
    tma_load(sm.q + x * BOX_BYTES, q_map, sm.q_full(), x * BOX, head, q0, b);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(sm.empty(st), (it / STAGES - 1) & 1);
    mbar_expect_tx(sm.k_full(st), Smem<D>::TILE);
#pragma unroll
    for (int x = 0; x < D / BOX; ++x)
      tma_load(sm.k(st) + x * BOX_BYTES, k_map, sm.k_full(st), x * BOX, g, it * BK, b);
    mbar_expect_tx(sm.v_full(st), Smem<D>::TILE);
#pragma unroll
    for (int x = 0; x < D / BOX; ++x)
      tma_load(sm.v(st) + x * BOX_BYTES, v_map, sm.v_full(st), x * BOX, g, it * BK, b);
  }
}

// One kv tile of the online softmax, in place: masks the columns past T (and
// past the row under the causal mask) where the tile holds any, turns s into
// p = exp(s * scale - m_new), and updates the running max and sum. corr[i] is
// what the accumulator's row i must be multiplied by (exactly 1 where the max
// did not move).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, bool mask,
                                             const int (&qi)[2], int c, int t_len, int causal,
                                             float scale_log2) {
  const float neg_inf = __int_as_float(0xff800000);
  if (mask) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 8 * n + c + (e & 1);
        if (kj >= t_len || (causal && kj > qi[e >> 1])) s[4 * n + e] = neg_inf;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = neg_inf;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // a row spans the quad
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    // a row masked everywhere so far keeps m = -inf, and its p = 2^-inf = 0
    const float mb = m_new == neg_inf ? 0.0f : __fmul_rn(m_new, scale_log2);
    corr[i] = ex2(__fmul_rn(m[i], scale_log2) - mb);  // 0 while m was -inf
    float psum = 0.0f;  // this thread's columns; the quad's sum is taken at the end
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ex2(fmaf(s[4 * n + 2 * i + j], scale_log2, -mb));
        s[4 * n + 2 * i + j] = p;
        psum += p;
      }
    l[i] = l[i] * corr[i] + psum;
    m[i] = m_new;
  }
}

// A consumer warpgroup: its 64 query rows against every kv tile, then the
// normalised rows stored.
template <int D>
__device__ __forceinline__ void consume(const Smem<D>& sm, __nv_bfloat16* __restrict__ out, int b,
                                        int head, int h, int q0, int n_kv, int s_len, int t_len,
                                        int causal, float scale_log2) {
  constexpr int STAGES = Cfg<D>::STAGES;
  const int cw = threadIdx.x / 128;  // rows 64*cw .. 64*cw+63 of the tile
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  // accumulator fragments: this thread holds rows r and r + 8, columns 8n + c
  // and 8n + c + 1 (register 4n + 2i + j: row r + 8i, column 8n + c + j), for
  // n < 16 in S and n < D/8 in O
  const int r = 64 * cw + 16 * warp + lane / 4;
  const int c = 2 * (lane % 4);
  const int qi[2] = {q0 + r, q0 + r + 8};
  const uint32_t q_rows = sm.q + cw * 64 * 128;  // this warpgroup's 64 rows in each box

  float o[D / 2], s[64];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) o[x] = 0.0f;
  float m[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
  float l[2] = {0.0f, 0.0f}, corr[2];

  mbar_wait(sm.q_full(), 0);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int k0 = it * BK;

    mbar_wait(sm.k_full(st), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss(s, sw128(q_rows + off, 16, 1024), sw128(sm.k(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();

    // a mask only where the tile holds T, or, under the causal mask, reaches
    // past this warpgroup's first row
    const bool mask = k0 + BK > t_len || (causal && k0 + BK - 1 > q0 + 64 * cw);
    softmax_tile(s, m, l, corr, k0, mask, qi, c, t_len, causal, scale_log2);
    if (!__all_sync(0xffffffffu, corr[0] == 1.0f && corr[1] == 1.0f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
    }
    // p packed over s[0..31]: s[j] takes columns of s[2j] and s[2j + 1], which
    // no earlier j overwrote; s[4kk..4kk+3] is then the A fragment of k-step kk
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) s[j] = pack_bf16(s[2 * j], s[2 * j + 1]);

    mbar_wait(sm.v_full(st), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, s[4 * kk], s[4 * kk + 1], s[4 * kk + 2], s[4 * kk + 3],
               sw128(sm.v(st) + kk * 2048, BOX_BYTES, 1024));
    wgmma_commit();
    wgmma_wait();
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(st));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qi[i] >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* row = out + ((static_cast<size_t>(b) * s_len + qi[i]) * h + head) * D + c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * i] / den, o[4 * n + 2 * i + 1] / den);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attention_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                int s_len, int t_len, int h, int hkv, int causal, float scale_log2) {
  constexpr int STAGES = Cfg<D>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Smem<D> sm;
  sm.q = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms start on 1024 bytes
  sm.bars = sm.q + (1 + 2 * STAGES) * Smem<D>::TILE;
  const int b = blockIdx.x / h;
  const int head = blockIdx.x % h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest query tiles first
  const int kv_end = causal ? min(t_len, q0 + BQ) : t_len;
  const int n_kv = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.k_full(st), 1);
      mbar_init(sm.v_full(st), 1);
      mbar_init(sm.empty(st), 8);  // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 256)
    consume<D>(sm, out, b, head, h, q0, n_kv, s_len, t_len, causal, scale_log2);
  else if (threadIdx.x == 256)
    load_tiles<D>(sm, &q_map, &k_map, &v_map, b, head, head / (h / hkv), q0, n_kv);
}

// cuTensorMapEncodeTiled is a driver function: fetched through the runtime,
// so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (batches, rows, heads, d) bf16 tensor as a 4-D map, innermost first, read
// in boxes of 64 columns x 128 rows of one head; rows past the end read 0.
int make_map(CUtensorMap* map, const void* ptr, int batches, int rows, int heads, int d) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t head_bytes = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * head_bytes;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[3] = {head_bytes, row_bytes, row_bytes * rows};  // bytes, dims 1..3
  const cuuint32_t box[4] = {BOX, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// lets attention_wgmma<D> take its dynamic shared memory (over 48 KB)
template <int D>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<D>()));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int s_len, int t_len,
           int h, int hkv, int causal, float scale, cudaStream_t stream) {
  const int q_tiles = (s_len + BQ - 1) / BQ;
  if (q_tiles > 65535 || static_cast<long long>(b) * h > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int e = make_map(&q_map, q, b, s_len, h, D);
  // with no kv rows the K and V maps describe q instead: the kv loop is
  // empty, nothing reads them, and every row comes out 0
  if (e == 0)
    e = t_len ? make_map(&k_map, k, b, t_len, hkv, D) : make_map(&k_map, q, b, s_len, h, D);
  if (e == 0)
    e = t_len ? make_map(&v_map, v, b, t_len, hkv, D) : make_map(&v_map, q, b, s_len, h, D);
  if (e != 0) return e;
  const cudaError_t a = allow_smem<D>();
  if (a != cudaSuccess) return static_cast<int>(a);
  attention_wgmma<D><<<dim3(b * h, q_tiles), THREADS, smem_bytes<D>(), stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), s_len, t_len, h, hkv, causal,
      scale * 1.4426950408889634f);  // log2(e): exp(x) = exp2(x log2 e)
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

}  // namespace

// q, out: (b, s, h, d); k, v: (b, t, hkv, d); row-major. route 0: all float32,
// the CUDA-core kernel; route 1: all bfloat16 at d = 64 or 128, the
// tensor-core kernel (every pointer 16-byte aligned, as TMA asks); route 2:
// all bfloat16, the CUDA-core kernel. d is 8, 16, 32, 64 or 128 and h a
// multiple of hkv. Returns the CUDA error code of the launch (0 = launched).
extern "C" int knn_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int route, int b, int s_len, int t_len, int h, int hkv,
                                   int d, int causal, float scale, void* stream) {
  if (b == 0 || s_len == 0 || h == 0) return 0;
  if (hkv <= 0 || h % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0)
    return simt::launch<float>(q, k, v, out, b, s_len, t_len, h, hkv, d, causal, scale, st);
  if (route == 1 && d == 64)
    return hopper::launch<64>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, st);
  if (route == 1 && d == 128)
    return hopper::launch<128>(q, k, v, out, b, s_len, t_len, h, hkv, causal, scale, st);
  if (route == 2)
    return simt::launch<__nv_bfloat16>(q, k, v, out, b, s_len, t_len, h, hkv, d, causal, scale,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
