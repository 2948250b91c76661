// K5 retrieval_topk: per row of a (B, N) score matrix, the k largest scores
// and their column indices, best first; ties go to the smaller column, a -inf
// score (and a NaN, read as -inf) gives (-1, -inf), -0.0 reads as +0.0, +inf
// is an ordinary largest score, and a row with fewer than k such columns is
// padded with (-1, -inf). Scores are float32, float16 or bfloat16; the
// selection is done in float32.
//
// Replaces the TPU kernel `retrieval_topk_pallas` / `_retrieval_topk_kernel`
// (src/repro/kernels/retrieval_topk.py), whose grid walked N in order and
// carried the running (block_b, k) best set from one tile to the next.
//
// What bounds it on an H100: bytes. A call must read B*N*elem bytes once and
// write B*k*8; the selection needs a few compares a score. At the retrieval
// cell (B = 1, N = 10^6) the 4 MB read takes ~1.2 us at 3.35 TB/s, under the
// launch latency, so there the launch count and the serial tail decide; at
// (512, 10^6) it is 0.6 ms of reading, and the kernel must stream.
//
// The design, one launch a call at every shape:
// - The grid is B * P blocks of 256 threads on its x axis (any B), block =
//   (row, part): part p of a row streams its share of the columns once, with
//   16-byte loads, the next round's loads in flight while a round is
//   filtered (a scalar head and tail where the row's address is not 16-byte
//   aligned). ops.retrieval_plan picks P: as many blocks as the card holds
//   at once, no part under 4,096 columns, P * k keys at most 32,768.
// - Selection inside a part keeps a running threshold theta, not sorts:
//   each score becomes a key (below); a key > theta is appended to a
//   shared-memory buffer, a warp at a time with one atomicAdd. Before its
//   first round goes in, theta rises to just below the k-th largest of the
//   threads' largest keys of that round (counted by rank; k <= 256), which
//   is at most the part's k-th key. Once the buffer holds more than
//   max(512, k) keys the block radix-selects the k-th largest of the k best
//   so far and the buffer (11-bit digits from the highest bit where the
//   keys differ, a shared histogram, three barriers a digit, stopping once
//   the digit's count decides), keeps exactly the k keys at or above it, and
//   that key becomes theta. Keys are distinct, so once k keys are >= theta
//   no key below it is among the k best. On random scores the part is then
//   a load stream with one barrier a round of 2,048 columns (the old design
//   sorted 1,024 keys twice every 8,192 columns: ~110 barriers).
// - The last step orders the k best of what is left by rank: each thread
//   counts the larger keys of its own (up to 512 keys; past that a bitonic
//   sort), and writes each key at its rank.
// - Merge in the same launch: with P > 1 each part writes its k best, rank
//   by rank, to a (B, k, P) scratch, so rank k - 1 holds each part's k-th
//   key (0 if it saw fewer than k); then it counts itself on its row's
//   arrival counter. The block that arrives last streams the row's keys,
//   rank by rank, through the same selection, starting from theta_lb - 1,
//   theta_lb the largest of the parts' k-th keys (the part that holds it has
//   k keys >= it, so the row's k-th key is >= theta_lb), and stops after a
//   round that appends nothing: every later key ranks below one of that
//   round's in its own part. It writes ids and scores by rank and sets the
//   counter back to 0 for the next call. With P = 1 the block writes the
//   answer itself and touches no counter.
//
// Memory order of the merge: every thread of a part stores its keys, then
// __threadfence() (its stores are visible device-wide before anything it
// does later), then __syncthreads(); thread 0's atomicAdd on the counter
// therefore comes after all of the part's stores. The block that reads P - 1
// from the atomicAdd has seen every other part's atomicAdd, hence (fence
// cumulativity) every other part's stores; it fences again and reads the
// scratch with __ldcg, from L2, since L1 is not coherent across SMs. The
// counter is reset by that block alone, after all P arrivals; the next call
// on the stream starts after this one ends.
//
// Order: each candidate is one 64-bit key, (order-preserving bits of the
// float32 score) << 32 | (0xffffffff - column). A larger key is a larger
// score, or the same score at a smaller column, so one unsigned compare gives
// the order; the key 0 is "no candidate" and sorts last. Keys are distinct
// (columns are), so the answer does not depend on the order of the selection.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long topk_key;

constexpr int THREADS = 256;
constexpr int KPT = 8;                // keys a thread filters a round
constexpr int ROUND = THREADS * KPT;  // keys a block filters a round
constexpr int SLACK = 512;            // a block selects past max(SLACK, k) appended keys
constexpr int MAX_K = 1024;
constexpr int DIGIT = 11;             // bits a radix-select digit
constexpr int BINS = 1 << DIGIT;
constexpr int BINS_PT = BINS / THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int PLACE_MAX = 4 * THREADS;  // keys the last step orders without a selection
static_assert(PLACE_MAX >= MAX_K && PLACE_MAX <= ROUND + SLACK,
              "a selection's k keys, and the last step's sort, must fit the append buffer");
constexpr unsigned FULL = 0xffffffffu;

enum { kF32 = 0, kF16 = 1, kBF16 = 2 };

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

// element e of a 16-byte vector of scores, as float32
template <typename In> __device__ __forceinline__ float elem(const uint4& v, int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[e]);
}
__device__ __forceinline__ unsigned short half_bits(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return static_cast<unsigned short>((e & 1) ? w[e >> 1] >> 16 : w[e >> 1] & 0xffffu);
}
template <> __device__ __forceinline__ float elem<__half>(const uint4& v, int e) {
  return __half2float(__ushort_as_half(half_bits(v, e)));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  return __bfloat162float(__ushort_as_bfloat16(half_bits(v, e)));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct State {
  int selects;      // selections this block made (read by K5_TIMING builds)
  int na;           // keys in the append buffer
  int n;            // a selection's output count
  int digit, kk, cnt;
  int last;         // this block merges its row
  topk_key kth;     // the selected key
  topk_key lo, hi;  // a selection's smallest and largest key (~0 and 0 between)
  topk_key lb;      // the merge's theta_lb (atomicMax over the parts' k-th keys)
  int warp_sum[WARPS];
};

// A block's shared memory: the dynamic keys (the append buffer of
// ROUND + lim keys, then two regions of k), a radix histogram (zero between
// selections) and the block's state.
extern __shared__ topk_key smem[];
__shared__ int hist[BINS];
__shared__ State st;

// A block's selection, in registers and the same in every thread.
struct Sel {
  int top;         // offset in smem of the k best so far (nt of them)
  int spare;       // offset in smem of the region a selection fills
  int k, lim, nt;
  topk_key theta;  // only keys > theta are appended
};

#ifdef K5_TIMING
// Phase times (globaltimer, ns) of two blocks, for `tools/k5_variants.py
// --timing`, which builds with -DK5_TIMING: [0] the first part of row 0,
// [1] the block that writes row 0's answer. Other builds mark nothing.
__device__ unsigned long long k5_marks[2][8];
__device__ __forceinline__ unsigned long long k5_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K5_MARK(block, i, value) \
  do {                            \
    if (threadIdx.x == 0) k5_marks[block][i] = (value); \
  } while (0)
#else
#define K5_MARK(block, i, value) \
  do {                            \
  } while (0)
#endif

// Key i of top[0..nt) then the append buffer (smem from 0), or 0 past total.
__device__ __forceinline__ topk_key candidate(const Sel& s, int total, int i) {
  return i < total ? smem[i < s.nt ? s.top + i : i - s.nt] : 0;
}

// The k-th largest of top[0..nt) and the append buffer's na keys (distinct,
// nonzero, k <= nt + na), by radix select; the k keys >= it go to the spare
// region, which becomes the top, and the append buffer empties. The bits
// above the highest one where the smallest and the largest key differ are
// every key's, so the first DIGIT-bit digit ends at that bit. A digit is a
// shared histogram (each run of lanes with the same bin adds once) and three
// barriers; the selection stops once the digit's count decides (the wanted
// rank's digit group is taken whole). Every thread calls it after a barrier
// (so all have read st.na); returns after one.
__device__ __forceinline__ void select_top(Sel& s, int na) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = s.nt + na;
  topk_key lo = ~0ull, hi = 0;
  for (int i = tid; i < total; i += THREADS) {
    const topk_key key = candidate(s, total, i);
    lo = min(lo, key);
    hi = max(hi, key);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0) {
    atomicMin(&st.lo, lo);
    atomicMax(&st.hi, hi);
  }
  __syncthreads();
  lo = st.lo;
  hi = st.hi;
  if (tid == 0) {
    st.na = 0;
    st.n = 0;
    st.kth = ~0ull;
    ++st.selects;
  }
  __syncthreads();
  if (tid == 0) {
    st.lo = ~0ull;
    st.hi = 0;
  }
  const int top_bit = lo == hi ? -1 : 63 - __clzll(static_cast<long long>(lo ^ hi));
  topk_key mask = top_bit >= 63 ? 0 : ~0ull << (top_bit + 1);  // the bits decided so far
  topk_key prefix = lo & mask;
  int kk = s.k;     // rank wanted among the keys under prefix
  int cnt = total;  // keys under prefix
  for (int shift = max(top_bit + 1 - DIGIT, 0); cnt != kk; shift = max(shift - DIGIT, 0)) {
#pragma unroll 4
    for (int base = 0; base < total; base += THREADS) {
      const topk_key key = candidate(s, total, base + tid);
      const bool in = key && (key & mask) == prefix;
      const int bin = in ? static_cast<int>(key >> shift) & (BINS - 1) : -1 - lane;
      const int below = __shfl_up_sync(FULL, bin, 1);
      const unsigned starts = __ballot_sync(FULL, lane == 0 || below != bin);
      if (in && ((starts >> lane) & 1)) {
        const unsigned later = lane == 31 ? 0 : starts >> (lane + 1);
        atomicAdd(&hist[bin], later ? __ffs(later) : 32 - lane);
      }
    }
    __syncthreads();
    // thread t holds bins BINS - 1 - BINS_PT t down to BINS - BINS_PT (t + 1)
    int c[BINS_PT], sum = 0;
#pragma unroll
    for (int j = 0; j < BINS_PT; ++j) {
      c[j] = hist[BINS - 1 - BINS_PT * tid - j];
      sum += c[j];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) st.warp_sum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += st.warp_sum[w];
    int acc = incl - sum;
    if (acc < kk && kk <= incl) {
      bool found = false;
#pragma unroll
      for (int j = 0; j < BINS_PT; ++j) {
        if (!found && acc + c[j] >= kk) {
          found = true;
          st.digit = BINS - 1 - BINS_PT * tid - j;
          st.kk = kk - acc;
          st.cnt = c[j];
        }
        acc += c[j];
      }
    }
#pragma unroll
    for (int j = 0; j < BINS_PT; ++j) hist[BINS - 1 - BINS_PT * tid - j] = 0;
    __syncthreads();
    prefix |= static_cast<topk_key>(st.digit) << shift;
    mask |= static_cast<topk_key>(BINS - 1) << shift;
    kk = st.kk;
    cnt = st.cnt;
  }
  // keys above the group, and the group: k keys, placed a warp at a time;
  // the k-th is the group's smallest
  topk_key least = ~0ull;
#pragma unroll 4
  for (int base = 0; base < total; base += THREADS) {
    const topk_key key = candidate(s, total, base + tid);
    const bool keep = key && key >= prefix;
    if (keep && (key & mask) == prefix) least = min(least, key);
    const unsigned kept = __ballot_sync(FULL, keep);
    if (kept) {
      int pos = 0;
      if (lane == 0) pos = atomicAdd(&st.n, __popc(kept));
      pos = __shfl_sync(FULL, pos, 0);
      if (keep) smem[s.spare + pos + __popc(kept & ((1u << lane) - 1))] = key;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) least = min(least, __shfl_xor_sync(FULL, least, off));
  if (lane == 0 && least != ~0ull) atomicMin(&st.kth, least);
  __syncthreads();
  s.theta = st.kth;
  const int t = s.top;
  s.top = s.spare;
  s.spare = t;
  s.nt = s.k;
}

// Appends this thread's keys above theta, a warp at a time. Returns
// APPENDED if the warp appended any, | FULL if the buffer then holds more
// than lim keys.
enum { APPENDED = 1, FULL_BUFFER = 2 };
template <int N>
__device__ __forceinline__ int append(const Sel& s, const topk_key (&key)[N]) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) m |= static_cast<unsigned>(key[j] > s.theta) << j;
  if (!__any_sync(FULL, m)) return 0;
  const int lane = threadIdx.x & 31;
  const int c = __popc(m);
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += t;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(&st.na, incl);
  base = __shfl_sync(FULL, base, 31);
  int pos = base + incl - c;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if ((m >> j) & 1) smem[pos++] = key[j];
  return APPENDED | (base + __shfl_sync(FULL, incl, 31) > s.lim ? FULL_BUFFER : 0);
}

// Counts, for each of its R keys, the larger ones among smem[from, to)
// (from even): four keys a step, in two 16-byte loads issued together.
template <int R>
__device__ __forceinline__ void count_larger(const topk_key (&mine)[R], int (&rank)[R],
                                             int from, int to) {
  const ulonglong2* pairs = reinterpret_cast<const ulonglong2*>(smem + from);
  const int quads = (to - from) / 4;
  for (int q = 0; q < quads; ++q) {
    const ulonglong2 a = pairs[2 * q], b = pairs[2 * q + 1];
#pragma unroll
    for (int j = 0; j < R; ++j)
      rank[j] += (a.x > mine[j]) + (a.y > mine[j]) + (b.x > mine[j]) + (b.y > mine[j]);
  }
  for (int i = from + 4 * quads; i < to; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) rank[j] += smem[i] > mine[j];
  }
}

// The first round of a stream, before its keys go in: theta rises to just
// below the k-th largest of the threads' largest keys above theta (a subset
// of the stream's keys, so at most the stream's k-th key), where k <=
// THREADS. Each maximum's rank is counted against the others.
__device__ __forceinline__ void seed(Sel& s, const topk_key (&key)[KPT]) {
  if (s.k > THREADS) return;
  topk_key best[1] = {0};
#pragma unroll
  for (int j = 0; j < KPT; ++j) best[0] = max(best[0], key[j]);
  append(s, best);
  const int m = __syncthreads_count(best[0] > s.theta);
  if (m >= s.k && static_cast<int>(threadIdx.x) < m) {
    const topk_key mine[1] = {smem[threadIdx.x]};
    int rank[1] = {0};
    count_larger(mine, rank, 0, m);
    if (rank[0] == s.k - 1) st.kth = mine[0];
  }
  if (threadIdx.x == 0) st.na = 0;
  __syncthreads();
  if (m >= s.k) s.theta = max(s.theta, st.kth - 1);
}

// The barrier that ends a round; selects if some warp filled the buffer.
__device__ __forceinline__ void round_end(Sel& s, int appended) {
  if (__syncthreads_or(appended & FULL_BUFFER)) select_top(s, st.na);
}

// The best k of top[0..nt) and the append buffer by rank, best first, then
// zeros up to k: put(rank, key) for each rank below k. Each thread holds R
// of the keys and counts the larger ones, a shared-memory broadcast a key.
template <int R, typename Put>
__device__ __forceinline__ void place_ranked(const Sel& s, int na, Put put) {
  const int n = s.nt + na;
  topk_key mine[R];
  int rank[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mine[j] = candidate(s, n, j * THREADS + threadIdx.x);
    rank[j] = 0;
  }
  count_larger(mine, rank, s.top, s.top + s.nt);
  count_larger(mine, rank, 0, na);
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (mine[j] && rank[j] < s.k) put(rank[j], mine[j]);
  for (int i = n + threadIdx.x; i < s.k; i += THREADS) put(i, 0ull);
}

// The same by a bitonic sort of top[0..nt) and the append buffer, copied
// after the buffer's keys and padded with zeros to a power of two: past
// 2 * THREADS keys the rank counts (n^2 / THREADS compares a thread) cost
// more than the sort's log^2 stages.
template <typename Put>
__device__ __forceinline__ void place_sorted(const Sel& s, int na, Put put) {
  const int n = s.nt + na;
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = threadIdx.x; i < p - na; i += THREADS) smem[na + i] = i < s.nt ? smem[s.top + i] : 0;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const topk_key a = smem[lo], b = smem[hi];
        if ((a < b) == ((lo & size) == 0)) {
          smem[lo] = b;
          smem[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < s.k; i += THREADS) put(i, smem[i]);
}

// After the last round (after a barrier): the best min(k, seen) keys by
// rank. A selection first if more than PLACE_MAX keys are left.
template <typename Put>
__device__ __forceinline__ void place(Sel& s, Put put) {
  int na = st.na;
  if (s.nt + na > PLACE_MAX) {
    select_top(s, na);
    na = 0;
  }
  const int n = s.nt + na;
  if (n <= THREADS) {
    place_ranked<1>(s, na, put);
  } else if (n <= 2 * THREADS) {
    place_ranked<2>(s, na, put);
  } else {
    place_sorted(s, na, put);
  }
}

// Part `part` of `parts` of a row of n scores: 16-byte vectors split evenly
// over the parts, the unaligned head to the first part, the tail to the last.
template <typename In>
__device__ __forceinline__ void stream_scores(Sel& s, const In* row, int n, int part, int parts) {
  constexpr int VEC = 16 / sizeof(In);
  constexpr int LOADS = KPT / VEC;
  constexpr int STEP = THREADS * LOADS;  // vectors a round
  const int tid = threadIdx.x;
  const int skew = static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(In));
  const int head = min(n, skew ? VEC - skew : 0);
  const int nv = (n - head) / VEC;
  const int tail0 = head + nv * VEC;
  const int per = (nv + parts - 1) / parts;
  const int v0 = static_cast<int>(min(static_cast<long long>(nv), static_cast<long long>(part) * per));
  const int v1 = min(nv, v0 + per);
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  const int rounds = (v1 - v0 + STEP - 1) / STEP;
  uint4 cur[LOADS], nxt[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int v = v0 + j * THREADS + tid;
    cur[j] = v < v1 ? __ldg(vec + v) : make_uint4(0, 0, 0, 0);
  }
  for (int r = 0; r < rounds; ++r) {
    const int vb = v0 + r * STEP;
    if (r + 1 < rounds) {
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int v = vb + STEP + j * THREADS + tid;
        nxt[j] = v < v1 ? __ldg(vec + v) : make_uint4(0, 0, 0, 0);
      }
    }
    topk_key key[KPT];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int v = vb + j * THREADS + tid;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        key[j * VEC + e] = v < v1 ? pack(elem<In>(cur[j], e),
                                         static_cast<uint32_t>(head + v * VEC + e)) : 0;
    }
    if (r == 0) seed(s, key);
    round_end(s, append(s, key));
#pragma unroll
    for (int j = 0; j < LOADS; ++j) cur[j] = nxt[j];
  }
  // the scalar columns: the head (first part) and the tail (last part)
  const int nh = part == 0 ? head : 0;
  const int ntl = part == parts - 1 ? n - tail0 : 0;
  if (nh + ntl > 0) {
    topk_key key[1] = {0};
    if (tid < nh) {
      key[0] = pack(to_f32(row[tid]), static_cast<uint32_t>(tid));
    } else if (tid < nh + ntl) {
      const int c = tail0 + tid - nh;
      key[0] = pack(to_f32(row[c]), static_cast<uint32_t>(c));
    }
    round_end(s, append(s, key));
  }
}

// The merge's input: a row's parts' keys from L2 (16-byte aligned, two to a
// vector), rank by rank: keys[r * parts + p] is part p's r-th best. A round
// (ROUND >= parts keys) holds, for every part, a key of a smaller rank than
// any later key of that part, so after a round that appends nothing no later
// key can pass theta, and the merge stops there: it reads the first ranks.
__device__ __forceinline__ void stream_keys(Sel& s, const topk_key* keys, int parts, int k) {
  constexpr int LOADS = KPT / 2;
  constexpr int STEP = THREADS * LOADS;
  const int tid = threadIdx.x;
  const int m = parts * k;
  const int nv = (m + 1) / 2;
  const uint4* vec = reinterpret_cast<const uint4*>(keys);
  for (int vb = 0; vb < nv; vb += STEP) {
    topk_key key[KPT];
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int v = vb + j * THREADS + tid;
      const uint4 w = v < nv ? __ldcg(vec + v) : make_uint4(0, 0, 0, 0);
      key[2 * j] = (static_cast<topk_key>(w.y) << 32) | w.x;
      key[2 * j + 1] = 2 * v + 1 < m ? (static_cast<topk_key>(w.w) << 32) | w.z : 0;
    }
    if (vb == 0) seed(s, key);
    const int appended = append(s, key);
    if (parts <= ROUND && !__syncthreads_or(appended & APPENDED)) break;
    round_end(s, appended);
  }
}

// One block per (row, part): blockIdx.x = row * parts + part. With parts > 1,
// scratch holds each row's parts' keys, best first, rank by rank (stride keys
// a row, stride = parts * k rounded up to even).
template <typename In>
__global__ void __launch_bounds__(THREADS, 4)
retrieval_topk_kernel(const In* __restrict__ scores, int n, int k, int lim, int parts,
                      topk_key* __restrict__ scratch, int* __restrict__ arrivals,
                      int* __restrict__ out_ids, float* __restrict__ out_s) {
  const int tid = threadIdx.x;
  const int row = static_cast<int>(blockIdx.x) / parts;
  const int part = static_cast<int>(blockIdx.x) % parts;
#ifdef K5_TIMING
  const unsigned long long t_start = k5_now();
#endif
  Sel s;
  s.top = ROUND + lim;                // lim and the regions are even: 16-byte aligned
  s.spare = s.top + k + (k & 1);
  s.k = k;
  s.lim = lim;
  s.nt = 0;
  s.theta = 0;
  for (int i = tid; i < BINS; i += THREADS) hist[i] = 0;
  if (tid == 0) {
    st.selects = 0;
    st.na = 0;
    st.lo = ~0ull;
    st.hi = 0;
  }
  __syncthreads();
  stream_scores<In>(s, scores + static_cast<size_t>(row) * n, n, part, parts);
  if (blockIdx.x == 0) {
    K5_MARK(0, 0, t_start);
    K5_MARK(0, 1, k5_now());  // streamed
  }

  if (parts > 1) {
    // the part's keys by rank (its k-th key at rank k - 1: 0 if it saw fewer)
    const size_t stride = static_cast<size_t>(parts) * k + ((parts * k) & 1);
    topk_key* keys = scratch + static_cast<size_t>(row) * stride;
    place(s, [&](int r, topk_key key) { keys[static_cast<size_t>(r) * parts + part] = key; });
    if (blockIdx.x == 0) K5_MARK(0, 4, k5_now());  // placed
    __threadfence();
    __syncthreads();
    if (tid == 0) st.last = atomicAdd(&arrivals[row], 1) == parts - 1;
    __syncthreads();
    if (blockIdx.x == 0) {
      K5_MARK(0, 2, k5_now());  // counted in
      K5_MARK(0, 3, st.selects);
    }
    if (!st.last) return;
    __threadfence();
    if (row == 0) {
      K5_MARK(1, 0, t_start);
      K5_MARK(1, 1, k5_now());  // arrived last
    }
    if (tid == 0) {
      st.na = 0;
      st.lb = 0;
    }
    __syncthreads();
    for (int p = tid; p < parts; p += THREADS) {
      const topk_key t = __ldcg(keys + static_cast<size_t>(k - 1) * parts + p);
      if (t) atomicMax(&st.lb, t);
    }
    __syncthreads();
    s.nt = 0;
    s.theta = st.lb ? st.lb - 1 : 0;  // keep the keys >= theta_lb
    stream_keys(s, keys, parts, k);
    if (row == 0) K5_MARK(1, 2, k5_now());  // merged
  } else if (row == 0) {
    K5_MARK(1, 0, t_start);
    K5_MARK(1, 1, k5_now());
    K5_MARK(1, 2, k5_now());
  }

  const size_t o = static_cast<size_t>(row) * k;
  place(s, [&](int r, topk_key key) {
    out_ids[o + r] = key_col(key);
    out_s[o + r] = key_score(key);
  });
  if (parts > 1 && tid == 0) arrivals[row] = 0;
  if (row == 0) {
    K5_MARK(1, 3, k5_now());  // answer written
    K5_MARK(1, 4, st.selects);
  }
}

int append_limit(int k) { return k > SLACK ? k + (k & 1) : SLACK; }

size_t smem_bytes(int k) {
  return static_cast<size_t>(ROUND + append_limit(k) + 2 * (k + (k & 1))) * sizeof(topk_key);
}

// Past 48 KB of shared memory a block (the static histogram and state
// included) the kernel must be allowed more.
template <typename In>
cudaError_t allow_smem(int k) {
  const size_t dynamic = smem_bytes(k);
  if (dynamic + sizeof(int) * BINS + 512 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(retrieval_topk_kernel<In>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dynamic));
}

template <typename In>
int launch(const void* in, int rows, int n, int k, int parts, void* scratch, int* arrivals,
           int* out_ids, float* out_s, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(rows) * parts;
  if (parts < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem<In>(k);
  if (e != cudaSuccess) return static_cast<int>(e);
  retrieval_topk_kernel<In><<<static_cast<unsigned>(blocks), THREADS, smem_bytes(k), stream>>>(
      static_cast<const In*>(in), n, k, append_limit(k), parts,
      static_cast<topk_key*>(scratch), arrivals, out_ids, out_s);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int slots(int k) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem<In>(k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, retrieval_topk_kernel<In>, THREADS,
                                                      smem_bytes(k));
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  return e == cudaSuccess ? sms * per_sm : -static_cast<int>(e);
}

}  // namespace

// Blocks of the kernel for `dtype` and k that the current device holds at
// once (its SMs times the blocks an SM holds); a negative CUDA error code if
// the runtime cannot say.
extern "C" int knn_retrieval_slots(int dtype, int k) {
  if (k < 1 || k > MAX_K) return -static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return slots<float>(k);
    case kF16: return slots<__half>(k);
    case kBF16: return slots<__nv_bfloat16>(k);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef K5_TIMING
extern "C" int knn_retrieval_marks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, k5_marks, sizeof(k5_marks)));
}
#endif

// One launch. scores: (rows, n) of type `dtype` (0 float32, 1 float16,
// 2 bfloat16), row-major, any alignment of the element type. parts: the
// blocks a row (ops.retrieval_plan); with parts > 1, scratch holds
// rows * (parts * k rounded up to even) keys and arrivals rows ints that are
// 0, and left 0. Writes out_ids and out_s (rows, k).
// k <= 1024, rows * parts < 2^31. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int knn_retrieval_topk(const void* scores, int dtype, int rows, int n, int k,
                                  int parts, void* scratch, int* arrivals, int* out_ids,
                                  float* out_s, void* stream) {
  if (rows == 0) return 0;
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(scores, rows, n, k, parts, scratch, arrivals, out_ids, out_s, st);
    case kF16:
      return launch<__half>(scores, rows, n, k, parts, scratch, arrivals, out_ids, out_s, st);
    case kBF16:
      return launch<__nv_bfloat16>(scores, rows, n, k, parts, scratch, arrivals, out_ids, out_s,
                                   st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
