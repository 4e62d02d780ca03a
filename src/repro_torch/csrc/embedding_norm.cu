// Per-sample squared norm of an embedding's gradient on Hopper:
//
//     out[n] = sum_{t,t'} [id_t == id_t'] (g_t . g_t')
//            = sum over the distinct ids v of sample n of |sum_{t: id_t = v} g_t|^2
//
//     ids (N,T) int32 or int64, g (N,T,p) fp32 or bf16 -> (N,) fp32
//
// Replaces src/repro/kernels/ghost_norm/ghost_norm.py::embedding_ghost_norm_sq_pallas.
// The Pallas kernel forms g's (T, T) Gram tile by tile and masks it with
// the ids' equality: T^2 p multiply-adds, nearly all multiplied by zero when
// ids rarely repeat.  Only equal ids interact, so the second form above
// needs T p adds: a segment sum of g's rows grouped by id.  That reads g
// once and does about one add per byte of bf16 g, so bytes bound it on the
// H100 (3.35 TB/s): 64 MB of g at an LM's (4, 2048, 4096) take 0.020 ms,
// where the pairwise form's 69 GFLOP would take milliseconds.
//
// Three launches on the caller's stream:
// 1. embedding_sort_kernel, one CTA of 1024 threads per sample: a stable LSD
//    radix sort of the positions by id, over only the bits the sample's id
//    range needs (key = id - min id, 8-bit digits: one pass for the ViT's
//    196 position ids, two for a 64000-id vocabulary).  Each pass is a
//    stable counting sort: the 32 warps own consecutive runs of the
//    positions, rank equal digits by ballots and count them per (digit,
//    warp), and a scan of the counts places every position.  Keys, orders
//    and ranks (20 bytes a position) sit in shared memory up to ~9.9k
//    positions on the H100, in a device workspace above that.  It writes
//    `order` (N, T): the sorted positions' t, bit 31 set where a segment of
//    equal ids starts.  Ties keep t order, so the result is one fixed order.
// 2. embedding_segment_kernel streams g's rows in sorted order.  A warp owns
//    a 512-byte column slice of every row (16 bytes a lane: 8 bf16 or 4
//    fp32) over a contiguous range of sorted positions.  Rows land in a
//    per-warp ring of kDepth 16-byte cp.async copies (sm_90's TMA has no row
//    gather); each lane adds its 16 bytes to fp32 running sums and, at each
//    segment end, their squares to a lane sum.  Only the lane that copied a
//    16-byte piece reads it, so the ring needs no barrier.  Blocks are
//    (sample, slice, position split); the wrapper picks the splits
//    (embedding_plan) to fill every SM's block slots in one even wave.
//    A segment that crosses the end of a range leaves its partial sum
//    vector (the range's head or tail), never its square: warp 0 folds the
//    block's eight ranges in order into one unit for the workspace.
// 3. embedding_finish_kernel, one block per sample: sums each slice's units,
//    carries the segments that cross them in split order, then sums the
//    slices in order.
//
// Exact for any segment length (one id over all T positions included): a
// segment's sum is complete before it is squared, however many ranges it
// crosses.  Both g dtypes accumulate in fp32 (bf16 -> fp32 is exact).  No
// atomics: every sum runs in a fixed order, so repeated calls are
// bit-identical.
#include "common.cuh"
#include "mma.cuh"

#include <atomic>
#include <climits>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kStart = 0x80000000u;  // order entry: a segment of equal ids starts here

// ------------------------------------------------------------ the sort --
constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kBins = 256;
// one count per (digit, warp) at word d * 33 + w: a warp's leaders (one per
// digit) and a thread's eight consecutive counters of the scan fall in
// distinct banks
constexpr int kHistStride = kSortWarps + 1;
constexpr int kHistBytes = kBins * kHistStride * 4;

// the lanes whose digit (9 bits: 0..255, or kBins for none) equals this
// lane's, by one ballot a bit (match.any is far slower on the H100)
__device__ __forceinline__ unsigned match_digit(int d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned m = __ballot_sync(kFull, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? m : ~m;
  }
  return peers;
}

__device__ __forceinline__ void warp_min_max(long long& lo, long long& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long l = __shfl_xor_sync(kFull, lo, off), h = __shfl_xor_sync(kFull, hi, off);
    lo = l < lo ? l : lo;
    hi = h > hi ? h : hi;
  }
}

// One stable counting-sort pass over the digit (key >> shift) & 255 of the
// sample's `t` positions, from the order `src` into `dst`.  Warp w owns
// src[w * run, (w + 1) * run) and walks it 32 at a time: each position's rank
// among the equal digits of its run (lanes in order) goes to `rank`, each
// (digit, warp) count to `hist`; the scan turns the counts into offsets
// (digit-major, then warp order).  Ties keep the current order.
__device__ void radix_pass(const unsigned long long* keys, const uint32_t* src, uint32_t* dst,
                           uint32_t* rank, uint32_t* hist, uint32_t* scratch, int t, int shift) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int run = (t + kSortThreads - 1) / kSortThreads * 32;
  const int begin = min(warp * run, t), end = min(begin + run, t);
  for (int i = threadIdx.x; i < kBins * kHistStride; i += kSortThreads) hist[i] = 0;
  __syncthreads();
  for (int b = begin; b < end; b += 32) {  // count and rank
    const int i = b + lane;
    const bool ok = i < end;
    const int d = ok ? static_cast<int>((keys[src[i]] >> shift) & 255) : kBins;
    const unsigned peers = match_digit(d);
    uint32_t* slot = hist + (ok ? d : 0) * kHistStride + warp;
    const uint32_t before = ok ? *slot : 0u;
    __syncwarp();
    if (ok) {
      rank[i] = before + __popc(peers & lower);
      if ((peers & lower) == 0) *slot = before + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  // exclusive scan over (digit, warp), eight counters a thread: logical
  // counter c = d * 32 + w lives at word c + c / 32
  constexpr int kPer = kBins * kSortWarps / kSortThreads;
  uint32_t* mine = hist + threadIdx.x * kPer + threadIdx.x * kPer / kSortWarps;
  uint32_t c[kPer], sum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    c[q] = mine[q];
    sum += c[q];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = scratch[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    scratch[lane] = w;
  }
  __syncthreads();
  uint32_t base = incl - sum + (warp > 0 ? scratch[warp - 1] : 0u);
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    mine[q] = base;
    base += c[q];
  }
  __syncthreads();
  for (int i = begin + lane; i < end; i += 32) {  // scatter
    const uint32_t r = src[i];
    const int d = static_cast<int>((keys[r] >> shift) & 255);
    dst[hist[d * kHistStride + warp] + rank[i]] = r;
  }
  __syncthreads();
}

// Sample blockIdx.x's positions sorted by id (ties by t) into `order`, one
// CTA a sample.  ws_keys == nullptr: keys, orders and ranks in shared memory;
// else in the workspace (ws_keys: N * T keys, ws_pos: 3 * N * T words).
template <typename TI>
__global__ void __launch_bounds__(kSortThreads)
    embedding_sort_kernel(const TI* __restrict__ ids_all, uint32_t* __restrict__ order_all,
                          int t, unsigned long long* ws_keys, uint32_t* ws_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long lo_w[kSortWarps], hi_w[kSortWarps];
  __shared__ uint32_t scratch[kSortWarps];
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem);
  const int64_t n = blockIdx.x;
  const TI* ids = ids_all + n * t;
  unsigned long long* keys;
  uint32_t* src;
  if (ws_keys == nullptr) {
    keys = reinterpret_cast<unsigned long long*>(smem + kHistBytes);
    src = reinterpret_cast<uint32_t*>(keys + t);
  } else {
    keys = ws_keys + n * t;
    src = ws_pos + 3 * n * t;
  }
  uint32_t* dst = src + t;
  uint32_t* rank = dst + t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the sample's keys, min and max
  long long lo = LLONG_MAX, hi = LLONG_MIN;
  for (int i = threadIdx.x; i < t; i += kSortThreads) {
    const long long v = static_cast<long long>(ids[i]);
    keys[i] = static_cast<unsigned long long>(v);
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
  }
  warp_min_max(lo, hi);
  if (lane == 0) {
    lo_w[warp] = lo;
    hi_w[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lo_w[lane];
    hi = hi_w[lane];
    warp_min_max(lo, hi);
    if (lane == 0) {
      lo_w[0] = lo;
      hi_w[0] = hi;
    }
  }
  __syncthreads();
  lo = lo_w[0];
  hi = hi_w[0];
  // key = id - min id as an unsigned 64-bit number: order-preserving for any ids
  const unsigned long long key0 = static_cast<unsigned long long>(lo);
  for (int i = threadIdx.x; i < t; i += kSortThreads) {
    keys[i] -= key0;
    src[i] = static_cast<uint32_t>(i);
  }
  const unsigned long long range = static_cast<unsigned long long>(hi) - key0;
  const int bits = range == 0 ? 0 : 64 - __clzll(static_cast<long long>(range));
  __syncthreads();
  for (int shift = 0; shift < bits; shift += 8) {
    radix_pass(keys, src, dst, rank, hist, scratch, t, shift);
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  // segment starts: a position's key against the one before it in the order
  uint32_t* order = order_all + n * t;
  for (int i = threadIdx.x; i < t; i += kSortThreads) {
    const uint32_t r = src[i];
    const bool start = i == 0 || keys[r] != keys[src[i - 1]];
    order[i] = r | (start ? kStart : 0u);
  }
}

// --------------------------------------------------- the segment sums --
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDepth = 4;  // rows in flight a warp: 2 KB of its ring
constexpr int kRingBytes = kWarps * kDepth * 32 * 16;

// A contiguous range of one (sample, slice)'s sorted positions, as one lane
// sees it: `head` is the partial sum of a segment that began before the
// range (kHead; kCloses if it ends inside), `tail` that of the last segment,
// begun inside and going on past the range (kTail); `inner` (the same on
// every lane) sums the squares of the segments closed inside.
enum : int { kNonEmpty = 1, kHead = 2, kCloses = 4, kTail = 8 };

template <int V>
struct Unit {
  int flags;
  float inner;
  float head[V], tail[V];
};

template <int V>
__device__ __forceinline__ float sq(const float (&x)[V]) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) s = fmaf(x[v], x[v], s);
  return s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// a <- a followed by b (the next range): a segment open across the join is
// summed on, and its square, once it closes, goes to this lane's `closed`
template <int V>
__device__ __forceinline__ void fold(Unit<V>& a, const Unit<V>& b, float& closed) {
  if (!(b.flags & kNonEmpty)) return;
  if (!(a.flags & kNonEmpty)) {
    a = b;
    return;
  }
  a.inner += b.inner;
  if ((a.flags & kHead) && !(a.flags & kCloses)) {  // a is one open segment: b's head goes on
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a.head[v] += b.head[v];
      a.tail[v] = b.tail[v];
    }
    a.flags = kNonEmpty | kHead | (b.flags & (kCloses | kTail));
    return;
  }
  if (b.flags & kHead) {  // a's tail goes on in b
    float c[V];
#pragma unroll
    for (int v = 0; v < V; ++v) c[v] = ((a.flags & kTail) ? a.tail[v] : 0.f) + b.head[v];
    if (!(b.flags & kCloses)) {  // ... through all of b
#pragma unroll
      for (int v = 0; v < V; ++v) a.tail[v] = c[v];
      a.flags |= kTail;
      return;
    }
    closed += sq(c);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) a.tail[v] = b.tail[v];
  a.flags = (a.flags & ~kTail) | (b.flags & kTail);
}

// One row's 16 bytes for this lane (columns col0 .. col0 + 16 / sizeof(TG))
// into its ring slot: a cp.async where the rows allow 16-byte copies (zero
// fill past p), element loads otherwise.
template <typename TG>
__device__ __forceinline__ void load_row(uint4* slot, const TG* row, int col0, int p, bool vec) {
  constexpr int V = 16 / sizeof(TG);
  if (vec) {
    const bool ok = col0 < p;
    repro::cp_async16(slot, ok ? row + col0 : row, ok);
  } else {
    uint4 r;
    TG* x = reinterpret_cast<TG*>(&r);
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = col0 + v < p ? row[col0 + v] : TG(0.f);
    *slot = r;
  }
}

template <typename TG>
__device__ __forceinline__ void add_row(float (&sum)[16 / sizeof(TG)], uint4 raw) {
  constexpr int V = 16 / sizeof(TG);
  const TG* x = reinterpret_cast<const TG*>(&raw);
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] += repro::to_float(x[v]);
}

// The unit of sorted positions [k0, k1) of one sample for this lane's columns.
template <typename TG>
__device__ __forceinline__ void segment_range(Unit<16 / sizeof(TG)>& u, const TG* g,
                                              const uint32_t* order, int t, int p, int col0,
                                              bool vec, int k0, int k1, uint4* ring) {
  constexpr int V = 16 / sizeof(TG);
  const int lane = threadIdx.x & 31;
  const int len = k1 - k0;
  float sum[V], closed = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = u.head[v] = u.tail[v] = 0.f;
  u.flags = 0;
  if (len > 0) {
    // order entries of the batch of 32 positions being consumed, and the next
    uint32_t cur = lane < len ? __ldg(order + k0 + lane) : 0u;
    uint32_t nxt = 32 + lane < len ? __ldg(order + k0 + 32 + lane) : 0u;
#pragma unroll
    for (int q = 0; q < kDepth; ++q) {
      if (q < len) {
        const uint32_t e = __shfl_sync(kFull, cur, q);
        load_row(ring + q * 32, g + static_cast<int64_t>(e & ~kStart) * p, col0, p, vec);
      }
      repro::cp_async_commit();
    }
    bool in_head = !(__shfl_sync(kFull, cur, 0) & kStart);
    u.flags = kNonEmpty | (in_head ? kHead : 0);
    for (int i = 0; i < len; ++i) {
      repro::cp_async_wait<kDepth - 1>();  // row i has landed
      const uint32_t e = __shfl_sync(kFull, cur, i & 31);
      if (i > 0 && (e & kStart)) {  // the running segment ended at i - 1
        if (in_head) {
#pragma unroll
          for (int v = 0; v < V; ++v) u.head[v] = sum[v];
          u.flags |= kCloses;
          in_head = false;
        } else {
          closed += sq(sum);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) sum[v] = 0.f;
      }
      uint4* slot = ring + (i % kDepth) * 32;
      add_row<TG>(sum, *slot);
      const int q = i + kDepth;  // refill the slot just read
      if (q < len) {
        const uint32_t eq = __shfl_sync(kFull, (q >> 5) == (i >> 5) ? cur : nxt, q & 31);
        load_row(slot, g + static_cast<int64_t>(eq & ~kStart) * p, col0, p, vec);
      }
      repro::cp_async_commit();
      if ((i & 31) == 31) {
        cur = nxt;
        nxt = i + 33 + lane < len ? __ldg(order + k0 + i + 33 + lane) : 0u;
      }
    }
    // the last segment closes at k1 when a segment starts there (or k1 = T)
    const bool ends = k1 == t || (__ldg(order + k1) & kStart);
    if (in_head) {
#pragma unroll
      for (int v = 0; v < V; ++v) u.head[v] = sum[v];
      if (ends) u.flags |= kCloses;
    } else if (ends) {
      closed += sq(sum);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) u.tail[v] = sum[v];
      u.flags |= kTail;
    }
  }
  repro::cp_async_wait<0>();
  u.inner = warp_sum(closed);
}

// This lane's V floats of a unit's head or tail, as V / 4 16-byte accesses
// (the warp's 32 lanes cover one contiguous 128 V bytes)
template <int V>
__device__ __forceinline__ void load_vec(float (&x)[V], const float* p) {
#pragma unroll
  for (int v = 0; v < V; v += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + v));
    x[v] = q.x;
    x[v + 1] = q.y;
    x[v + 2] = q.z;
    x[v + 3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[V]) {
#pragma unroll
  for (int v = 0; v < V; v += 4)
    *reinterpret_cast<float4*>(p + v) = make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
}

// The workspace: per unit (sample, slice, block) its head and tail vectors
// ([2][32 lanes][V] floats), then every unit's inner sum, then its flags.
template <int V>
struct Units {
  float* vecs;
  float* inner;
  int* flags;
  __device__ Units(float* base, int64_t units)
      : vecs(base), inner(base + units * 64 * V),
        flags(reinterpret_cast<int*>(base + units * 64 * V + units)) {}
};

// grid: N * slices * blocks; each warp one of the (sample, slice)'s
// 8 * blocks position ranges, each block one unit
template <typename TG>
__global__ void __launch_bounds__(kThreads)
    embedding_segment_kernel(const TG* __restrict__ g, const uint32_t* __restrict__ order_all,
                             float* __restrict__ ws, int t, int p, int slices, int blocks,
                             bool vec) {
  constexpr int V = 16 / sizeof(TG);
  extern __shared__ __align__(16) uint4 ring_all[];  // [kWarps][kDepth][32]
  __shared__ int flags_w[kWarps];
  __shared__ float inner_w[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t unit = blockIdx.x;
  const int b = static_cast<int>(unit % blocks);
  const int64_t ns = unit / blocks;  // n * slices + slice
  const int slice = static_cast<int>(ns % slices);
  const int64_t n = ns / slices;
  const int64_t splits = static_cast<int64_t>(blocks) * kWarps, j = b * kWarps + warp;
  const int k0 = static_cast<int>(j * t / splits), k1 = static_cast<int>((j + 1) * t / splits);
  uint4* ring = ring_all + warp * kDepth * 32 + lane;

  Unit<V> u;
  segment_range<TG>(u, g + n * t * static_cast<int64_t>(p), order_all + n * t, t, p,
                    (slice * 32 + lane) * V, vec, k0, k1, ring);

  // warp 0 folds the block's ranges in order; the others pass theirs on
  float* xs = reinterpret_cast<float*>(ring_all + warp * kDepth * 32);  // [2][32][V]
  if (warp > 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xs[lane * V + v] = u.head[v];
      xs[(32 + lane) * V + v] = u.tail[v];
    }
    if (lane == 0) {
      flags_w[warp] = u.flags;
      inner_w[warp] = u.inner;
    }
  }
  __syncthreads();
  if (warp > 0) return;
  float closed = 0.f;
  for (int w = 1; w < kWarps; ++w) {
    const float* x = reinterpret_cast<const float*>(ring_all + w * kDepth * 32);
    Unit<V> next;
    next.flags = flags_w[w];
    next.inner = inner_w[w];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      next.head[v] = x[lane * V + v];
      next.tail[v] = x[(32 + lane) * V + v];
    }
    fold(u, next, closed);
  }
  u.inner += warp_sum(closed);
  const Units<V> out(ws, static_cast<int64_t>(gridDim.x));
  float* vec_out = out.vecs + unit * 64 * V + lane * V;
  if (u.flags & kHead) store_vec(vec_out, u.head);
  if (u.flags & kTail) store_vec(vec_out + 32 * V, u.tail);
  if (lane == 0) {
    out.inner[unit] = u.inner;
    out.flags[unit] = u.flags;
  }
}

// out[n] = the sum over sample n's slices, in order, of each slice's total;
// warp w takes slices w, w + 32, ...  A slice's total is its units' inner
// sums (32 units at a time, summed across lanes) plus the squares of the
// segments that cross units, carried through the units with a head or a
// tail in split order (from position 0, where no segment is open).
template <int V>
__global__ void __launch_bounds__(1024)
    embedding_finish_kernel(const float* __restrict__ ws, float* __restrict__ out, int n_all,
                            int slices, int blocks) {
  __shared__ float warp_total[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = blockIdx.x;
  const Units<V> units(const_cast<float*>(ws), static_cast<int64_t>(n_all) * slices * blocks);
  float total = 0.f;
  for (int s = warp; s < slices; s += 32) {
    const int64_t u0 = (n * slices + s) * blocks;
    float inner = 0.f, closed = 0.f, carry[V];
#pragma unroll
    for (int v = 0; v < V; ++v) carry[v] = 0.f;
    for (int b0 = 0; b0 < blocks; b0 += 32) {
      const bool mine = b0 + lane < blocks;
      const int flags_l = mine ? __ldg(units.flags + u0 + b0 + lane) : 0;
      inner += warp_sum(mine ? __ldg(units.inner + u0 + b0 + lane) : 0.f);
      // the units with a head or a tail, in order
      for (unsigned chain = __ballot_sync(kFull, flags_l & (kHead | kTail)); chain;
           chain &= chain - 1) {
        const int b = __ffs(chain) - 1;
        const int f = __shfl_sync(kFull, flags_l, b);
        const float* vec = units.vecs + (u0 + b0 + b) * 64 * V + lane * V;
        if (f & kHead) {
          float head[V];
          load_vec(head, vec);
#pragma unroll
          for (int v = 0; v < V; ++v) carry[v] += head[v];
          if (f & kCloses) {
            closed += sq(carry);
#pragma unroll
            for (int v = 0; v < V; ++v) carry[v] = 0.f;
          }
        }
        if (f & kTail) load_vec(carry, vec + 32 * V);
      }
    }
    total += inner + warp_sum(closed);
  }
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < 32; ++w) s += warp_total[w];
    out[n] = s;
  }
}

// ------------------------------------------------------------- launch --
// Dynamic shared memory of a sort CTA holding a sample of t positions: the
// histogram, its keys and three orders
int64_t sort_smem_bytes(int t) { return kHistBytes + 20 * int64_t{t}; }

constexpr int kMaxDevices = 64;

// The dynamic shared memory a sort CTA may have on the current device (0 on
// error).  The first call on a device lets both sort instances use all of it,
// so a launch pays neither the query nor the attribute.
int64_t sort_smem_limit() {
  static std::atomic<int64_t> ready[kMaxDevices];  // 0 until set
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 0;
  int64_t limit = ready[device].load(std::memory_order_acquire);
  if (limit > 0) return limit;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  constexpr int kStatic = 2 * kSortWarps * 8 + kSortWarps * 4;  // lo_w, hi_w, scratch
  limit = optin - kStatic;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  if (cudaFuncSetAttribute(embedding_sort_kernel<int32_t>, attr, static_cast<int>(limit)) !=
          cudaSuccess ||
      cudaFuncSetAttribute(embedding_sort_kernel<int64_t>, attr, static_cast<int>(limit)) !=
          cudaSuccess)
    return 0;
  ready[device].store(limit, std::memory_order_release);
  return limit;
}

template <typename TI>
cudaError_t launch_sort(const void* ids, uint32_t* order, int n, int t, void* sort_ws,
                        cudaStream_t stream) {
  unsigned long long* keys = static_cast<unsigned long long*>(sort_ws);
  uint32_t* pos = keys == nullptr ? nullptr : reinterpret_cast<uint32_t*>(keys + int64_t{n} * t);
  const int64_t bytes = keys == nullptr ? sort_smem_bytes(t) : kHistBytes;
  if (bytes > sort_smem_limit()) return cudaErrorInvalidValue;
  embedding_sort_kernel<TI><<<n, kSortThreads, static_cast<int>(bytes), stream>>>(
      static_cast<const TI*>(ids), order, t, keys, pos);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t launch_segments(const void* g, const uint32_t* order, float* ws, float* out, int n,
                            int t, int p, int slices, int blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TG);
  if (slices != (p + 32 * V - 1) / (32 * V) || blocks < 1) return cudaErrorInvalidValue;
  const int64_t units = int64_t{n} * slices * blocks;
  if (units > INT32_MAX) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && (p * sizeof(TG)) % 16 == 0;
  embedding_segment_kernel<TG><<<static_cast<unsigned>(units), kThreads, kRingBytes, stream>>>(
      static_cast<const TG*>(g), order, ws, t, p, slices, blocks, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  embedding_finish_kernel<V><<<n, 1024, 0, stream>>>(ws, out, n, slices, blocks);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_for_g(int g_dtype, const void* ids, const void* g, float* out,
                         uint32_t* order, float* ws, void* sort_ws, int n, int t, int p,
                         int slices, int blocks, cudaStream_t stream) {
  if (g_dtype != repro::kFloat32 && g_dtype != repro::kBFloat16) return cudaErrorInvalidValue;
  cudaError_t err = launch_sort<TI>(ids, order, n, t, sort_ws, stream);
  if (err != cudaSuccess) return err;
  if (g_dtype == repro::kFloat32)
    return launch_segments<float>(g, order, ws, out, n, t, p, slices, blocks, stream);
  return launch_segments<bf16>(g, order, ws, out, n, t, p, slices, blocks, stream);
}

}  // namespace

// The most positions a sample may have for its sort to run in shared memory
// (above it the caller passes a sort workspace).
extern "C" int embedding_sort_capacity() {
  const int64_t limit = sort_smem_limit();
  return limit <= kHistBytes ? 0 : static_cast<int>((limit - kHistBytes) / 20);
}

// Blocks of the segment kernel for g of `g_dtype` that one SM holds at once
// (the wrapper's split fills the card in one wave).
extern "C" int embedding_segment_blocks_per_sm(int g_dtype) {
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (g_dtype == repro::kFloat32)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, embedding_segment_kernel<float>, kThreads, kRingBytes);
  else if (g_dtype == repro::kBFloat16)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, embedding_segment_kernel<bf16>, kThreads, kRingBytes);
  return err == cudaSuccess ? blocks : 0;
}

// ids (n, t) of `id_dtype` (int32 or int64), g (n, t, p) of `g_dtype`,
// contiguous, t * p < 2^31; out (n,) fp32.  Workspaces from the caller:
// `order` n * t uint32; `units` (16-byte aligned) n * slices * blocks * (64 *
// V + 2) floats with V = 16 / sizeof(g's element) and slices = ceil(p / (32 *
// V)); `sort_ws` nullptr when t <= embedding_sort_capacity(), else n * t
// 64-bit keys (8-byte aligned) followed by 3 * n * t uint32.
extern "C" int embedding_ghost_norm_sq_launch(const void* ids, const void* g, void* out,
                                              void* order, void* units, void* sort_ws, int n,
                                              int t, int p, int id_dtype, int g_dtype,
                                              int slices, int blocks, void* stream_ptr) {
  if (n < 1 || t < 1 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* o = static_cast<uint32_t*>(order);
  float* ws = static_cast<float*>(units);
  float* dst = static_cast<float*>(out);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  if (id_dtype == repro::kInt32)
    err = launch_for_g<int32_t>(g_dtype, ids, g, dst, o, ws, sort_ws, n, t, p, slices,
                                blocks, stream);
  else if (id_dtype == repro::kInt64)
    err = launch_for_g<int64_t>(g_dtype, ids, g, dst, o, ws, sort_ws, n, t, p, slices,
                                blocks, stream);
  return static_cast<int>(err);
}
