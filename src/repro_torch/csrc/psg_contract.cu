// Weighted bank sums of book-keeping clipping, one launch for a group of
// banks, each with its own row of clip factors:
//
//     out_s[f] = sum_n c_s[n] * psg_s[n, f]     psg_s (N, F_s), c_s (N,) -> out_s (F_s,) fp32
//
// for every segment s of the group.  Under one global clip threshold every
// c_s is the same row; under per-layer clipping each bank takes its own
// layer group's row, and the step stays one launch.  Replaces
// src/repro/kernels/psg_contract/psg_contract.py::psg_contract_pallas, which
// contracts one bank per call.
//
// What bounds it on the H100: bytes.  Each psg value is read once and used
// in one multiply-add (2 flops per 4 bytes in fp32), so at best the kernel
// streams the banks at 3.35 TB/s.  A bk_mixed step's banks are small (VGG-19:
// 40 of them, 2 KB to 75 MB; ViT-Base: 50, 96 KB each), so one launch per
// bank costs more in host launch time than the card spends reading them.
//
// Design: one launch per group.  The segment descriptors {psg, out, F, dtype,
// c} travel by value in a __grid_constant__ kernel parameter (up to
// kMaxSegments of them, ~11.3 KB; CUDA 12.1+ takes 32 KB of parameters), so no
// host-to-device copy precedes the launch; a longer list is launched in
// chunks by the caller.  The grid is the concatenation of every segment's
// column blocks, and a block finds its segment by binary search over the
// prefix sum of blocks.  A thread owns 4 columns and loops over the samples
// n in order, 8 rows in flight: where F is a multiple of 4 and the rows and
// the output are aligned, as one 16-byte (fp32) or 8-byte (bf16) load and a
// 16-byte store, elsewhere as 4 element loads a warp-width apart
// (coalesced).  The sum over n never leaves the thread: no cross-block
// reduction, no atomics, and a fixed order (deterministic).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4 * kThreads;  // columns of one block
constexpr int kUnroll = 8;           // sample rows in flight per thread
constexpr int kMaxSegments = 256;    // descriptors of one launch (kernels/psg_contract)

struct Segment {
  const void* psg;
  float* out;
  long long f;
  int dtype;
  const float* c;  // this segment's row of clip factors, (n,) fp32
};

struct Group {
  int n;
  int n_segments;
  int first_block[kMaxSegments + 1];  // prefix sum of the segments' blocks
  Segment seg[kMaxSegments];
};

struct F4 {
  float x, y, z, w;
};

__device__ __forceinline__ F4 load4(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ F4 load4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void fma4(float (&acc)[4], float c, const F4& x) {
  acc[0] = fmaf(c, x.x, acc[0]);
  acc[1] = fmaf(c, x.y, acc[1]);
  acc[2] = fmaf(c, x.z, acc[2]);
  acc[3] = fmaf(c, x.w, acc[3]);
}

// columns [col0, col0 + kCols) of one segment
template <typename T>
__device__ __forceinline__ void contract(const T* __restrict__ psg, float* __restrict__ out,
                                         int64_t f, int64_t col0, const float* __restrict__ c,
                                         int n) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(psg) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int64_t col = col0 + 4 * threadIdx.x;
    if (col >= f) return;
    const T* x = psg + col;
    int i = 0;
    for (; i + kUnroll <= n; i += kUnroll) {
      F4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = load4(x + static_cast<int64_t>(i + u) * f);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma4(acc, __ldg(c + i + u), v[u]);
    }
    for (; i < n; ++i) fma4(acc, __ldg(c + i), load4(x + static_cast<int64_t>(i) * f));
    *reinterpret_cast<float4*>(out + col) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  // element loads: columns col0 + threadIdx.x + j * kThreads, j < 4
  const int64_t col = col0 + threadIdx.x;
  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) live[j] = col + j * kThreads < f;
  if (!live[0]) return;
  const T* x = psg + col;
  int i = 0;
  for (; i + kUnroll <= n; i += kUnroll) {
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[u][j] = live[j] ? repro::to_float(x[static_cast<int64_t>(i + u) * f + j * kThreads])
                          : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float cu = __ldg(c + i + u);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(cu, v[u][j], acc[j]);
    }
  }
  for (; i < n; ++i) {
    const float ci = __ldg(c + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (live[j]) {
        acc[j] = fmaf(ci, repro::to_float(x[static_cast<int64_t>(i) * f + j * kThreads]), acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (live[j]) out[col + j * kThreads] = acc[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    psg_contract_grouped_kernel(const __grid_constant__ Group g) {
  // the segment of this block: the last s with first_block[s] <= blockIdx.x
  // (segments without columns own no block and are passed over)
  const int block = static_cast<int>(blockIdx.x);
  int lo = 0, hi = g.n_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (g.first_block[mid] <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Segment& s = g.seg[lo];
  const int64_t col0 = static_cast<int64_t>(block - g.first_block[lo]) * kCols;
  if (s.dtype == repro::kFloat32) {
    contract(static_cast<const float*>(s.psg), s.out, s.f, col0, s.c, g.n);
  } else {
    contract(static_cast<const __nv_bfloat16*>(s.psg), s.out, s.f, col0, s.c, g.n);
  }
}

}  // namespace

// One launch over `n_segments` (1 .. kMaxSegments) banks of n samples.
// `table` holds 5 int64 per segment: the psg pointer ((n, f) contiguous of
// `dtype`), the out pointer ((f,) fp32), f, the dtype code and the pointer
// to the segment's clip factors ((n,) fp32).
extern "C" int psg_contract_grouped_launch(const int64_t* table, int n_segments, int n,
                                           void* stream_ptr) {
  if (n_segments < 1 || n_segments > kMaxSegments || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Group g;
  g.n = n;
  g.n_segments = n_segments;
  int64_t blocks = 0;
  for (int s = 0; s < n_segments; ++s) {
    const int64_t* row = table + 5 * s;
    const int dtype = static_cast<int>(row[3]);
    if (row[2] < 0 || (dtype != repro::kFloat32 && dtype != repro::kBFloat16)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t seg_blocks = (row[2] + kCols - 1) / kCols;
    g.seg[s] = {reinterpret_cast<const void*>(row[0]), reinterpret_cast<float*>(row[1]), row[2],
                dtype, reinterpret_cast<const float*>(row[4])};
    g.first_block[s] = static_cast<int>(blocks);
    blocks += seg_blocks;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  g.first_block[n_segments] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  psg_contract_grouped_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream_ptr)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
