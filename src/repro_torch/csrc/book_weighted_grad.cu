// Weighted book contraction of book-keeping clipping (arXiv:2210.00038):
//
//     out[m] = sum_r w[m,r] * a[m,r]^T g[m,r]      a (M,R,D), g (M,R,p), w (M,R) -> (M,D,p)
//
// Replaces src/repro/kernels/psg_contract/psg_contract.py::book_weighted_grad_pallas.
//
// What bounds it on the H100: operations.  A row-scaled GEMM (D x R)(R x p)
// does 2 R D p flops on (D + p + 1) R values; at VGG-19's conv7-9 (R = 8192,
// D = 2304, p = 256) that is ~9.7 GFLOP on ~85 MB, about 110 flop/byte, far
// above the fp32 SIMT ridge (20 flop/byte).
//
// Design:
// - Each block owns one 64 x 64 tile of out[m] and loops over all of R
//   inside the block, 16 rows at a time.  That loop takes the place of the
//   Pallas kernel's sequential grid axis (psg_contract.py:92): no sum
//   crosses blocks, so there is no second pass and no atomics, and the
//   result is deterministic.
// - The staged g rows are scaled by their weight w[m,r] as they land in
//   shared memory, so the weighted cotangent g * w never exists in device
//   memory (the point of the Pallas kernel).
// - Every thread accumulates a 4 x 4 patch of the tile in registers with
//   fp32 FMAs; D and p edges (1152/2304/4608/512 and 256/512/10) are masked
//   on load and on store.
// - a and g each come as fp32 or bf16 (the book holds them in the model
//   dtype).
// - Simple first: no tensor cores, no split over R.  At VGG shapes the grid
//   is 72-576 blocks, which under-fills 132 SMs for the R = 8192 taps.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileD = 64;
constexpr int kTileP = 64;
constexpr int kRows = 16;  // rows of R staged per step

template <typename TA, typename TG>
__global__ void __launch_bounds__(kThreads)
    book_weighted_grad_kernel(const TA* __restrict__ a, const TG* __restrict__ g,
                              const float* __restrict__ w, float* __restrict__ out, int r, int d,
                              int p) {
  __shared__ float sa[kRows][kTileD];
  __shared__ float sg[kRows][kTileP];

  const int64_t m = blockIdx.z;
  const int d0 = blockIdx.y * kTileD;
  const int p0 = blockIdx.x * kTileP;
  a += m * r * static_cast<int64_t>(d);
  g += m * r * static_cast<int64_t>(p);
  w += m * r;
  out += m * d * static_cast<int64_t>(p);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < r; r0 += kRows) {
    for (int idx = threadIdx.x; idx < kRows * kTileD; idx += kThreads) {
      const int rr = idx / kTileD;
      const int dd = idx % kTileD;
      const int gr = r0 + rr;
      const int gd = d0 + dd;
      sa[rr][dd] = (gr < r && gd < d)
                       ? repro::to_float(a[static_cast<int64_t>(gr) * d + gd])
                       : 0.f;
    }
    for (int idx = threadIdx.x; idx < kRows * kTileP; idx += kThreads) {
      const int rr = idx / kTileP;
      const int pp = idx % kTileP;
      const int gr = r0 + rr;
      const int gp = p0 + pp;
      sg[rr][pp] = (gr < r && gp < p)
                       ? repro::to_float(g[static_cast<int64_t>(gr) * p + gp]) * w[gr]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      float av[4];
      float gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = sa[k][ty + 16 * i];
        gv[i] = sg[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], gv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gd = d0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gp = p0 + tx + 16 * j;
      if (gd < d && gp < p) out[static_cast<int64_t>(gd) * p + gp] = acc[i][j];
    }
  }
}

template <typename TA, typename TG>
cudaError_t launch(const void* a, const void* g, const float* w, float* out, int m, int r, int d,
                   int p, cudaStream_t stream) {
  const dim3 grid((p + kTileP - 1) / kTileP, (d + kTileD - 1) / kTileD, m);
  book_weighted_grad_kernel<TA, TG><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TG*>(g), w, out, r, d, p);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t launch_for_g(int g_dtype, const void* a, const void* g, const float* w, float* out,
                         int m, int r, int d, int p, cudaStream_t stream) {
  if (g_dtype == repro::kFloat32) return launch<TA, float>(a, g, w, out, m, r, d, p, stream);
  if (g_dtype == repro::kBFloat16) {
    return launch<TA, __nv_bfloat16>(a, g, w, out, m, r, d, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a (m, r, d) of `a_dtype`, g (m, r, p) of `g_dtype`, contiguous; w (m, r)
// fp32; out (m, d, p) fp32.
extern "C" int book_weighted_grad_launch(const void* a, const void* g, const void* w, void* out,
                                         int m, int r, int d, int p, int a_dtype, int g_dtype,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaError_t err = cudaErrorInvalidValue;
  if (a_dtype == repro::kFloat32) {
    err = launch_for_g<float>(g_dtype, a, g, wf, o, m, r, d, p, stream);
  } else if (a_dtype == repro::kBFloat16) {
    err = launch_for_g<__nv_bfloat16>(g_dtype, a, g, wf, o, m, r, d, p, stream);
  }
  return static_cast<int>(err);
}
