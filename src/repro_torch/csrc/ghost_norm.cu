// Per-sample ghost norm (paper Eq. 2.7) on Hopper:
//
//     out[n] = sum_{t,t'} (a_t . a_t') * (g_t . g_t')      a (N,T,D), g (N,T,p)
//
// Replaces src/repro/kernels/ghost_norm/ghost_norm.py::ghost_norm_sq_pallas.
//
// What bounds it on the H100: operations.  Per sample the two Gram matrices
// cost T^2 (D + p) multiply-adds while the inputs are only T (D + p) values,
// so at the VGG shapes (T = 4..256) the arithmetic intensity is T/2 to
// 128 flop/byte: at T >= 64 above the fp32 SIMT ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte), at T = 4 or 1 the loads dominate.
//
// Design:
// - One block per (sample, lower-triangle tile pair (i, j), j <= i) of the
//   (T, T) plane; off-diagonal pairs count twice (Gram symmetry), which
//   halves the work as the Pallas kernel does.
// - Both (BT x BT) Gram tiles live in registers (each thread owns an
//   (BT/16)^2 patch); the feature dimension streams through shared memory
//   in 32-wide chunks.  The Grams never reach device memory.
// - No padding of T to the tile: rows past T load as zeros and contribute
//   nothing.  BT is 16 when T <= 16 (10 of VGG-19's ghost taps, T = 16, 4
//   and 1), else 32, so small-T taps do not pay for a 256-row tile.
// - A block cannot carry a sum to another, so each block writes one
//   (sample, pair) partial and a second tiny pass sums the partials of a
//   sample in a fixed order: repeated runs give bit-identical norms.  With a
//   single pair (T <= BT) the first pass writes the norm directly.
// - fp32 SIMT FMAs, no tensor cores yet: simple and right first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // features staged in shared memory per step

// Stage rows [row0, row0 + BT) x features [k0, k0 + kChunk) of one sample's
// (rows, width) matrix into shared memory; zeros outside the matrix.
template <typename T, int BT>
__device__ __forceinline__ void stage(float (*dst)[kChunk + 1], const T* __restrict__ x,
                                      int rows, int width, int row0, int k0) {
  for (int idx = threadIdx.x; idx < BT * kChunk; idx += kThreads) {
    const int r = idx / kChunk;
    const int k = idx % kChunk;
    const int gr = row0 + r;
    const int gk = k0 + k;
    dst[r][k] = (gr < rows && gk < width)
                    ? repro::to_float(x[static_cast<int64_t>(gr) * width + gk])
                    : 0.f;
  }
}

// acc += X[i0:i0+BT] X[j0:j0+BT]^T over the full width of X (one sample).
template <typename T, int BT>
__device__ __forceinline__ void gram_tile(float (&acc)[BT / 16][BT / 16],
                                          const T* __restrict__ x, int rows, int width,
                                          int i0, int j0, float (*si)[kChunk + 1],
                                          float (*sj)[kChunk + 1]) {
  constexpr int R = BT / 16;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  for (int k0 = 0; k0 < width; k0 += kChunk) {
    stage<T, BT>(si, x, rows, width, i0, k0);
    stage<T, BT>(sj, x, rows, width, j0, k0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float vi[R];
      float vj[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vi[r] = si[ty + 16 * r][k];
        vj[r] = sj[tx + 16 * r][k];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(vi[r], vj[c], acc[r][c]);
    }
    __syncthreads();
  }
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
    ghost_norm_pairs(const T* __restrict__ a, const T* __restrict__ g, float* __restrict__ partial,
                     int t, int d, int p, int n_pairs) {
  constexpr int R = BT / 16;
  __shared__ float si[BT][kChunk + 1];
  __shared__ float sj[BT][kChunk + 1];
  __shared__ float warp_sums[kThreads / 32];

  const int64_t block = blockIdx.x;
  const int64_t n = block / n_pairs;
  const int pair = static_cast<int>(block % n_pairs);
  // lower-triangle pair index -> (i, j) with j <= i
  int i = static_cast<int>((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= pair) ++i;
  while (i * (i + 1) / 2 > pair) --i;
  const int j = pair - i * (i + 1) / 2;

  float ga[R][R];
  float gg[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      ga[r][c] = 0.f;
      gg[r][c] = 0.f;
    }
  gram_tile<T, BT>(ga, a + n * t * static_cast<int64_t>(d), t, d, i * BT, j * BT, si, sj);
  gram_tile<T, BT>(gg, g + n * t * static_cast<int64_t>(p), t, p, i * BT, j * BT, si, sj);

  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) s = fmaf(ga[r][c], gg[r][c], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[block] = (i == j ? 1.f : 2.f) * total;
  }
}

// out[n] = sum of sample n's pair partials, in pair order (deterministic).
__global__ void sum_pairs(const float* __restrict__ partial, float* __restrict__ out, int n,
                          int n_pairs) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float acc = 0.f;
  for (int q = 0; q < n_pairs; ++q) acc += partial[static_cast<int64_t>(s) * n_pairs + q];
  out[s] = acc;
}

template <typename T, int BT>
void launch_pairs(const void* a, const void* g, float* partial, int n, int t, int d, int p,
                  int n_pairs, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(n) * n_pairs);
  ghost_norm_pairs<T, BT><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), partial, t, d, p, n_pairs);
}

}  // namespace

// a (n, t, d), g (n, t, p), contiguous, both of `dtype`; out (n,) fp32.
// `tile` is 16 or 32.  `partial` holds n * n_pairs floats when a sample has
// more than one tile pair; it may alias `out` when n_pairs == 1.
extern "C" int ghost_norm_sq_launch(const void* a, const void* g, void* out, void* partial,
                                    int n, int t, int d, int p, int dtype, int tile,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (t + tile - 1) / tile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  float* part = static_cast<float*>(n_pairs == 1 ? out : partial);
  if (tile != 16 && tile != 32) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32) {
    if (tile == 16) launch_pairs<float, 16>(a, g, part, n, t, d, p, n_pairs, stream);
    else launch_pairs<float, 32>(a, g, part, n, t, d, p, n_pairs, stream);
  } else if (dtype == repro::kBFloat16) {
    if (tile == 16) launch_pairs<__nv_bfloat16, 16>(a, g, part, n, t, d, p, n_pairs, stream);
    else launch_pairs<__nv_bfloat16, 32>(a, g, part, n, t, d, p, n_pairs, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_pairs == 1) return static_cast<int>(err);
  sum_pairs<<<(n + 255) / 256, 256, 0, stream>>>(part, static_cast<float*>(out), n, n_pairs);
  return static_cast<int>(cudaGetLastError());
}
