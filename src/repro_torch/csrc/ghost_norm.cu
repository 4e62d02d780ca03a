// Per-sample ghost norms (paper Eq. 2.7) on Hopper, two kernels from one
// template:
//
//     ghost_norm_sq:           out[n] = sum_{t,t'} (a_t . a_t')   (g_t . g_t')
//     embedding_ghost_norm_sq: out[n] = sum_{t,t'} [id_t == id_t'] (g_t . g_t')
//
//     a (N,T,D) or ids (N,T), g (N,T,p) -> (N,) fp32
//
// Replace src/repro/kernels/ghost_norm/ghost_norm.py::ghost_norm_sq_pallas
// and ::embedding_ghost_norm_sq_pallas.  The second is the first with the
// activation Gram replaced by the equality mask of the ids: the squared
// norm of a sample's embedding gradient (a scatter-add of g rows by id)
// without forming the (V, p) gradient.
//
// What bounds them on the H100: operations.  Per sample the Grams cost
// T^2 (D + p) multiply-adds (T^2 p for the embedding) while the inputs are
// only T (D + p) values, so at T = 196 (ViT-Base) or T >= 64 (VGG-19) the
// arithmetic intensity is far above the fp32 SIMT ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte); at T = 4 or 1 the loads dominate.
//
// Design:
// - One block per (sample, lower-triangle tile pair (i, j), j <= i) of the
//   (T, T) plane; off-diagonal pairs count twice (Gram symmetry), which
//   halves the work as the Pallas kernels do.
// - The (BT x BT) tiles live in registers (each thread owns an (BT/16)^2
//   patch); the feature dimension streams through shared memory in
//   32-wide chunks.  Neither the Grams nor the mask reach device memory.
// - No padding of T to the tile: rows past T load as zeros, and the id
//   mask drops them by index (their id slots also hold the -1 / -2
//   sentinels of the plain version's pad_ids_pair, which match nothing).
//   BT is 16 when T <= 16, else 32, so small-T taps do not pay for a
//   256-row tile.
// - a and g each come as fp32 or bf16 (the clipping engine hands the
//   activation over in the model dtype and the cotangent in fp32); ids as
//   int32 or int64.
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

// kIds = false: `a` is the activation (N, T, D) of float type TA and the
// left factor is its Gram tile.  kIds = true: `a` is the ids (N, T) of
// integer type TA and the left factor is the equality mask of two id tiles
// (`d` is unused).
template <typename TA, typename TG, int BT, bool kIds>
__global__ void __launch_bounds__(kThreads)
    ghost_norm_pairs(const TA* __restrict__ a, const TG* __restrict__ g,
                     float* __restrict__ partial, int t, int d, int p, int n_pairs) {
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
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float left[R][R];  // activation Gram tile, or id equality mask
  float gg[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      left[r][c] = 0.f;
      gg[r][c] = 0.f;
    }
  gram_tile<TG, BT>(gg, g + n * t * static_cast<int64_t>(p), t, p, i * BT, j * BT, si, sj);
  if constexpr (kIds) {
    __shared__ long long id_i[BT];
    __shared__ long long id_j[BT];
    const TA* ids = a + n * t;
    for (int r = threadIdx.x; r < BT; r += kThreads) {
      const int gi = i * BT + r;
      const int gj = j * BT + r;
      id_i[r] = gi < t ? static_cast<long long>(ids[gi]) : -1;
      id_j[r] = gj < t ? static_cast<long long>(ids[gj]) : -2;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int row = i * BT + ty + 16 * r;
        const int col = j * BT + tx + 16 * c;
        left[r][c] =
            (row < t && col < t && id_i[ty + 16 * r] == id_j[tx + 16 * c]) ? 1.f : 0.f;
      }
  } else {
    gram_tile<TA, BT>(left, a + n * t * static_cast<int64_t>(d), t, d, i * BT, j * BT, si,
                      sj);
  }

  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) s = fmaf(left[r][c], gg[r][c], s);
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

struct PairArgs {
  const void* a;
  const void* g;
  float* out;
  float* partial;  // == out when a sample has a single tile pair
  int n, t, d, p, tile, n_pairs;
  cudaStream_t stream;
};

PairArgs make_args(const void* a, const void* g, void* out, void* partial, int n, int t, int d,
                   int p, int tile, void* stream_ptr) {
  const int n_tiles = (t + tile - 1) / tile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  float* o = static_cast<float*>(out);
  return PairArgs{a, g, o, n_pairs == 1 ? o : static_cast<float*>(partial),
                  n, t, d, p, tile, n_pairs, static_cast<cudaStream_t>(stream_ptr)};
}

template <typename TA, typename TG, bool kIds>
cudaError_t launch_pairs(const PairArgs& x) {
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(x.n) * x.n_pairs);
  const TA* a = static_cast<const TA*>(x.a);
  const TG* g = static_cast<const TG*>(x.g);
  if (x.tile == 16) {
    ghost_norm_pairs<TA, TG, 16, kIds>
        <<<blocks, kThreads, 0, x.stream>>>(a, g, x.partial, x.t, x.d, x.p, x.n_pairs);
  } else {
    ghost_norm_pairs<TA, TG, 32, kIds>
        <<<blocks, kThreads, 0, x.stream>>>(a, g, x.partial, x.t, x.d, x.p, x.n_pairs);
  }
  return cudaGetLastError();
}

template <typename TA, bool kIds>
cudaError_t launch_for_g(const PairArgs& x, int g_dtype) {
  if (g_dtype == repro::kFloat32) return launch_pairs<TA, float, kIds>(x);
  if (g_dtype == repro::kBFloat16) return launch_pairs<TA, __nv_bfloat16, kIds>(x);
  return cudaErrorInvalidValue;
}

// The pair pass has run (err); reduce the partials unless it wrote `out`.
int finish(const PairArgs& x, cudaError_t err) {
  if (err != cudaSuccess || x.n_pairs == 1) return static_cast<int>(err);
  sum_pairs<<<(x.n + 255) / 256, 256, 0, x.stream>>>(x.partial, x.out, x.n, x.n_pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (n, t, d) of `a_dtype`, g (n, t, p) of `g_dtype`, contiguous; out (n,)
// fp32.  `tile` is 16 or 32.  `partial` holds n * n_pairs floats when a
// sample has more than one tile pair; it may alias `out` when n_pairs == 1.
extern "C" int ghost_norm_sq_launch(const void* a, const void* g, void* out, void* partial,
                                    int n, int t, int d, int p, int a_dtype, int g_dtype,
                                    int tile, void* stream_ptr) {
  if (tile != 16 && tile != 32) return static_cast<int>(cudaErrorInvalidValue);
  const PairArgs x = make_args(a, g, out, partial, n, t, d, p, tile, stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  if (a_dtype == repro::kFloat32) err = launch_for_g<float, false>(x, g_dtype);
  else if (a_dtype == repro::kBFloat16) err = launch_for_g<__nv_bfloat16, false>(x, g_dtype);
  return finish(x, err);
}

// ids (n, t) of `id_dtype` (int32 or int64), g (n, t, p) of `g_dtype`,
// contiguous; out (n,) fp32; `tile` and `partial` as above.
extern "C" int embedding_ghost_norm_sq_launch(const void* ids, const void* g, void* out,
                                              void* partial, int n, int t, int p, int id_dtype,
                                              int g_dtype, int tile, void* stream_ptr) {
  if (tile != 16 && tile != 32) return static_cast<int>(cudaErrorInvalidValue);
  const PairArgs x = make_args(ids, g, out, partial, n, t, 0, p, tile, stream_ptr);
  cudaError_t err = cudaErrorInvalidValue;
  if (id_dtype == repro::kInt32) err = launch_for_g<int32_t, true>(x, g_dtype);
  else if (id_dtype == repro::kInt64) err = launch_for_g<int64_t, true>(x, g_dtype);
  return finish(x, err);
}
