// Weighted book contraction of book-keeping clipping (arXiv:2210.00038):
//
//     out[m] = sum_r w[m,r] * a[m,r]^T g[m,r]      a (M,R,D), g (M,R,p), w (M,R) -> (M,D,p)
//
// Replaces src/repro/kernels/psg_contract/psg_contract.py::book_weighted_grad_pallas.
//
// What bounds it on the H100: operations.  A row-scaled GEMM (D x R)(R x p)
// does 2 R D p multiply-adds' worth of flops on (D + p + 1) R values, ~110
// flop/byte at VGG-19's conv taps and ~600 at ViT-Base's MLP, so the
// tensor cores' rate is the limit.  Tensor cores have no fp32 product, so
// operands are split into bf16 pieces as they land in shared memory, and
// each tile product is a sum of bf16 MMAs:
//
// - g is always scaled by its row weight w[m,r] in fp32 on chip (the
//   weighted cotangent never exists in device memory, the point of the
//   Pallas kernel) and split.
// - a in bf16 is exact (ViT-Base's book, bf16 compute): g' = g_hi + g_lo
//   (|g' - g_hi - g_lo| <= 2^-18 |g'|), a g' = a g_lo + a g_hi, 2 MMAs;
//   each product within ~2^-18 of a g', against the 1e-4 gate.
// - a in fp32 (fp32 compute: VGG-19, the LMs' fp32 gates): a and g' are
//   split into three pieces each (x = hi + mid + lo, |x - hi - mid - lo|
//   <= 2^-27 |x|) and six MMAs keep every product of pieces down to 2^-18
//   of |a g'|: mid mid + lo hi + hi lo + mid hi + hi mid + hi hi (bf16x6;
//   the dropped mid lo, lo mid, lo lo are <= 2^-26).  A two-piece split
//   (bf16x3) is within ~2^-16 of each product: a sum that one product
//   dominates (a vocabulary head's column of one target token) then
//   carries that product's ~1e-5 error, which the fp32 gates between two
//   equivalent steps (the model axis against one rank, 1e-5) see.
// One bf16 product of rounded operands (2^-8 per product) would not meet
// the 1e-4 gate.  The tensor cores' fp32 sums inside an MMA chain need not
// round to nearest, so each k-step's chain (2 x 16 rows) starts from zero
// and is added to the running fp32 sum with an ordinary rounded add.
//
// Design:
// - One 128 x 128 tile of out[m] per block, 8 warps of 64 x 32.  R runs in
//   k-steps of 32 rows: raw a and g rows (and w) are double-buffered in
//   shared memory with cp.async (16-byte copies where rows are 16-byte
//   aligned, plain loads otherwise), then split once per block into bf16
//   hi / lo tiles that ldmatrix.trans reads as MMA fragments.
// - Split over R: when M x tiles leaves SMs idle (VGG-19's taps have M = 1
//   and 4-36 tiles), R is cut into `splits` chunks of `rows_per_split`
//   rows, each block writes its fp32 partial tile to `partial`
//   (splits, M, D, p), and a second kernel sums the partials in split
//   order.  No atomics: the output is deterministic.  The wrapper picks
//   the split (kernels/psg_contract/psg_contract.py::book_splits).
// - D, p and R edges are masked by index (zero rows and columns).
#include "common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBD = 128;   // out rows (D) per block
constexpr int kBP = 128;   // out columns (p) per block
constexpr int kBR = 32;    // rows of R per k-step
constexpr int kPad = 8;    // bf16 per split row: 16-byte shift, ldmatrix conflict-free
constexpr int kSD = kBD + kPad, kSP = kBP + kPad;

// an fp32 a takes the three-piece split (and g' with it): the mid tiles
template <typename TA>
constexpr int kMidRows = std::is_same_v<TA, bf16> ? 1 : kBR;

template <typename TA, typename TG>
struct Smem {
  TA a_raw[2][kBR][kBD];
  TG g_raw[2][kBR][kBP];
  float w[2][kBR];
  bf16 a_hi[kBR][kSD];
  bf16 a_mid[kMidRows<TA>][kSD];
  bf16 a_lo[kBR][kSD];
  bf16 g_hi[kBR][kSP];
  bf16 g_mid[kMidRows<TA>][kSP];
  bf16 g_lo[kBR][kSP];
};

// rows [r0, r0 + kBR) x columns [c0, c0 + kC) of a (rows, cols) matrix into
// raw[kBR][kC]; outside [0, r_end) x [0, cols) is zero
template <typename T, int kC, bool kVec>
__device__ __forceinline__ void load_raw(T (*raw)[kC], const T* src, int r0, int r_end,
                                         int c0, int cols) {
  if constexpr (kVec) {  // cols * sizeof(T) and src are 16-byte aligned
    constexpr int kE = 16 / sizeof(T);
    for (int i = threadIdx.x; i < kBR * kC / kE; i += kThreads) {
      const int r = i / (kC / kE), c = (i % (kC / kE)) * kE;
      const bool in = r0 + r < r_end && c0 + c < cols;
      repro::cp_async16(&raw[r][c],
                        in ? src + static_cast<int64_t>(r0 + r) * cols + c0 + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < kBR * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const bool in = r0 + r < r_end && c0 + c < cols;
      raw[r][c] = in ? src[static_cast<int64_t>(r0 + r) * cols + c0 + c] : T(0.f);
    }
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// x = hi + lo in bf16; hi alone when kLo is false (x already bf16, exact)
template <bool kLo>
__device__ __forceinline__ void split8(const float (&x)[8], bf16* hi, bf16* lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    h[j] = repro::bits(hv);
    if constexpr (kLo) {
      const float2 hf = __bfloat1622float2(hv);
      l[j] = repro::pack_bf16(x[2 * j] - hf.x, x[2 * j + 1] - hf.y);
    }
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (kLo) *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// x = hi + mid + lo in bf16 (each remainder exact in fp32)
__device__ __forceinline__ void split8x3(const float (&x)[8], bf16* hi, bf16* mid, bf16* lo) {
  uint32_t h[4], m[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    const float2 hf = __bfloat1622float2(hv);
    const float r0 = x[2 * j] - hf.x, r1 = x[2 * j + 1] - hf.y;
    const __nv_bfloat162 mv = __floats2bfloat162_rn(r0, r1);
    const float2 mf = __bfloat1622float2(mv);
    h[j] = repro::bits(hv);
    m[j] = repro::bits(mv);
    l[j] = repro::pack_bf16(r0 - mf.x, r1 - mf.y);
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(mid) = make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

template <typename TA, typename TG, bool kVec>
__global__ void __launch_bounds__(kThreads)
    book_weighted_grad_kernel(const TA* __restrict__ a, const TG* __restrict__ g,
                              const float* __restrict__ w, float* __restrict__ out, int m_count,
                              int r, int d, int p, int rows_per_split) {
  constexpr bool kSplitA = !std::is_same_v<TA, bf16>;  // a bf16 is exact; fp32: 3 pieces
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<TA, TG>& sm = *reinterpret_cast<Smem<TA, TG>*>(smem_raw);

  const int m = blockIdx.z % m_count, split = blockIdx.z / m_count;
  const int d0 = blockIdx.y * kBD, p0 = blockIdx.x * kBP;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r, r_begin + rows_per_split);
  const int n_steps = (r_end - r_begin + kBR - 1) / kBR;
  a += static_cast<int64_t>(m) * r * d;
  g += static_cast<int64_t>(m) * r * p;
  w += static_cast<int64_t>(m) * r;
  out += (static_cast<int64_t>(split) * m_count + m) * d * p;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int dw = (warp & 1) * 64, pw = (warp >> 1) * 32;  // this warp's 64 x 32

  auto load_step = [&](int step) {
    const int stage = step & 1, r0 = r_begin + step * kBR;
    load_raw<TA, kBD, kVec>(sm.a_raw[stage], a, r0, r_end, d0, d);
    load_raw<TG, kBP, kVec>(sm.g_raw[stage], g, r0, r_end, p0, p);
    const int row = r0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < kBR) sm.w[stage][threadIdx.x] = row < r_end ? w[row] : 0.f;
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_step(0);
  repro::cp_async_commit();
  if (n_steps > 1) load_step(1);
  repro::cp_async_commit();

  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    repro::cp_async_wait<1>();  // this step's rows have landed
    __syncthreads();            // ... for every thread; the last MMAs are done
    // split the raw rows into bf16 hi / lo tiles, g scaled by its weight
    for (int i = threadIdx.x; i < kBR * kBD / 8; i += kThreads) {
      const int rr = i / (kBD / 8), c = (i % (kBD / 8)) * 8;
      float x[8];
      load8(&sm.a_raw[stage][rr][c], x);
      if constexpr (kSplitA) {
        split8x3(x, &sm.a_hi[rr][c], &sm.a_mid[rr][c], &sm.a_lo[rr][c]);
      } else {
        split8<false>(x, &sm.a_hi[rr][c], &sm.a_lo[rr][c]);
      }
    }
    for (int i = threadIdx.x; i < kBR * kBP / 8; i += kThreads) {
      const int rr = i / (kBP / 8), c = (i % (kBP / 8)) * 8;
      float x[8];
      load8(&sm.g_raw[stage][rr][c], x);
      const float wr = sm.w[stage][rr];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] *= wr;
      if constexpr (kSplitA) {
        split8x3(x, &sm.g_hi[rr][c], &sm.g_mid[rr][c], &sm.g_lo[rr][c]);
      } else {
        split8<true>(x, &sm.g_hi[rr][c], &sm.g_lo[rr][c]);
      }
    }
    __syncthreads();  // the split tiles are ready; this raw stage is free
    if (step + 2 < n_steps) load_step(step + 2);
    repro::cp_async_commit();

    // B fragments of both k16 halves: 4 n8 tiles of the warp's 32 columns
    uint32_t bh[2][4][2], bm[2][4][2], bl[2][4][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int ni2 = 0; ni2 < 2; ++ni2) {
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = pw + ni2 * 16 + (lane >> 4) * 8;
        uint32_t f[4];
        repro::ldmatrix_x4_trans(f, &sm.g_hi[row][col]);
        bh[kk][2 * ni2][0] = f[0]; bh[kk][2 * ni2][1] = f[1];
        bh[kk][2 * ni2 + 1][0] = f[2]; bh[kk][2 * ni2 + 1][1] = f[3];
        repro::ldmatrix_x4_trans(f, &sm.g_lo[row][col]);
        bl[kk][2 * ni2][0] = f[0]; bl[kk][2 * ni2][1] = f[1];
        bl[kk][2 * ni2 + 1][0] = f[2]; bl[kk][2 * ni2 + 1][1] = f[3];
        if constexpr (kSplitA) {
          repro::ldmatrix_x4_trans(f, &sm.g_mid[row][col]);
          bm[kk][2 * ni2][0] = f[0]; bm[kk][2 * ni2][1] = f[1];
          bm[kk][2 * ni2 + 1][0] = f[2]; bm[kk][2 * ni2 + 1][1] = f[3];
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      // A fragments (rows d, k = r) of both k16 halves, from the [r][d] tiles
      uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int row = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = dw + mi * 16 + ((lane >> 3) & 1) * 8;
        repro::ldmatrix_x4_trans(ah[kk], &sm.a_hi[row][col]);
        if constexpr (kSplitA) {
          repro::ldmatrix_x4_trans(am[kk], &sm.a_mid[row][col]);
          repro::ldmatrix_x4_trans(al[kk], &sm.a_lo[row][col]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};  // this k-step's chain, small terms first
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if constexpr (kSplitA) {
            repro::mma_bf16(c, am[kk], bm[kk][ni][0], bm[kk][ni][1]);
            repro::mma_bf16(c, al[kk], bh[kk][ni][0], bh[kk][ni][1]);
            repro::mma_bf16(c, ah[kk], bl[kk][ni][0], bl[kk][ni][1]);
            repro::mma_bf16(c, am[kk], bh[kk][ni][0], bh[kk][ni][1]);
            repro::mma_bf16(c, ah[kk], bm[kk][ni][0], bm[kk][ni][1]);
          } else {
            repro::mma_bf16(c, ah[kk], bl[kk][ni][0], bl[kk][ni][1]);
          }
          repro::mma_bf16(c, ah[kk], bh[kk][ni][0], bh[kk][ni][1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += c[e];
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gd = d0 + dw + mi * 16 + grp + (e >> 1) * 8;
        const int gp = p0 + pw + ni * 8 + 2 * tig + (e & 1);
        if (gd < d && gp < p) out[static_cast<int64_t>(gd) * p + gp] = acc[mi][ni][e];
      }
    }
  }
}

// out[i] = sum_s partial[s][i], in split order
__global__ void book_reduce_splits_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int64_t n, int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[k * n + i];
    out[i] = s;
  }
}

template <typename TA, typename TG, bool kVec>
cudaError_t launch_tiles(const void* a, const void* g, const float* w, float* dst, int m,
                         int r, int d, int p, int splits, int rows_per_split,
                         cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(Smem<TA, TG>));
  auto kernel = book_weighted_grad_kernel<TA, TG, kVec>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kBP - 1) / kBP, (d + kBD - 1) / kBD, m * splits);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const TA*>(a),
                                            static_cast<const TG*>(g), w, dst, m, r, d, p,
                                            rows_per_split);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, int row_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row_bytes % 16 == 0;
}

template <typename TA, typename TG>
cudaError_t launch(const void* a, const void* g, const float* w, float* out, float* partial,
                   int m, int r, int d, int p, int splits, int rows_per_split,
                   cudaStream_t stream) {
  float* dst = splits > 1 ? partial : out;
  const bool vec = aligned16(a, d * static_cast<int>(sizeof(TA))) &&
                   aligned16(g, p * static_cast<int>(sizeof(TG)));
  const cudaError_t err =
      vec ? launch_tiles<TA, TG, true>(a, g, w, dst, m, r, d, p, splits, rows_per_split, stream)
          : launch_tiles<TA, TG, false>(a, g, w, dst, m, r, d, p, splits, rows_per_split,
                                        stream);
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t n = static_cast<int64_t>(m) * d * p;
  const int64_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  book_reduce_splits_kernel<<<blocks, 256, 0, stream>>>(partial, out, n, splits);
  return cudaGetLastError();
}

template <typename TA>
cudaError_t launch_for_g(int g_dtype, const void* a, const void* g, const float* w, float* out,
                         float* partial, int m, int r, int d, int p, int splits,
                         int rows_per_split, cudaStream_t stream) {
  if (g_dtype == repro::kFloat32) {
    return launch<TA, float>(a, g, w, out, partial, m, r, d, p, splits, rows_per_split,
                             stream);
  }
  if (g_dtype == repro::kBFloat16) {
    return launch<TA, bf16>(a, g, w, out, partial, m, r, d, p, splits, rows_per_split,
                            stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a (m, r, d) of `a_dtype`, g (m, r, p) of `g_dtype`, contiguous; w (m, r)
// fp32; out (m, d, p) fp32.  R is cut into `splits` chunks of
// `rows_per_split` rows (a multiple of 32); with splits > 1, `partial`
// (splits, m, d, p) fp32 holds the chunks' sums and a second kernel adds
// them into out.
extern "C" int book_weighted_grad_launch(const void* a, const void* g, const void* w, void* out,
                                         void* partial, int m, int r, int d, int p, int splits,
                                         int rows_per_split, int a_dtype, int g_dtype,
                                         void* stream_ptr) {
  if (splits < 1 || rows_per_split % kBR != 0 ||
      static_cast<int64_t>(splits) * rows_per_split < r || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partial);
  cudaError_t err = cudaErrorInvalidValue;
  if (a_dtype == repro::kFloat32) {
    err = launch_for_g<float>(g_dtype, a, g, wf, o, part, m, r, d, p, splits, rows_per_split,
                              stream);
  } else if (a_dtype == repro::kBFloat16) {
    err = launch_for_g<bf16>(g_dtype, a, g, wf, o, part, m, r, d, p, splits, rows_per_split,
                             stream);
  }
  return static_cast<int>(err);
}
