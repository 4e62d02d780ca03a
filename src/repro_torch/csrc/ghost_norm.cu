// Per-sample ghost norms (paper Eq. 2.7) on Hopper:
//
//     ghost_norm_sq:           out[n] = sum_{t,t'} (a_t . a_t')   (g_t . g_t')
//     conv_ghost_norm_sq:      the same with a = unfold2d(x) read from the raw
//                              NHWC conv input x, never built
//
//     a (N,T,D) or x (N,H,W,C), g (N,T,p) -> (N,) fp32
//
// Replace src/repro/kernels/ghost_norm/ghost_norm.py::ghost_norm_sq_pallas.
// The same module's embedding_ghost_norm_sq_pallas is embedding_norm.cu, a
// segment sum rather than a Gram.
//
// What bounds the Gram kernels on the H100: operations on the tensor cores.
// Per sample the two Grams cost T^2 (D + p) multiply-adds on T (D + p)
// inputs (at T = 196 or 64 far above the bf16 ridge of ~295 flop/byte).
// Tensor cores take no fp32 operand and the norms are held to 1e-4, so:
// - a bf16 operand (the ViT's a and g) is exact: one bf16 MMA per product;
// - an fp32 operand (VGG-19's) is split into bf16 hi + lo as it lands in
//   shared memory or registers, and its Gram is lo.hi + hi.lo + hi.hi
//   (bf16x3; the dropped lo.lo is <= 2^-16 of a product).  3xTF32 would
//   run at half bf16x3's rate.
// So the bound counts, per Gram, 1 (bf16) or 3 (fp32) products at the
// bf16 peak.  The tensor cores' sums inside an MMA chain need not round to
// nearest, so each k-step's chain starts from zero and is added to an fp32
// register sum with an ordinary rounded add (as book_weighted_grad.cu).
//
// Two kernels, picked by T (the wrapper's tile_for):
// - T >= 17, ghost_norm_tiles_kernel: one block per (sample, lower-triangle
//   pair (i, j) of 64-row tiles), off-diagonal pairs weighted 2x.  Eight
//   warps own 16 x 32 of the 64 x 64 tile; the a-Gram and the g-Gram tiles
//   are accumulated in the same fragment layout, so the epilogue is an
//   elementwise product of two register arrays reduced over the block and
//   neither Gram reaches device memory.  Features stream through a 4-stage
//   cp.async ring in k-steps of 32 (fp32) or 64 (bf16) features: 16-byte
//   copies where the operand's rows allow them, plain loads otherwise,
//   zero-fill past T and D; the g-Gram's steps, then the a-Gram's, share
//   the ring.  fp32 stages are split once per block into
//   bf16 hi / lo tiles; bf16 stages are MMA operands as they land.  Tile
//   edge 64: a 32 tile re-reads each row strip twice as often, and T = 196
//   fills 4 tiles (77% live).
// - T <= 16, ghost_norm_packed_kernel: one m16 tile covers a whole sample's
//   Gram; for T <= 8, floor(16 / T) samples share the tile and only its
//   block diagonal counts (T = 4: 4 samples a tile, not 1/16 of it live).
//   The eight warps split the feature dimension by k16 chunks and load
//   their fragments straight from device memory (the m16 A fragment of a
//   Gram X X^T is also its two n8 B fragments: one load, both operands),
//   then sum their partial Grams in shared memory in warp order.
// The conv entry is the same two kernels with another row source: tile row
// t is output position (y, x) = (t / W_out, t % W_out) and feature k walks
// (i, j, c), c fastest, so a_t[k] = x[n, y*s_h + i - pad_top,
// x*s_w + j - pad_left, c], zero outside the image.  Any feature order
// that all rows share gives the same Gram, so this (i, j, c) order (runs
// of C, and of kw*C along a patch row, contiguous in x) replaces unfold2d's
// channel-major one and im2col never happens.
//
// Determinism: a block cannot carry a sum to another, so each block of the
// tiles kernel writes one (sample, pair) partial and sum_pairs adds a
// sample's partials in pair order; with one pair (T <= 64), and in the
// packed kernel, the block writes the norm itself.  No atomics: repeated
// runs give bit-identical norms.
#include "common.cuh"
#include "mma.cuh"

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------- row sources --
// Element (row, k) of one sample's (rows, width) operand, as an offset from
// the sample's base pointer; `ok` is false outside the operand (or, for a
// conv, in the padding), and the element then reads as zero.
struct Dense {
  int rows, width;
  int64_t sample_stride;
  __device__ __forceinline__ int64_t offset(int row, int k, bool& ok) const {
    ok = row < rows && k < width;
    return static_cast<int64_t>(row) * width + k;
  }
};

// n / d for 0 <= n < 2^31 by a multiply and a shift (division by an
// invariant integer: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1)
struct FastDiv {
  uint32_t m, l;
  static FastDiv make(uint32_t d) {
    uint32_t l = 0;
    while ((uint64_t{1} << l) < d) ++l;
    const uint64_t m = ((uint64_t{1} << 32) * ((uint64_t{1} << l) - d)) / d + 1;
    return {static_cast<uint32_t>(m), l};
  }
  __device__ __forceinline__ int operator()(int n) const {
    const uint32_t t = __umulhi(static_cast<uint32_t>(n), m);
    return static_cast<int>((static_cast<uint64_t>(t) + static_cast<uint32_t>(n)) >> l);
  }
};

// The implicit im2col of an NHWC input: row t = (y, x) output position,
// feature k = (i, j, c) with c fastest; width = kh * kw * c.
struct Conv {
  int rows, width;
  int64_t sample_stride;  // h * w * c
  int h, w, c, kwc, sh, sw, pad_top, pad_left, w_out;
  FastDiv by_w_out, by_kwc, by_c;
  __device__ __forceinline__ int64_t offset(int row, int k, bool& ok) const {
    const int y = by_w_out(row), x = row - y * w_out;
    const int i = by_kwc(k), rem = k - i * kwc;
    const int j = by_c(rem), ch = rem - j * c;
    const int yy = y * sh + i - pad_top, xx = x * sw + j - pad_left;
    ok = row < rows && k < width && yy >= 0 && yy < h && xx >= 0 && xx < w;
    return (static_cast<int64_t>(yy) * w + xx) * c + ch;
  }
};

// ------------------------------------------- T >= 17: 64 x 64 tile pairs --
constexpr int kThreads = 256;
constexpr int kBT = 64;     // tile edge (rows of T)
constexpr int kSplitK = 32;           // features per k-step of an fp32 operand
constexpr int kSplitRow = kSplitK + 8;  // its bf16 hi / lo rows: 80 B, conflict-free ldmatrix

// The ring of one operand type: features per k-step and the row stride of
// a staged tile.  fp32 rows are 144 B (conflict-free float4 reads for the
// split); bf16 rows 144 B too (64 features + 8: conflict-free ldmatrix),
// so a bf16 operand, which needs no split, takes twice the features per
// step and half the barriers.
template <typename T>
struct Ring {
  static constexpr bool kSplit = std::is_same_v<T, float>;
  static constexpr int kK = kSplit ? kSplitK : 64;
  static constexpr int kRow = kSplit ? kK + 4 : kK + 8;
  static constexpr int kStageBytes = 2 * kBT * kRow * static_cast<int>(sizeof(T));  // tiles i, j
};
constexpr int kSplitBytes = 2 * 2 * kBT * kSplitRow * static_cast<int>(sizeof(bf16));  // hi, lo

// One instance of the tiles kernel: the ring's depth and slot size, the
// shared memory, and the blocks an SM must hold (both bf16: 3, for one wave
// of ViT-Base's 320 blocks, at 80 registers; a split operand's fragments
// need more registers: 2)
template <typename TA, typename TG>
struct Tiles {
  static constexpr bool kSplit = Ring<TA>::kSplit || Ring<TG>::kSplit;
  static constexpr int kStages = 4;
  static constexpr int kMinBlocks = kSplit ? 2 : 3;
  static constexpr int kSlot = Ring<TA>::kStageBytes > Ring<TG>::kStageBytes
                                   ? Ring<TA>::kStageBytes : Ring<TG>::kStageBytes;
  static constexpr int kRawBytes = kStages * kSlot;
  static constexpr int kSmemBytes = kRawBytes + (kSplit ? kSplitBytes : 0);
};

// Rows [row_i, row_i + kBT) (and [row_j, ...) unless diag) x features
// [k0, k0 + kK) into one ring stage.  `vec`: every 16-byte chunk of a row
// is contiguous, aligned and all inside or all outside the operand.
template <typename T, class Src>
__device__ __forceinline__ void load_stage(T* raw, const T* base, const Src& src, int row_i,
                                           int row_j, bool diag, int k0, bool vec) {
  constexpr int K = Ring<T>::kK, R = Ring<T>::kRow;
  const int tiles = diag ? 1 : 2;
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CH = K / E;
    for (int idx = threadIdx.x; idx < tiles * kBT * CH; idx += kThreads) {
      const int r = idx / CH, c = (idx % CH) * E;  // r over both tiles
      const int row = (r < kBT ? row_i : row_j - kBT) + r;
      bool ok;
      const int64_t off = src.offset(row, k0 + c, ok);
      repro::cp_async16(raw + r * R + c, ok ? base + off : base, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < tiles * kBT * K; idx += kThreads) {
      const int r = idx / K, c = idx % K;
      const int row = (r < kBT ? row_i : row_j - kBT) + r;
      bool ok;
      const int64_t off = src.offset(row, k0 + c, ok);
      raw[r * R + c] = ok ? base[off] : T(0.f);
    }
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
}

// one fp32 stage -> bf16 hi / lo tiles (x = hi + lo)
__device__ __forceinline__ void split_stage(const float* raw, bf16* hi, bf16* lo, int tiles) {
  for (int idx = threadIdx.x; idx < tiles * kBT * kSplitK / 8; idx += kThreads) {
    const int r = idx / (kSplitK / 8), c = (idx % (kSplitK / 8)) * 8;
    float x[8];
    load8(raw + r * Ring<float>::kRow + c, x);
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * q], x[2 * q + 1]);
      const float2 hf = __bfloat1622float2(hv);
      h[q] = repro::bits(hv);
      l[q] = repro::pack_bf16(x[2 * q] - hf.x, x[2 * q + 1] - hf.y);
    }
    *reinterpret_cast<uint4*>(hi + r * kSplitRow + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * kSplitRow + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// acc += X_i[wm:wm+16] X_j[wn:wn+32]^T over one k-step of K features, from
// bf16 tiles of `kRow`-element rows; kSplit adds the lo.hi and hi.lo products
template <bool kSplit, int K, int kRow>
__device__ __forceinline__ void mma_step(float (&acc)[4][4], const bf16* hi_i, const bf16* lo_i,
                                         const bf16* hi_j, const bf16* lo_j, int wm, int wn,
                                         int lane) {
  float c[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) c[ni][0] = c[ni][1] = c[ni][2] = c[ni][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int a_off = (wm + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8;
    uint32_t ah[4], al[4];
    repro::ldmatrix_x4(ah, hi_i + a_off);
    if constexpr (kSplit) repro::ldmatrix_x4(al, lo_i + a_off);
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int nb2 = 0; nb2 < 2; ++nb2) {
      const int b_off = (wn + nb2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kRow + kk * 16 +
                        ((lane >> 3) & 1) * 8;
      uint32_t f[4];
      repro::ldmatrix_x4(f, hi_j + b_off);
      bh[2 * nb2][0] = f[0]; bh[2 * nb2][1] = f[1];
      bh[2 * nb2 + 1][0] = f[2]; bh[2 * nb2 + 1][1] = f[3];
      if constexpr (kSplit) {
        repro::ldmatrix_x4(f, lo_j + b_off);
        bl[2 * nb2][0] = f[0]; bl[2 * nb2][1] = f[1];
        bl[2 * nb2 + 1][0] = f[2]; bl[2 * nb2 + 1][1] = f[3];
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {  // small terms first
      if constexpr (kSplit) {
        repro::mma_bf16(c[ni], al, bh[ni][0], bh[ni][1]);
        repro::mma_bf16(c[ni], ah, bl[ni][0], bl[ni][1]);
      }
      repro::mma_bf16(c[ni], ah, bh[ni][0], bh[ni][1]);
    }
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] += c[ni][e];
}

// acc += this warp's part of the (i, j) tile of the Gram of the operand
// staged in `slot` (one k-step)
template <typename T>
__device__ __forceinline__ void gram_step(float (&acc)[4][4], const unsigned char* slot,
                                          unsigned char* split, bool diag) {
  using RT = Ring<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  const T* cur = reinterpret_cast<const T*>(slot);
  if constexpr (RT::kSplit) {
    bf16* hi = reinterpret_cast<bf16*>(split);
    bf16* lo = hi + 2 * kBT * kSplitRow;
    split_stage(cur, hi, lo, diag ? 1 : 2);
    __syncthreads();
    const int j_off = diag ? 0 : kBT * kSplitRow;
    mma_step<true, kSplitK, kSplitRow>(acc, hi, lo, hi + j_off, lo + j_off, wm, wn, lane);
  } else {
    const bf16* j_tile = cur + (diag ? 0 : kBT * RT::kRow);
    mma_step<false, RT::kK, RT::kRow>(acc, cur, nullptr, j_tile, nullptr, wm, wn, lane);
  }
}

// This warp's part of the (i, j) tiles of one sample's two Grams: the
// g-Gram's k-steps, then the a-Gram's, through one ring, so the a-Gram's
// first loads are in flight while the g-Gram finishes
template <typename TA, typename TG, class SrcA>
__device__ __forceinline__ void gram_tiles(float (&acc_a)[4][4], float (&acc_g)[4][4],
                                           const TA* a, const SrcA& sa, bool vec_a,
                                           const TG* g, const Dense& sg, bool vec_g,
                                           int row_i, int row_j, unsigned char* smem) {
  using TT = Tiles<TA, TG>;
  constexpr int kStages = TT::kStages, kSlot = TT::kSlot;
  unsigned char* split = smem + TT::kRawBytes;
  const bool diag = row_i == row_j;
  const int steps_g = (sg.width + Ring<TG>::kK - 1) / Ring<TG>::kK;
  const int steps = steps_g + (sa.width + Ring<TA>::kK - 1) / Ring<TA>::kK;
  auto load = [&](int s) {
    unsigned char* slot = smem + (s % kStages) * kSlot;
    if (s < steps_g) {
      load_stage(reinterpret_cast<TG*>(slot), g, sg, row_i, row_j, diag, s * Ring<TG>::kK,
                 vec_g);
    } else {
      load_stage(reinterpret_cast<TA*>(slot), a, sa, row_i, row_j, diag,
                 (s - steps_g) * Ring<TA>::kK, vec_a);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    repro::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    repro::cp_async_wait<kStages - 2>();  // step s has landed ...
    __syncthreads();  // ... for every thread, and step s - 1 is consumed
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    repro::cp_async_commit();
    const unsigned char* slot = smem + (s % kStages) * kSlot;
    if (s < steps_g) {
      gram_step<TG>(acc_g, slot, split, diag);
    } else {
      gram_step<TA>(acc_a, slot, split, diag);
    }
  }
}

template <typename TA, typename TG, class SrcA>
__global__ void __launch_bounds__(kThreads, (Tiles<TA, TG>::kMinBlocks))
    ghost_norm_tiles_kernel(const TA* __restrict__ a, const TG* __restrict__ g, SrcA sa,
                            Dense sg, bool vec_a, bool vec_g, float* __restrict__ partial,
                            int n_pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_sums[kThreads / 32];
  const int64_t block = blockIdx.x;
  const int64_t n = block / n_pairs;
  const int pair = static_cast<int>(block % n_pairs);
  // lower-triangle pair index -> (i, j) with j <= i
  int i = static_cast<int>((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= pair) ++i;
  while (i * (i + 1) / 2 > pair) --i;
  const int j = pair - i * (i + 1) / 2;

  float acc_a[4][4], acc_g[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_a[ni][e] = acc_g[ni][e] = 0.f;
  gram_tiles(acc_a, acc_g, a + n * sa.sample_stride, sa, vec_a, g + n * sg.sample_stride, sg,
             vec_g, i * kBT, j * kBT, smem);

  float s = 0.f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) s = fmaf(acc_a[ni][e], acc_g[ni][e], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[block] = (i == j ? 1.f : 2.f) * total;
  }
}

// ------------------------------------------ T <= 16: packed m16 tiles --
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;  // k16 chunks a warp loads before it multiplies

// two consecutive features (k, k + 1) of one row as a bf16x2 hi (and lo)
// pair; `pair_vec`: both lie in one aligned, contiguous pair
template <typename T, class Src>
__device__ __forceinline__ void load_pair(const T* base, const Src& src, bool row_ok, int row,
                                          int k, bool pair_vec, float2& v) {
  bool ok0, ok1;
  const int64_t off0 = src.offset(row, k, ok0);
  ok0 = ok0 && row_ok;
  if (pair_vec) {
    if constexpr (std::is_same_v<T, float>) {
      v = ok0 ? *reinterpret_cast<const float2*>(base + off0) : make_float2(0.f, 0.f);
    } else {
      v = ok0 ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base + off0))
              : make_float2(0.f, 0.f);
    }
    return;
  }
  const int64_t off1 = src.offset(row, k + 1, ok1);
  ok1 = ok1 && row_ok;
  v.x = ok0 ? repro::to_float(base[off0]) : 0.f;
  v.y = ok1 ? repro::to_float(base[off1]) : 0.f;
}

// acc += this warp's k16 chunks (warp, warp + 8, ...) of the packed tile's
// 16 x 16 Gram.  Row r of the tile is row r % t of sample r / t; the
// fragment rows of a lane are grp and grp + 8.
template <typename T, class Src>
__device__ __forceinline__ void gram_packed(float (&acc)[2][4], const T* base, const Src& src,
                                            bool pair_vec, const int64_t (&row_base)[2],
                                            const int (&row_t)[2], const bool (&row_ok)[2]) {
  constexpr bool kSplit = std::is_same_v<T, float>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tig = lane & 3;
  const int n_chunks = (src.width + 15) / 16;
  for (int c0 = warp; c0 < n_chunks; c0 += kWarps * kAhead) {
    // fragment x[u][q]: q = 0 (row grp, k 2tig), 1 (grp + 8, 2tig),
    // 2 (grp, 2tig + 8), 3 (grp + 8, 2tig + 8) of chunk c0 + u * kWarps
    float2 x[kAhead][4];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = (c0 + u * kWarps) * 16 + 2 * tig;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = q & 1;
        load_pair(base + row_base[rr], src, row_ok[rr], row_t[rr], k + (q >> 1) * 8, pair_vec,
                  x[u][q]);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x[u][q].x, x[u][q].y);
        hi[q] = repro::bits(hv);
        if constexpr (kSplit) {
          const float2 hf = __bfloat1622float2(hv);
          lo[q] = repro::pack_bf16(x[u][q].x - hf.x, x[u][q].y - hf.y);
        }
      }
      // the B fragment of n8 tile 0 (tile rows 0-7) is (a0, a2), of tile 1 (a1, a3)
      float c[2][4];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        c[ni][0] = c[ni][1] = c[ni][2] = c[ni][3] = 0.f;
        if constexpr (kSplit) {
          repro::mma_bf16(c[ni], lo, hi[ni], hi[ni + 2]);
          repro::mma_bf16(c[ni], hi, lo[ni], lo[ni + 2]);
        }
        repro::mma_bf16(c[ni], hi, hi[ni], hi[ni + 2]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] += c[ni][e];
      }
    }
  }
}

template <typename TA, typename TG, class SrcA>
__global__ void __launch_bounds__(kThreads)
    ghost_norm_packed_kernel(const TA* __restrict__ a, const TG* __restrict__ g, SrcA sa,
                             Dense sg, bool pair_a, bool pair_g, float* __restrict__ out, int n,
                             int t, int per_tile) {
  __shared__ float red[2][kWarps][16][17];  // partial Grams (a, g) per warp
  __shared__ float prod[16][17];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * per_tile;
  int64_t base_a[2], base_g[2];
  int row_t[2];
  bool row_ok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = grp + 8 * rr;
    const int s = r / t;
    row_t[rr] = r - s * t;
    row_ok[rr] = s < per_tile && n0 + s < n;
    base_a[rr] = row_ok[rr] ? (n0 + s) * sa.sample_stride : 0;
    base_g[rr] = row_ok[rr] ? (n0 + s) * sg.sample_stride : 0;
  }
  float acc_a[2][4], acc_g[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_a[ni][e] = acc_g[ni][e] = 0.f;
  gram_packed(acc_g, g, sg, pair_g, base_g, row_t, row_ok);
  gram_packed(acc_a, a, sa, pair_a, base_a, row_t, row_ok);
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = grp + (e >> 1) * 8, c = ni * 8 + 2 * tig + (e & 1);
      red[0][warp][r][c] = acc_a[ni][e];
      red[1][warp][r][c] = acc_g[ni][e];
    }
  __syncthreads();
  {  // one Gram entry per thread: the warps' partials in warp order, then
     // the product where row and column belong to one sample
    const int r = threadIdx.x / 16, c = threadIdx.x % 16;
    float ga = 0.f, gg = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ga += red[0][w][r][c];
      gg += red[1][w][r][c];
    }
    prod[r][c] = (r / t == c / t) ? ga * gg : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < per_tile && n0 + static_cast<int>(threadIdx.x) < n) {
    const int r0 = threadIdx.x * t;
    float total = 0.f;
    for (int r = r0; r < r0 + t; ++r)
      for (int c = r0; c < r0 + t; ++c) total += prod[r][c];
    out[n0 + threadIdx.x] = total;
  }
}

// ------------------------------------------------------------ launch --
// out[n] = sum of sample n's pair partials, in pair order (deterministic).
__global__ void sum_pairs(const float* __restrict__ partial, float* __restrict__ out, int n,
                          int n_pairs) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float acc = 0.f;
  for (int q = 0; q < n_pairs; ++q) acc += partial[static_cast<int64_t>(s) * n_pairs + q];
  out[s] = acc;
}

int n_pairs_for(int t, int tile) {
  const int n_tiles = (t + tile - 1) / tile;
  return n_tiles * (n_tiles + 1) / 2;
}

// The pair pass has run (err); reduce the partials unless it wrote `out`.
cudaError_t finish(cudaError_t err, const float* partial, float* out, int n, int n_pairs,
                   cudaStream_t stream) {
  if (err != cudaSuccess || n_pairs == 1) return err;
  sum_pairs<<<(n + 255) / 256, 256, 0, stream>>>(partial, out, n, n_pairs);
  return cudaGetLastError();
}

bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

// How the kernels may read one operand: 16-byte chunks (tiles kernel) and
// 2-element pairs (packed kernel), each contiguous, aligned, and all inside
// or all outside the operand and the image.
struct Access {
  bool vec16, pair;
};

template <typename T>
Access dense_access(const void* base, int width) {
  const int size = static_cast<int>(sizeof(T));
  return {aligned(base, 16) && (width * size) % 16 == 0,
          aligned(base, 2 * size) && width % 2 == 0};
}

template <typename T>
Access conv_access(const void* base, const Conv& cv, int kw, int pad_right) {
  const int size = static_cast<int>(sizeof(T));
  // a chunk inside one pixel, or inside one patch row of a conv whose
  // windows never leave the image across W
  const bool in_pixel = (cv.c * size) % 16 == 0;
  const bool in_row = cv.pad_left == 0 && pad_right == 0 && (cv.w * cv.c * size) % 16 == 0 &&
                      (cv.sw * cv.c * size) % 16 == 0 && (kw * cv.c * size) % 16 == 0;
  return {aligned(base, 16) && (in_pixel || in_row), aligned(base, 2 * size) && cv.c % 2 == 0};
}

struct Launch {
  const void* a;
  const void* g;
  float* out;
  float* partial;
  int n, t, tile;
  cudaStream_t stream;
};

template <typename TA, typename TG, class SrcA>
cudaError_t launch_gram(const Launch& x, const SrcA& sa, Access acc_a, const Dense& sg) {
  const Access acc_g = dense_access<TG>(x.g, sg.width);
  const TA* a = static_cast<const TA*>(x.a);
  const TG* g = static_cast<const TG*>(x.g);
  if (x.tile == 16) {
    const int per_tile = x.t <= 8 ? 16 / x.t : 1;
    const unsigned blocks = static_cast<unsigned>((x.n + per_tile - 1) / per_tile);
    ghost_norm_packed_kernel<TA, TG, SrcA><<<blocks, kThreads, 0, x.stream>>>(
        a, g, sa, sg, acc_a.pair, acc_g.pair, x.out, x.n, x.t, per_tile);
    return cudaGetLastError();
  }
  const int n_pairs = n_pairs_for(x.t, kBT);
  constexpr int bytes = Tiles<TA, TG>::kSmemBytes;
  auto kernel = ghost_norm_tiles_kernel<TA, TG, SrcA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  float* dst = n_pairs == 1 ? x.out : x.partial;
  const unsigned blocks = static_cast<unsigned>(static_cast<int64_t>(x.n) * n_pairs);
  kernel<<<blocks, kThreads, bytes, x.stream>>>(a, g, sa, sg, acc_a.vec16, acc_g.vec16, dst,
                                                n_pairs);
  return finish(cudaGetLastError(), x.partial, x.out, x.n, n_pairs, x.stream);
}

// the cotangent's dtype picks the instance
template <class SrcA, typename TA>
cudaError_t launch_for_g(const Launch& x, const SrcA& sa, Access acc_a, const Dense& sg,
                         int g_dtype) {
  if (g_dtype == repro::kFloat32) return launch_gram<TA, float>(x, sa, acc_a, sg);
  if (g_dtype == repro::kBFloat16) return launch_gram<TA, bf16>(x, sa, acc_a, sg);
  return cudaErrorInvalidValue;
}

}  // namespace

// a (n, t, d) of `a_dtype`, g (n, t, p) of `g_dtype`, contiguous; out (n,)
// fp32.  `tile` is 16 (t <= 16: the packed kernel) or 64 (the tiles
// kernel); `partial` holds n * n_pairs floats when a sample has more than
// one 64-row tile pair, and may alias `out` otherwise.
extern "C" int ghost_norm_sq_launch(const void* a, const void* g, void* out, void* partial,
                                    int n, int t, int d, int p, int a_dtype, int g_dtype,
                                    int tile, void* stream_ptr) {
  if (!((tile == 16 && t <= 16) || (tile == kBT && t > 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch x{a, g, static_cast<float*>(out), static_cast<float*>(partial), n, t, tile,
                 static_cast<cudaStream_t>(stream_ptr)};
  const Dense sa{t, d, static_cast<int64_t>(t) * d};
  const Dense sg{t, p, static_cast<int64_t>(t) * p};
  cudaError_t err = cudaErrorInvalidValue;
  if (a_dtype == repro::kFloat32)
    err = launch_for_g<Dense, float>(x, sa, dense_access<float>(a, d), sg, g_dtype);
  else if (a_dtype == repro::kBFloat16)
    err = launch_for_g<Dense, bf16>(x, sa, dense_access<bf16>(a, d), sg, g_dtype);
  return static_cast<int>(err);
}

// x (n, h, w, c) of `x_dtype`, the raw NHWC input of a conv with kernel
// (kh, kw), strides (sh, sw) and explicit pads (top, bottom, left, right);
// g (n, h_out * w_out, p) of `g_dtype`; out, partial and tile as above with
// t = h_out * w_out.  Computes ghost_norm_sq(unfold2d(x), g) without
// forming the patches.
extern "C" int conv_ghost_norm_sq_launch(const void* xin, const void* g, void* out,
                                         void* partial, int n, int h, int w, int c, int kh,
                                         int kw, int sh, int sw, int pad_top, int pad_bottom,
                                         int pad_left, int pad_right, int p, int x_dtype,
                                         int g_dtype, int tile, void* stream_ptr) {
  const int h_out = (h + pad_top + pad_bottom - kh) / sh + 1;
  const int w_out = (w + pad_left + pad_right - kw) / sw + 1;
  const int t = h_out * w_out;
  if (h_out < 1 || w_out < 1 || !((tile == 16 && t <= 16) || (tile == kBT && t > 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch x{xin, g, static_cast<float*>(out), static_cast<float*>(partial), n, t, tile,
                 static_cast<cudaStream_t>(stream_ptr)};
  const Conv sa{t, kh * kw * c, static_cast<int64_t>(h) * w * c, h, w, c, kw * c, sh, sw,
                pad_top, pad_left, w_out, FastDiv::make(w_out), FastDiv::make(kw * c),
                FastDiv::make(c)};
  const Dense sg{t, p, static_cast<int64_t>(t) * p};
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == repro::kFloat32)
    err = launch_for_g<Conv, float>(x, sa, conv_access<float>(xin, sa, kw, pad_right), sg,
                                    g_dtype);
  else if (x_dtype == repro::kBFloat16)
    err = launch_for_g<Conv, bf16>(x, sa, conv_access<bf16>(xin, sa, kw, pad_right), sg,
                                   g_dtype);
  return static_cast<int>(err);
}
