// Attention forward with an online softmax (FlashAttention-2 style):
//
//     o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / g]) v[b, j, h / g]
//
// over the keys j that the causal and window masks leave to query row i,
// at absolute positions q_offset + i and j.  q (B, Sq, H, hd), k and v
// (B, Skv, K, hd), g = H / K, all contiguous in the JAX public layout and
// of one type (fp32 or bf16); o (B, Sq, H, hd) in that type.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py::
// flash_attention_pallas.  The Pallas kernel carries (m, l, acc) in VMEM
// across a sequential KV grid axis; blocks here run in parallel in no
// order, so one block owns a (batch, head, 64-row q tile) and loops over
// the KV tiles itself, with m, l and its share of the (64, hd) accumulator
// in registers.  Scores and probabilities live only in shared memory.
// The block reads KV head h / g in place: no transposed copy and none of
// the Pallas wrapper's jnp.repeat of K and V (8x at Yi-6B's 32/4 heads).
//
// What bounds it on the H100: operations.  A causal prompt of length s
// needs 4 * hd * s(s+1)/2 flops per head against (2 + 2/g) * s * hd
// values moved, hundreds of flops per byte, so a tensor-core kernel would
// be bound by the 989 TFLOP/s bf16 rate.  This first version multiplies
// in fp32 on the CUDA cores (67 TFLOP/s at best, and below that here,
// since every fma reads its operands from shared memory): simple and
// exact to fp32 summation order, not fast.  What the design does about
// the bound: it skips the KV tiles that the causal or window mask leaves
// fully dead (half the work of a causal prefill), reads each K/V tile once
// per block through shared memory for 64 query rows, and keeps P in fp32
// (the Pallas kernel rounds P to the input type before P.V; this kernel
// does not).  wgmma, TMA and warp specialisation are later work.
//
// Thread layout: 256 threads as 16 x 16; thread (ty, tx) owns query rows
// 4ty..4ty+3, score columns tx and tx+16 of the 32-key tile, and output
// columns tx + 16c.  The 16 threads of a row group are one half-warp, so
// row max and row sum reduce with xor shuffles inside it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 32;  // keys per tile
constexpr float kNegInf = -1e30f;  // the Pallas kernel's finite mask value

template <int HD>
constexpr size_t smem_bytes() {
  // q tile and k tile padded by one column (conflict-free column reads),
  // v tile, p tile padded by one column
  return sizeof(float) *
         (kBQ * (HD + 1) + kBKV * (HD + 1) + kBKV * HD + kBQ * (kBKV + 1));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                           int heads, int kv_heads, int causal, int window, int q_offset,
                           float scale) {
  constexpr int QS = HD + 1, KS = HD + 1, PS = kBKV + 1, RC = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // (kBQ, QS)
  float* ks = qs + kBQ * QS;    // (kBKV, KS)
  float* vs = ks + kBKV * KS;   // (kBKV, HD)
  float* ps = vs + kBKV * HD;   // (kBQ, PS)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the longest causal rows first: the last q tile has the most live keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kv_head = head / (heads / kv_heads);
  const int64_t q_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const T* qb = q + (static_cast<int64_t>(b) * sq * heads + head) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * skv * kv_heads + kv_head) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * skv * kv_heads + kv_head) * HD;
  T* ob = o + (static_cast<int64_t>(b) * sq * heads + head) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * QS + d] = q0 + r < sq ? repro::to_float(qb[(q0 + r) * q_stride + d]) : 0.f;
  }

  float m[4], l[4], acc[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.f;
  }

  // the keys any row of this tile can reach; tiles outside are dead
  const int rows = min(kBQ, sq - q0);
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + q0 + rows - 1;
  const int k_hi = causal ? min(skv, qpos_hi + 1) : skv;
  const int k_lo = window >= 0 ? max(0, qpos_lo - window + 1) : 0;

  for (int k0 = (k_lo / kBKV) * kBKV; k0 < k_hi; k0 += kBKV) {
    __syncthreads();  // the previous tile's readers (and the q tile's writers) are done
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < skv;
      const int64_t at = (k0 + r) * kv_stride + d;
      ks[r * KS + d] = in ? repro::to_float(kb[at]) : 0.f;
      vs[r * HD + d] = in ? repro::to_float(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * QS + d];
      const float k0v = ks[tx * KS + d], k1v = ks[(tx + 16) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k0v, s[i][0]);
        s[i][1] = fmaf(qv[i], k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool live = kpos < skv;
        if (causal) live = live && kpos <= qpos;
        if (window >= 0) live = live && qpos - kpos < window;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      ps[(4 * ty + i) * PS + tx] = p0;
      ps[(4 * ty + i) * PS + tx + 16] = p1;
      l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * PS + j];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float vv = vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < RC; ++c) store(&ob[r * q_stride + tx + 16 * c], acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int heads, int kv_heads, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(smem_bytes<HD>());
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, b);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, heads, kv_heads, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int b, int sq,
              int skv, int heads, int kv_heads, int causal, int window, int q_offset,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, window, q_offset,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, window, q_offset,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, window, q_offset,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, skv, heads, kv_heads, causal, window, q_offset,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, sq, heads, hd), k and v (b, skv, kv_heads, hd), o (b, sq, heads, hd),
// all contiguous of `dtype`; window < 0 means none; scale multiplies q . k.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int sq, int skv, int heads, int kv_heads, int hd,
                                      int causal, int window, int q_offset, float scale,
                                      int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == repro::kFloat32) {
    return launch_hd<float>(hd, q, k, v, o, b, sq, skv, heads, kv_heads, causal, window,
                            q_offset, scale, stream);
  }
  if (dtype == repro::kBFloat16) {
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, b, sq, skv, heads, kv_heads, causal,
                                    window, q_offset, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
