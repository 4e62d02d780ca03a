// Attention forward with an online softmax (FlashAttention style):
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
// order, so one block owns a (batch, head, q tile) and loops over the KV
// tiles itself.  Every instance reads KV head h / g in place (no
// transposed copy and none of the Pallas wrapper's jnp.repeat of K and V,
// 8x at Yi-6B's 32/4 heads), skips the KV tiles that the causal or window
// mask leaves fully dead (half the work of a causal prefill), masks ragged
// edges by index, starts the longest causal rows first, masks with the
// Pallas kernel's finite -1e30 and floors the denominator at 1e-30.  No
// atomics: the output is deterministic.
//
// What bounds it on the H100: operations.  A causal prompt of length s
// needs 4 * hd * s(s+1)/2 flops per head against (2 + 2/g) * s * hd values
// moved, hundreds of flops per byte, so the kernel is bound by the tensor
// cores' 989 TFLOP/s bf16 rate.  Which instance runs is set by the dtype
// and the head dim:
//
// - bf16, head dims 64 and 128 (the serving path: Yi-6B's prefills, hd
//   128): warpgroup MMA fed by TMA (namespace wg), FlashAttention-3's
//   shape.  A block owns 128 query rows and has three warpgroups: one
//   producer, whose single thread loads Q once and keeps 128-key K and V
//   tiles in flight into a 2-stage (hd 128) or 3-stage (hd 64) ring of
//   128-byte-swizzled shared-memory tiles, guarded by full/empty mbarriers
//   (TMA zero-fills rows past the end); and two consumer warpgroups of 64
//   rows each.  A consumer runs S = Q K^T as wgmma.m64n128k16 with both
//   operands read from shared memory (one K tile serves all 64 rows, where
//   mma.sync re-read it per 16-row warp), masks and exponentiates S in its
//   accumulator registers, rounds P to bf16 in registers and runs
//   O += P V as wgmma.m64n{hd}k16 with P as the register A operand and V
//   as the transposed shared-memory B operand.  The two consumers take
//   turns issuing their MMAs (ping-pong on two named barriers), so one's
//   softmax overlaps the other's MMAs.  The block's rows are the query
//   heads that share a KV head (up to 8, Yi-6B's g) times 128 / 8 = 16
//   positions, so the causal blocks are 16 positions fine.  setmaxnreg
//   moves registers from the producer (24) to the consumers (240).  A tile
//   dead for one consumer's rows is skipped by it alone.  The tensor maps
//   are encoded on the host per call (the driver's encoder through
//   cudaGetDriverEntryPoint, no -lcuda).  Measured on the card and not
//   kept: issuing the next tile's S with the previous P V inside one
//   consumer (slower), and a third ring stage at hd 128 (no gain).
// - bf16, head dims 16, 32 and 96: mma.sync (namespace tc).  4 warps, each
//   owning 16 query rows of a 64-row tile; Q's fragments stay in registers
//   for the whole KV loop.  64-key K and V tiles are double-buffered in
//   shared memory with cp.async.  S = Q K^T and O += P V are bf16
//   mma.sync.m16n8k16 with fp32 accumulators (ldmatrix for Q and K,
//   ldmatrix.trans for V); P is the A operand of P V directly.  Head dim 96
//   (Phi-3-vision: 3072 / 32) is 6 k16 steps of Q K^T, 12 n8 tiles of the
//   output row and 12 16-byte cp.async chunks a row; its 208-byte padded
//   row keeps ldmatrix conflict-free.  It takes this instance because the
//   wgmma layout cuts a row into 64-column swizzled regions (HD / 64); a
//   wgmma instance at 96 (a 128-column map that TMA zero-fills past 96, or
//   a 64 + 32-column split) is later work.
// - Precision of both bf16 instances: Q K^T of bf16 inputs is exact
//   products summed in fp32, as the Pallas kernel's fp32 dot; the row max
//   and row sum live in the accumulator fragments and reduce over the four
//   lanes of a quad; P is rounded to bf16 before P V, as the Pallas kernel
//   does (p.astype(v_ref.dtype)), and l sums the unrounded fp32 P, also as
//   there.  Against the plain version (fp32 P) that adds about 2^-9 / 3 of
//   a row's scale before the output's own bf16 rounding, which alone can
//   differ by one step (2^-7 of an entry).
// - fp32: the SIMT kernel (CUDA-core fp32 FMAs from shared memory, a 64-row
//   q tile per block, 32-key tiles).  Tensor cores have no fp32 product, and
//   this instance carries the fp32 gates (1e-5 of the largest entry, the
//   prefill logits at 1e-4), so it stays exact to fp32 summation order.
//   It serves the fp32 compute paths (the logit comparison, reduced tests),
//   not the bf16 serving path; it is not fast.
#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's finite mask value

// ---------------------------------------------------------------------------
// bf16 instance for head dims 16 and 32: mma.sync
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBKV = 64;          // keys per tile
constexpr int kPad = 8;           // bf16 per row: 16-byte shift, ldmatrix conflict-free
constexpr float kLog2e = 1.4426950408889634f;

// K and V tiles, two stages each; Q is staged in K's second buffer first
template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(bf16)) * 4 * kBKV * (HD + kPad);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + kBKV) of a (rows, HD) head slice with row stride
// `stride` into a (kBKV, HD + kPad) tile; rows at or past `n_rows` are zero
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kBKV * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = row0 + r < n_rows;
    repro::cp_async16(dst + r * (HD + kPad) + col,
                      src + (in ? row0 + r : 0) * stride + col, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                                int skv, int heads, int kv_heads, int causal, int window,
                                int q_offset, float scale) {
  constexpr int S = HD + kPad;  // shared row stride, elements
  constexpr int KD = HD / 16;   // k16 steps of Q K^T
  constexpr int ND = HD / 8;    // n8 tiles of the output row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [2][kBKV][S]
  bf16* sv = sk + 2 * kBKV * S;                  // [2][kBKV][S]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  // heads vary fastest over the grid, and the last q tile (the longest
  // causal rows) of every head is scheduled first
  const int head = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kv_head = head / (heads / kv_heads);
  const int64_t q_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const bf16* qb = q + (static_cast<int64_t>(b) * sq * heads + head) * HD;
  const bf16* kb = k + (static_cast<int64_t>(b) * skv * kv_heads + kv_head) * HD;
  const bf16* vb = v + (static_cast<int64_t>(b) * skv * kv_heads + kv_head) * HD;
  bf16* ob = o + (static_cast<int64_t>(b) * sq * heads + head) * HD;

  // the keys any row of this tile can reach; tiles outside are dead
  const int rows = min(kBQ, sq - q0);
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + q0 + rows - 1;
  const int k_hi = causal ? min(skv, qpos_hi + 1) : skv;
  const int k_lo = window >= 0 ? max(0, qpos_lo - window + 1) : 0;
  const int k_first = (k_lo / kBKV) * kBKV;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + kBKV - 1) / kBKV : 0;

  // Q into K's second buffer, and the first K/V tile, in one group
  load_tile<HD>(sk + kBKV * S, qb, q_stride, q0, sq);
  if (n_tiles > 0) {
    load_tile<HD>(sk, kb, kv_stride, k_first, skv);
    load_tile<HD>(sv, vb, kv_stride, k_first, skv);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, for the whole KV loop
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    repro::ldmatrix_x4(qf[kk], sk + kBKV * S + (warp * 16 + (lane & 15)) * S + kk * 16 +
                                   (lane >> 4) * 8);
  }
  __syncthreads();  // Q's buffer is K's second stage from here on

  // rows grp and grp + 8 of the warp: running max (log2 units), sum, output
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int qpos_row = q_offset + q0 + warp * 16 + grp;  // and + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * kBKV;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      load_tile<HD>(sk + (stage ^ 1) * kBKV * S, kb, kv_stride, k0 + kBKV, skv);
      load_tile<HD>(sv + (stage ^ 1) * kBKV * S, vb, kv_stride, k0 + kBKV, skv);
    }
    repro::cp_async_commit();
    const bf16* kt = sk + stage * kBKV * S;
    const bf16* vt = sv + stage * kBKV * S;

    // S = Q K^T: 8 n8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, kt + (nb2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16(s[2 * nb2], qf[kk], kf[0], kf[1]);
        repro::mma_bf16(s[2 * nb2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale into log2 units and mask; a tile live for every row of the
    // block skips the per-entry test
    const bool full = k0 + kBKV <= skv && (!causal || k0 + kBKV - 1 <= qpos_lo) &&
                      (window < 0 || qpos_hi - k0 < window);
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (!full) {
          const int kpos = k0 + nb * 8 + 2 * tig + (e & 1);
          const int qpos = qpos_row + (e >> 1) * 8;
          bool live = kpos < skv;
          if (causal) live = live && kpos <= qpos;
          if (window >= 0) live = live && qpos - kpos < window;
          x = live ? x : kNegInf;
        }
        s[nb][e] = x;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], x);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(row_max[h]));
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m[e >> 1]);
        row_sum[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(row_sum[h]);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments, rounded to bf16, are the A operand
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = repro::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = repro::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = repro::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = repro::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int nd2 = 0; nd2 < ND / 2; ++nd2) {
        uint32_t vf[4];
        repro::ldmatrix_x4_trans(vf, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                                         nd2 * 16 + (lane >> 4) * 8);
        repro::mma_bf16(acc[2 * nd2], pa, vf[0], vf[1]);
        repro::mma_bf16(acc[2 * nd2 + 1], pa, vf[2], vf[3]);
      }
    }
    repro::cp_async_wait<0>();
    __syncthreads();  // the next tile has landed; this one's readers are done
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + grp + 8 * h;
    if (r >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* orow = ob + r * q_stride + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
          __floats2bfloat162_rn(acc[nd][2 * h] / denom, acc[nd][2 * h + 1] / denom);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int heads, int kv_heads, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(heads, (sq + kBQ - 1) / kBQ, b);
  flash_attention_bf16_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, skv, heads, kv_heads, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 instance for head dims 64 and 128: warpgroup MMA (wgmma) fed by TMA
namespace wg {

using bf16 = __nv_bfloat16;
namespace h = repro::sm90;

constexpr int kBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kBKV = 128;       // keys per K/V tile
constexpr int kConsumers = 2;   // consumer warpgroups; warpgroup 0 loads
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kRowBytes = 128;  // one swizzled tile row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// shared memory: Q (two 64-row halves, one per consumer), the K and V
// rings, then the barriers; every tile 1024-byte aligned
template <int HD>
struct Layout {
  static constexpr int kRegions = HD / 64;  // 64-column swizzled regions of a row
  static constexpr int kStages = HD == 128 ? 2 : 3;
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBKV * HD * 2;  // one K or V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // full[S], empty[S], q
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;  // + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 bf16* __restrict__ o, int sq, int skv, int heads,
                                 int kv_heads, int causal, int window, int q_offset,
                                 float scale, int pack_log2) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (h::smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_bar = empty + L::kStages;

  // a block's 128 rows are npos query positions of 2^pack_log2 heads that
  // share a KV head, row = position * 2^pack_log2 + head (one K/V tile
  // serves them all).  Head groups vary fastest over the grid; the last
  // positions (the longest causal rows) of every group are scheduled first
  const int npos = kBQ >> pack_log2;
  const int head0 = blockIdx.x << pack_log2, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * npos;
  const int kv_head = head0 / (heads / kv_heads);

  // the keys any row of this block can reach; tiles outside are dead
  const int rows = min(npos, sq - q0);  // positions
  const int k_hi = causal ? min(skv, q_offset + q0 + rows) : skv;
  const int k_lo = window >= 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int k_first = (k_lo / kBKV) * kBKV;
  const int n_tiles = k_hi > k_first ? (k_hi - k_first + kBKV - 1) / kBKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      h::mbar_init(&full[s], 1);
      h::mbar_init(&empty[s], 128 * kConsumers);
    }
    h::mbar_init(q_bar, 1);
    h::mbar_init_fence();
  }
  __syncthreads();

  const int group = threadIdx.x / 128;  // warpgroup
  if (group == 0) {
    // producer: one thread keeps the K/V ring full; the warpgroup gives its
    // registers to the consumers
    h::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      h::mbar_arrive_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int r = 0; r < L::kRegions; ++r) {
        h::tma_load_4d(smem + r * kBQ * kRowBytes, &q_map, q_bar, 64 * r, head0, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % L::kStages;
        if (it >= L::kStages) h::mbar_wait(&empty[s], (it / L::kStages - 1) & 1);
        h::mbar_arrive_expect_tx(&full[s], 2 * L::kTileBytes);
        const int k0 = k_first + it * kBKV;
#pragma unroll
        for (int r = 0; r < L::kRegions; ++r) {
          h::tma_load_4d(smem + L::kK + s * L::kTileBytes + r * kBKV * kRowBytes, &k_map,
                         &full[s], 64 * r, kv_head, k0, b);
          h::tma_load_4d(smem + L::kV + s * L::kTileBytes + r * kBKV * kRowBytes, &v_map,
                         &full[s], 64 * r, kv_head, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of the block
  h::regs_alloc<240>();
  const int cw = group - 1;
  const int tid = threadIdx.x - 128 * group;
  const int warp = tid >> 5, lane = tid & 31, grp = lane >> 2, tig = lane & 3;
  const int pos_lo = q0 + ((64 * cw) >> pack_log2);  // this warpgroup's positions
  const int pos_hi = min(q0 + ((64 * cw + 63) >> pack_log2), sq - 1);
  const bool idle = pos_lo >= sq;  // the block's ragged edge
  const int qpos_lo = q_offset + pos_lo, qpos_hi = q_offset + pos_hi;
  const int my_k_hi = causal ? min(skv, qpos_hi + 1) : skv;
  const int my_k_lo = window >= 0 ? max(0, qpos_lo - window + 1) : 0;
  int qpos_r[2];  // this thread's two rows: 64 cw + 16 warp + grp (+ 8)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qpos_r[hh] = q_offset + q0 + ((64 * cw + 16 * warp + grp + 8 * hh) >> pack_log2);
  }
  const float scale_log2 = scale * kLog2e;
  const unsigned char* q_tile = smem + cw * 64 * kRowBytes;

  constexpr int SN = kBKV / 2;  // S accumulator floats per thread
  constexpr int ON = HD / 2;    // O accumulator floats per thread
  float acc[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ping-pong: the two consumers take turns issuing their MMAs (named
  // barrier 1 + cw is this one's turn), so one's softmax runs while the
  // other's MMAs do; every tile passes the turn twice, live or not
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  if (cw == 1) h::bar_arrive(other_turn, 256);  // consumer 0 goes first
  h::mbar_wait(q_bar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % L::kStages;
    const int k0 = k_first + it * kBKV;
    h::mbar_wait(&full[s], (it / L::kStages) & 1);
    if (idle || k0 >= my_k_hi || k0 + kBKV <= my_k_lo) {  // dead for these rows
      for (int turn = 0; turn < 2; ++turn) {
        h::bar_sync(my_turn, 256);
        h::bar_arrive(other_turn, 256);
      }
      h::mbar_arrive(&empty[s]);
      continue;
    }
    const unsigned char* k_tile = smem + L::kK + s * L::kTileBytes;
    const unsigned char* v_tile = smem + L::kV + s * L::kTileBytes;

    // S = Q K^T: HD / 16 k-steps of m64n128k16, both operands K-major
    float sc[SN];
#pragma unroll
    for (int i = 0; i < SN; ++i) sc[i] = 0.f;
    h::fence_regs(sc);
    h::bar_sync(my_turn, 256);
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // 64-column region kk / 4, 32 B per k16 within
      h::wgmma_ss<kBKV>(
          sc, h::desc_sw128(q_tile + (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32, 16, 1024),
          h::desc_sw128(k_tile + (kk / 4) * kBKV * kRowBytes + (kk % 4) * 32, 16, 1024), kk > 0);
    }
    h::wgmma_commit();
    h::bar_arrive(other_turn, 256);
    h::wgmma_wait<0>();
    h::fence_regs(sc);

    // scale into log2 units and mask; a tile live for every row of the
    // warpgroup skips the per-entry test
    const bool full_tile = k0 + kBKV <= skv && (!causal || k0 + kBKV - 1 <= qpos_lo) &&
                           (window < 0 || qpos_hi - k0 < window);
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (!full_tile) {
          const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
          const int qpos = qpos_r[e >> 1];
          bool live = kpos < skv;
          if (causal) live = live && kpos <= qpos;
          if (window >= 0) live = live && qpos - kpos < window;
          x = live ? x : kNegInf;
        }
        sc[4 * j + e] = x;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], x);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], tc::quad_max(row_max[hh]));
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      row_sum[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + tc::quad_sum(row_sum[hh]);
#pragma unroll
    for (int i = 0; i < ON; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: P rounded to bf16 in registers is the A operand (n8 chunks
    // 2kc, 2kc+1 of S are k16 chunk kc); V is the transposed B operand
    uint32_t pa[kBKV / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kc][r] = repro::pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
      }
    }
    h::fence_regs(acc);
    h::bar_sync(my_turn, 256);
    h::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      h::wgmma_rs<HD>(acc, pa[kc],
                      h::desc_sw128(v_tile + kc * 16 * kRowBytes, kBKV * kRowBytes, 1024), 1);
    }
    h::wgmma_commit();
    h::bar_arrive(other_turn, 256);
    h::wgmma_wait<0>();
    h::fence_regs(acc);
    h::mbar_arrive(&empty[s]);  // this warpgroup is done with the stage
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = 64 * cw + 16 * warp + grp + 8 * hh;
    const int pos = q0 + (row >> pack_log2);
    if (pos >= sq) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    bf16* orow = o + ((static_cast<int64_t>(b) * sq + pos) * heads + head0 +
                      (row & ((1 << pack_log2) - 1))) * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] / denom, acc[4 * j + 2 * hh + 1] / denom);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, reached through the runtime (no -lcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (batch, rows, heads, HD) bf16 tensor as a 4-d map (HD innermost) with
// boxes of 64 columns x box_heads heads x box_rows rows, 128-byte swizzled
// (box row = row * box_heads + head); rows past the end load as zeros
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int batch, int n_rows, int n_heads,
                int box_heads, int box_rows) {
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(n_rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {HD * 2ull, HD * 2ull * n_heads, HD * 2ull * n_heads * n_rows};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                   strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int heads, int kv_heads, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int bytes = Layout<HD>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // pack the query heads that share a KV head: the largest power of two
  // that divides H / K, at most 8 (16 positions a block)
  const int group = heads / kv_heads;
  int pack_log2 = 0;
  while (pack_log2 < 3 && group % (2 << pack_log2) == 0) ++pack_log2;
  const int npos = kBQ >> pack_log2;
  CUtensorMap qm, km, vm;
  if (!tensor_map<HD>(&qm, q, b, sq, heads, 1 << pack_log2, npos) ||
      !tensor_map<HD>(&km, k, b, skv, kv_heads, 1, kBKV) ||
      !tensor_map<HD>(&vm, v, b, skv, kv_heads, 1, kBKV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(heads >> pack_log2, (sq + npos - 1) / npos, b);
  flash_attention_wgmma_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), sq, skv, heads, kv_heads, causal, window, q_offset,
      scale, pack_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// fp32 instance: CUDA-core SIMT
//
// Thread layout: 256 threads as 16 x 16; thread (ty, tx) owns query rows
// 4ty..4ty+3, score columns tx and tx+16 of the 32-key tile, and output
// columns tx + 16c.  The 16 threads of a row group are one half-warp, so
// row max and row sum reduce with xor shuffles inside it.  Scores and
// probabilities live in shared memory; P stays fp32.
namespace simt {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows per block
constexpr int kBKV = 32;  // keys per tile

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o, int sq,
                                int skv, int heads, int kv_heads, int causal, int window,
                                int q_offset, float scale) {
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
  const float* qb = q + (static_cast<int64_t>(b) * sq * heads + head) * HD;
  const float* kb = k + (static_cast<int64_t>(b) * skv * kv_heads + kv_head) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * skv * kv_heads + kv_head) * HD;
  float* ob = o + (static_cast<int64_t>(b) * sq * heads + head) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r * QS + d] = q0 + r < sq ? qb[(q0 + r) * q_stride + d] : 0.f;
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
      ks[r * KS + d] = in ? kb[at] : 0.f;
      vs[r * HD + d] = in ? vb[at] : 0.f;
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
    for (int c = 0; c < RC; ++c) ob[r * q_stride + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int skv,
           int heads, int kv_heads, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(smem_bytes<HD>());
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fp32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, heads, b);
  flash_attention_fp32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, skv, heads, kv_heads, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// one instance per head dim: HD is a template parameter of both kernels
using LaunchFn = int (*)(const void*, const void*, const void*, void*, int, int, int, int, int,
                         int, int, int, float, cudaStream_t);

template <template <int> class Pick>
LaunchFn for_head_dim(int hd) {
  switch (hd) {
    case 16: return Pick<16>::fn;
    case 32: return Pick<32>::fn;
    case 64: return Pick<64>::fn;
    case 96: return Pick<96>::fn;
    case 128: return Pick<128>::fn;
    default: return nullptr;
  }
}

// bf16: wgmma for head dims 64 and 128, mma.sync for 16, 32 and 96
template <int HD>
constexpr LaunchFn bf16_launch() {
  if constexpr (HD == 64 || HD == 128) {
    return wg::launch<HD>;
  } else {
    return tc::launch<HD>;
  }
}

template <int HD>
struct Bf16 {
  static constexpr LaunchFn fn = bf16_launch<HD>();
};

template <int HD>
struct Fp32 {
  static constexpr LaunchFn fn = simt::launch<HD>;
};

}  // namespace

// q (b, sq, heads, hd), k and v (b, skv, kv_heads, hd), o (b, sq, heads, hd),
// all contiguous of `dtype` and 16-byte aligned; window < 0 means none;
// scale multiplies q . k.  bf16 runs the tensor-core instance, fp32 the
// SIMT one.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int b, int sq, int skv, int heads, int kv_heads, int hd,
                                      int causal, int window, int q_offset, float scale,
                                      int dtype, void* stream_ptr) {
  LaunchFn fn = nullptr;
  if (dtype == repro::kBFloat16) fn = for_head_dim<Bf16>(hd);
  if (dtype == repro::kFloat32) fn = for_head_dim<Fp32>(hd);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, b, sq, skv, heads, kv_heads, causal, window, q_offset, scale,
            static_cast<cudaStream_t>(stream_ptr));
}
