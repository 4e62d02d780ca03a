// Weighted bank sum of book-keeping clipping:
//
//     out[f] = sum_n c[n] * psg[n, f]      psg (N, F), c (N,) -> (F,) fp32
//
// Replaces src/repro/kernels/psg_contract/psg_contract.py::psg_contract_pallas.
//
// What bounds it on the H100: bytes.  Each psg value is read once and used
// in one multiply-add (2 flops per 4 bytes in fp32), so the kernel can at
// best stream the bank at 3.35 TB/s.
//
// Design: CUDA rather than Triton only so that the three kernels share one
// nvcc build and one library.  Each thread owns one column f and loops over
// the samples n in order, so a warp reads 32 neighbouring floats of a row
// (coalesced column strips) and the sum over n never leaves the thread: no
// cross-block reduction, and the order of the sum is fixed (deterministic).
// The loop is unrolled by four so four independent row loads are in flight.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    psg_contract_kernel(const T* __restrict__ psg, const float* __restrict__ c,
                        float* __restrict__ out, int n, int64_t f) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= f) return;
  const T* x = psg + col;
  float acc = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    const float x0 = repro::to_float(x[static_cast<int64_t>(i) * f]);
    const float x1 = repro::to_float(x[static_cast<int64_t>(i + 1) * f]);
    const float x2 = repro::to_float(x[static_cast<int64_t>(i + 2) * f]);
    const float x3 = repro::to_float(x[static_cast<int64_t>(i + 3) * f]);
    acc = fmaf(c[i], x0, acc);
    acc = fmaf(c[i + 1], x1, acc);
    acc = fmaf(c[i + 2], x2, acc);
    acc = fmaf(c[i + 3], x3, acc);
  }
  for (; i < n; ++i) acc = fmaf(c[i], repro::to_float(x[static_cast<int64_t>(i) * f]), acc);
  out[col] = acc;
}

}  // namespace

// psg (n, f) contiguous of `dtype`; c (n,) fp32; out (f,) fp32.
extern "C" int psg_contract_launch(const void* psg, const void* c, void* out, int n, int64_t f,
                                   int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned blocks = static_cast<unsigned>((f + kThreads - 1) / kThreads);
  const float* cf = static_cast<const float*>(c);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32) {
    psg_contract_kernel<float><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(psg),
                                                               cf, o, n, f);
  } else if (dtype == repro::kBFloat16) {
    psg_contract_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(psg), cf, o, n, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
