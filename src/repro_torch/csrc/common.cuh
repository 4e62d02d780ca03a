// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes fp32 or bf16 operands (each operand its own type) and
// accumulates in fp32, as the Pallas kernels they replace do; embedding ids
// are int32 or int64.  A dtype crosses the C interface as an int code that
// the Python wrappers set (kernels/checks.py DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt32 = 2;
constexpr int kInt64 = 3;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

}  // namespace repro
