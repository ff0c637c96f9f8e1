// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggt {

constexpr int kWarps = 8;              // output rows per block
constexpr int kPerLane = 4;            // columns per lane per pass
constexpr int kPassCols = 32 * kPerLane;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

}  // namespace ggt
