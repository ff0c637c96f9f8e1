// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggt {

constexpr int kWarps = 8;              // warps per block
constexpr int kPerLane = 4;            // columns per lane per pass
constexpr int kPassCols = 32 * kPerLane;
constexpr int kInFlight = 4;           // gathered rows a row group keeps
                                       // in flight in the vector kernels
constexpr int kGroupRows = 2;          // consecutive rows a row group owns
                                       // in the vector kernels
constexpr int kNarrowCols = 8;         // widest row of the thread-a-row
                                       // paths (K1, K2, K3)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A slot weight (K1's pack weight, K3's alpha) as the TPU kernels take
// it against a message of T: f32 for f32, rounded to bf16 for bf16
// (_kernel_weighted and _kernel_headed cast the weighted one-hot to the
// message's dtype before the product, spmm_kernel.py:362-364, 567-568).
// The product of two bf16 values is exact in f32.
template <typename T>
__device__ __forceinline__ float as_weight(float a) {
  return a;
}
template <>
__device__ __forceinline__ float as_weight<__nv_bfloat16>(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// Sixteen bytes of T, the unit of a vector load: Vec<T>::kN values,
// unpacked to f32.  A bf16 value is the high half of its f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r,
                                                float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& r,
                                                float (&x)[8]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The lanes of the calling thread's group of LANES (16 or 32) lanes.
template <int LANES>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (LANES == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << LANES) - 1u) << (threadIdx.x % 32 / LANES * LANES);
  }
}

// The index of the calling thread's group of LANES lanes in the grid.
template <int LANES>
__device__ __forceinline__ long long group_index() {
  return (long long)blockIdx.x * (32 * kWarps / LANES) + threadIdx.x / LANES;
}

// Lane r <= kGroupRows of a row group: the slot range [begin, end) of
// row row0 + r ([0, 0) past the last row), one load for the group.
__device__ __forceinline__ void load_ranges(const int* __restrict__ row_range,
                                            long long n_rows, long long row0,
                                            int lane, int& begin, int& end) {
  begin = end = 0;
  if (lane <= kGroupRows && row0 + lane < n_rows) {
    begin = row_range[2 * (row0 + lane)];
    end = row_range[2 * (row0 + lane) + 1];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace ggt
