// Weighted packed segmented SpMM for Hopper (sm_90a).
//
// Replaces graphgym_tpu/ops/pallas/spmm_kernel.py:_kernel_weighted (and
// the x[senders] gather that spmm_packed runs before it):
//
//   out[t*R + local_rows[i,c], :] += weights[i,c] * x[senders[i,c], :]
//
// over the slots of a PackedCSR layout: receiver-sorted edges cut into
// chunks of C slots, each chunk owned by one R-row output tile.  Within
// a tile the slots of one receiver row are contiguous, so the pack also
// carries row_range[r] = [start, end): the flat slots of row r, ending
// after its last edge of nonzero weight.  Slots outside every range are
// padding slots, bucket-padding chunks or trailing zero-weight edges
// (the padding node's padded edges): each adds 0 to a finite sum, and
// the kernel never reads them.
//
// Bound: bytes.  Per edge the kernel reads 8 bytes of pack and one
// D-wide row of x (mostly from L2: x is reread once per in-edge); each
// output row is written once.  There is no product for the tensor
// cores to take.
//
// Design: one warp owns one output row.  It walks the row's slots in
// order; lane l accumulates columns l, l+32, l+64, l+96 of each pass of
// 128 columns in registers, so every x-row read is four coalesced 128-byte
// loads and the rows of a block's eight warps are independent.  No two
// warps touch one output row: there are no atomics, the sum order is
// the slot order (products rounded, then summed, as in the plain
// version), launches are bitwise repeatable (the determinism contract of
// tests/test_determinism.py:54-67), and each output row is written once.
//
// Padding: a sender outside [0, n_rows) reads as zero (pack padding
// slots carry sender == n_rows, one past the last row of x).

#include "common.cuh"

namespace {

using ggt::kPassCols;
using ggt::kPerLane;
using ggt::kWarps;
using ggt::to_float;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
packed_spmm_kernel(const T* __restrict__ x, long long n_rows, int d,
                   const int* __restrict__ senders,
                   const float* __restrict__ weights,
                   const int* __restrict__ row_range,
                   float* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int begin = row_range[2 * row];
  const int end = row_range[2 * row + 1];
  for (int c0 = 0; c0 < d; c0 += kPassCols) {
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = begin; k < end; ++k) {
      const long long s = senders[k];
      const float w = weights[k];
      if (s < 0 || s >= n_rows) continue;  // the same for the whole warp
      const T* xs = x + s * d;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = c0 + j * 32 + lane;
        if (col < d) acc[j] += __fmul_rn(w, to_float(xs[col]));
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int col = c0 + j * 32 + lane;
      if (col < d) out[row * d + col] = acc[j];
    }
  }
}

template <typename T>
int launch(const T* x, long long n_rows, int d, const int* senders,
           const float* weights, const int* row_range, float* out,
           void* stream) {
  const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
  packed_spmm_kernel<T><<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      x, n_rows, d, senders, weights, row_range, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  x is [n_rows, d] row-major,
// senders / weights are the pack's [num_chunks, chunk] arrays, row_range
// is [n_rows, 2], out is [n_rows, d] f32.  Returns cudaGetLastError()
// after the launch.
extern "C" int packed_spmm_f32(const void* x, long long n_rows, int d,
                               const void* senders, const void* weights,
                               const void* row_range, void* out,
                               void* stream) {
  return launch<float>((const float*)x, n_rows, d, (const int*)senders,
                       (const float*)weights, (const int*)row_range,
                       (float*)out, stream);
}

extern "C" int packed_spmm_bf16(const void* x, long long n_rows, int d,
                                const void* senders, const void* weights,
                                const void* row_range, void* out,
                                void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)x, n_rows, d,
                               (const int*)senders, (const float*)weights,
                               (const int*)row_range, (float*)out, stream);
}
