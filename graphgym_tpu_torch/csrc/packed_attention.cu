// Per-head weighted packed aggregation (attention) for Hopper (sm_90a).
//
// Replaces graphgym_tpu/ops/pallas/spmm_kernel.py:_kernel_headed (K3,
// through packed_segment_matmul_headed) and the v[senders] gather that
// packed_attention (graphgym_tpu/nn/layers.py:172) runs before it:
//
//   out[row, h*dv + k] = sum over the slots s of row:
//                        alpha[s, h] * v[senders[s], h*dv + k]
//
// over the slots of an 'att' PackedCSR layout, with the per-slot,
// per-head coefficients alpha (softmax'd attention, traced) in a
// slot-major [num_chunks * chunk, heads] f32 array.  As in
// packed_spmm.cu, a row's slots are contiguous and row_range[r] =
// [start, end) ends after its last slot of nonzero pack weight.  Reading
// only those is exact: alpha is 0 on every slot of pack weight 0, because
// the softmax masks by the same weights > 0.
//
// Bound: bytes.  Per slot the kernel reads 4 bytes of sender, 4*heads of
// alpha and one H*dv-wide row of v (mostly from L2: v is reread once per
// in-edge); each output row is written once.  Two flops per slot and
// column, far below the card's rate for that traffic.
//
// Design: packed_spmm.cu's.  One warp owns one output row and walks its
// slots in order; lane l accumulates columns l, l+32, l+64, l+96 of each
// 128-column pass in f32 registers, so every v-row read is four coalesced
// loads.  Column col belongs to head col / dv; for one head every lane
// reads the same alpha word (one broadcast load), for more heads the
// lanes read at most heads neighbouring words of one slot.  No atomics,
// the sum order is the slot order (products rounded, then summed, as in
// the plain version), launches are bitwise repeatable and each output
// row is written once.  The TPU kernel's per-head one-hot matmuls and
// column mask (_kernel_headed, :564-577) have no counterpart here.
//
// Padding: a sender outside [0, n_rows) reads as zero (pack padding
// slots carry sender == n_rows, one past the last row of v).

#include "common.cuh"

namespace {

using ggt::kPassCols;
using ggt::kPerLane;
using ggt::kWarps;
using ggt::to_float;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
packed_attention_kernel(const T* __restrict__ v, long long n_rows, int d,
                        int heads, const int* __restrict__ senders,
                        const float* __restrict__ alpha,
                        const int* __restrict__ row_range,
                        float* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int dv = d / heads;
  const int begin = row_range[2 * row];
  const int end = row_range[2 * row + 1];
  for (int c0 = 0; c0 < d; c0 += kPassCols) {
    float acc[kPerLane];
    int head[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int col = c0 + j * 32 + lane;
      acc[j] = 0.f;
      head[j] = col < d ? col / dv : 0;
    }
#pragma unroll 4
    for (int k = begin; k < end; ++k) {
      const long long s = senders[k];
      if (s < 0 || s >= n_rows) continue;  // the same for the whole warp
      const float* a = alpha + (long long)k * heads;
      const T* vs = v + s * d;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = c0 + j * 32 + lane;
        if (col < d) acc[j] += __fmul_rn(a[head[j]], to_float(vs[col]));
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
int launch(const T* v, long long n_rows, int d, int heads,
           const int* senders, const float* alpha, const int* row_range,
           float* out, void* stream) {
  const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
  packed_attention_kernel<T><<<blocks, 32 * kWarps, 0,
                               (cudaStream_t)stream>>>(
      v, n_rows, d, heads, senders, alpha, row_range, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  v is [n_rows, d] row-major
// with d = heads * dv, senders the pack's [num_chunks, chunk] array,
// alpha [num_chunks * chunk, heads] f32, row_range [n_rows, 2], out
// [n_rows, d] f32.  Returns cudaGetLastError() after the launch.
extern "C" int packed_attention_f32(const void* v, long long n_rows, int d,
                                    int heads, const void* senders,
                                    const void* alpha, const void* row_range,
                                    void* out, void* stream) {
  return launch<float>((const float*)v, n_rows, d, heads,
                       (const int*)senders, (const float*)alpha,
                       (const int*)row_range, (float*)out, stream);
}

extern "C" int packed_attention_bf16(const void* v, long long n_rows, int d,
                                     int heads, const void* senders,
                                     const void* alpha,
                                     const void* row_range, void* out,
                                     void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)v, n_rows, d, heads,
                               (const int*)senders, (const float*)alpha,
                               (const int*)row_range, (float*)out, stream);
}
