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
// Design: the row walk K3 shares with K1 (row_walk.cuh), which picks
// its path by width.  At a head width of a multiple of 16 bytes (the
// paths' D = 128, H = 1 or 4) row groups of a warp or a half-warp, each
// owning two consecutive rows, take 16-byte loads of v rows, with each
// batch of senders and alpha loaded in one coalesced load and read back
// by shuffles, the next row's batch loaded ahead and four rows in
// flight; one head is a template case.  One head of at most 8 columns
// takes a thread per row (a warp per hub row); any other width a warp
// per row.  Every path: no atomics, the sum order is the slot order
// (products rounded, then summed, as in the plain version), launches are
// bitwise repeatable, and each output row is written once.  The TPU
// kernel's per-head one-hot matmuls and column mask (_kernel_headed,
// :564-577) have no counterpart here.
//
// Padding: a sender outside [0, n_rows) reads as zero (pack padding
// slots carry sender == n_rows, one past the last row of v).

#include "row_walk.cuh"

// Plain C entry points (bound with ctypes).  v is [n_rows, d] row-major
// with d = heads * dv, senders the pack's [num_chunks, chunk] array,
// alpha [num_chunks * chunk, heads] f32, row_range [n_rows, 2], out
// [n_rows, d] f32.  Returns cudaGetLastError() after the launch.
extern "C" int packed_attention_f32(const void* v, long long n_rows, int d,
                                    int heads, const void* senders,
                                    const void* alpha, const void* row_range,
                                    void* out, void* stream) {
  return ggt::launch_row_walk<float>(
      (const float*)v, n_rows, n_rows, d, heads, (const int*)senders,
      (const float*)alpha, (const int*)row_range, (float*)out,
      (cudaStream_t)stream);
}

extern "C" int packed_attention_bf16(const void* v, long long n_rows, int d,
                                     int heads, const void* senders,
                                     const void* alpha, const void* row_range,
                                     void* out, void* stream) {
  return ggt::launch_row_walk<__nv_bfloat16>(
      (const __nv_bfloat16*)v, n_rows, n_rows, d, heads, (const int*)senders,
      (const float*)alpha, (const int*)row_range, (float*)out,
      (cudaStream_t)stream);
}
