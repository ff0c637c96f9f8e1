// Weighted packed segmented SpMM (K1) for Hopper (sm_90a).
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
// cores to take.  At D = 1 the bytes of the ws train pack take less
// time than any launch: there the launch itself is the floor.
//
// Design: K1 is the one-head case of the row walk it shares with K3
// (row_walk.cuh), with alpha = the pack's weights, whose [num_chunks,
// chunk] f32 array is the same memory as a slot-major [num_chunks *
// chunk, 1].  The walk is picked by width: a thread per row, and a warp
// for a hub row, at D <= 8 (ID-GIN's and ID-SAGE's 1-wide layer 0); row
// groups with 16-byte loads and batched, shuffled senders and weights
// at a width of a multiple of 16 bytes (D = 128); a warp per row at any
// other width.  Every walk sums a row's products (rounded, then summed,
// as in the plain version) in slot order with no atomics, so launches
// are bitwise repeatable (the determinism contract of
// tests/test_determinism.py:54-67), and writes each output row once.
//
// Padding: a sender outside [0, x_rows) reads as zero (pack padding
// slots carry sender == x_rows, one past the last row of x).
//
// Rectangular packs: out has n_rows rows and x has x_rows, which differ
// on a graph-pooling pack (rows the graph slots, senders the nodes or
// ego centers: out [graphs, D] from x [nodes, D]) and on its transpose
// (the pooling's backward).  A square pack, every layer's, passes one
// count twice.  The grid covers the out rows only, so a pool of 93 graph
// slots launches for 93 rows, whatever x holds.

#include "row_walk.cuh"

// Plain C entry points (bound with ctypes).  x is [x_rows, d] row-major,
// senders / weights are the pack's [num_chunks, chunk] arrays, row_range
// is [n_rows, 2], out is [n_rows, d] f32.  Returns cudaGetLastError()
// after the launch.
extern "C" int packed_spmm_f32(const void* x, long long x_rows, int d,
                               const void* senders, const void* weights,
                               const void* row_range, long long n_rows,
                               void* out, void* stream) {
  return ggt::launch_row_walk<float>(
      (const float*)x, x_rows, n_rows, d, 1, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)out,
      (cudaStream_t)stream);
}

extern "C" int packed_spmm_bf16(const void* x, long long x_rows, int d,
                                const void* senders, const void* weights,
                                const void* row_range, long long n_rows,
                                void* out, void* stream) {
  return ggt::launch_row_walk<__nv_bfloat16>(
      (const __nv_bfloat16*)x, x_rows, n_rows, d, 1, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)out,
      (cudaStream_t)stream);
}

// The launch floor under packed_spmm_f32 / _bf16, for measurement: the
// same arguments, an empty kernel over the grid that call would take.
extern "C" int packed_spmm_floor_f32(const void* x, long long, int d,
                                     const void*, const void*, const void*,
                                     long long n_rows, void* out,
                                     void* stream) {
  return ggt::launch_floor<float>((const float*)x, n_rows, d, 1,
                                  (const float*)out, (cudaStream_t)stream);
}

extern "C" int packed_spmm_floor_bf16(const void* x, long long, int d,
                                      const void*, const void*, const void*,
                                      long long n_rows, void* out,
                                      void* stream) {
  return ggt::launch_floor<__nv_bfloat16>((const __nv_bfloat16*)x, n_rows,
                                          d, 1, (const float*)out,
                                          (cudaStream_t)stream);
}
