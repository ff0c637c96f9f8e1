// Unweighted packed segmented sum for Hopper (sm_90a).
//
// Replaces graphgym_tpu/ops/pallas/spmm_kernel.py:_kernel (K2, through
// packed_segment_matmul with weights=None, and its group pre-sum
// _group_reduce):
//
//   out[tiles[i]*R + local_rows[i,c], :] += msg[i,c,:]
//
// over EVERY slot of a PackedCSR layout.  Unlike K1 and K3 the messages
// are an input, already gathered and weighted, so padding slots may hold
// anything and count: as on the TPU, each adds its message to local row 0
// of its chunk's tile (or, for a pack built with group G > 1, to the row
// whose group it pads).  Nothing may be skipped, so K1's row_range (which
// stops at a row's last nonzero-weight edge) is no use here.
//
// Bound: bytes.  Every slot's message row is read once (NC*C*D elements),
// and each output row is written once; one add per element.  At the
// ID-GIN / ws train 'plain' pack (448 x 1024 slots, D = 128, f32) that is
// 234.9 MB of msg + 1.8 MB of pack ints + 25.2 MB of output, about 78 us
// at 3.35 TB/s.
//
// Design.  The slot order is cut, on the host and once per pack
// (SegmentRuns in ops/cuda/spmm_kernel.py), into runs: at most RUN_SLOTS
// consecutive slots of one output row within one chunk.  A row's slots
// are contiguous within a tile by construction, except that the tile's
// padding slots come after its other rows; long rows (the last tile's
// row 0 collects every bucket-padding chunk: 41,286 slots at the train
// pack) are cut into many runs, so no warp walks more than RUN_SLOTS
// message rows.
//   Pass 1: one warp per run sums its slots in slot order in f32
//   registers (lane l owns columns l, l+32, l+64, l+96 of each 128-column
//   pass, so each message row is four coalesced loads).  The run of a row
//   that has only one writes the output row itself; the others write a
//   partial row.
//   Pass 2: one block per output row that has no run or several.  Warp w
//   sums that row's partials w, w+8, ... in order; warp 0 then adds the
//   eight warp sums in order and writes the row (zero for a row with no
//   run).
// Every output row is written once, by one owner, in a fixed order: no
// atomics, and two launches are bitwise equal (the determinism contract
// of tests/test_determinism.py:54-67).  f32 and bf16 messages; the sum is
// f32 throughout (the TPU kernel rounds bf16 group sums to bf16 before
// its matmul; this kernel does not).

#include "common.cuh"

namespace {

using ggt::kPassCols;
using ggt::kPerLane;
using ggt::kWarps;
using ggt::to_float;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
segment_runs_kernel(const T* __restrict__ msg, int d, long long n_runs,
                    const int* __restrict__ run_start,
                    const int* __restrict__ run_out,
                    float* __restrict__ partial, float* __restrict__ out) {
  const long long run = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (run >= n_runs) return;
  const long long begin = run_start[run];
  const long long end = run_start[run + 1];
  const int dst = run_out[run];
  float* o = dst >= 0 ? out + (long long)dst * d
                      : partial + (long long)(-1 - dst) * d;
  for (int c0 = 0; c0 < d; c0 += kPassCols) {
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (long long k = begin; k < end; ++k) {
      const T* m = msg + k * d;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = c0 + j * 32 + lane;
        if (col < d) acc[j] += to_float(m[col]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int col = c0 + j * 32 + lane;
      if (col < d) o[col] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
segment_combine_kernel(int d, const int* __restrict__ comb_rows,
                       const int* __restrict__ comb_ptr,
                       const float* __restrict__ partial,
                       float* __restrict__ out) {
  __shared__ float sums[kWarps][kPassCols];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int begin = comb_ptr[blockIdx.x];
  const int end = comb_ptr[blockIdx.x + 1];
  float* o = out + (long long)comb_rows[blockIdx.x] * d;
  for (int c0 = 0; c0 < d; c0 += kPassCols) {
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
    for (int p = begin + warp; p < end; p += kWarps) {
      const float* src = partial + (long long)p * d;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = c0 + j * 32 + lane;
        if (col < d) acc[j] += src[col];
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) sums[warp][j * 32 + lane] = acc[j];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = c0 + j * 32 + lane;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sums[w][j * 32 + lane];
        if (col < d) o[col] = s;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* msg, int d, long long n_runs, const int* run_start,
           const int* run_out, long long n_comb, const int* comb_rows,
           const int* comb_ptr, float* partial, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_runs > 0) {
    const unsigned blocks = (unsigned)((n_runs + kWarps - 1) / kWarps);
    segment_runs_kernel<T><<<blocks, 32 * kWarps, 0, s>>>(
        msg, d, n_runs, run_start, run_out, partial, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_comb > 0) {
    segment_combine_kernel<<<(unsigned)n_comb, 32 * kWarps, 0, s>>>(
        d, comb_rows, comb_ptr, partial, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  msg is the [num_chunks *
// chunk, d] message array, run_start / run_out / comb_rows / comb_ptr the
// pack's SegmentRuns, partial [num_partials, d] f32 scratch, out
// [num_tiles * 128, d] f32.  Launches pass 1, then pass 2 on the same
// stream; returns cudaGetLastError() after the launches.
extern "C" int packed_segment_f32(const void* msg, int d, long long n_runs,
                                  const void* run_start, const void* run_out,
                                  long long n_comb, const void* comb_rows,
                                  const void* comb_ptr, void* partial,
                                  void* out, void* stream) {
  return launch<float>((const float*)msg, d, n_runs, (const int*)run_start,
                       (const int*)run_out, n_comb, (const int*)comb_rows,
                       (const int*)comb_ptr, (float*)partial, (float*)out,
                       stream);
}

extern "C" int packed_segment_bf16(const void* msg, int d, long long n_runs,
                                   const void* run_start,
                                   const void* run_out, long long n_comb,
                                   const void* comb_rows,
                                   const void* comb_ptr, void* partial,
                                   void* out, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)msg, d, n_runs,
                               (const int*)run_start, (const int*)run_out,
                               n_comb, (const int*)comb_rows,
                               (const int*)comb_ptr, (float*)partial,
                               (float*)out, stream);
}
