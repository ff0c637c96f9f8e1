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
// Design.  Each output row has one owner group of LANES lanes (a warp,
// or a half-warp), which walks its slots in order and accumulates in
// f32 registers.  Vector path (each head's width a multiple of 16 bytes
// of v): a group owns kGroupRows consecutive rows, loads their slot
// ranges in one load, and loads the next row's first batch of senders
// and alpha while it gathers the current row's v rows, so a row costs
// about one dependent trip to memory.  Lane l owns 16 consecutive bytes
// of each pass of LANES * 16 bytes (4 f32 or 8 bf16 columns), so one
// load instruction of the group covers a whole pass of a v row.  The
// slots are taken in batches: lane l loads the sender of slot k0 + l
// and the l-th alpha word of the batch (LANES / heads slots, heads
// words each), one coalesced load each, and the group reads them back
// with __shfl_sync, so the walk has no dependent scalar load.
// kInFlight v rows are loaded before the products of the first of them.
// One head is a template case: its alpha is one word per slot and its
// batch is LANES slots.  Scalar path (any other width): a warp per row;
// lane l accumulates columns l, l+32, l+64, l+96 of each 128-column
// pass and reads alpha and senders slot by slot.
//
// Both paths: no atomics, the sum order is the slot order (products
// rounded, then summed, as in the plain version), launches are bitwise
// repeatable, and each output row is written once.  The TPU kernel's
// per-head one-hot matmuls and column mask (_kernel_headed, :564-577)
// have no counterpart here.
//
// Padding: a sender outside [0, n_rows) reads as zero (pack padding
// slots carry sender == n_rows, one past the last row of v).

#include "common.cuh"

namespace {

using ggt::kGroupRows;
using ggt::kInFlight;
using ggt::kPassCols;
using ggt::kPerLane;
using ggt::kWarps;
using ggt::to_float;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
packed_attention_scalar(const T* __restrict__ v, long long n_rows, int d,
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

template <typename T, int LANES, bool ONE_HEAD>
__global__ void __launch_bounds__(32 * kWarps)
packed_attention_vec(const T* __restrict__ v, long long n_rows, int d,
                     int heads_arg, const int* __restrict__ senders,
                     const float* __restrict__ alpha,
                     const int* __restrict__ row_range,
                     float* __restrict__ out) {
  constexpr int VW = ggt::Vec<T>::kN;
  const int heads = ONE_HEAD ? 1 : heads_arg;
  const int lane = threadIdx.x % LANES;
  const unsigned mask = ggt::group_mask<LANES>();
  const long long row0 = ggt::group_index<LANES>() * kGroupRows;
  int my_begin, my_end;
  ggt::load_ranges(row_range, n_rows, row0, lane, my_begin, my_end);
  const int dv = d / heads;
  const int per_batch = LANES / heads;  // slots whose alpha one load holds
  // lane l: the sender of slot b + l and the l-th alpha word of a batch
  // of slots from b on (a row past the last one has no slot)
  auto load_batch = [&](int b, int e, int& s, float& a) {
    const int nb = min(per_batch, e - b);
    s = lane < nb ? senders[b + lane] : -1;
    a = lane < nb * heads ? alpha[(long long)b * heads + lane] : 0.f;
  };
  int next_s;
  float next_a;
  load_batch(__shfl_sync(mask, my_begin, 0, LANES),
             __shfl_sync(mask, my_end, 0, LANES), next_s, next_a);
#pragma unroll 1  // one copy of the row body: registers, not spills
  for (int r = 0; r < kGroupRows; ++r) {
    const long long row = row0 + r;
    const int begin = __shfl_sync(mask, my_begin, r, LANES);
    const int end = __shfl_sync(mask, my_end, r, LANES);
    const int first_s = next_s;
    const float first_a = next_a;
    if (r + 1 < kGroupRows)  // the next row's first batch, loaded ahead
      load_batch(__shfl_sync(mask, my_begin, r + 1, LANES),
                 __shfl_sync(mask, my_end, r + 1, LANES), next_s, next_a);
    for (int c0 = 0; c0 < d; c0 += LANES * VW) {
      const int col = c0 + lane * VW;
      const bool has_col = col < d;
      const int head = (ONE_HEAD || !has_col) ? 0 : col / dv;
      float acc[VW];
#pragma unroll
      for (int t = 0; t < VW; ++t) acc[t] = 0.f;
      for (int k0 = begin; k0 < end; k0 += per_batch) {
        const int nb = min(per_batch, end - k0);
        int my_s = first_s;
        float my_a = first_a;
        if (k0 != begin) load_batch(k0, end, my_s, my_a);
        for (int i = 0; i < nb; i += kInFlight) {
          int s[kInFlight];
          float a[kInFlight];
          uint4 raw[kInFlight];
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            s[j] = __shfl_sync(mask, my_s, i + j, LANES);
            a[j] = __shfl_sync(mask, my_a, (i + j) * heads + head, LANES);
            if (i + j >= nb || s[j] < 0 || s[j] >= n_rows) s[j] = -1;
            raw[j] = (s[j] >= 0 && has_col)
                         ? ggt::load16(v + (long long)s[j] * d + col)
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            if (s[j] < 0) continue;  // the same for the whole group
            float x[VW];
            ggt::Vec<T>::unpack(raw[j], x);
#pragma unroll
            for (int t = 0; t < VW; ++t) acc[t] += __fmul_rn(a[j], x[t]);
          }
        }
      }
      if (row < n_rows && has_col) {
        float4* o = reinterpret_cast<float4*>(out + row * d + col);
#pragma unroll
        for (int t = 0; t < VW / 4; ++t)
          o[t] = make_float4(acc[4 * t], acc[4 * t + 1], acc[4 * t + 2],
                             acc[4 * t + 3]);
      }
    }
  }
}

// Lanes per row of the vector path for these arguments (a half-warp
// when one pass of it spans the row), 0 for the scalar path.
template <typename T>
int vector_lanes(const T* v, int d, int heads, const float* out) {
  constexpr int VW = ggt::Vec<T>::kN;
  const int lanes = d <= 16 * VW ? 16 : 32;
  const bool vec = (d / heads) % VW == 0 && heads <= lanes &&
                   ggt::aligned16(v) && ggt::aligned16(out);
  return vec ? lanes : 0;
}

template <typename T, int LANES>
void launch_vec(const T* v, long long n_rows, int d, int heads,
                const int* senders, const float* alpha, const int* row_range,
                float* out, cudaStream_t stream) {
  constexpr long long kRows = 32 * kWarps / LANES * ggt::kGroupRows;
  const unsigned blocks = (unsigned)((n_rows + kRows - 1) / kRows);
  if (heads == 1) {
    packed_attention_vec<T, LANES, true><<<blocks, 32 * kWarps, 0, stream>>>(
        v, n_rows, d, heads, senders, alpha, row_range, out);
  } else {
    packed_attention_vec<T, LANES, false>
        <<<blocks, 32 * kWarps, 0, stream>>>(v, n_rows, d, heads, senders,
                                             alpha, row_range, out);
  }
}

template <typename T>
int launch(const T* v, long long n_rows, int d, int heads,
           const int* senders, const float* alpha, const int* row_range,
           float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int lanes = vector_lanes(v, d, heads, out);
  if (lanes == 16) {
    launch_vec<T, 16>(v, n_rows, d, heads, senders, alpha, row_range, out,
                      st);
  } else if (lanes == 32) {
    launch_vec<T, 32>(v, n_rows, d, heads, senders, alpha, row_range, out,
                      st);
  } else {
    const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
    packed_attention_scalar<T><<<blocks, 32 * kWarps, 0, st>>>(
        v, n_rows, d, heads, senders, alpha, row_range, out);
  }
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
                                     const void* alpha, const void* row_range,
                                     void* out, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)v, n_rows, d, heads,
                               (const int*)senders,
                               (const float*)alpha, (const int*)row_range,
                               (float*)out, stream);
}
