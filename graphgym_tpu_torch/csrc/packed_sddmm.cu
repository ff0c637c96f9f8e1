// Per-head sampled dot products over a packed layout (SDDMM) for Hopper
// (sm_90a).
//
// Replaces the SDDMM half of graphgym_tpu/ops/pallas/spmm_kernel.py's
// _segmm_headed_bwd (:655-669, d_w = <g[row], msg>, XLA there) and the
// dot-product attention score of graphgym_tpu/nn/layers.py:152-156
// (score_fn on the gathered q[rows], k[senders], also XLA):
//
//   out[s, h] = sum over k < dv of a[row(s), h*dv + k] * b[senders[s], h*dv + k]
//                                               (pack weight[s] != 0)
//   out[s, h] = 0                               (pack weight[s] == 0)
//
// over every slot s of a PackedCSR layout, out [num_chunks * chunk,
// heads] f32.  Every slot of nonzero weight lies in its row's
// row_range; the kernel computes those ranges and writes 0 to every
// other slot itself (no memset pass): the owner of row r also writes
// the slots from the end of its range up to the first slot of row r+1
// (row 0's owner also those before its range), and the slots after the
// last row's range (the bucket-padding chunks, tens of thousands of
// slots) are shared out over every row group of the grid.  That needs
// the ranges in row order, which pack_csr builds.
//
// Bound: bytes.  a and b read once each (b's rows are reread once per
// in-edge, mostly from L2), 8 bytes of sender and weight per slot read,
// 4*heads bytes written per slot; two flops per slot and column.
//
// Design.  Each row has one owner group of LANES lanes (a warp, or a
// half-warp).  Vector path (the row at most one pass of LANES lanes of
// 16 bytes, each head's width a power-of-two number, at least 4, of
// lane vectors): a group owns kGroupRows consecutive rows, loads their
// slot ranges in one load, and loads the next row's slice of a and
// first batch of senders while it works on the current row.  Lane l
// holds columns [l*VW, (l+1)*VW) of a[row] in registers, read once; the
// group streams b[sender] rows with 16-byte loads, kInFlight rows in
// flight, the senders of a batch of LANES / heads slots loaded in one
// coalesced load and shared by __shfl_sync.  Each lane sums its VW
// products per slot in column order; the lanes of each head add the
// partial sums of four slots at once in a fixed tree of
// __shfl_xor_sync (reduce4: 6 shuffles for the four, where a butterfly
// per slot takes 20), one more shuffle hands each lane its slot's and
// head's result, and the batch's results go out in one coalesced store.
// Scalar path (any other shape): a warp per row, lanes strided over
// each head's columns, a butterfly over the warp, slot by slot.  No
// atomics; launches are bitwise repeatable.
//
// Padding: a sender outside [0, n_rows) reads as zero.

#include "common.cuh"

namespace {

using ggt::kGroupRows;
using ggt::kInFlight;
using ggt::kWarps;
using ggt::to_float;

// The slots after the last row's range (the last tile's padding and
// the bucket-padding chunks) belong to no range: every row group of the
// grid writes 0 to its share of them.
template <int LANES>
__device__ __forceinline__ void zero_tail(float* __restrict__ out,
                                          const int* __restrict__ row_range,
                                          long long n_rows, long long n_slots,
                                          int heads, int lane) {
  const long long groups = (long long)gridDim.x * (32 * kWarps / LANES);
  for (long long z = (long long)row_range[2 * n_rows - 1] * heads +
                     ggt::group_index<LANES>() * LANES + lane;
       z < n_slots * heads; z += groups * LANES)
    out[z] = 0.f;
}

// Zero the slots of no row_range between row `row`'s range [begin, end)
// and the next row's first slot `next` (for row 0 also those before its
// range); the last row's gap is the tail (zero_tail).
template <int LANES>
__device__ __forceinline__ void zero_gap(float* __restrict__ out,
                                         long long row, long long n_rows,
                                         int begin, int end, int next,
                                         int heads, int lane) {
  if (row + 1 < n_rows)
    for (long long z = (long long)end * heads + lane;
         z < (long long)next * heads; z += LANES)
      out[z] = 0.f;
  if (row == 0)
    for (long long z = lane; z < (long long)begin * heads; z += LANES)
      out[z] = 0.f;
}

// x[0..3] summed over each aligned group of `group` lanes (a power of
// two, at least 4) in a fixed tree: two transposing steps, each lane
// passing on the half of its sums that its partner keeps, then a
// butterfly.  Lane l ends with the group's sum of x[j], j = 2 * (bit
// group/2 of l) + (bit group/4 of l); lanes of one j hold equal bits.
template <int LANES>
__device__ __forceinline__ float reduce4(const float (&x)[4], int group,
                                         int lane, unsigned mask) {
  int off = group / 2;
  const bool hi = lane & off;
  const float y0 = (hi ? x[2] : x[0]) +
                   __shfl_xor_sync(mask, hi ? x[0] : x[2], off, LANES);
  const float y1 = (hi ? x[3] : x[1]) +
                   __shfl_xor_sync(mask, hi ? x[1] : x[3], off, LANES);
  off /= 2;
  const bool lo = lane & off;
  float z = (lo ? y1 : y0) + __shfl_xor_sync(mask, lo ? y0 : y1, off, LANES);
  for (off /= 2; off > 0; off /= 2) z += __shfl_xor_sync(mask, z, off, LANES);
  return z;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
packed_sddmm_scalar(const T* __restrict__ a, const T* __restrict__ b,
                    long long n_rows, int d, int heads,
                    const int* __restrict__ senders,
                    const float* __restrict__ weights,
                    const int* __restrict__ row_range, long long n_slots,
                    float* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row < n_rows) {
    const int dv = d / heads;
    const int begin = row_range[2 * row];
    const int end = row_range[2 * row + 1];
    const T* ar = a + row * d;
    for (int k = begin; k < end; ++k) {
      const long long s = senders[k];
      const bool live = s >= 0 && s < n_rows && weights[k] != 0.f;
      const T* bs = b + (live ? s : 0) * d;
      for (int h = 0; h < heads; ++h) {
        float p = 0.f;
        if (live)
          for (int c = h * dv + lane; c < (h + 1) * dv; c += 32)
            p += __fmul_rn(to_float(ar[c]), to_float(bs[c]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) out[(long long)k * heads + h] = live ? p : 0.f;
      }
    }
    zero_gap<32>(out, row, n_rows, begin, end,
                 row + 1 < n_rows ? row_range[2 * row + 2] : 0, heads, lane);
  }
  zero_tail<32>(out, row_range, n_rows, n_slots, heads, lane);
}

template <typename T, int LANES, bool ONE_HEAD>
__global__ void __launch_bounds__(32 * kWarps)
packed_sddmm_vec(const T* __restrict__ a, const T* __restrict__ b,
                 long long n_rows, int d, int heads_arg,
                 const int* __restrict__ senders,
                 const float* __restrict__ weights,
                 const int* __restrict__ row_range, long long n_slots,
                 float* __restrict__ out) {
  static_assert(kInFlight == 4, "reduce4 sums four slots at a time");
  constexpr int VW = ggt::Vec<T>::kN;
  const int heads = ONE_HEAD ? 1 : heads_arg;
  const int lane = threadIdx.x % LANES;
  const unsigned mask = ggt::group_mask<LANES>();
  const long long row0 = ggt::group_index<LANES>() * kGroupRows;
  int my_begin, my_end;
  ggt::load_ranges(row_range, n_rows, row0, lane, my_begin, my_end);
  const int col = lane * VW;  // the row is one pass of the group
  const bool has_col = col < d;
  const int group = d / heads / VW;  // lanes of one head, a power of two
  const int per_batch = LANES / heads;
  auto load_senders = [&](int k0, int e) {
    return lane < min(per_batch, e - k0) ? senders[k0 + lane] : -1;
  };
  auto load_a = [&](long long row) {
    return (row < n_rows && has_col) ? ggt::load16(a + row * d + col)
                                     : make_uint4(0u, 0u, 0u, 0u);
  };
  // the next row's a-row slice and first batch of senders, loaded ahead
  int next_s = load_senders(__shfl_sync(mask, my_begin, 0, LANES),
                            __shfl_sync(mask, my_end, 0, LANES));
  uint4 next_a = load_a(row0);
#pragma unroll 1  // one copy of the row body: registers, not spills
  for (int r = 0; r < kGroupRows; ++r) {
    const long long row = row0 + r;
    const int begin = __shfl_sync(mask, my_begin, r, LANES);
    const int end = __shfl_sync(mask, my_end, r, LANES);
    const int next = __shfl_sync(mask, my_begin, r + 1, LANES);
    const int first_s = next_s;
    float ar[VW];
    ggt::Vec<T>::unpack(next_a, ar);
    if (r + 1 < kGroupRows) {
      next_s = load_senders(next, __shfl_sync(mask, my_end, r + 1, LANES));
      next_a = load_a(row + 1);
    }
    for (int k0 = begin; k0 < end; k0 += per_batch) {
      const int nb = min(per_batch, end - k0);
      const int my_s = k0 == begin ? first_s : load_senders(k0, end);
      float mine = 0.f;  // lane l: slot k0 + l / heads, head l % heads
      for (int i = 0; i < nb; i += kInFlight) {
        int s[kInFlight];
        uint4 raw[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          s[j] = __shfl_sync(mask, my_s, i + j, LANES);
          if (i + j >= nb || s[j] < 0 || s[j] >= n_rows) s[j] = -1;
          raw[j] = (s[j] >= 0 && has_col)
                       ? ggt::load16(b + (long long)s[j] * d + col)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
        float p[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          p[j] = 0.f;
          if (s[j] < 0) continue;
          float x[VW];
          ggt::Vec<T>::unpack(raw[j], x);
#pragma unroll
          for (int t = 0; t < VW; ++t) p[j] += __fmul_rn(ar[t], x[t]);
        }
        const float q = reduce4<LANES>(p, group, lane, mask);
        // slot i + j's sum of head h sits in lane h * group + (j / 2) *
        // group / 2 + (j % 2) * group / 4; lane l takes its own
        const int j = lane / heads - i;
        const float got = __shfl_sync(
            mask, q,
            (lane % heads) * group + (j >> 1) * (group / 2) +
                (j & 1) * (group / 4),
            LANES);
        if (j >= 0 && j < kInFlight) mine = got;
      }
      if (lane < nb * heads) {
        const int k = k0 + lane / heads;
        out[(long long)k0 * heads + lane] = weights[k] != 0.f ? mine : 0.f;
      }
    }
    if (row < n_rows)
      zero_gap<LANES>(out, row, n_rows, begin, end, next, heads, lane);
  }
  zero_tail<LANES>(out, row_range, n_rows, n_slots, heads, lane);
}

// Lanes per row of the vector path for these arguments (the fewest, 16
// or 32, whose one pass spans the row), 0 for the scalar path.
template <typename T>
int vector_lanes(const T* a, const T* b, int d, int heads) {
  constexpr int VW = ggt::Vec<T>::kN;
  const int dv = d / heads;
  const int group = dv / VW;
  const bool vec = dv % VW == 0 && group >= 4 &&
                   (group & (group - 1)) == 0 && ggt::aligned16(a) &&
                   ggt::aligned16(b) && d <= 32 * VW;
  return vec ? (d <= 16 * VW ? 16 : 32) : 0;
}

template <typename T, int LANES>
void launch_vec(const T* a, const T* b, long long n_rows, int d, int heads,
                const int* senders, const float* weights,
                const int* row_range, long long n_slots, float* out,
                cudaStream_t stream) {
  constexpr long long kRows = 32 * kWarps / LANES * ggt::kGroupRows;
  const unsigned blocks = (unsigned)((n_rows + kRows - 1) / kRows);
  if (heads == 1) {
    packed_sddmm_vec<T, LANES, true><<<blocks, 32 * kWarps, 0, stream>>>(
        a, b, n_rows, d, heads, senders, weights, row_range, n_slots, out);
  } else {
    packed_sddmm_vec<T, LANES, false><<<blocks, 32 * kWarps, 0, stream>>>(
        a, b, n_rows, d, heads, senders, weights, row_range, n_slots, out);
  }
}

template <typename T>
int launch(const T* a, const T* b, long long n_rows, int d, int heads,
           const int* senders, const float* weights, const int* row_range,
           long long n_slots, float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int lanes = vector_lanes(a, b, d, heads);
  if (lanes == 16) {
    launch_vec<T, 16>(a, b, n_rows, d, heads, senders, weights, row_range,
                      n_slots, out, st);
  } else if (lanes == 32) {
    launch_vec<T, 32>(a, b, n_rows, d, heads, senders, weights, row_range,
                      n_slots, out, st);
  } else {
    const unsigned blocks = (unsigned)((n_rows + kWarps - 1) / kWarps);
    packed_sddmm_scalar<T><<<blocks, 32 * kWarps, 0, st>>>(
        a, b, n_rows, d, heads, senders, weights, row_range, n_slots, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  a and b are [n_rows, d]
// row-major with d = heads * dv, senders and weights the pack's
// [num_chunks, chunk] arrays (n_slots slots), row_range [n_rows, 2], out
// [n_slots, heads] f32.  Returns cudaGetLastError() after the launch.
extern "C" int packed_sddmm_f32(const void* a, const void* b,
                                long long n_rows, int d, int heads,
                                const void* senders, const void* weights,
                                const void* row_range, long long n_slots,
                                void* out, void* stream) {
  return launch<float>((const float*)a, (const float*)b, n_rows, d, heads,
                       (const int*)senders, (const float*)weights,
                       (const int*)row_range, n_slots, (float*)out, stream);
}

extern "C" int packed_sddmm_bf16(const void* a, const void* b,
                                 long long n_rows, int d, int heads,
                                 const void* senders, const void* weights,
                                 const void* row_range, long long n_slots,
                                 void* out, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)a,
                               (const __nv_bfloat16*)b, n_rows, d, heads,
                               (const int*)senders,
                               (const float*)weights, (const int*)row_range,
                               n_slots, (float*)out, stream);
}
