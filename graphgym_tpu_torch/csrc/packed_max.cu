// Packed segmented max, forward and backward, for Hopper (sm_90a).
//
// Stands in for XLA's segment_max in the JAX package's 'max' aggregation
// of GeneralConv and GeneralIDConv (graphgym_tpu/ops/sparse.py:25-57 ->
// graphgym_tpu/ops/segment.py:50-60): the JAX package has no Pallas
// kernel for it.  Over the slots of a PackedCSR layout (receiver-sorted
// edges in chunks, row_range[r] = the flat slots [start, end) of row r):
//
//   forward   out[r, c] = max over the slots k of row r with
//                         weights[k] != 0 of weights[k] * x[senders[k], c]
//             cnt[r, c] = how many of those slots reach it
//             (a row with no such slot: out 0, cnt 0)
//   backward  on the transpose pack, where row s's slots name the
//             receivers r of s's edges:
//             dx[s, c] = sum over the slots k of row s with
//                        weights[k] != 0, in slot order, of
//                        [w * x[s, c] == out[r, c]]
//                          * (g[r, c] * (1 / cnt[r, c])) * w
//
// The gradient splits a tie evenly between the slots that reach the
// max, per column, as jax.ops.segment_max's does.  The products w * x
// are rounded as in the forward (__fmul_rn on both sides), so the
// backward's equality test sees the forward's values.
//
// Zero is not neutral for a max: a slot of weight 0 (pack padding, a
// padding node's self-loop in the 'gcn' pack, trailing padded edges)
// and a sender outside [0, n_rows) are skipped explicitly, so such a row
// comes out 0 with no gradient, as the JAX -inf mask and isfinite -> 0
// give.
//
// Bound: bytes.  The forward reads 8 bytes of pack per slot and one row
// of x per slot (from L2 after its first read), writes out and cnt once;
// the backward reads the pack, x once, and out, cnt and g of each slot's
// receiver, and writes dx once.  One compare (forward) or three
// operations (backward) per slot and column, far below the card's rate.
//
// Design: one warp owns a row, as on row_walk.cuh's scalar walk; no
// atomics, each output row written once, the backward's sum in slot
// order, so launches are bitwise repeatable.  The warp loads 32 slots'
// senders and weights in one coalesced load and reads them back by
// shuffle.  Lane l owns 4 columns of each pass of 128: 4 consecutive
// ones (one 16-byte load of f32, 8 bytes of bf16) where the width is a
// multiple of 4 and the pointers aligned, else columns l, l+32, l+64,
// l+96.  Rows of more than 32 slots (ba's hubs, up to 49) take more
// batches of 32.

#include "common.cuh"

namespace ggt {
namespace {

constexpr int kCols = 4;   // columns a lane owns per pass

// The kCols columns lane owns in the pass from c0: consecutive (VEC)
// or strided by 32.
template <bool VEC>
__device__ __forceinline__ int col_of(int c0, int lane, int j) {
  return VEC ? c0 + lane * kCols + j : c0 + j * 32 + lane;
}

// Load the lane's columns of row p (d columns) as f32; 0 past d.
template <typename T, bool VEC>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, int d,
                                          int c0, int lane,
                                          float (&v)[kCols]) {
  if constexpr (VEC) {
    const int col = col_of<true>(c0, lane, 0);
    if (col >= d) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] = 0.f;
      return;
    }
    if constexpr (sizeof(T) == 4) {
      const uint4 r = load16(p + col);
      v[0] = __uint_as_float(r.x);
      v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z);
      v[3] = __uint_as_float(r.w);
    } else {   // bf16: 8 bytes, each value the high half of its f32
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p + col));
      v[0] = __uint_as_float(r.x << 16);
      v[1] = __uint_as_float(r.x & 0xffff0000u);
      v[2] = __uint_as_float(r.y << 16);
      v[3] = __uint_as_float(r.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = col_of<false>(c0, lane, j);
      v[j] = col < d ? to_float(p[col]) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ p, int d,
                                           int c0, int lane,
                                           const float (&v)[kCols]) {
  if constexpr (VEC) {
    const int col = col_of<true>(c0, lane, 0);
    if (col < d)
      *reinterpret_cast<float4*>(p + col) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = col_of<false>(c0, lane, j);
      if (col < d) p[col] = v[j];
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
packed_max_fwd(const T* __restrict__ x, long long n_rows, int d,
               const int* __restrict__ senders,
               const float* __restrict__ weights,
               const int* __restrict__ row_range, float* __restrict__ out,
               float* __restrict__ cnt) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // the whole warp
  const int begin = row_range[2 * row];
  const int end = row_range[2 * row + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * kCols) {
    float best[kCols], count[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) best[j] = count[j] = 0.f;
    for (int k0 = begin; k0 < end; k0 += 32) {
      const int nb = min(32, end - k0);
      const int my_s = lane < nb ? senders[k0 + lane] : -1;
      const float my_w = lane < nb ? weights[k0 + lane] : 0.f;
      for (int i = 0; i < nb; ++i) {
        const int s = __shfl_sync(kAll, my_s, i);
        const float w = __shfl_sync(kAll, my_w, i);
        if (w == 0.f || s < 0 || s >= n_rows) continue;  // whole warp
        float v[kCols];
        load_cols<T, VEC>(x + (long long)s * d, d, c0, lane, v);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float m = __fmul_rn(w, v[j]);
          if (count[j] == 0.f || m > best[j]) {
            best[j] = m;
            count[j] = 1.f;
          } else if (m == best[j]) {
            count[j] += 1.f;
          }
        }
      }
    }
    store_cols<VEC>(out + row * d, d, c0, lane, best);
    store_cols<VEC>(cnt + row * d, d, c0, lane, count);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
packed_max_bwd(const T* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ out, const float* __restrict__ cnt,
               long long n_rows, int d, const int* __restrict__ senders,
               const float* __restrict__ weights,
               const int* __restrict__ row_range, float* __restrict__ dx) {
  constexpr unsigned kAll = 0xffffffffu;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // the whole warp
  const int begin = row_range[2 * row];
  const int end = row_range[2 * row + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * kCols) {
    float xs[kCols], acc[kCols];
    load_cols<T, VEC>(x + row * d, d, c0, lane, xs);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
    for (int k0 = begin; k0 < end; k0 += 32) {
      const int nb = min(32, end - k0);
      const int my_r = lane < nb ? senders[k0 + lane] : -1;
      const float my_w = lane < nb ? weights[k0 + lane] : 0.f;
      for (int i = 0; i < nb; ++i) {
        const int r = __shfl_sync(kAll, my_r, i);
        const float w = __shfl_sync(kAll, my_w, i);
        if (w == 0.f || r < 0 || r >= n_rows) continue;  // whole warp
        float o[kCols], c[kCols], gr[kCols];
        load_cols<float, VEC>(out + (long long)r * d, d, c0, lane, o);
        load_cols<float, VEC>(cnt + (long long)r * d, d, c0, lane, c);
        load_cols<float, VEC>(g + (long long)r * d, d, c0, lane, gr);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (__fmul_rn(w, xs[j]) == o[j] && c[j] > 0.f)
            acc[j] = __fadd_rn(
                acc[j], __fmul_rn(__fmul_rn(gr[j], __frcp_rn(c[j])), w));
        }
      }
    }
    store_cols<VEC>(dx + row * d, d, c0, lane, acc);
  }
}

// Consecutive columns where the width is a multiple of kCols and every
// array is aligned for its vector load; strided columns otherwise.
template <typename T>
bool vec_ok(int d, const T* x, const void* a, const void* b, const void* c,
            const void* e) {
  const unsigned long long xa = reinterpret_cast<unsigned long long>(x);
  return d % kCols == 0 && xa % (kCols * sizeof(T)) == 0 && aligned16(a) &&
         aligned16(b) && aligned16(c) && aligned16(e);
}

inline unsigned row_blocks(long long n_rows) {
  return (unsigned)((n_rows + kWarps - 1) / kWarps);
}

// An empty kernel: launched over the max's grid, its time is the floor
// under the max's (forward and backward take the same grid).
__global__ void empty_rows() {}

template <typename T>
int launch_fwd(const T* x, long long n_rows, int d, const int* senders,
               const float* weights, const int* row_range, float* out,
               float* cnt, cudaStream_t st) {
  const unsigned blocks = row_blocks(n_rows);
  if (vec_ok(d, x, out, cnt, out, cnt)) {
    packed_max_fwd<T, true><<<blocks, 32 * kWarps, 0, st>>>(
        x, n_rows, d, senders, weights, row_range, out, cnt);
  } else {
    packed_max_fwd<T, false><<<blocks, 32 * kWarps, 0, st>>>(
        x, n_rows, d, senders, weights, row_range, out, cnt);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* x, const float* g, const float* out,
               const float* cnt, long long n_rows, int d,
               const int* senders, const float* weights,
               const int* row_range, float* dx, cudaStream_t st) {
  const unsigned blocks = row_blocks(n_rows);
  if (vec_ok(d, x, g, out, cnt, dx)) {
    packed_max_bwd<T, true><<<blocks, 32 * kWarps, 0, st>>>(
        x, g, out, cnt, n_rows, d, senders, weights, row_range, dx);
  } else {
    packed_max_bwd<T, false><<<blocks, 32 * kWarps, 0, st>>>(
        x, g, out, cnt, n_rows, d, senders, weights, row_range, dx);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggt

// Plain C entry points (bound with ctypes).  x is [n_rows, d] row-major
// (f32 or bf16); senders / weights are a pack's [num_chunks, chunk]
// arrays and row_range its [n_rows, 2]; out, cnt, g and dx are
// [n_rows, d] f32.  The backward takes the transpose pack.  Each returns
// cudaGetLastError() after the launch.
extern "C" int packed_max_f32(const void* x, long long n_rows, int d,
                              const void* senders, const void* weights,
                              const void* row_range, void* out, void* cnt,
                              void* stream) {
  return ggt::launch_fwd<float>((const float*)x, n_rows, d,
                                (const int*)senders, (const float*)weights,
                                (const int*)row_range, (float*)out,
                                (float*)cnt, (cudaStream_t)stream);
}

extern "C" int packed_max_bf16(const void* x, long long n_rows, int d,
                               const void* senders, const void* weights,
                               const void* row_range, void* out, void* cnt,
                               void* stream) {
  return ggt::launch_fwd<__nv_bfloat16>(
      (const __nv_bfloat16*)x, n_rows, d, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)out,
      (float*)cnt, (cudaStream_t)stream);
}

extern "C" int packed_max_bwd_f32(const void* x, const void* g,
                                  const void* out, const void* cnt,
                                  long long n_rows, int d,
                                  const void* senders, const void* weights,
                                  const void* row_range, void* dx,
                                  void* stream) {
  return ggt::launch_bwd<float>(
      (const float*)x, (const float*)g, (const float*)out,
      (const float*)cnt, n_rows, d, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)dx,
      (cudaStream_t)stream);
}

extern "C" int packed_max_bwd_bf16(const void* x, const void* g,
                                   const void* out, const void* cnt,
                                   long long n_rows, int d,
                                   const void* senders, const void* weights,
                                   const void* row_range, void* dx,
                                   void* stream) {
  return ggt::launch_bwd<__nv_bfloat16>(
      (const __nv_bfloat16*)x, (const float*)g, (const float*)out,
      (const float*)cnt, n_rows, d, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)dx,
      (cudaStream_t)stream);
}

// The launch floor under packed_max_* / packed_max_bwd_*, for
// measurement: an empty kernel over the grid they take for n_rows rows.
extern "C" int packed_max_floor(long long n_rows, void* stream) {
  ggt::empty_rows<<<ggt::row_blocks(n_rows), 32 * ggt::kWarps, 0,
                    (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
