// The row walk shared by K1 (packed_spmm.cu) and K3 (packed_attention.cu):
//
//   out[row, h*dv + k] = sum over the slots s of row, in slot order:
//                        alpha[s, h] * v[senders[s], h*dv + k]
//
// over the slots of a PackedCSR layout, with the per-slot, per-head
// coefficients alpha in a slot-major [num_chunks * chunk, heads] f32
// array, each rounded to bf16 against a bf16 v (as_weight).  K1 is the
// one-head case with alpha = the pack's weights (whose [num_chunks,
// chunk] array is the same memory as [num_chunks * chunk, 1]); K3 passes
// its attention coefficients.  A row's slots are
// contiguous and row_range[r] = [start, end) ends after its last slot of
// nonzero pack weight, so the walk never reads padding slots,
// bucket-padding chunks or trailing zero-weight edges (each would add 0).
//
// Bound: bytes.  Per slot a walk reads 4 bytes of sender, 4*heads of
// alpha and one H*dv-wide row of v (mostly from L2: v is reread once per
// in-edge); each output row is written once.  Two flops per slot and
// column, far below the card's rate for that traffic.
//
// Every path: no atomics, the sum order is the slot order (products
// rounded, then summed, as in the plain versions), launches are bitwise
// repeatable, and each output row is written once.  v has n_src rows
// and out n_rows: the same count on a square pack (a layer's A), two on
// a rectangular one (graph pooling: graph slots from node rows, and its
// transpose).  A sender outside [0, n_src) reads as zero: it adds
// nothing (pack padding slots carry sender == n_src, one past the last
// row of v).
//
// Three paths, picked by width (pick_walk):
//
// Narrow (one head, at most kNarrowCols columns: ID-GIN's and ID-SAGE's
// 1-wide layer 0, every other width below a 16-byte vector, and the
// 4- and 8-wide rows on which a vector group would keep one or two lanes
// of 16 busy).  A lane of a warp per row would leave 31 of 32 idle, so a
// thread owns a row: a warp's 32 consecutive rows load their slot ranges
// in one coalesced load, and each thread loads a batch of its row's
// senders and alpha (16 slots at one column, 8 at more), then their v
// rows, then sums.  The ws rows hold 2-9 slots, so a row costs three
// dependent trips to memory.  A hub row (more than kLongRow slots;
// Barabasi-Albert corpora have rows of thousands) would hold its whole
// warp, and so the launch, behind one thread: such rows are walked by
// their warp after the short ones, kHubBatches * 32 slots a trip, lane l
// taking slots k0 + 32u + l; the products are rounded on their lanes and
// added in slot order on every lane through shuffles (the chain of
// dependent adds, about 4 cycles a slot and column, is the hub row's
// cost).
//
// Vector (each head's width a multiple of 16 bytes of v).  Each output
// row has one owner group of LANES lanes (a warp, or a half-warp when
// one pass of 16 lanes spans the row) and each group owns kGroupRows
// consecutive rows: it loads their slot ranges in one load, and loads
// the next row's first batch of senders and alpha while it gathers the
// current row's v rows, so a row costs about one dependent trip to
// memory.  Lane l owns 16 consecutive bytes of each pass of LANES * 16
// bytes (4 f32 or 8 bf16 columns), so one load instruction of the group
// covers a whole pass of a v row.  The slots are taken in batches: lane
// l loads the sender of slot k0 + l and the l-th alpha word of the batch
// (LANES / heads slots, heads words each), one coalesced load each, and
// the group reads them back with __shfl_sync, so the walk has no
// dependent scalar load.  kInFlight v rows are loaded before the
// products of the first of them.  One head is a template case: its alpha
// is one word per slot and its batch is LANES slots.
//
// Scalar (any other width).  A warp per row; lane l accumulates columns
// l, l+32, l+64, l+96 of each 128-column pass and reads alpha and
// senders slot by slot.
#pragma once

#include "common.cuh"

namespace ggt {
namespace {

constexpr int kLongRow = 32;     // a row of more slots is a hub row: its
                                 // warp walks it in the narrow path
constexpr int kHubBatches = 4;   // slots per lane per trip of a hub row

template <typename T, int NC>
__global__ void __launch_bounds__(32 * kWarps)
row_walk_narrow(const T* __restrict__ v, long long n_src,
                long long n_rows, int d, const int* __restrict__ senders,
                const float* __restrict__ alpha,
                const int* __restrict__ row_range,
                float* __restrict__ out) {
  constexpr int kAhead = NC == 1 ? 16 : 8;  // slots a thread loads at once
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row0 = row - lane;
  if (row0 >= n_rows) return;  // the whole warp: no lane leaves alone
  int begin = 0, end = 0;
  if (row < n_rows) {
    begin = row_range[2 * row];
    end = row_range[2 * row + 1];
  }
  auto live = [n_src](int s) { return s >= 0 && s < n_src; };
  const bool hub = end - begin > kLongRow;
  if (!hub && row < n_rows) {
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    for (int k0 = begin; k0 < end; k0 += kAhead) {
      int s[kAhead];
      float a[kAhead];
      float x[kAhead][NC];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const bool in = k0 + j < end;
        s[j] = in ? senders[k0 + j] : -1;
        a[j] = in ? as_weight<T>(alpha[k0 + j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          x[j][c] = live(s[j]) && c < d
                        ? to_float(v[(long long)s[j] * d + c])
                        : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (!live(s[j])) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] += __fmul_rn(a[j], x[j][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < d) out[row * d + c] = acc[c];
  }
  // the warp's hub rows, one after another, every lane on each
  unsigned hubs = __ballot_sync(kAll, hub);
  while (hubs) {
    const int r = __ffs(hubs) - 1;
    hubs &= hubs - 1;
    const int b = __shfl_sync(kAll, begin, r);
    const int e = __shfl_sync(kAll, end, r);
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    for (int k0 = b; k0 < e; k0 += kHubBatches * 32) {
      int s[kHubBatches];
      float a[kHubBatches];
      float p[kHubBatches][NC];
#pragma unroll
      for (int u = 0; u < kHubBatches; ++u) {
        const int k = k0 + u * 32 + lane;
        s[u] = k < e ? senders[k] : -1;
        a[u] = k < e ? as_weight<T>(alpha[k]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kHubBatches; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          p[u][c] = live(s[u]) && c < d
                        ? __fmul_rn(a[u],
                                    to_float(v[(long long)s[u] * d + c]))
                        : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kHubBatches; ++u) {
        for (unsigned m = __ballot_sync(kAll, live(s[u])); m; m &= m - 1) {
          const int j = __ffs(m) - 1;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[c] += __shfl_sync(kAll, p[u][c], j);
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < d) out[(row0 + r) * d + c] = acc[c];
    }
  }
}

template <typename T, int LANES, bool ONE_HEAD>
__global__ void __launch_bounds__(32 * kWarps)
row_walk_vec(const T* __restrict__ v, long long n_src, long long n_rows,
             int d, int heads_arg, const int* __restrict__ senders,
             const float* __restrict__ alpha,
             const int* __restrict__ row_range, float* __restrict__ out) {
  constexpr int VW = Vec<T>::kN;
  const int heads = ONE_HEAD ? 1 : heads_arg;
  const int lane = threadIdx.x % LANES;
  const unsigned mask = group_mask<LANES>();
  const long long row0 = group_index<LANES>() * kGroupRows;
  int my_begin, my_end;
  load_ranges(row_range, n_rows, row0, lane, my_begin, my_end);
  const int dv = d / heads;
  const int per_batch = LANES / heads;  // slots whose alpha one load holds
  // lane l: the sender of slot b + l and the l-th alpha word of a batch
  // of slots from b on (a row past the last one has no slot)
  auto load_batch = [&](int b, int e, int& s, float& a) {
    const int nb = min(per_batch, e - b);
    s = lane < nb ? senders[b + lane] : -1;
    a = lane < nb * heads ? as_weight<T>(alpha[(long long)b * heads + lane])
                          : 0.f;
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
            if (i + j >= nb || s[j] < 0 || s[j] >= n_src) s[j] = -1;
            raw[j] = (s[j] >= 0 && has_col)
                         ? load16(v + (long long)s[j] * d + col)
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            if (s[j] < 0) continue;  // the same for the whole group
            float x[VW];
            Vec<T>::unpack(raw[j], x);
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

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
row_walk_scalar(const T* __restrict__ v, long long n_src, long long n_rows,
                int d, int heads, const int* __restrict__ senders,
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
      if (s < 0 || s >= n_src) continue;  // the same for the whole warp
      const float* a = alpha + (long long)k * heads;
      const T* vs = v + s * d;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = c0 + j * 32 + lane;
        if (col < d)
          acc[j] += __fmul_rn(as_weight<T>(a[head[j]]), to_float(vs[col]));
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int col = c0 + j * 32 + lane;
      if (col < d) out[row * d + col] = acc[j];
    }
  }
}

// An empty kernel: launched over a walk's grid, its time is the floor
// under the walk's.
__global__ void empty_walk() {}

enum Walk { kNarrow, kVec16, kVec32, kScalar };

// The path for these arguments: narrow for one head of at most
// kNarrowCols columns; vector where each head's width is a multiple of
// 16 bytes and v and out are 16-byte aligned (a half-warp a row when one
// pass of 16 lanes spans the row); scalar otherwise.
template <typename T>
Walk pick_walk(const T* v, int d, int heads, const float* out) {
  constexpr int VW = Vec<T>::kN;
  if (heads == 1 && d <= kNarrowCols) return kNarrow;
  const int lanes = d <= 16 * VW ? 16 : 32;
  const bool vec = (d / heads) % VW == 0 && heads <= lanes &&
                   aligned16(v) && aligned16(out);
  return !vec ? kScalar : lanes == 16 ? kVec16 : kVec32;
}

// Blocks of 32 * kWarps threads that a walk takes for n_rows rows.
inline unsigned walk_blocks(Walk walk, long long n_rows) {
  const long long rows = walk == kNarrow  ? 32 * kWarps
                         : walk == kVec16 ? 2 * kWarps * kGroupRows
                         : walk == kVec32 ? kWarps * kGroupRows
                                          : kWarps;
  return (unsigned)((n_rows + rows - 1) / rows);
}

// Launch the walk on stream: out [n_rows, d] from v [n_src, d]; returns
// cudaGetLastError() after it.
template <typename T>
int launch_row_walk(const T* v, long long n_src, long long n_rows, int d,
                    int heads, const int* senders, const float* alpha,
                    const int* row_range, float* out, cudaStream_t st) {
  const Walk walk = pick_walk(v, d, heads, out);
  const unsigned blocks = walk_blocks(walk, n_rows);
  const int threads = 32 * kWarps;
  switch (walk) {
    case kNarrow:
      if (d == 1) {
        row_walk_narrow<T, 1><<<blocks, threads, 0, st>>>(
            v, n_src, n_rows, d, senders, alpha, row_range, out);
      } else {
        row_walk_narrow<T, kNarrowCols><<<blocks, threads, 0, st>>>(
            v, n_src, n_rows, d, senders, alpha, row_range, out);
      }
      break;
    case kVec16:
    case kVec32:
      if (walk == kVec16 && heads == 1) {
        row_walk_vec<T, 16, true><<<blocks, threads, 0, st>>>(
            v, n_src, n_rows, d, heads, senders, alpha, row_range, out);
      } else if (walk == kVec16) {
        row_walk_vec<T, 16, false><<<blocks, threads, 0, st>>>(
            v, n_src, n_rows, d, heads, senders, alpha, row_range, out);
      } else if (heads == 1) {
        row_walk_vec<T, 32, true><<<blocks, threads, 0, st>>>(
            v, n_src, n_rows, d, heads, senders, alpha, row_range, out);
      } else {
        row_walk_vec<T, 32, false><<<blocks, threads, 0, st>>>(
            v, n_src, n_rows, d, heads, senders, alpha, row_range, out);
      }
      break;
    case kScalar:
      row_walk_scalar<T><<<blocks, threads, 0, st>>>(
          v, n_src, n_rows, d, heads, senders, alpha, row_range, out);
      break;
  }
  return (int)cudaGetLastError();
}

// Launch empty_walk over the grid launch_row_walk takes for these
// arguments; returns cudaGetLastError() after it.
template <typename T>
int launch_floor(const T* v, long long n_rows, int d, int heads,
                 const float* out, cudaStream_t st) {
  empty_walk<<<walk_blocks(pick_walk(v, d, heads, out), n_rows),
               32 * kWarps, 0, st>>>();
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggt
