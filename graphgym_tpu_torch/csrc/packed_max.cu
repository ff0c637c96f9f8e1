// Packed segmented max, forward and backward, for Hopper (sm_90a).
//
// Stands in for XLA's segment_max in the JAX package's 'max' aggregation
// of GeneralConv and GeneralIDConv (graphgym_tpu/ops/sparse.py:25-57 ->
// graphgym_tpu/ops/segment.py:50-60) and in its max pooling
// (graphgym_tpu/nn/heads.py): the JAX package has no Pallas kernel for
// it.  Over the slots of a PackedCSR layout (receiver-sorted edges in
// chunks, row_range[r] = the flat slots [start, end) of row r):
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
// padding node's self-loop in the 'gcn' pack, trailing padded edges, a
// padding node or padding ego center in a pooling pack) and a sender
// outside [0, x_rows) are skipped explicitly, so such a row comes out 0
// with no gradient, as the JAX -inf mask and isfinite -> 0 give.
//
// Rectangular packs: the forward's out has n_rows rows and x has x_rows;
// the backward's dx has the rows of x and of its pack, and g, out and
// cnt have g_rows.  They differ on graph max pooling (out [graphs, D]
// from x [nodes, D]; the backward on the transpose pack, a node's slots
// naming its graph slot); a layer's square pack passes one count
// twice.
//
// Bound: bytes.  The forward reads 8 bytes of pack per slot and one row
// of x per slot (from L2 after its first read), writes out and cnt once;
// the backward reads the pack, the x row of each row with a live slot,
// and out, cnt and g of each slot's receiver, and writes dx once.  One
// compare (forward) or three operations (backward) per slot and column,
// far below the card's rate.  What holds a launch back is the chain of
// dependent trips to memory (row range -> senders -> gathered rows),
// how many of them the card runs at once, and a block's fixed costs, so
// the design is about those.
//
// Column slices.  Every launch gives each slice of the columns its own
// owners, so no owner walks a row's slots once per 128-column pass, and
// a few rows at a wide D (the pooling's 17 rows x 768) still fill the
// card; a row's slices are neighbouring blocks.  A group of LANES lanes
// (a warp, or a half-warp where 16 lanes span the row) owns a slice, in
// one of three modes.  kVec: lane l holds consecutive columns, one
// 16-byte load of x a slot in the forward (4 f32 or 8 bf16: 128 or 256
// columns a warp), 4 f32 columns of out, cnt, g and dx in the backward
// (8, two vectors, on f32 rows of whole 256-column slices where the
// launch still has kMinBlocks blocks: ws and ba at D = 256, a row's
// columns in half the warps); where the width is a multiple of the
// vector and the arrays aligned.  kStrided: kStridedCols columns
// strided by 32, any width.  kNarrow: one
// column a lane, 32 a warp, where the other two would give the launch
// fewer than kMinBlocks blocks even at one row a tile (forward: the
// pooling's 17-93 graph slots) or a group (backward: design_sf_max's
// 1,280 rows): more owners for few rows.
//
// The forward: runs of a tile, split evenly.  A block of G groups owns
// a tile of consecutive rows and one slice.  Warp 0 loads the tile's
// row ranges in one load and cuts each row into runs of RUN slots (an
// empty row is one run of none), and a shuffle scan numbers the runs in
// shared memory.  Group g takes runs [g * U / G, (g + 1) * U / G) of the
// tile's U: short rows go whole to one group, several a group, and a
// long row (ba's hubs, a pooling row of 64 slots or 500, make_graph's
// 5,400) is split over every group of its block.  A group loads a run's
// senders and weights in one coalesced load (lane l slot l), the next
// run's while it gathers the current one's x rows, and issues the loads
// of all RUN gathered rows before the first compare; a dead slot is
// masked after the loads, never skipped before them.  So a run costs
// one trip to memory, and RUN rows are in flight a group (kVecRun, or
// kNarrowRun of one column); the registers are capped so that an SM
// holds kFwdBlocks blocks.  A group's (max, count) partials stay in
// registers while its runs stay in one row.  A row wholly inside one
// group is stored by it; a row that crosses groups leaves one partial in
// shared memory for each later group (their first row), and after the
// barrier the group that holds the row's first run merges them in group
// order (16-byte shared loads on kVec; on kNarrow every group's value
// read at once, those of other rows as count 0) and stores.  The merge
// is exact (a max, and a count of small integers), and the split
// depends only on the pack and the width, so launches are bitwise
// repeatable; the result equals the slot-order walk's but for the sign
// of a zero that two tied slots reach with opposite signs (+0 == -0 in
// every comparison that reads it).  The tile has kGroupRuns rows a
// group, halved until the launch has kMinBlocks blocks or one row a
// tile: a pooling row of 64 slots then gets a block of its own.
//
// The backward: one owner per (row, slice), so each dx entry is summed
// in slot order, the same order and the same bits as the plain version
// (and as this kernel's earlier one-warp-a-row design).  The owner reads
// its row's slot range and a batch of LANES receivers and weights; a row
// with no live slot writes zeros and reads nothing else: x is read once
// a batch holds a live slot (idgraph_ba's pooling backward has ~5,900
// live rows of 327,680), and dx is written with streaming stores.  Then
// out, cnt and g of the live slots, added in slot order: slot by slot on
// kVec and kStrided (measured on the ego packs, more slots in flight cost
// more in registers, so in resident warps, than they gave), and
// kBwdNarrowInFlight slots loaded before their adds on kNarrow, where a
// lane holds one value a slot and few rows leave hub rows (30-34 slots
// on design_sf_max) as the launch's longest chain.  A row of more than
// LANES slots takes more batches (make_graph's hubs: one owner walks
// 5,400 slots).
//
// No atomics; each output row and slice is written once.

#include <type_traits>

#include "common.cuh"

namespace ggt {
namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kVecRun = 4;       // slots of a forward run (their x rows are
                                 // loaded at once), a vector a lane
constexpr int kNarrowRun = 8;    // the same, one column a lane
constexpr int kGroupRuns = 4;    // rows a group of a forward tile, at most
constexpr int kMaxTileRows = 32;   // rows a forward tile, at most (warp 0
                                   // scans them)
constexpr int kBwdNarrowInFlight = 4;   // slots whose out, cnt and g the
                                        // backward loads at once, one
                                        // column a lane (else one)
constexpr int kFwdBlocks = 5;      // blocks an SM holds of the forward: its
                                   // registers capped to fit (48 a thread)
constexpr int kMinBlocks = 512;    // blocks a launch should have (about
                                   // four an SM of the H100's 132)
constexpr int kStridedCols = 4;    // columns a lane in kStrided
constexpr int kBwdWideCols = 8;    // the backward's columns a lane on a
                                   // wide row (two 16-byte vectors)
constexpr int kMaxGridY = 65535;   // the grid's largest y (and z)

enum Mode { kVec, kStrided, kNarrow };

template <int N>
struct Floats {
  float v[N];
};

// Columns a lane holds, and where: VN consecutive ones (kVec) or
// strided by 32.
template <typename T, Mode M, int VN>
struct Cols {
  static constexpr int kN = M == kNarrow    ? 1
                            : M == kStrided ? kStridedCols
                                            : VN;
  // x as loaded, before its conversion to f32: one vector (kVec, 8 or
  // 16 bytes) or converted values
  using XRaw = std::conditional_t<
      (M != kVec || kN * sizeof(T) > 16), Floats<kN>,
      std::conditional_t<kN * sizeof(T) == 16, uint4, uint2>>;

  // the t-th column's offset in its slice
  __device__ __forceinline__ static int at(int lane, int t) {
    return M == kVec ? lane * kN + t : t * 32 + lane;
  }
  __device__ __forceinline__ static XRaw load_x(const T* __restrict__ p,
                                                int d, int c0, int lane) {
    if constexpr (M == kVec && (kN * sizeof(T) > 16)) {   // f32, 8 a lane
      XRaw f;
      load_f32(reinterpret_cast<const float*>(p), d, c0, lane, f.v);
      return f;
    } else if constexpr (M == kVec) {
      const int col = c0 + at(lane, 0);
      if (col >= d) return XRaw{};
      if constexpr (std::is_same_v<XRaw, uint4>) {
        return load16(p + col);
      } else {
        return __ldg(reinterpret_cast<const uint2*>(p + col));
      }
    } else {
      XRaw f;
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        const int col = c0 + at(lane, t);
        f.v[t] = col < d ? to_float(p[col]) : 0.f;
      }
      return f;
    }
  }
  __device__ __forceinline__ static void unpack(const XRaw& r,
                                                float (&v)[kN]) {
    if constexpr (std::is_same_v<XRaw, Floats<kN>>) {
#pragma unroll
      for (int t = 0; t < kN; ++t) v[t] = r.v[t];
    } else if constexpr (std::is_same_v<XRaw, uint4>) {
      if constexpr (kN == 4) {   // f32
        v[0] = __uint_as_float(r.x);
        v[1] = __uint_as_float(r.y);
        v[2] = __uint_as_float(r.z);
        v[3] = __uint_as_float(r.w);
      } else {
        Vec<T>::unpack(r, v);
      }
    } else {   // 4 bf16: each value the high half of its f32
      v[0] = __uint_as_float(r.x << 16);
      v[1] = __uint_as_float(r.x & 0xffff0000u);
      v[2] = __uint_as_float(r.y << 16);
      v[3] = __uint_as_float(r.y & 0xffff0000u);
    }
  }
  // the lane's columns of an f32 row (zeros past d)
  __device__ __forceinline__ static void load_f32(const float* __restrict__ p,
                                                  int d, int c0, int lane,
                                                  float (&v)[kN]) {
    if constexpr (M == kVec) {
      const int col = c0 + at(lane, 0);
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const uint4 r = col < d ? load16(p + col + 4 * q)
                                : make_uint4(0u, 0u, 0u, 0u);
        v[4 * q] = __uint_as_float(r.x);
        v[4 * q + 1] = __uint_as_float(r.y);
        v[4 * q + 2] = __uint_as_float(r.z);
        v[4 * q + 3] = __uint_as_float(r.w);
      }
    } else {
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        const int col = c0 + at(lane, t);
        v[t] = col < d ? __ldg(p + col) : 0.f;
      }
    }
  }
  // store the lane's columns of an f32 row (STREAM: evict-first)
  template <bool STREAM = false>
  __device__ __forceinline__ static void store(float* __restrict__ p, int d,
                                               int c0, int lane,
                                               const float (&v)[kN]) {
    if constexpr (M == kVec) {
      const int col = c0 + at(lane, 0);
      if (col < d) {
#pragma unroll
        for (int q = 0; q < kN / 4; ++q) {
          const float4 f =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
          float4* o = reinterpret_cast<float4*>(p + col) + q;
          if constexpr (STREAM) {
            __stcs(o, f);
          } else {
            *o = f;
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kN; ++t) {
        const int col = c0 + at(lane, t);
        if (col < d) {
          if constexpr (STREAM) {
            __stcs(p + col, v[t]);
          } else {
            p[col] = v[t];
          }
        }
      }
    }
  }
  // a part of a slice's row in shared memory, the lane's values from
  // at(lane, 0) (one 16-byte access each 4 values on kVec)
  __device__ __forceinline__ static void save(float* s, int lane,
                                              const float (&v)[kN]) {
    if constexpr (M == kVec) {
#pragma unroll
      for (int q = 0; q < kN / 4; ++q)
        reinterpret_cast<float4*>(s + at(lane, 0))[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < kN; ++t) s[at(lane, t)] = v[t];
    }
  }
  __device__ __forceinline__ static void restore(const float* s, int lane,
                                                 float (&v)[kN]) {
    if constexpr (M == kVec) {
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(s + at(lane, 0))[q];
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < kN; ++t) v[t] = s[at(lane, t)];
    }
  }
};

// A running max of a lane's N columns and how many slots reach it.
template <int N>
struct MaxCount {
  float best[N], count[N];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int t = 0; t < N; ++t) best[t] = count[t] = 0.f;
  }
  // one live slot's value m in column t
  __device__ __forceinline__ void take(int t, float m) {
    if (count[t] == 0.f || m > best[t]) {
      best[t] = m;
      count[t] = 1.f;
    } else if (m == best[t]) {
      count[t] += 1.f;
    }
  }
  // another part's (max, count) in column t; a count of 0 is no part
  __device__ __forceinline__ void merge(int t, float b, float c) {
    if (c == 0.f) return;
    if (count[t] == 0.f || b > best[t]) {
      best[t] = b;
      count[t] = c;
    } else if (b == best[t]) {
      count[t] += c;
    }
  }
};

// The first run of group g of G over a tile of `total` runs.
template <int G>
__device__ __forceinline__ int first_run(int g, int total) {
  return (int)((long long)g * total / G);
}

template <typename T, int LANES, Mode M>
__global__ void __launch_bounds__(32 * kWarps, kFwdBlocks)
packed_max_fwd(const T* __restrict__ x, long long x_rows, long long n_rows,
               int d, int tile_rows, const int* __restrict__ senders,
               const float* __restrict__ weights,
               const int* __restrict__ row_range, float* __restrict__ out,
               float* __restrict__ cnt) {
  using C = Cols<T, M, Vec<T>::kN>;
  constexpr int N = C::kN;
  constexpr int RUN = M == kNarrow ? kNarrowRun : kVecRun;
  constexpr int W = LANES * N;               // columns a slice
  constexpr int G = 32 * kWarps / LANES;     // groups a block
  __shared__ int s_begin[kMaxTileRows], s_end[kMaxTileRows];
  __shared__ int s_run0[kMaxTileRows + 1];   // first run of each row
  // a group's head part: the max, then the count
  __shared__ __align__(16) float s_part[G][2][W];

  // block b: slice b % slices of tile b / slices (a tile's slices run
  // side by side)
  const int slices = (d + W - 1) / W;
  const long long r0 = (long long)(blockIdx.x / slices) * tile_rows;
  const int rows = (int)min((long long)tile_rows, n_rows - r0);
  const int c0 = (int)(blockIdx.x % slices) * W;
  const int grp = threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const unsigned mask = group_mask<LANES>();

  if (threadIdx.x < 32) {   // warp 0: the tile's ranges and runs
    const int i = threadIdx.x;
    int b = 0, e = 0, u = 0;
    if (i < rows) {
      b = row_range[2 * (r0 + i)];
      e = max(b, row_range[2 * (r0 + i) + 1]);
      u = max(1, (e - b + RUN - 1) / RUN);
    }
    int incl = u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kAll, incl, o);
      if (i >= o) incl += up;
    }
    if (i < rows) {
      s_begin[i] = b;
      s_end[i] = e;
      s_run0[i + 1] = incl;
    }
    if (i == 0) s_run0[0] = 0;
  }
  __syncthreads();

  const int total = s_run0[rows];
  const int j0 = first_run<G>(grp, total), j1 = first_run<G>(grp + 1, total);
  MaxCount<N> acc;
  acc.clear();
  int tail_row = -1;   // a row this group begins and a later one ends
  if (j0 < j1) {
    int r = 0;
    while (s_run0[r + 1] <= j0) ++r;
    // run j of row r: lane l takes slot l of it (none past the row)
    auto load_run = [&](int j, int row, int& s, float& w, int& nb) {
      const int k0 = s_begin[row] + (j - s_run0[row]) * RUN;
      nb = max(0, min(RUN, s_end[row] - k0));
      s = lane < nb ? senders[k0 + lane] : -1;
      w = lane < nb ? weights[k0 + lane] : 0.f;
    };
    int next_s, next_nb;
    float next_w;
    load_run(j0, r, next_s, next_w, next_nb);
    for (int j = j0; j < j1; ++j) {
      const int my_s = next_s, nb = next_nb;
      const float my_w = next_w;
      const bool row_ends = j + 1 == s_run0[r + 1];
      if (j + 1 < j1)   // the next run's batch, loaded ahead
        load_run(j + 1, row_ends ? r + 1 : r, next_s, next_w, next_nb);
      int s[RUN];
      float w[RUN];
      typename C::XRaw raw[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        s[i] = __shfl_sync(mask, my_s, i, LANES);
        w[i] = __shfl_sync(mask, my_w, i, LANES);
        if (i >= nb || w[i] == 0.f || s[i] < 0 || s[i] >= x_rows) s[i] = -1;
        raw[i] = s[i] >= 0 ? C::load_x(x + (long long)s[i] * d, d, c0, lane)
                           : typename C::XRaw{};
      }
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        if (s[i] < 0) continue;   // the same for the whole group
        float v[N];
        C::unpack(raw[i], v);
#pragma unroll
        for (int t = 0; t < N; ++t) acc.take(t, __fmul_rn(w[i], v[t]));
      }
      if (row_ends || j + 1 == j1) {
        const bool first = s_run0[r] >= j0;   // the row's first run is ours
        if (row_ends && first) {
          C::store(out + (r0 + r) * d, d, c0, lane, acc.best);
          C::store(cnt + (r0 + r) * d, d, c0, lane, acc.count);
        } else if (!first) {   // a later part of a row begun before us
          C::save(s_part[grp][0], lane, acc.best);
          C::save(s_part[grp][1], lane, acc.count);
        } else {
          tail_row = r;   // j + 1 == j1: the parts after ours, after the
                          // barrier
        }
        if (row_ends) {
          acc.clear();
          ++r;
        }
      }
    }
  }
  __syncthreads();
  if (tail_row >= 0) {   // merge the later groups' parts, in group order
    const int end_run = s_run0[tail_row + 1];
    if constexpr (M == kNarrow) {
      // one value a part: read every group's, each with no wait on the
      // last, and merge those of this row (a count of 0 is no part)
#pragma unroll
      for (int g = 1; g < G; ++g) {
        const int ga = first_run<G>(g, total);
        const bool part =
            g > grp && ga < end_run && ga < first_run<G>(g + 1, total);
        acc.merge(0, s_part[g][0][lane], part ? s_part[g][1][lane] : 0.f);
      }
    } else {
      for (int g = grp + 1; g < G; ++g) {
        const int ga = first_run<G>(g, total);
        if (ga >= end_run) break;
        if (ga == first_run<G>(g + 1, total)) continue;   // no runs
        float b[N], c[N];
        C::restore(s_part[g][0], lane, b);
        C::restore(s_part[g][1], lane, c);
#pragma unroll
        for (int t = 0; t < N; ++t) acc.merge(t, b[t], c[t]);
      }
    }
    C::store(out + (r0 + tail_row) * d, d, c0, lane, acc.best);
    C::store(cnt + (r0 + tail_row) * d, d, c0, lane, acc.count);
  }
}

template <typename T, int LANES, Mode M, int VN>
__global__ void __launch_bounds__(32 * kWarps)
packed_max_bwd(const T* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ out, const float* __restrict__ cnt,
               long long n_rows, long long g_rows, int d,
               const int* __restrict__ senders,
               const float* __restrict__ weights,
               const int* __restrict__ row_range, float* __restrict__ dx) {
  using C = Cols<T, M, VN>;
  constexpr int N = C::kN;
  constexpr int K = M == kNarrow ? kBwdNarrowInFlight : 1;
  // block (s, y, z): slice s of the rows of block y + z * kMaxGridY (a
  // row's slices run side by side)
  const long long row =
      ((long long)blockIdx.z * kMaxGridY + blockIdx.y) * (32 * kWarps / LANES) +
      threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  const unsigned mask = group_mask<LANES>();
  if (row >= n_rows) return;   // the whole group
  const int c0 = blockIdx.x * (LANES * N);
  const int begin = row_range[2 * row];
  const int end = max(begin, row_range[2 * row + 1]);
  float acc[N], xs[N];
#pragma unroll
  for (int t = 0; t < N; ++t) acc[t] = xs[t] = 0.f;
  bool x_loaded = false;
  for (int k0 = begin; k0 < end; k0 += LANES) {
    // lane l: the receiver and weight of slot k0 + l
    const int nb = min(LANES, end - k0);
    const int my_r = lane < nb ? senders[k0 + lane] : -1;
    const float my_w = lane < nb ? weights[k0 + lane] : 0.f;
    if (!x_loaded) {   // the row's x, once a batch holds a live slot
      const bool live = my_w != 0.f && my_r >= 0 && my_r < g_rows;
      if (!(__ballot_sync(mask, live) & mask)) continue;   // whole group
      C::unpack(C::load_x(x + row * d, d, c0, lane), xs);
      x_loaded = true;
    }
    if constexpr (K == 1) {   // slot by slot: the fewest registers
      for (int i = 0; i < nb; ++i) {
        const int r = __shfl_sync(mask, my_r, i, LANES);
        const float w = __shfl_sync(mask, my_w, i, LANES);
        if (w == 0.f || r < 0 || r >= g_rows) continue;   // whole group
        float o[N], c[N], gr[N];
        const long long at = (long long)r * d;
        C::load_f32(out + at, d, c0, lane, o);
        C::load_f32(cnt + at, d, c0, lane, c);
        C::load_f32(g + at, d, c0, lane, gr);
#pragma unroll
        for (int t = 0; t < N; ++t) {
          if (__fmul_rn(w, xs[t]) == o[t] && c[t] > 0.f)
            acc[t] = __fadd_rn(
                acc[t], __fmul_rn(__fmul_rn(gr[t], __frcp_rn(c[t])), w));
        }
      }
    } else {   // K slots' out, cnt and g loaded before their adds
      for (int i0 = 0; i0 < nb; i0 += K) {
        int r[K];
        float w[K], o[K][N], c[K][N], gr[K][N];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          r[j] = __shfl_sync(mask, my_r, (i0 + j) % LANES, LANES);
          w[j] = __shfl_sync(mask, my_w, (i0 + j) % LANES, LANES);
          if (i0 + j >= nb || w[j] == 0.f || r[j] < 0 || r[j] >= g_rows)
            r[j] = -1;
          if (r[j] >= 0) {
            const long long at = (long long)r[j] * d;
            C::load_f32(out + at, d, c0, lane, o[j]);
            C::load_f32(cnt + at, d, c0, lane, c[j]);
            C::load_f32(g + at, d, c0, lane, gr[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (r[j] < 0) continue;   // the same for the whole group
#pragma unroll
          for (int t = 0; t < N; ++t) {
            if (__fmul_rn(w[j], xs[t]) == o[j][t] && c[j][t] > 0.f)
              acc[t] = __fadd_rn(
                  acc[t],
                  __fmul_rn(__fmul_rn(gr[j][t], __frcp_rn(c[j][t])), w[j]));
          }
        }
      }
    }
  }
  C::template store<true>(dx + row * d, d, c0, lane, acc);
}

// A launch's shape: its grid, the kernel's lanes a group and mode, and
// the rows a tile (forward) or a group (backward).
struct Shape {
  dim3 grid;
  int lanes;
  Mode mode;
  int rows;
  int cols;   // columns a lane (kVec)
};

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The forward's shape: kVec (where the vector fits) or kStrided, unless
// that gives fewer than kMinBlocks blocks even at one row a tile: then
// kNarrow.  The tile has kGroupRuns rows a group, halved while the
// launch has fewer than kMinBlocks blocks.
inline Shape fwd_shape(long long n_rows, int d, bool vec, int vec_n) {
  Mode mode = vec ? kVec : kStrided;
  const int n = vec ? vec_n : kStridedCols;
  int lanes = vec && d <= 16 * n ? 16 : 32;
  int slices = (int)ceil_div(d, lanes * n);
  int full = min(kGroupRuns * 32 * kWarps / lanes, kMaxTileRows);
  if (n_rows * slices < kMinBlocks) {
    mode = kNarrow;
    lanes = 32;
    slices = (int)ceil_div(d, 32);
    full = min(kGroupRuns * kWarps, kMaxTileRows);
  }
  int tile = full;
  while (tile > 1 && ceil_div(n_rows, tile) * slices < kMinBlocks) tile /= 2;
  return {dim3((unsigned)(ceil_div(n_rows, tile) * slices)), lanes, mode,
          tile, n};
}

// The backward's shape, likewise: kNarrow where the other two give
// fewer than kMinBlocks blocks; a group a row.
inline Shape bwd_shape(long long n_rows, int d, bool vec, bool f32) {
  Mode mode = vec ? kVec : kStrided;
  int lanes = vec && d <= 16 * 4 ? 16 : 32;
  int cols = 4;
  int slices = (int)ceil_div(d, lanes * cols);
  long long blocks = ceil_div(n_rows, 32 * kWarps / lanes);
  if (blocks * slices < kMinBlocks) {
    mode = kNarrow;
    lanes = 32;
    cols = 1;
    slices = (int)ceil_div(d, 32);
    blocks = ceil_div(n_rows, kWarps);
  } else if (vec && f32 && lanes == 32 && d % (32 * kBwdWideCols) == 0 &&
             blocks * (d / (32 * kBwdWideCols)) >= kMinBlocks) {
    // f32 rows of whole 256-column slices (ws and ba at D = 256) take
    // two vectors a lane where that still fills the card: a row's
    // columns in half the warps
    cols = kBwdWideCols;
    slices = (int)ceil_div(d, 32 * cols);
  }
  return {dim3((unsigned)slices,
               (unsigned)(blocks < kMaxGridY ? blocks : kMaxGridY),
               (unsigned)ceil_div(blocks, kMaxGridY)),
          lanes, mode, 1, cols};
}

inline unsigned long long address(const void* p) {
  return reinterpret_cast<unsigned long long>(p);
}

// The forward's vector mode fits: the width a multiple of one 16-byte
// vector of T and x, out and cnt aligned to it.
template <typename T>
bool fwd_vec(int d, const T* x, const void* out, const void* cnt) {
  return d % Vec<T>::kN == 0 && address(x) % 16 == 0 && aligned16(out) &&
         aligned16(cnt);
}

// The backward's: a multiple of 4 columns, x aligned to 4 values and g,
// out, cnt and dx to 16 bytes.
template <typename T>
bool bwd_vec(int d, const T* x, const void* g, const void* out,
             const void* cnt, const void* dx) {
  return d % 4 == 0 && address(x) % (4 * sizeof(T)) == 0 && aligned16(g) &&
         aligned16(out) && aligned16(cnt) && aligned16(dx);
}

// An empty kernel: launched over the max's grid, its time is the floor
// under the max's.
__global__ void empty_rows() {}

template <typename T>
int launch_fwd(const T* x, long long x_rows, long long n_rows, int d,
               const int* senders, const float* weights,
               const int* row_range, float* out, float* cnt,
               cudaStream_t st) {
  const Shape sh =
      fwd_shape(n_rows, d, fwd_vec(d, x, out, cnt), Vec<T>::kN);
  const int threads = 32 * kWarps;
#define GGT_FWD(LANES, MODE)                                              \
  packed_max_fwd<T, LANES, MODE><<<sh.grid, threads, 0, st>>>(            \
      x, x_rows, n_rows, d, sh.rows, senders, weights, row_range, out, cnt)
  if (sh.mode == kNarrow) {
    GGT_FWD(32, kNarrow);
  } else if (sh.mode == kStrided) {
    GGT_FWD(32, kStrided);
  } else if (sh.lanes == 16) {
    GGT_FWD(16, kVec);
  } else {
    GGT_FWD(32, kVec);
  }
#undef GGT_FWD
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* x, const float* g, const float* out,
               const float* cnt, long long n_rows, long long g_rows,
               int d, const int* senders, const float* weights,
               const int* row_range, float* dx, cudaStream_t st) {
  const Shape sh = bwd_shape(n_rows, d, bwd_vec(d, x, g, out, cnt, dx),
                             sizeof(T) == 4);
  const int threads = 32 * kWarps;
#define GGT_BWD(LANES, MODE, VN)                                          \
  packed_max_bwd<T, LANES, MODE, VN><<<sh.grid, threads, 0, st>>>(        \
      x, g, out, cnt, n_rows, g_rows, d, senders, weights, row_range, dx)
  if (sh.mode == kNarrow) {
    GGT_BWD(32, kNarrow, 1);
  } else if (sh.mode == kStrided) {
    GGT_BWD(32, kStrided, 4);
  } else if (sh.lanes == 16) {
    GGT_BWD(16, kVec, 4);
  } else if (sh.cols == kBwdWideCols) {
    GGT_BWD(32, kVec, kBwdWideCols);
  } else {
    GGT_BWD(32, kVec, 4);
  }
#undef GGT_BWD
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggt

// Plain C entry points (bound with ctypes).  The forward: x is
// [x_rows, d] row-major (f32 or bf16), senders / weights are a pack's
// [num_chunks, chunk] arrays and row_range its [n_rows, 2], out and cnt
// [n_rows, d] f32.  The backward takes the transpose pack: x and dx are
// [n_rows, d], row_range [n_rows, 2], g, out and cnt [g_rows, d] f32.
// Each is one kernel launch and returns cudaGetLastError() after it.
extern "C" int packed_max_f32(const void* x, long long x_rows, int d,
                              const void* senders, const void* weights,
                              const void* row_range, long long n_rows,
                              void* out, void* cnt, void* stream) {
  return ggt::launch_fwd<float>((const float*)x, x_rows, n_rows, d,
                                (const int*)senders, (const float*)weights,
                                (const int*)row_range, (float*)out,
                                (float*)cnt, (cudaStream_t)stream);
}

extern "C" int packed_max_bf16(const void* x, long long x_rows, int d,
                               const void* senders, const void* weights,
                               const void* row_range, long long n_rows,
                               void* out, void* cnt, void* stream) {
  return ggt::launch_fwd<__nv_bfloat16>(
      (const __nv_bfloat16*)x, x_rows, n_rows, d, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)out,
      (float*)cnt, (cudaStream_t)stream);
}

extern "C" int packed_max_bwd_f32(const void* x, const void* g,
                                  const void* out, const void* cnt,
                                  long long n_rows, int d,
                                  const void* senders, const void* weights,
                                  const void* row_range, long long g_rows,
                                  void* dx, void* stream) {
  return ggt::launch_bwd<float>(
      (const float*)x, (const float*)g, (const float*)out,
      (const float*)cnt, n_rows, g_rows, d, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)dx,
      (cudaStream_t)stream);
}

extern "C" int packed_max_bwd_bf16(const void* x, const void* g,
                                   const void* out, const void* cnt,
                                   long long n_rows, int d,
                                   const void* senders, const void* weights,
                                   const void* row_range, long long g_rows,
                                   void* dx, void* stream) {
  return ggt::launch_bwd<__nv_bfloat16>(
      (const __nv_bfloat16*)x, (const float*)g, (const float*)out,
      (const float*)cnt, n_rows, g_rows, d, (const int*)senders,
      (const float*)weights, (const int*)row_range, (float*)dx,
      (cudaStream_t)stream);
}

// The launch floor under packed_max_* (backward 0) or packed_max_bwd_*
// (backward 1), for measurement: an empty kernel over the grid the
// kernel takes for n_rows rows of d columns of f32 (bf16 0) or bf16
// (bf16 1), in the vector mode where the width allows it.
extern "C" int packed_max_floor(long long n_rows, int d, int bf16,
                                int backward, void* stream) {
  const int vec_n = bf16 ? 8 : 4;
  const ggt::Shape sh = backward ? ggt::bwd_shape(n_rows, d, d % 4 == 0,
                                                  !bf16)
                                 : ggt::fwd_shape(n_rows, d, d % vec_n == 0,
                                                  vec_n);
  ggt::empty_rows<<<sh.grid, 32 * ggt::kWarps, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
