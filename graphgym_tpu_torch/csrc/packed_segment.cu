// Unweighted segmented sum for Hopper (sm_90a), redesigned from the row
// index up:
//
//   out[r, :] = sum over the positions p of row r, in position order, of
//               msg[src[p], :]          (msg[p, :] where src is null)
//
// Replaces graphgym_tpu/ops/pallas/spmm_kernel.py:_kernel (K2, through
// packed_segment_matmul with weights=None, and its group pre-sum
// _group_reduce), whose one-hot matmul adds every slot of a PackedCSR
// layout to its row.  The TPU contract (every slot counts, padding slots
// included) is the case without src, or with src the slots stably sorted
// by row (ops/cuda/spmm_kernel.py:pack_segment_index_host).  A source at
// or beyond msg's rows is "none": skipped and never read.
//
// The index (SegmentIndex, built on the host with the batch): positions
// sorted by output row, row_ptr [n_out + 1] their CSR pointer, src [P]
// each position's message row, and for the rows of more than
// kOwnerSlots positions a fixed-length list of runs (run_row,
// run_first, run_len: a run's row, the row's first run and its run
// length; -1 past the last) with an int32 arrival counter per run (zero
// between launches).  Its shapes depend on P and n_out alone, so one
// captured program serves every batch of a signature.
//
// Bound: bytes.  The messages of the live positions read once, the index
// read once, each output row written once; one add per message element.
// On the edge convs' 'edge' pack at D = 300 (BONDS, 9,808 real edges)
// that is 14.9 MB, 4.4 us at 3.35 TB/s.
//
// What the design does about the old kernel's costs:
//  1. A row of at most kOwnerSlots positions has one owner, which sums
//     it and writes it once: no partial, no combine pass.  A longer row
//     is cut into runs, each summed by its own warp into a partial.  A
//     run is a chain of trips to memory, so runs are short where the
//     long rows hold few positions (16: a padding row of hundreds of
//     edges costs about what a short row costs), and longer where their
//     positions would outnumber the warps the card holds (2,048 runs in
//     all: an embedding pack's runs of ~144, so its partials stay few;
//     ops/cuda/spmm_kernel.py:run_length).  The last run of each group
//     of kGroupRuns runs to arrive (an atomic on a counter, after a
//     fence) adds the group's partials in run order; the last group of
//     the row to arrive adds the group sums in order and writes the row;
//     each counter is set back to 0 by the one that found it full, for
//     the next launch or replay.  One launch; a row of 41,286 positions
//     (1,966 runs of 21) waits for 16 + 123 partials after its runs,
//     not 1,966.  The sums do not depend on which run arrives last, so two
//     launches are bitwise equal.  No float atomics.  The run warps
//     stride over the run list (at most kMaxRunBlocks blocks), so its
//     padding past the last run costs one load a warp.
//  2. Only positions are read, and a caller lists only what it sums: the
//     edge sums' index holds the E batch edges, not the chunk padding of
//     the 'edge' pack's slots.
//  3. Messages are read in place through src: no slot-order copy of the
//     per-edge messages or of the encoder's gathered gradient.
//  4. A lane owns one vector of 4 columns (16 bytes of f32, 8 of bf16;
//     one column where the row is no multiple of 4) in each of VPL <= 4
//     groups of 32 vectors, so a warp reads a row of up to 128 vectors
//     (512 columns) in one instruction per group: D = 300 is 75
//     vectors, three a lane.  A batch of 32 sources is loaded in one
//     coalesced load and shuffled, and ahead<VPL>() message rows are
//     loaded before the first of them is added: a short row costs about
//     one trip to memory after its pointers.  A warp owns kGroupRows
//     consecutive short rows and loads the next one's sources while it
//     sums the current one.  Where the run list outgrows half the rows
//     (the embedding packs, the TPU contract's packs), the runs are the
//     work, and a launch of 4-column vectors takes the variant
//     capped to kRunsMinBlocks blocks an SM (80 registers at D = 300, a
//     few spilled): the runs' loads need the warps more than the one-trip
//     path needs the registers.  Widths of at most kNarrowCols columns
//     (the edge convs' in-degree at width 1) take one thread a row or
//     run.
//
// The owner walk is K1's and K3's (row_walk.cuh) in its aims, not in its
// code: it keeps VPL vectors a lane in one pass (so a row's sources are
// loaded once at D = 300, where the row walk takes a pass a vector),
// reads a CSR pointer and leaves the long rows to the runs (the row
// walk takes [begin, end) pairs and walks hub rows in their warp), and
// has no coefficient.  ROADMAP queue B item 8 merges the two.
// Sums are f32 throughout, in position order within a row or run (bf16
// messages are widened exactly; the TPU kernel rounds bf16 group sums to
// bf16 before its matmul, this kernel does not).

#include <algorithm>

#include "common.cuh"

namespace {

using ggt::kGroupRows;
using ggt::kNarrowCols;
using ggt::kWarps;

constexpr int kOwnerSlots = 32;  // OWNER_SLOTS: the longest row at one
                                 // owner (ops/cuda/spmm_kernel.py)
constexpr int kGroupRuns = 16;   // GROUP_RUNS: a long row's runs added
                                 // group by group
constexpr int kRunsMinBlocks = 3;   // blocks an SM holds where runs dominate
constexpr int kMaxRunBlocks = 1056;  // the run warps stride over the list
                                     // (8 blocks an SM on 132 SMs)
constexpr unsigned kAll = 0xffffffffu;

template <int VB>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

__device__ __forceinline__ unsigned word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word(const uint2& r, int i) {
  return i == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }

// VB bytes of T: kN columns, loaded as one vector and added to f32
// sums (a bf16 value is the high half of its f32).
template <typename T, int VB>
struct Chunk {
  static constexpr int kN = VB / (int)sizeof(T);
  using R = typename Raw<VB>::type;

  __device__ __forceinline__ static R zero() { return R{}; }
  __device__ __forceinline__ static R load(const T* p) {
    return __ldg(reinterpret_cast<const R*>(p));
  }
  __device__ __forceinline__ static void add(const R& r, float (&acc)[kN]) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] += __uint_as_float(word(r, i));
    } else if constexpr (VB == 2) {
      acc[0] += __uint_as_float((unsigned)r << 16);
    } else {
#pragma unroll
      for (int i = 0; i < VB / 4; ++i) {
        const unsigned w = word(r, i);
        acc[2 * i] += __uint_as_float(w << 16);
        acc[2 * i + 1] += __uint_as_float(w & 0xffff0000u);
      }
    }
  }
};

// kN f32 columns: stored with the widest aligned vector, or loaded past
// L1 (partials another SM wrote).
template <int N>
__device__ __forceinline__ void store_cols(float* p, const float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int t = 0; t < N / 4; ++t)
      reinterpret_cast<float4*>(p)[t] =
          make_float4(a[4 * t], a[4 * t + 1], a[4 * t + 2], a[4 * t + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    p[0] = a[0];
  }
}

template <int N>
__device__ __forceinline__ void load_cols_cg(const float* p, float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int t = 0; t < N / 4; ++t) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + t);
      a[4 * t] = v.x;
      a[4 * t + 1] = v.y;
      a[4 * t + 2] = v.z;
      a[4 * t + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    a[0] = v.x;
    a[1] = v.y;
  } else {
    a[0] = __ldcg(p);
  }
}

// The source of position k (its own row without src), -1 past end.
__device__ __forceinline__ int source_of(const int* __restrict__ src,
                                         int k, int end) {
  return k < end ? (src ? src[k] : k) : -1;
}

// Messages a warp keeps in flight for VPL vectors a lane.
template <int VPL>
__host__ __device__ constexpr int ahead() {
  return VPL == 1 ? 8 : VPL == 2 ? 6 : VPL == 3 ? 4 : 3;
}

// Partials a warp keeps in flight when it adds a long row's runs, for
// COLS f32 columns a lane.
template <int COLS>
__host__ __device__ constexpr int combine_ahead() {
  return COLS >= 32 ? 1 : 32 / COLS;
}

// A warp's arrival at a counter that ``expected`` arrivals complete:
// its stores fenced first; true for the last to arrive, which then sees
// every earlier arrival's stores.
__device__ __forceinline__ bool warp_arrive(int* counter, int expected,
                                            int lane) {
  __threadfence();
  __syncwarp();
  int old = 0;
  if (lane == 0) old = atomicAdd(counter, 1);
  if (__shfl_sync(kAll, old, 0) != expected - 1) return false;
  __threadfence();
  return true;
}

// acc = the sum, in order, of the f32 partial rows p0, p0 + stride, ...
// (count of them), the lane's vectors v0 + lane + 32 v of each, read
// past L1 (other SMs wrote them), combine_ahead of them in flight.
template <int VPL, int kN>
__device__ __forceinline__ void warp_add_partials(
    const float* __restrict__ partial, int d, int nv, int v0, int lane,
    int p0, int count, int stride, float (&acc)[VPL][kN]) {
  constexpr int kAhead = combine_ahead<VPL * kN>();
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int t = 0; t < kN; ++t) acc[v][t] = 0.f;
  for (int i0 = 0; i0 < count; i0 += kAhead) {
    float x[kAhead][VPL][kN];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float* part = partial + (long long)(p0 + (i0 + i) * stride) * d;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vec = v0 + lane + 32 * v;
        if (i0 + i < count && vec < nv) {
          load_cols_cg<kN>(part + vec * kN, x[i][v]);
        } else {
#pragma unroll
          for (int t = 0; t < kN; ++t) x[i][v][t] = 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i0 + i >= count) continue;  // the same for the whole warp
#pragma unroll
      for (int v = 0; v < VPL; ++v)
#pragma unroll
        for (int t = 0; t < kN; ++t) acc[v][t] += x[i][v][t];
    }
  }
}

// One pass of a warp over positions [b, e): the vectors v0 + lane + 32 v
// (v < VPL, below nv) of each live message, added in position order to
// acc.  first_s is lane l's source of position b + l where have_first.
template <typename T, int VB, int VPL>
__device__ __forceinline__ void warp_sum(
    const T* __restrict__ msg, unsigned long long n_src, int d, int nv,
    int v0, const int* __restrict__ src, int b, int e, int first_s,
    bool have_first, int lane, float (&acc)[VPL][Chunk<T, VB>::kN]) {
  using C = Chunk<T, VB>;
  constexpr int kN = C::kN;
  constexpr int kAhead = ahead<VPL>();
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int t = 0; t < kN; ++t) acc[v][t] = 0.f;
  for (int k0 = b; k0 < e; k0 += 32) {
    const int nb = min(32, e - k0);
    const int my_s = (have_first && k0 == b)
                         ? first_s
                         : source_of(src, k0 + lane, k0 + nb);
    for (int i = 0; i < nb; i += kAhead) {
      typename C::R raw[kAhead][VPL];
      bool live[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int s = __shfl_sync(kAll, my_s, (i + j) & 31);
        live[j] = i + j < nb && (unsigned long long)(unsigned)s < n_src;
        const T* row = msg + (long long)s * d;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int vec = v0 + lane + 32 * v;
          raw[j][v] = (live[j] && vec < nv) ? C::load(row + vec * kN)
                                            : C::zero();
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        if (!live[j]) continue;  // the same for the whole warp
#pragma unroll
        for (int v = 0; v < VPL; ++v) C::add(raw[j][v], acc[v]);
      }
    }
  }
}

template <typename T, int VB, int VPL>
__device__ __forceinline__ void warp_store(float* __restrict__ row, int nv,
                                           int v0, int lane,
                                           const float (&acc)[VPL][
                                               Chunk<T, VB>::kN]) {
  constexpr int kN = Chunk<T, VB>::kN;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int vec = v0 + lane + 32 * v;
    if (vec < nv) store_cols<kN>(row + vec * kN, acc[v]);
  }
}

// Blocks [0, run_blocks) take a warp a run, the rest kGroupRows rows a
// warp.  MIN_BLOCKS: the blocks an SM must hold (registers capped to fit;
// see plan()).
template <typename T, int VB, int VPL, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * kWarps, MIN_BLOCKS)
segment_vec(const T* __restrict__ msg, unsigned long long n_src, int d,
            const int* __restrict__ src, const int* __restrict__ row_ptr,
            long long n_out, const int* __restrict__ run_row,
            const int* __restrict__ run_first,
            const int* __restrict__ run_len, long long n_runs,
            unsigned run_blocks, int* __restrict__ arrivals,
            float* __restrict__ partial, float* __restrict__ out) {
  using C = Chunk<T, VB>;
  constexpr int kN = C::kN;
  constexpr int kPass = 32 * VPL;  // vectors a warp covers in a pass
  const int nv = d / kN;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float acc[VPL][kN];
  if (blockIdx.x < run_blocks) {
    // the runs of the long rows, a warp a run, striding over the list
    const long long stride = (long long)run_blocks * kWarps;
    for (long long j = (long long)blockIdx.x * kWarps + warp; j < n_runs;
         j += stride) {
      const int row = run_row[j];
      if (row < 0) return;  // past the last run
      const int first = run_first[j];
      const int len = run_len[j];
      const int rb = row_ptr[row];
      const int re = row_ptr[row + 1];
      const int b = rb + (int)(j - first) * len;
      const int e = min(b + len, re);
      const int nruns = (re - rb + len - 1) / len;
      for (int v0 = 0; v0 < nv; v0 += kPass) {
        warp_sum<T, VB, VPL>(msg, n_src, d, nv, v0, src, b, e, 0, false,
                             lane, acc);
        warp_store<T, VB, VPL>(partial + j * d, nv, v0, lane, acc);
      }
      // the last run of its group adds the group's partials; the last
      // group of the row adds the groups' sums and writes the row
      const int g0 = first + (int)(j - first) / kGroupRuns * kGroupRuns;
      const int in_group = min(kGroupRuns, nruns - (g0 - first));
      const int groups = (nruns + kGroupRuns - 1) / kGroupRuns;
      if (!warp_arrive(arrivals + g0, in_group, lane)) continue;
      if (lane == 0) arrivals[g0] = 0;  // ready for the next launch
      float* dst = groups == 1 ? out + (long long)row * d
                               : partial + (long long)g0 * d;
      for (int v0 = 0; v0 < nv; v0 += kPass) {
        warp_add_partials<VPL, kN>(partial, d, nv, v0, lane, g0, in_group,
                                   1, acc);
        warp_store<T, VB, VPL>(dst, nv, v0, lane, acc);
      }
      if (groups == 1) continue;
      // the row's counter: its second run's entry, no group's first
      if (!warp_arrive(arrivals + first + 1, groups, lane)) continue;
      if (lane == 0) arrivals[first + 1] = 0;
      for (int v0 = 0; v0 < nv; v0 += kPass) {
        warp_add_partials<VPL, kN>(partial, d, nv, v0, lane, first, groups,
                                   kGroupRuns, acc);
        warp_store<T, VB, VPL>(out + (long long)row * d, nv, v0, lane, acc);
      }
    }
    return;
  }
  // kGroupRows consecutive rows: their pointers in one load, the next
  // row's first batch of sources loaded while the current row is summed
  const long long row0 =
      ((long long)(blockIdx.x - run_blocks) * kWarps + warp) * kGroupRows;
  if (row0 >= n_out) return;
  int ptr = 0;
  if (lane <= kGroupRows && row0 + lane <= n_out) ptr = row_ptr[row0 + lane];
  auto first_batch = [&](int r) {
    const int b = __shfl_sync(kAll, ptr, r);
    const int e = __shfl_sync(kAll, ptr, r + 1);
    return (e - b <= kOwnerSlots && row0 + r < n_out)
               ? source_of(src, b + lane, min(e, b + 32))
               : -1;
  };
  int next_s = first_batch(0);
#pragma unroll 1
  for (int r = 0; r < kGroupRows; ++r) {
    const long long row = row0 + r;
    if (row >= n_out) break;
    const int b = __shfl_sync(kAll, ptr, r);
    const int e = __shfl_sync(kAll, ptr, r + 1);
    const int first_s = next_s;
    if (r + 1 < kGroupRows) next_s = first_batch(r + 1);
    if (e - b > kOwnerSlots) continue;  // a long row: its runs write it
    for (int v0 = 0; v0 < nv; v0 += kPass) {
      warp_sum<T, VB, VPL>(msg, n_src, d, nv, v0, src, b, e, first_s,
                           v0 == 0, lane, acc);
      warp_store<T, VB, VPL>(out + row * d, nv, v0, lane, acc);
    }
  }
}

// acc = the sum, in order, of the f32 partial rows p0, p0 + stride, ...
// (count of them), d <= NC columns, 8 of them in flight.
template <int NC>
__device__ __forceinline__ void thread_add_partials(
    const float* __restrict__ partial, int d, int p0, int count,
    int stride, float (&acc)[NC]) {
  constexpr int kAhead = 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int i0 = 0; i0 < count; i0 += kAhead) {
    float x[kAhead][NC];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        x[i][c] = i0 + i < count && c < d
                      ? __ldcg(partial +
                               (long long)(p0 + (i0 + i) * stride) * d + c)
                      : 0.f;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i0 + i >= count) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += x[i][c];
    }
  }
}

// acc = the sum of msg's rows src[k] (k in [b, e), none skipped), d <= NC
// columns, kAhead positions loaded before their adds.
template <typename T, int NC>
__device__ __forceinline__ void thread_sum(const T* __restrict__ msg,
                                           unsigned long long n_src, int d,
                                           const int* __restrict__ src,
                                           int b, int e, float (&acc)[NC]) {
  constexpr int kAhead = NC == 1 ? 16 : 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int k0 = b; k0 < e; k0 += kAhead) {
    int s[kAhead];
    float x[kAhead][NC];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) s[j] = source_of(src, k0 + j, e);
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool live = (unsigned long long)(unsigned)s[j] < n_src;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        x[j][c] = live && c < d ? ggt::to_float(msg[(long long)s[j] * d + c])
                                : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if ((unsigned long long)(unsigned)s[j] >= n_src) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += x[j][c];
    }
  }
}

// d <= kNarrowCols: a thread a run (blocks [0, run_blocks), striding
// over the run list) or a row.
template <typename T, int NC>
__global__ void __launch_bounds__(32 * kWarps)
segment_narrow(const T* __restrict__ msg, unsigned long long n_src, int d,
               const int* __restrict__ src, const int* __restrict__ row_ptr,
               long long n_out, const int* __restrict__ run_row,
               const int* __restrict__ run_first,
               const int* __restrict__ run_len, long long n_runs,
               unsigned run_blocks, int* __restrict__ arrivals,
               float* __restrict__ partial, float* __restrict__ out) {
  float acc[NC];
  if (blockIdx.x >= run_blocks) {
    const long long r =
        (long long)(blockIdx.x - run_blocks) * blockDim.x + threadIdx.x;
    if (r >= n_out) return;
    const int b = row_ptr[r];
    const int e = row_ptr[r + 1];
    if (e - b > kOwnerSlots) return;  // a long row: its runs write it
    thread_sum<T, NC>(msg, n_src, d, src, b, e, acc);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < d) out[r * d + c] = acc[c];
    return;
  }
  const long long stride = (long long)run_blocks * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_runs; t += stride) {
    const int row = run_row[t];
    if (row < 0) return;  // past the last run
    const int first = run_first[t];
    const int len = run_len[t];
    const int rb = row_ptr[row];
    const int re = row_ptr[row + 1];
    const int b = rb + (int)(t - first) * len;
    const int nruns = (re - rb + len - 1) / len;
    thread_sum<T, NC>(msg, n_src, d, src, b, min(b + len, re), acc);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < d) partial[t * d + c] = acc[c];
    // groups of kGroupRuns runs, then the row, as the vector path
    const int g0 = first + (int)(t - first) / kGroupRuns * kGroupRuns;
    const int in_group = min(kGroupRuns, nruns - (g0 - first));
    const int groups = (nruns + kGroupRuns - 1) / kGroupRuns;
    __threadfence();
    if (atomicAdd(arrivals + g0, 1) != in_group - 1) continue;
    __threadfence();
    arrivals[g0] = 0;
    thread_add_partials<NC>(partial, d, g0, in_group, 1, acc);
    float* dst = groups == 1 ? out + (long long)row * d
                             : partial + (long long)g0 * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < d) dst[c] = acc[c];
    if (groups == 1) continue;
    __threadfence();
    if (atomicAdd(arrivals + first + 1, 1) != groups - 1) continue;
    __threadfence();
    arrivals[first + 1] = 0;
    thread_add_partials<NC>(partial, d, first, groups, kGroupRuns, acc);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < d) out[(long long)row * d + c] = acc[c];
  }
}

// An empty kernel: launched over K2's grid, its time is the floor under
// K2's.
__global__ void empty_segment() {}

// The launch K2 takes for these arguments: the path (0 narrow, else the
// vector bytes), the vectors a lane, and the blocks.
struct Plan {
  int vb = 0;  // 0: the narrow path
  int vpl = 0;
  bool runs_heavy = false;  // the run list outgrows half the rows
  unsigned run_blocks = 0;
  unsigned blocks = 0;
};

template <typename T>
Plan plan(const T* msg, int d, long long n_out, long long n_runs) {
  Plan p;
  const int threads = 32 * kWarps;
  if (d > kNarrowCols) {
    // vectors of 4 columns where the row and msg allow them (every
    // width on the port's paths), else of one column, 4 a lane
    const int quad = 4 * (int)sizeof(T);
    const bool vec = d % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(msg) % quad == 0;
    p.vb = vec ? quad : (int)sizeof(T);
    p.vpl = vec ? std::min(4, (d / 4 + 31) / 32) : 4;
    p.run_blocks = (unsigned)std::min<long long>(
        kMaxRunBlocks, (n_runs + kWarps - 1) / kWarps);
    // n_runs ~ P / 10.8 for P positions (segment_runs_bound): rows
    // averaging over ~5 positions (the embedding packs, the TPU
    // contract's packs) are mostly runs, and take the variant with
    // kRunsMinBlocks blocks an SM
    p.runs_heavy = vec && 2 * n_runs > n_out;
    const long long rows = (long long)kWarps * kGroupRows;
    p.blocks = p.run_blocks + (unsigned)((n_out + rows - 1) / rows);
  } else {
    p.run_blocks = (unsigned)std::min<long long>(
        kMaxRunBlocks, (n_runs + threads - 1) / threads);
    p.blocks = p.run_blocks + (unsigned)((n_out + threads - 1) / threads);
  }
  return p;
}

template <typename T>
int launch(const T* msg, long long n_src, int d, const int* src,
           const int* row_ptr, long long n_out, const int* run_row,
           const int* run_first, const int* run_len, long long n_runs,
           int* arrivals, float* partial, float* out, cudaStream_t st) {
  const Plan p = plan(msg, d, n_out, n_runs);
  if (p.blocks == 0) return (int)cudaGetLastError();
  const unsigned long long ns = (unsigned long long)n_src;
  const int threads = 32 * kWarps;
  constexpr int kQuad = 4 * (int)sizeof(T);
#define GGT_SEGMENT_ARGS                                                   \
  msg, ns, d, src, row_ptr, n_out, run_row, run_first, run_len, n_runs,    \
      p.run_blocks, arrivals, partial, out
#define GGT_SEGMENT_QUAD(VPL)                                              \
  if (p.runs_heavy) {                                                      \
    segment_vec<T, kQuad, VPL, kRunsMinBlocks>                             \
        <<<p.blocks, threads, 0, st>>>(GGT_SEGMENT_ARGS);                  \
  } else {                                                                 \
    segment_vec<T, kQuad, VPL, 1>                                          \
        <<<p.blocks, threads, 0, st>>>(GGT_SEGMENT_ARGS);                  \
  }
  if (p.vb == 0 && d == 1) {
    segment_narrow<T, 1><<<p.blocks, threads, 0, st>>>(GGT_SEGMENT_ARGS);
  } else if (p.vb == 0) {
    segment_narrow<T, kNarrowCols>
        <<<p.blocks, threads, 0, st>>>(GGT_SEGMENT_ARGS);
  } else if (p.vb == (int)sizeof(T)) {
    segment_vec<T, (int)sizeof(T), 4, 1>
        <<<p.blocks, threads, 0, st>>>(GGT_SEGMENT_ARGS);
  } else if (p.vpl == 1) {
    GGT_SEGMENT_QUAD(1)
  } else if (p.vpl == 2) {
    GGT_SEGMENT_QUAD(2)
  } else if (p.vpl == 3) {
    GGT_SEGMENT_QUAD(3)
  } else {
    GGT_SEGMENT_QUAD(4)
  }
#undef GGT_SEGMENT_QUAD
#undef GGT_SEGMENT_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_floor(const T* msg, int d, long long n_out, long long n_runs,
                 cudaStream_t st) {
  const Plan p = plan(msg, d, n_out, n_runs);
  if (p.blocks > 0) empty_segment<<<p.blocks, 32 * kWarps, 0, st>>>();
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  msg is [n_src, d] row-major;
// src [P] int32 or null (position p reads msg row p); row_ptr [n_out + 1]
// int32; run_row / run_first / run_len / arrivals [n_runs] int32
// (arrivals zero); partial [n_runs, d] f32 scratch; out [n_out, d] f32.
// Returns cudaGetLastError() after the launch.
#define GGT_SEGMENT_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* msg, long long n_src, int d,              \
                      const void* src, const void* row_ptr, long long n_out, \
                      const void* run_row, const void* run_first,           \
                      const void* run_len, long long n_runs,                \
                      void* arrivals, void* partial, void* out,             \
                      void* stream) {                                       \
    return launch<T>((const T*)msg, n_src, d, (const int*)src,              \
                     (const int*)row_ptr, n_out, (const int*)run_row,       \
                     (const int*)run_first, (const int*)run_len, n_runs,    \
                     (int*)arrivals, (float*)partial, (float*)out,          \
                     (cudaStream_t)stream);                                 \
  }
GGT_SEGMENT_ENTRY(packed_segment_f32, float)
GGT_SEGMENT_ENTRY(packed_segment_bf16, __nv_bfloat16)
#undef GGT_SEGMENT_ENTRY

// The launch floor under packed_segment_f32 / _bf16, for measurement: the
// same arguments, an empty kernel over the grid that call would take.
#define GGT_SEGMENT_FLOOR(NAME, T)                                          \
  extern "C" int NAME(const void* msg, long long, int d, const void*,       \
                      const void*, long long n_out, const void*,            \
                      const void*, const void*, long long n_runs, void*,    \
                      void*, void*, void* stream) {                         \
    return launch_floor<T>((const T*)msg, d, n_out, n_runs,                 \
                           (cudaStream_t)stream);                           \
  }
GGT_SEGMENT_FLOOR(packed_segment_floor_f32, float)
GGT_SEGMENT_FLOOR(packed_segment_floor_bf16, __nv_bfloat16)
#undef GGT_SEGMENT_FLOOR
