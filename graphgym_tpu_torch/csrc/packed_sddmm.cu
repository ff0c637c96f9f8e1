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
// heads] f32, with row(s) = tiles[s / chunk] * 128 + local_rows[s], the
// pack's own row of the slot.
//
// Bound: bytes.  a and b read once each (b's rows are reread once per
// in-edge, mostly from L2), 8 bytes of sender and weight per slot read,
// 4*heads bytes written per slot; two flops per slot and column.  (The
// kernel reads 12 bytes of every slot, its local row as well, padding
// included: the price of needing no row ranges.)
//
// Design: a run of slots per owner.  Each slot's output is a dot
// product of its own; nothing is summed across a row.  So the unit of
// work is a run of kRun consecutive slots of one chunk, not a row: every
// owner gets the same number of slots, and a row of thousands of slots
// (a hub) is spread over as many owners as it has runs instead of
// holding one warp while the grid has finished.  Every slot of the
// layout lies in exactly one run, so each owner writes its own run's
// outputs and nothing else is left to zero.  An owner loads its run's
// senders, weights and local rows in one coalesced load, one field set
// per lane.  A run with no slot of nonzero weight (the padding tail of
// the last tile, the bucket-padding chunks) only writes its zeros, with
// streaming stores.
//
// Vector path (the row at most one pass of LANES lanes of 16 bytes, a
// power-of-two number of heads, each head's width a power-of-two number, at
// least 4, of lane vectors): an owner is a group of LANES lanes, lane l
// holding columns [l*VW, (l+1)*VW).  It walks its run kFlight slots at a
// time: the b[sender] rows of all kFlight slots are loaded (16 bytes a lane)
// before any is used, and a[row] is loaded only where a slot's row differs
// from the slot before it (rows ascend within a chunk: on short rows once
// per row, on a hub once per run, from L2).  Slots of weight 0 load nothing.
// The depth comes from occupancy, not from each owner: 8 or 16 rows in
// flight from registers (80-180 registers a thread) measured slower than 4
// on every pack on an H100, and capping the registers at 48 (kMinBlocks
// blocks an SM) faster than leaving them at ~60; runs of 16 slots beat 8 and
// 32 except on the smallest packs (8) and ba's (32).  Each lane sums its VW
// products per slot in column order; the lanes of each head add the partial
// sums of four slots at once in a fixed tree of __shfl_xor_sync (reduce4: 6
// shuffles for the four, where a butterfly per slot takes 20), one more
// shuffle hands each lane its slot's and head's result, and each batch of
// min(LANES / heads, kRun) slots goes out in one coalesced store.  The
// per-lane column order and the tree are those of a row-owner walk, so every
// output is the same float whichever slots share a run.  Scalar path (any
// other shape): a warp a run, slot by slot, lanes strided over each head's
// columns and a butterfly over the warp.  No atomics; launches are bitwise
// repeatable.
//
// Padding: a sender outside [0, n_rows) reads as zero.

#include "common.cuh"

namespace {

using ggt::kWarps;
using ggt::to_float;

constexpr int kChunk = 1024;    // slots of a chunk (EDGES_PER_CHUNK)
constexpr int kTileRows = 128;  // rows of a tile (ROWS_PER_TILE)
constexpr int kRun = 16;       // slots of a run
constexpr int kFlight = 4;     // b rows an owner has in flight
constexpr int kMinBlocks = 5;  // blocks an SM holds on the vector path
                               // (registers: at most 48 a thread)
static_assert(kChunk % kRun == 0, "a run lies in one chunk");
static_assert(kFlight % 4 == 0 && kRun % kFlight == 0,
              "reduce4 sums four slots at a time; rounds tile the run");

// A run's slots as LANES lanes hold them after the run's one load: the
// slot m * LANES + lane in field m.  sender is -1 where the slot takes
// no product (weight 0, a padding sender or a row past the last).
template <int LANES>
struct Run {
  static constexpr int kFields = (kRun + LANES - 1) / LANES;
  int sender[kFields];
  int row[kFields];
  bool any;  // some slot of this lane's takes a product

  __device__ __forceinline__ Run(const int* __restrict__ senders,
                                 const float* __restrict__ weights,
                                 const int* __restrict__ local_rows,
                                 int tile, long long s0, long long n_rows,
                                 int lane) {
    any = false;
#pragma unroll
    for (int m = 0; m < kFields; ++m) {
      const int i = m * LANES + lane;
      sender[m] = row[m] = -1;
      if (i < kRun) {
        const int s = senders[s0 + i];
        const long long r =
            (long long)tile * kTileRows + local_rows[s0 + i];
        if (weights[s0 + i] != 0.f && s >= 0 && s < n_rows && r < n_rows) {
          sender[m] = s;
          row[m] = (int)r;
          any = true;
        }
      }
    }
  }
};

// The run's R x heads outputs, all 0: streaming stores.
template <int LANES>
__device__ __forceinline__ void zero_run(float* __restrict__ o, int heads,
                                         int lane) {
  for (int z = lane; z < kRun * heads; z += LANES) __stcs(o + z, 0.f);
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
                    const int* __restrict__ local_rows,
                    const int* __restrict__ tiles, long long n_runs,
                    float* __restrict__ out) {
  const long long run = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (run >= n_runs) return;
  const int lane = threadIdx.x % 32;
  const long long s0 = run * kRun;
  const Run<32> slots(senders, weights, local_rows, tiles[s0 / kChunk], s0,
                      n_rows, lane);
  float* o = out + s0 * heads;
  if (!__any_sync(0xffffffffu, slots.any)) {
    zero_run<32>(o, heads, lane);
    return;
  }
  const int dv = d / heads;
#pragma unroll
  for (int m = 0; m < Run<32>::kFields; ++m) {
#pragma unroll 1
    for (int i = 0; i < 32 && m * 32 + i < kRun; ++i) {
      const int s = __shfl_sync(0xffffffffu, slots.sender[m], i);
      const int r = __shfl_sync(0xffffffffu, slots.row[m], i);
      const T* ar = a + (long long)(s >= 0 ? r : 0) * d;
      const T* bs = b + (long long)(s >= 0 ? s : 0) * d;
      for (int h = 0; h < heads; ++h) {
        float p = 0.f;
        if (s >= 0)
          for (int c = h * dv + lane; c < (h + 1) * dv; c += 32)
            p += __fmul_rn(to_float(ar[c]), to_float(bs[c]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) o[(m * 32 + i) * heads + h] = p;
      }
    }
  }
}

template <typename T, int LANES, bool ONE_HEAD>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
packed_sddmm_vec(const T* __restrict__ a, const T* __restrict__ b,
                 long long n_rows, int d, int heads_arg,
                 const int* __restrict__ senders,
                 const float* __restrict__ weights,
                 const int* __restrict__ local_rows,
                 const int* __restrict__ tiles, long long n_runs,
                 float* __restrict__ out) {
  constexpr int VW = ggt::Vec<T>::kN;
  const int heads = ONE_HEAD ? 1 : heads_arg;
  const long long run = ggt::group_index<LANES>();
  if (run >= n_runs) return;  // the whole group: one run a group
  const int lane = threadIdx.x % LANES;
  const unsigned mask = ggt::group_mask<LANES>();
  const long long s0 = run * kRun;
  const Run<LANES> slots(senders, weights, local_rows, tiles[s0 / kChunk],
                         s0, n_rows, lane);
  float* o = out + s0 * heads;
  if (!__any_sync(mask, slots.any)) {
    zero_run<LANES>(o, heads, lane);
    return;
  }
  const int col = lane * VW;  // the row is one pass of the group
  const bool has_col = col < d;
  const int group = d / heads / VW;  // lanes of one head, a power of two
  // slots of a stored batch: lane l takes slot l / heads, head l % heads
  const int per_batch = min(LANES / heads, kRun);
  const int my_slot = lane / heads, my_head = lane % heads;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int cur_row = -1;
  uint4 cur_a = zero;
  float mine = 0.f;
#pragma unroll
  for (int i0 = 0; i0 < kRun; i0 += kFlight) {
    int s[kFlight];
    uint4 raw[kFlight], ra[kFlight];
#pragma unroll
    for (int j = 0; j < kFlight; ++j) {
      const int i = i0 + j;
      s[j] = __shfl_sync(mask, slots.sender[i / LANES], i % LANES, LANES);
      const int r = __shfl_sync(mask, slots.row[i / LANES], i % LANES, LANES);
      raw[j] = (s[j] >= 0 && has_col)
                   ? ggt::load16(b + (long long)s[j] * d + col)
                   : zero;
      if (s[j] >= 0 && r != cur_row) {  // a[row] only where the row changes
        cur_row = r;
        cur_a = has_col ? ggt::load16(a + (long long)r * d + col) : zero;
      }
      ra[j] = cur_a;
    }
#pragma unroll
    for (int q = 0; q < kFlight; q += 4) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = 0.f;
        if (s[q + j] < 0) continue;
        float x[VW], y[VW];
        ggt::Vec<T>::unpack(ra[q + j], x);
        ggt::Vec<T>::unpack(raw[q + j], y);
#pragma unroll
        for (int t = 0; t < VW; ++t) p[j] += __fmul_rn(x[t], y[t]);
      }
      const float sum = reduce4<LANES>(p, group, lane, mask);
      // slot i + j's sum of head h sits in lane h * group + (j / 2) *
      // group / 2 + (j % 2) * group / 4; lane l takes its own
      const int i = i0 + q;
      const int j = my_slot - i % per_batch;
      const float got = __shfl_sync(
          mask, sum,
          my_head * group + (j >> 1) * (group / 2) + (j & 1) * (group / 4),
          LANES);
      if (j >= 0 && j < 4) mine = got;
      if ((i + 4) % per_batch == 0 && lane < per_batch * heads)
        o[(i + 4 - per_batch) * heads + lane] = mine;  // the batch is done
    }
  }
}

// Lanes of an owner on the vector path for these arguments (the fewest,
// 16 or 32, whose one pass spans the row), 0 for the scalar path.
template <typename T>
int vector_lanes(const T* a, const T* b, int d, int heads) {
  constexpr int VW = ggt::Vec<T>::kN;
  const int dv = d / heads;
  const int group = dv / VW;
  const bool vec = dv % VW == 0 && group >= 4 &&
                   (group & (group - 1)) == 0 &&
                   (heads & (heads - 1)) == 0 && ggt::aligned16(a) &&
                   ggt::aligned16(b) && d <= 32 * VW;
  return vec ? (d <= 16 * VW ? 16 : 32) : 0;
}

// Blocks of the launch over n_runs runs with owners of `lanes` lanes (0:
// a warp, the scalar path).
unsigned run_blocks(int lanes, long long n_runs) {
  const long long owners = 32 * kWarps / (lanes ? lanes : 32);
  return (unsigned)((n_runs + owners - 1) / owners);
}

template <typename T>
int launch(const T* a, const T* b, long long n_rows, int d, int heads,
           const int* senders, const float* weights, const int* local_rows,
           const int* tiles, long long n_slots, float* out, void* stream) {
  if (n_slots % kChunk != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_runs = n_slots / kRun;
  const int lanes = vector_lanes(a, b, d, heads);
  const unsigned blocks = run_blocks(lanes, n_runs);
  if (lanes == 16 && heads == 1) {
    packed_sddmm_vec<T, 16, true><<<blocks, 32 * kWarps, 0, st>>>(
        a, b, n_rows, d, heads, senders, weights, local_rows, tiles, n_runs,
        out);
  } else if (lanes == 16) {
    packed_sddmm_vec<T, 16, false><<<blocks, 32 * kWarps, 0, st>>>(
        a, b, n_rows, d, heads, senders, weights, local_rows, tiles, n_runs,
        out);
  } else if (lanes == 32 && heads == 1) {
    packed_sddmm_vec<T, 32, true><<<blocks, 32 * kWarps, 0, st>>>(
        a, b, n_rows, d, heads, senders, weights, local_rows, tiles, n_runs,
        out);
  } else if (lanes == 32) {
    packed_sddmm_vec<T, 32, false><<<blocks, 32 * kWarps, 0, st>>>(
        a, b, n_rows, d, heads, senders, weights, local_rows, tiles, n_runs,
        out);
  } else {
    packed_sddmm_scalar<T><<<blocks, 32 * kWarps, 0, st>>>(
        a, b, n_rows, d, heads, senders, weights, local_rows, tiles, n_runs,
        out);
  }
  return (int)cudaGetLastError();
}

// An empty kernel: launched over the SDDMM's grid, its time is the floor
// under any kernel of that grid.
__global__ void __launch_bounds__(32 * kWarps) empty_runs() {}

template <typename T>
int launch_floor(const T* a, const T* b, int d, int heads, long long n_slots,
                 void* stream) {
  if (n_slots % kChunk != 0) return (int)cudaErrorInvalidValue;
  empty_runs<<<run_blocks(vector_lanes(a, b, d, heads), n_slots / kRun),
               32 * kWarps, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  a and b are [n_rows, d]
// row-major with d = heads * dv, senders, weights and local_rows the
// pack's [num_chunks, chunk] arrays (n_slots slots, a multiple of the
// chunk), tiles its [num_chunks], out [n_slots, heads] f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int packed_sddmm_f32(const void* a, const void* b,
                                long long n_rows, int d, int heads,
                                const void* senders, const void* weights,
                                const void* local_rows, const void* tiles,
                                long long n_slots, void* out, void* stream) {
  return launch<float>((const float*)a, (const float*)b, n_rows, d, heads,
                       (const int*)senders, (const float*)weights,
                       (const int*)local_rows, (const int*)tiles, n_slots,
                       (float*)out, stream);
}

extern "C" int packed_sddmm_bf16(const void* a, const void* b,
                                 long long n_rows, int d, int heads,
                                 const void* senders, const void* weights,
                                 const void* local_rows, const void* tiles,
                                 long long n_slots, void* out, void* stream) {
  return launch<__nv_bfloat16>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, n_rows, d, heads,
      (const int*)senders, (const float*)weights, (const int*)local_rows,
      (const int*)tiles, n_slots, (float*)out, stream);
}

// The launch floor under packed_sddmm_f32 / _bf16, for measurement: the
// same arguments, an empty kernel over the grid that call takes.
extern "C" int packed_sddmm_floor_f32(const void* a, const void* b,
                                      long long, int d, int heads,
                                      const void*, const void*, const void*,
                                      const void*, long long n_slots, void*,
                                      void* stream) {
  return launch_floor<float>((const float*)a, (const float*)b, d, heads,
                             n_slots, stream);
}

extern "C" int packed_sddmm_floor_bf16(const void* a, const void* b,
                                       long long, int d, int heads,
                                       const void*, const void*,
                                       const void*, const void*,
                                       long long n_slots, void*,
                                       void* stream) {
  return launch_floor<__nv_bfloat16>((const __nv_bfloat16*)a,
                                     (const __nv_bfloat16*)b, d, heads,
                                     n_slots, stream);
}
