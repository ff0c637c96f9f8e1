// Host pack builder of the port's loader.
//
// The port's own copy of the chunk packer of the JAX package's native
// library (graphgym_tpu/native/graph_native.cpp:181-275), extended to
// the port's PackedCSR (graphgym_tpu_torch/ops/cuda/spmm_kernel.py):
// besides the four chunk arrays it writes each row's slot range
// (row_range), the slot of every input edge (the attention packs' slot
// map), padding slots that read the row after a rectangular pack's
// senders (num_senders), and the padded chunk count in one pass.
//
// The layout is the numpy pack_csr_with_slots's, array for array:
// edges ordered by (receiver, sender), ties in input order, each row's
// span padded to a multiple of G slots that keep its local row, the
// rows of an R-row tile laid out one after another over the tile's
// C-slot chunks, every tile at least one chunk.  The order comes from
// two stable counting sorts (by sender, then by receiver), O(E + N).
// The JAX package's packer sorts each row by sender with std::sort,
// which does not keep the input order of repeated edges; a row's sum
// order, and so the port's bitwise repeat, depends on it.
//
// A plain C ABI bound with ctypes; no call keeps state or allocates
// what it returns (the caller passes every output buffer).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// The pack's chunk count before padding; -1 if a receiver lies outside
// [0, num_rows).
int64_t pack_count(int64_t num_rows, int64_t e, const int32_t* receivers,
                   int64_t R, int64_t C, int64_t G) {
  std::vector<int64_t> deg(num_rows, 0);
  for (int64_t i = 0; i < e; ++i) {
    int32_t r = receivers[i];
    if (r < 0 || r >= num_rows) return -1;
    deg[r]++;
  }
  int64_t num_tiles = (num_rows + R - 1) / R, nc = 0;
  for (int64_t t = 0; t < num_tiles; ++t) {
    int64_t slots = 0, hi = std::min(num_rows, (t + 1) * R);
    for (int64_t r = t * R; r < hi; ++r) slots += (deg[r] + G - 1) / G * G;
    int64_t k = (slots + C - 1) / C;
    nc += k > 0 ? k : 1;
  }
  return nc;
}

// Fill a pack of nc_out >= nc chunks (nc from pack_count): senders,
// weights, local rows [nc_out * C], tiles [nc_out], row_range
// [num_rows * 2] and, when edge_slot is not null, the flat slot of each
// input edge [e] (int32: a pack's slots stay below 2^31).  Every slot is written once: a row's edges, its group
// padding (local row kept, weight 0, sender num_senders), then the rest
// of its tile's last chunk and the chunks past nc as no-op padding
// (sender num_senders, weight 0, local row 0; the padding chunks the
// last tile).  Returns 0, or 1 for a negative sender, 2 for a receiver
// outside [0, num_rows), 3 when the layout needs more than nc_out
// chunks.
int pack_fill(int64_t num_rows, int64_t num_senders, int64_t e,
              const int32_t* senders, const int32_t* receivers,
              const float* weights, int64_t R, int64_t C, int64_t G,
              int64_t nc_out, int32_t* out_senders, float* out_weights,
              int32_t* out_local, int32_t* out_tiles, int32_t* row_range,
              int32_t* edge_slot) {
  // scratch kept per thread across calls: a loader builds packs of one
  // size every epoch, and fresh pages would cost more than the sorts
  thread_local std::vector<int32_t> cursor, by_sender, order, first;
  int64_t smax = -1;
  for (int64_t i = 0; i < e; ++i) {
    if (senders[i] < 0) return 1;
    smax = std::max<int64_t>(smax, senders[i]);
  }
  // stable counting sort by sender ...
  cursor.assign(smax + 2, 0);
  for (int64_t i = 0; i < e; ++i) cursor[senders[i] + 1]++;
  for (int64_t s = 0; s <= smax; ++s) cursor[s + 1] += cursor[s];
  by_sender.resize(e);
  for (int64_t i = 0; i < e; ++i) by_sender[cursor[senders[i]]++] = (int32_t)i;
  // ... then by receiver: (receiver, sender, input position) order
  first.assign(num_rows + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (receivers[i] < 0 || receivers[i] >= num_rows) return 2;
    first[receivers[i] + 1]++;
  }
  for (int64_t r = 0; r < num_rows; ++r) first[r + 1] += first[r];
  cursor.assign(first.begin(), first.end() - 1);
  order.resize(e);
  for (int64_t j = 0; j < e; ++j) {
    int32_t i = by_sender[j];
    order[cursor[receivers[i]]++] = i;
  }

  const int32_t pad_sender = (int32_t)num_senders;
  auto pad = [&](int64_t lo, int64_t hi, int32_t local) {
    std::fill(out_senders + lo, out_senders + hi, pad_sender);
    std::fill(out_weights + lo, out_weights + hi, 0.0f);
    std::fill(out_local + lo, out_local + hi, local);
  };
  int64_t num_tiles = (num_rows + R - 1) / R, chunk = 0;
  for (int64_t t = 0; t < num_tiles; ++t) {
    int64_t lo = t * R, hi = std::min(num_rows, lo + R), off = 0;
    for (int64_t r = lo; r < hi; ++r) {
      int64_t start = chunk * C + off, end = start;
      int64_t deg = first[r + 1] - first[r];
      int64_t padded = (deg + G - 1) / G * G;
      if (start + padded > nc_out * C) return 3;
      int32_t local = (int32_t)(r - lo);
      const int32_t* row = order.data() + first[r];
      for (int64_t k = 0; k < deg; ++k) {
        int64_t i = row[k], slot = start + k;
        out_senders[slot] = senders[i];
        out_weights[slot] = weights[i];
        out_local[slot] = local;
        if (edge_slot) edge_slot[i] = (int32_t)slot;
        // the range stops after the row's last slot of nonzero weight
        if (weights[i] != 0.0f) end = slot + 1;
      }
      pad(start + deg, start + padded, local);
      row_range[2 * r] = (int32_t)start;
      row_range[2 * r + 1] = (int32_t)end;
      off += padded;
    }
    int64_t k = std::max<int64_t>((off + C - 1) / C, 1);
    if (chunk + k > nc_out) return 3;
    pad(chunk * C + off, (chunk + k) * C, 0);
    std::fill(out_tiles + chunk, out_tiles + chunk + k, (int32_t)t);
    chunk += k;
  }
  pad(chunk * C, nc_out * C, 0);
  std::fill(out_tiles + chunk, out_tiles + nc_out, (int32_t)(num_tiles - 1));
  return 0;
}

// out[0:n] = fill, then out[index[i]] = values[i] for each i < e: the
// attention packs' slot map from the bwd and fwd packs' edge slots.
// Returns 0, or 1 for an index outside [0, n).
int scatter_i32(int64_t n, int32_t fill, int64_t e, const int32_t* index,
                const int32_t* values, int32_t* out) {
  std::fill(out, out + n, fill);
  for (int64_t i = 0; i < e; ++i) {
    if (index[i] < 0 || index[i] >= n) return 1;
    out[index[i]] = values[i];
  }
  return 0;
}

}  // extern "C"
