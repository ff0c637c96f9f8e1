// Host pack builder of the port's loader, and the graph statistics of
// its data pipeline (hop distances, triangle counts).
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
// The statistics (multi_bfs, triangle_counts) are the port's own copies
// of the JAX package's multi_bfs and of the triangle count inside its
// clustering_coeff (graphgym_tpu/native/graph_native.cpp:276-316,
// :40-82), on one thread.  Each returns integers only (hop distances,
// triangle counts): every float operation of the statistics built on
// them stays in data/structure.py, in the numpy plain versions' order.
//
// The ego-net union (ego_sizes, ego_fill) and Brandes' betweenness
// (betweenness) are the port's counterparts of the JAX package's
// (graphgym_tpu/native/graph_native.cpp:114-180, :318-377), written to
// the port's plain versions rather than to the JAX code's order: the
// union is data/transforms.py's numpy ego_nets array for array, and
// the betweenness sums are data/structure.py's Python loop's, in its
// order, whatever the thread count.
//
// A plain C ABI bound with ctypes; no call keeps state or allocates
// what it returns (the caller passes every output buffer).

#include <algorithm>
#include <cstdint>
#include <thread>
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

// Hop distances from each source over a CSR (row u: the receivers of
// u's edges): out[si * n + v] the distance from sources[si] to v, -1
// where unreached.  With max_dist >= 0 a node at max_dist is reached
// but not expanded (the numpy plain version's levels); max_dist < 0
// sets no cap.  Returns 0, or 1 for a source outside [0, n), 2 for a
// neighbour outside [0, n).
//
// The distances of the JAX package's queue BFS, found 64 sources at a
// time, level by level: bit b of a node's word is source b of the
// block.  A level ORs each frontier word into the node's neighbours;
// the bits a node had not seen are its sources at this distance.  A
// queue BFS per source spends its time on a branch per edge that the
// CPU cannot predict; here an edge costs one OR for 64 sources, which
// is what a 500-node corpus's all-pairs path length needs.
int multi_bfs(int64_t n, const int64_t* indptr, const int32_t* indices,
              int64_t num_sources, const int64_t* sources,
              int64_t max_dist, int32_t* out) {
  for (int64_t k = 0; k < (n > 0 ? indptr[n] : 0); ++k)
    if (indices[k] < 0 || indices[k] >= n) return 2;
  for (int64_t si = 0; si < num_sources; ++si)
    if (sources[si] < 0 || sources[si] >= n) return 1;
  std::fill(out, out + num_sources * n, -1);
  std::vector<uint64_t> seen(n), front(n), next(n);
  for (int64_t b0 = 0; b0 < num_sources; b0 += 64) {
    int64_t nb = std::min<int64_t>(64, num_sources - b0);
    std::fill(seen.begin(), seen.end(), 0);
    std::fill(front.begin(), front.end(), 0);
    for (int64_t b = 0; b < nb; ++b) {
      int64_t s0 = sources[b0 + b];
      seen[s0] |= uint64_t(1) << b;
      front[s0] |= uint64_t(1) << b;
      out[(b0 + b) * n + s0] = 0;
    }
    for (int32_t d = 1; max_dist < 0 || d <= max_dist; ++d) {
      std::fill(next.begin(), next.end(), 0);
      for (int64_t u = 0; u < n; ++u) {
        uint64_t f = front[u];
        if (!f) continue;
        for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k)
          next[indices[k]] |= f;
      }
      bool reached = false;
      for (int64_t v = 0; v < n; ++v) {
        uint64_t fresh = next[v] & ~seen[v];
        front[v] = fresh;
        if (!fresh) continue;
        reached = true;
        seen[v] |= fresh;
        for (; fresh; fresh &= fresh - 1)
          out[(b0 + __builtin_ctzll(fresh)) * n + v] = d;
      }
      if (!reached) break;
    }
  }
  return 0;
}

// tri[j] = the number of (k, i), both taken from row j with their
// repeats, with i != j, i != k and an edge i -> k: each closed wedge
// i - j - k from both of its ends, so twice the triangles through j on
// a simple undirected graph (the numpy plain version's count, repeated
// edges and self loops included).  Row j's k are counted in a mark
// array; each i adds the marks of its distinct out-neighbours other
// than itself.  Returns 0, or 2 for a neighbour outside [0, n).
int triangle_counts(int64_t n, const int64_t* indptr,
                    const int32_t* indices, int64_t* tri) {
  int64_t e = n > 0 ? indptr[n] : 0;
  for (int64_t k = 0; k < e; ++k)
    if (indices[k] < 0 || indices[k] >= n) return 2;
  // each row's distinct out-neighbours, sorted
  std::vector<int64_t> uptr(n + 1, 0);
  std::vector<int32_t> uniq(indices, indices + e);
  for (int64_t u = 0; u < n; ++u) {
    int32_t* lo = uniq.data() + indptr[u];
    int32_t* hi = uniq.data() + indptr[u + 1];
    std::sort(lo, hi);
    int32_t* end = std::unique(lo, hi);
    int32_t* dst = uniq.data() + uptr[u];
    std::copy(lo, end, dst);   // compacts in place: dst <= lo
    uptr[u + 1] = uptr[u] + (end - lo);
  }
  std::vector<int64_t> mark(n, 0);
  for (int64_t j = 0; j < n; ++j) {
    for (int64_t a = indptr[j]; a < indptr[j + 1]; ++a) mark[indices[a]]++;
    int64_t t = 0;
    for (int64_t a = indptr[j]; a < indptr[j + 1]; ++a) {
      int32_t i = indices[a];
      if (i == j) continue;
      for (int64_t b = uptr[i]; b < uptr[i + 1]; ++b) {
        int32_t k = uniq[b];
        if (k != i) t += mark[k];
      }
    }
    tri[j] = t;
    for (int64_t a = indptr[j]; a < indptr[j + 1]; ++a) mark[indices[a]] = 0;
  }
  return 0;
}

// The out-edge CSR of an edge list: indptr [n + 1], each slot's
// receiver (nbr) and input edge id (eid), the edges of a sender in
// input order (a stable counting sort).  Returns false for an endpoint
// outside [0, n).
static bool edge_csr(int64_t n, int64_t e, const int32_t* senders,
                     const int32_t* receivers, std::vector<int64_t>& indptr,
                     std::vector<int32_t>& nbr, std::vector<int64_t>& eid) {
  indptr.assign(n + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (senders[i] < 0 || senders[i] >= n || receivers[i] < 0 ||
        receivers[i] >= n)
      return false;
    indptr[senders[i] + 1]++;
  }
  for (int64_t u = 0; u < n; ++u) indptr[u + 1] += indptr[u];
  std::vector<int64_t> cursor(indptr.begin(), indptr.end() - 1);
  nbr.resize(e);
  eid.resize(e);
  for (int64_t i = 0; i < e; ++i) {
    int64_t k = cursor[senders[i]]++;
    nbr[k] = receivers[i];
    eid[k] = i;
  }
  return true;
}

// The members of center c's ego net, the nodes within `radius` hops
// along out-edges (BFS order, c first, in queue[0:*count]); dist holds
// their hop counts and -1 elsewhere (the caller resets the members').
static void ego_bfs(const std::vector<int64_t>& indptr,
                    const std::vector<int32_t>& nbr, int64_t c,
                    int64_t radius, int32_t* dist, int32_t* queue,
                    int64_t* count) {
  int64_t head = 0, tail = 0;
  dist[c] = 0;
  queue[tail++] = (int32_t)c;
  while (head < tail) {
    int32_t u = queue[head++];
    if (dist[u] >= radius) continue;
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
      int32_t v = nbr[k];
      if (dist[v] < 0) {
        dist[v] = dist[u] + 1;
        queue[tail++] = v;
      }
    }
  }
  *count = tail;
}

// Pass 1 of the ego-net union: per center c, the members of its
// radius-hop ego net (node_counts[c], c included) and the input edges
// with both ends among them (edge_counts[c]).  Returns 0, or 1 for an
// endpoint outside [0, n).
int ego_sizes(int64_t n, int64_t e, const int32_t* senders,
              const int32_t* receivers, int64_t radius,
              int64_t* node_counts, int64_t* edge_counts) {
  std::vector<int64_t> indptr, eid;
  std::vector<int32_t> nbr;
  if (!edge_csr(n, e, senders, receivers, indptr, nbr, eid)) return 1;
  std::vector<int32_t> dist(n, -1), queue(n);
  for (int64_t c = 0; c < n; ++c) {
    int64_t cnt = 0, ec = 0;
    ego_bfs(indptr, nbr, c, radius, dist.data(), queue.data(), &cnt);
    for (int64_t q = 0; q < cnt; ++q)
      for (int64_t k = indptr[queue[q]]; k < indptr[queue[q] + 1]; ++k)
        ec += dist[nbr[k]] >= 0;
    node_counts[c] = cnt;
    edge_counts[c] = ec;
    for (int64_t q = 0; q < cnt; ++q) dist[queue[q]] = -1;
  }
  return 0;
}

// Pass 2: the union into caller-allocated arrays, sized by pass 1:
// union_senders / union_receivers [sum(edge_counts)], orig_of
// [n + sum(node_counts - 1)], the original node of each union node.
// The layout of the numpy ego_nets: center c keeps id c; ego c's other
// members take the next ids in ascending original id; ego c's edges
// follow ego c-1's, in input order (its members' edge ids, sorted).
// Returns 0, or 1 for an endpoint outside [0, n).
int ego_fill(int64_t n, int64_t e, const int32_t* senders,
             const int32_t* receivers, int64_t radius,
             int32_t* union_senders, int32_t* union_receivers,
             int64_t* orig_of) {
  std::vector<int64_t> indptr, eid;
  std::vector<int32_t> nbr;
  if (!edge_csr(n, e, senders, receivers, indptr, nbr, eid)) return 1;
  std::vector<int32_t> dist(n, -1), queue(n);
  std::vector<int64_t> newid(n, -1), edges;
  for (int64_t i = 0; i < n; ++i) orig_of[i] = i;
  int64_t next_id = n, epos = 0;
  for (int64_t c = 0; c < n; ++c) {
    int64_t cnt = 0;
    ego_bfs(indptr, nbr, c, radius, dist.data(), queue.data(), &cnt);
    std::sort(queue.begin(), queue.begin() + cnt);
    edges.clear();
    for (int64_t q = 0; q < cnt; ++q) {
      int32_t u = queue[q];
      if (u == c) {
        newid[u] = c;
      } else {
        newid[u] = next_id;
        orig_of[next_id++] = u;
      }
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k)
        if (dist[nbr[k]] >= 0) edges.push_back(eid[k]);
    }
    std::sort(edges.begin(), edges.end());
    for (int64_t i : edges) {
      union_senders[epos] = (int32_t)newid[senders[i]];
      union_receivers[epos++] = (int32_t)newid[receivers[i]];
    }
    for (int64_t q = 0; q < cnt; ++q) {
      dist[queue[q]] = -1;
      newid[queue[q]] = -1;
    }
  }
  return 0;
}

// Brandes' betweenness, unnormalized: bc[v] = the sum over sources s != v
// of s's dependency on v, over the CSR (row u: u's out-neighbours, in
// the order the Python loop reads them).  Each source's dependencies
// are the loop's to the bit: sigma summed in BFS order, and each
// delta[u] summed over its successors v in reverse BFS order, as
// sigma[u] / sigma[v] * (1 + delta[v]), one term per edge u -> v (the
// predecessors of v read from the transpose).  Sources run on
// `num_threads` threads in blocks, each source's dependencies into a
// row of its own, and the rows are added into bc in source order: the
// same sums on every run and at every thread count.  Returns 0, or 2 for
// a neighbour outside [0, n).
int betweenness(int64_t n, const int64_t* indptr, const int32_t* indices,
                int64_t num_threads, double* bc) {
  int64_t e = n > 0 ? indptr[n] : 0;
  for (int64_t k = 0; k < e; ++k)
    if (indices[k] < 0 || indices[k] >= n) return 2;
  std::fill(bc, bc + n, 0.0);
  // the transpose: the senders of v's in-edges
  std::vector<int64_t> tptr(n + 1, 0);
  std::vector<int32_t> tidx(e);
  for (int64_t k = 0; k < e; ++k) tptr[indices[k] + 1]++;
  for (int64_t v = 0; v < n; ++v) tptr[v + 1] += tptr[v];
  {
    std::vector<int64_t> cursor(tptr.begin(), tptr.end() - 1);
    for (int64_t u = 0; u < n; ++u)
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k)
        tidx[cursor[indices[k]]++] = (int32_t)u;
  }
  const int64_t T = std::max<int64_t>(1, num_threads);
  const int64_t B = std::min<int64_t>(n, 256);
  std::vector<double> rows((size_t)B * (size_t)n);
  auto source = [&](int64_t s0, double* delta, std::vector<double>& sigma,
                    std::vector<int64_t>& dist, std::vector<int32_t>& order) {
    std::fill(sigma.begin(), sigma.end(), 0.0);
    std::fill(dist.begin(), dist.end(), -1);
    std::fill(delta, delta + n, 0.0);
    sigma[s0] = 1.0;
    dist[s0] = 0;
    int64_t head = 0, tail = 0;
    order[tail++] = (int32_t)s0;
    while (head < tail) {
      int32_t u = order[head++];
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int32_t v = indices[k];
        if (dist[v] < 0) {
          dist[v] = dist[u] + 1;
          order[tail++] = v;
        }
        if (dist[v] == dist[u] + 1) sigma[v] += sigma[u];
      }
    }
    for (int64_t i = tail - 1; i >= 0; --i) {
      int32_t v = order[i];
      for (int64_t k = tptr[v]; k < tptr[v + 1]; ++k) {
        int32_t u = tidx[k];
        if (dist[u] >= 0 && dist[u] == dist[v] - 1)
          delta[u] += sigma[u] / sigma[v] * (1 + delta[v]);
      }
    }
  };
  for (int64_t b0 = 0; b0 < n; b0 += B) {
    int64_t nb = std::min(B, n - b0);
    auto work = [&](int64_t t) {
      std::vector<double> sigma(n);
      std::vector<int64_t> dist(n);
      std::vector<int32_t> order(n);
      for (int64_t j = t; j < nb; j += T)
        source(b0 + j, rows.data() + (size_t)j * n, sigma, dist, order);
    };
    auto reduce = [&](int64_t t) {
      int64_t lo = n * t / T, hi = n * (t + 1) / T;
      for (int64_t j = 0; j < nb; ++j) {
        const double* delta = rows.data() + (size_t)j * n;
        for (int64_t v = lo; v < hi; ++v)
          if (v != b0 + j) bc[v] += delta[v];
      }
    };
    std::vector<std::thread> threads;
    for (int64_t t = 1; t < T; ++t) threads.emplace_back(work, t);
    work(0);
    for (auto& th : threads) th.join();
    threads.clear();
    for (int64_t t = 1; t < T; ++t) threads.emplace_back(reduce, t);
    reduce(0);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
