"""Structural graph algorithms in vectorized numpy over CSR.

A copy of graphgym_tpu/data/structure.py (the port never loads the JAX
package's g++-built native library): the ego-net transform, the
clustering-coefficient labels, the synthetic corpora's rejection
statistics and the feature augmentations (degree, path lengths,
PageRank, betweenness, Laplacian spectrum) run on them.  The BFS and the
triangle count run in the port's own native library
(graphgym_tpu_torch/native: ``bfs_from_sources``, ``triangle_counts``),
which returns integers only; every float operation stays here.  So
does Brandes' betweenness (``betweenness_centrality``), whose native
sums are the Python loop's, in its order.  The numpy and Python
bodies, ``bfs_from_sources_plain``, ``triangle_counts_plain`` and
``betweenness_centrality_plain``, are the plain versions the tests hold
them to.
"""

from __future__ import annotations

import numpy as np

from graphgym_tpu_torch import native
from graphgym_tpu_torch.data.hostgraph import HostGraph


def degrees(g: HostGraph) -> np.ndarray:
    """Undirected degree per node (networkx G.degree for the symmetric
    edge set = out-degree here)."""
    d = np.zeros(g.num_nodes, np.int64)
    np.add.at(d, g.senders, 1)
    return d


def _expand(indptr: np.ndarray, indices: np.ndarray,
            src: np.ndarray, cur: np.ndarray):
    """Vectorized CSR frontier expansion: for frontier pairs
    (src[k], cur[k]) return (src repeated per neighbor, all neighbors) —
    no per-node Python loop."""
    counts = (indptr[cur + 1] - indptr[cur]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, src.dtype), np.zeros(0, indices.dtype))
    starts = indptr[cur]
    run_off = np.arange(total) - np.repeat(
        np.cumsum(counts) - counts, counts)
    flat = np.repeat(starts, counts) + run_off
    return np.repeat(src, counts), indices[flat]


def clustering_coefficient(g: HostGraph) -> np.ndarray:
    """nx.clustering equivalent for undirected simple graphs:
    c_i = 2 T_i / (d_i (d_i - 1)), T_i = triangles through i; the
    closed wedges from the native ``triangle_counts``, the division
    here in float64."""
    indptr, indices = g.csr()
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    tri = triangle_counts(g)
    # each triangle through j appears as 2 directed closed wedges
    denom = deg * (deg - 1)
    out = np.zeros(g.num_nodes, np.float64)
    nz = denom > 0
    out[nz] = tri[nz] / denom[nz]
    return out


def triangle_counts(g: HostGraph) -> np.ndarray:
    """Closed directed wedges i - j - k per center j, int64 (twice the
    triangles through j): graph_native.cpp's ``triangle_counts``."""
    return native.triangle_counts(*g.csr())


def triangle_counts_plain(g: HostGraph) -> np.ndarray:
    """The plain version of ``triangle_counts``, vectorized wedge
    counting: every directed wedge (i->j->k) is a candidate; membership
    (i,k) in E is tested with searchsorted on the sorted edge-key array.
    Chunked over wedges to bound memory."""
    n = g.num_nodes
    indptr, indices = g.csr()
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    s, r = g.senders.astype(np.int64), g.receivers.astype(np.int64)
    keys = np.sort(s * n + r)
    tri = np.zeros(n, np.int64)
    # wedges grouped by center j: pairs (i, k) with i,k in N(j);
    # enumerate per edge (j -> k): candidates i = N(j)
    edge_chunk = max(1, int(2e7 // max(int(deg.mean()) + 1, 1)))
    for lo in range(0, g.num_edges, edge_chunk):
        js = s[lo:lo + edge_chunk]
        ks = r[lo:lo + edge_chunk]
        eid = np.arange(len(js))
        wedge_e, wedge_i = _expand(indptr, indices, eid, js)
        wedge_k = ks[wedge_e]
        ii = wedge_i.astype(np.int64)
        valid = (ii != wedge_k) & (ii != js[wedge_e])
        ii, kk = ii[valid], wedge_k[valid]
        wk = ii * n + kk
        pos = np.searchsorted(keys, wk)
        pos = np.minimum(pos, len(keys) - 1)
        closed = keys[pos] == wk if len(keys) else np.zeros(0, bool)
        # each closed wedge (i-j-k) contributes to the center j
        np.add.at(tri, js[wedge_e][valid][closed], 1)
    return tri


def bfs_from_sources(g: HostGraph, sources: np.ndarray,
                     max_dist: int | None = None) -> np.ndarray:
    """Hop distances from each source: [S, N] int32, -1 unreachable
    (beyond ``max_dist`` hops too): graph_native.cpp's ``multi_bfs``."""
    cap = -1 if max_dist is None else max(int(max_dist), 0)
    return native.bfs_distances(*g.csr(), sources, cap)


def bfs_from_sources_plain(g: HostGraph, sources: np.ndarray,
                           max_dist: int | None = None) -> np.ndarray:
    """The plain version of ``bfs_from_sources``: frontier BFS with
    fully-vectorized CSR expansion."""
    n = g.num_nodes
    sources = np.asarray(sources, np.int64)
    s_count = len(sources)
    indptr, indices = g.csr()
    dist = np.full((s_count, n), -1, np.int32)
    dist[np.arange(s_count), sources] = 0
    src = np.arange(s_count, dtype=np.int64)
    cur = sources.copy()
    d = 0
    limit = max_dist if max_dist is not None else n
    while len(cur) and d < limit:
        d += 1
        ns, nv = _expand(indptr, indices, src, cur)
        if not len(ns):
            break
        fresh = dist[ns, nv] < 0
        ns, nv = ns[fresh], nv[fresh]
        # dedupe (source, node) pairs discovered twice this level
        key = ns * n + nv
        _, first = np.unique(key, return_index=True)
        ns, nv = ns[first], nv[first]
        dist[ns, nv] = d
        src, cur = ns, nv
    return dist


def bfs_all_pairs(g: HostGraph, max_dist: int | None = None) -> np.ndarray:
    """All-pairs hop distances [N, N]."""
    return bfs_from_sources(g, np.arange(g.num_nodes), max_dist)


def ego_radius_nodes(g: HostGraph, radius: int):
    """For each node i, the sorted array of nodes within hop distance
    <= radius (including i) — the ego-net node sets (reference
    transform.py:21 nx.ego_graph)."""
    dist = bfs_all_pairs(g, max_dist=radius)
    within = (dist >= 0) & (dist <= radius)
    return [np.nonzero(within[i])[0] for i in range(g.num_nodes)]


def avg_shortest_path_len(g: HostGraph,
                          chunk: int = 2048) -> np.ndarray:
    """Per-node mean shortest-path length over reachable nodes
    (reference path_len_fun, feature_augment.py:60-63; includes the
    0-distance to self, matching nx.shortest_path_length dict).
    Chunked over sources so memory stays O(chunk * N)."""
    n = g.num_nodes
    out = np.zeros(n, np.float64)
    for lo in range(0, n, chunk):
        srcs = np.arange(lo, min(lo + chunk, n))
        dist = bfs_from_sources(g, srcs)
        reach = dist >= 0
        cnt = reach.sum(1)
        tot = np.where(reach, dist, 0).sum(1)
        out[srcs] = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)
    return out


def graph_avg_path_len(g: HostGraph, chunk: int = 2048) -> float:
    """nx.average_shortest_path_length: mean over ordered pairs u != v
    (assumes connected)."""
    n = g.num_nodes
    tot = 0.0
    cnt = 0
    for lo in range(0, n, chunk):
        srcs = np.arange(lo, min(lo + chunk, n))
        dist = bfs_from_sources(g, srcs)
        reach = dist > 0
        tot += float(np.where(reach, dist, 0).sum())
        cnt += int(reach.sum())
    return tot / cnt if cnt else 0.0


def pagerank(g: HostGraph, alpha: float = 0.85, tol: float = 1e-6,
             max_iter: int = 100) -> np.ndarray:
    """Power-iteration PageRank matching nx.pagerank defaults
    (alpha=0.85, L1 tolerance 1e-6 * n)."""
    n = g.num_nodes
    s, r = g.senders, g.receivers
    deg_out = np.zeros(n, np.float64)
    np.add.at(deg_out, s, 1.0)
    x = np.full(n, 1.0 / n)
    dangling = deg_out == 0
    for _ in range(max_iter):
        contrib = np.where(dangling, 0.0, x / np.maximum(deg_out, 1))
        nxt = np.zeros(n, np.float64)
        np.add.at(nxt, r, contrib[s])
        nxt = alpha * (nxt + x[dangling].sum() / n) + (1 - alpha) / n
        if np.abs(nxt - x).sum() < n * tol:
            x = nxt
            break
        x = nxt
    return x


def betweenness_centrality(g: HostGraph, normalized: bool = True
                           ) -> np.ndarray:
    """Brandes' algorithm (unweighted), matching
    nx.betweenness_centrality's normalization 2/((n-1)(n-2)) for
    undirected graphs: the native ``betweenness`` sums, scaled here as
    the plain version scales its own."""
    return _betweenness_scale(native.betweenness(*g.csr()), normalized)


def _betweenness_scale(bc: np.ndarray, normalized: bool) -> np.ndarray:
    n = len(bc)
    bc /= 2.0  # undirected: each pair counted twice
    if normalized and n > 2:
        bc *= 2.0 / ((n - 1) * (n - 2))
    return bc


def betweenness_centrality_plain(g: HostGraph, normalized: bool = True
                                 ) -> np.ndarray:
    """The plain version of ``betweenness_centrality``: the Python
    loop, one source at a time."""
    n = g.num_nodes
    indptr, indices = g.csr()
    bc = np.zeros(n, np.float64)
    for s0 in range(n):
        # BFS
        sigma = np.zeros(n)
        sigma[s0] = 1.0
        dist = np.full(n, -1, np.int64)
        dist[s0] = 0
        order = [s0]
        head = 0
        preds = [[] for _ in range(n)]
        while head < len(order):
            u = order[head]
            head += 1
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    order.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
                    preds[v].append(u)
        delta = np.zeros(n)
        for v in reversed(order):
            for u in preds[v]:
                delta[u] += sigma[u] / sigma[v] * (1 + delta[v])
            if v != s0:
                bc[v] += delta[v]
    return _betweenness_scale(bc, normalized)


def laplacian_spectrum(g: HostGraph) -> np.ndarray:
    """Eigenvalues of the combinatorial Laplacian (nx.laplacian_spectrum:
    ascending eigvalsh of D - A)."""
    n = g.num_nodes
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (g.senders, g.receivers), 1.0)
    a = np.minimum(a, 1.0)  # simple graph
    lap = np.diag(a.sum(1)) - a
    return np.linalg.eigvalsh(lap)


def connected_components(g: HostGraph) -> np.ndarray:
    """Component id per node — vectorized min-label propagation
    (pointer-jumping style: each round halves-or-better the label
    diameter, all rounds are whole-array numpy ops)."""
    n = g.num_nodes
    s, r = g.senders.astype(np.int64), g.receivers.astype(np.int64)
    comp = np.arange(n, dtype=np.int64)
    while True:
        nxt = comp.copy()
        np.minimum.at(nxt, r, comp[s])
        np.minimum.at(nxt, s, comp[r])
        # pointer jumping: follow labels to their current root
        nxt = nxt[nxt]
        if np.array_equal(nxt, comp):
            break
        comp = nxt
    # densify ids to 0..k-1 in first-seen order
    _, first_pos, inv = np.unique(comp, return_index=True,
                                  return_inverse=True)
    order = np.argsort(np.argsort(first_pos))
    return order[inv]
