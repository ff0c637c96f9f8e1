"""Graph samplers: neighbor, GraphSAINT, cluster and random-node (the
port of graphgym_tpu/data/samplers.py).

The PyG sampler options of the reference (loader_pyg.py:204-255:
full_batch, NeighborSampler, RandomNodeSampler, GraphSAINT node / edge /
random-walk, ClusterLoader) as host-side CSR sampling that returns
induced subgraphs; ``SamplerLoader`` (data/loaders.py) collates them
into padded batches each epoch.  Every draw takes the Generator's
numbers in the JAX package's order, so one seed gives both packages the
same subgraphs.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np

from graphgym_tpu_torch.data.hostgraph import HostGraph


def induced_subgraph(g: HostGraph, nodes: np.ndarray) -> HostGraph:
    """Node-induced subgraph with relabeled ids: node arrays sliced,
    graph-level arrays kept, edge arrays dropped, and the supervision
    restricted to the kept nodes (all of them where the graph has node
    labels and no node_label_index)."""
    nodes = np.unique(nodes)
    lookup = np.full(g.num_nodes, -1, np.int64)
    lookup[nodes] = np.arange(len(nodes))
    s, r = g.senders, g.receivers
    keep = (lookup[s] >= 0) & (lookup[r] >= 0)
    ei = np.stack([lookup[s[keep]], lookup[r[keep]]]).astype(np.int32)
    out = HostGraph(len(nodes), ei)
    for key, val in g.feats.items():
        val = np.asarray(val)
        if key == "node_label_index":
            sel = lookup[val]
            out[key] = np.sort(sel[sel >= 0])
        elif key.startswith("node_") and len(val) == g.num_nodes:
            out[key] = val[nodes]
        elif not key.startswith(("edge_", "node_")):
            out[key] = val
    if "node_label_index" not in out and "node_label" in out:
        out["node_label_index"] = np.arange(out.num_nodes)
    return out


def neighbor_sample(g: HostGraph, batch_nodes: np.ndarray,
                    sizes: List[int],
                    rng: np.random.Generator) -> HostGraph:
    """Layer-wise neighbor expansion (reference NeighborSampler,
    loader_pyg.py:209-215 with cfg.train.neighbor_sizes): from the seed
    nodes, up to sizes[l] neighbors of each frontier node at hop l,
    without replacement (each candidate a random key, a node's ``size``
    smallest kept); the subgraph induced by the union, supervising only
    the seeds that the graph supervises."""
    indptr, indices = g.csr()
    frontier = np.asarray(batch_nodes)
    all_nodes = [frontier]
    for size in sizes:
        cur = frontier.astype(np.int64)
        counts = (indptr[cur + 1] - indptr[cur]).astype(np.int64)
        total = int(counts.sum())
        if total == 0:
            frontier = np.array([], np.int64)
            all_nodes.append(frontier)
            continue
        seg = np.repeat(np.arange(len(cur)), counts)
        run = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
        nbrs = indices[np.repeat(indptr[cur], counts) + run]
        keys = rng.random(total)
        order = np.lexsort((keys, seg))
        # after the (segment, key) sort the rank within a segment is the
        # position minus the segment's start, as ``run`` counts it
        frontier = np.unique(nbrs[order[run < size]])
        all_nodes.append(frontier)
    nodes = np.unique(np.concatenate(all_nodes))
    sub = induced_subgraph(g, nodes)
    lookup = np.full(g.num_nodes, -1, np.int64)
    lookup[nodes] = np.arange(len(nodes))
    seeds = lookup[np.asarray(batch_nodes)]
    base = g.get("node_label_index")
    if base is not None:
        allowed = np.zeros(g.num_nodes, bool)
        allowed[np.asarray(base)] = True
        seeds = seeds[allowed[np.asarray(batch_nodes)]]
    sub["node_label_index"] = np.sort(seeds[seeds >= 0])
    return sub


def saint_node(g: HostGraph, budget: int,
               rng: np.random.Generator) -> HostGraph:
    """GraphSAINT node sampler: nodes drawn without replacement with
    probability proportional to out-degree + 1."""
    deg = np.zeros(g.num_nodes)
    np.add.at(deg, g.senders, 1.0)
    p = (deg + 1) / (deg + 1).sum()
    nodes = rng.choice(g.num_nodes, size=min(budget, g.num_nodes),
                       replace=False, p=p)
    return induced_subgraph(g, nodes)


def saint_edge(g: HostGraph, budget: int,
               rng: np.random.Generator) -> HostGraph:
    """GraphSAINT edge sampler: a uniform edge sample, induced over its
    endpoints."""
    e = g.num_edges
    sel = rng.choice(e, size=min(budget, e), replace=False)
    nodes = np.unique(np.concatenate([g.senders[sel], g.receivers[sel]]))
    return induced_subgraph(g, nodes)


def saint_random_walk(g: HostGraph, roots: int, walk_length: int,
                      rng: np.random.Generator) -> HostGraph:
    """GraphSAINT random-walk sampler (cfg.train.walk_length, reference
    config.py:245): ``roots`` uniform start nodes, each walking
    ``walk_length`` steps to a uniform neighbor (staying put where it
    has none), root by root within a step as the JAX package draws."""
    indptr, indices = g.csr()
    starts = rng.integers(0, g.num_nodes, size=roots)
    visited = [starts]
    cur = starts.copy()
    for _ in range(walk_length):
        nxt = np.empty_like(cur)
        for i, u in enumerate(cur):
            nbrs = indices[indptr[u]:indptr[u + 1]]
            nxt[i] = rng.choice(nbrs) if len(nbrs) else u
        visited.append(nxt)
        cur = nxt
    return induced_subgraph(g, np.concatenate(visited))


def random_node_parts(g: HostGraph, num_parts: int,
                      rng: np.random.Generator) -> List[HostGraph]:
    """RandomNodeSampler: a random partition into num_parts induced
    subgraphs."""
    perm = rng.permutation(g.num_nodes)
    return [induced_subgraph(g, part)
            for part in np.array_split(perm, num_parts)]


def cluster_parts(g: HostGraph, num_parts: int,
                  rng: np.random.Generator) -> List[HostGraph]:
    """ClusterLoader-style partition without METIS: balanced clusters
    grown breadth first from seeds in a random order, the leftovers in
    the last part; the non-empty parts' induced subgraphs."""
    indptr, indices = g.csr()
    n = g.num_nodes
    target = (n + num_parts - 1) // num_parts
    # the walk in Python lists: a scalar read of a numpy array costs ten
    # times a list's, and the walk reads one a neighbor
    ptr, nbrs = indptr.tolist(), indices.tolist()
    assigned = [-1] * n
    part = count = 0
    for seed in rng.permutation(n).tolist():
        if assigned[seed] >= 0:
            continue
        queue = collections.deque([seed])
        while queue and count < target:
            u = queue.popleft()
            if assigned[u] >= 0:
                continue
            assigned[u] = part
            count += 1
            for v in nbrs[ptr[u]:ptr[u + 1]]:
                if assigned[v] < 0:
                    queue.append(v)
        if count >= target:
            part = min(part + 1, num_parts - 1)
            count = 0
    assigned = np.asarray(assigned, np.int64)
    assigned[assigned < 0] = num_parts - 1
    return [induced_subgraph(g, np.nonzero(assigned == p)[0])
            for p in range(num_parts) if np.any(assigned == p)]


def make_sampled_graphs(g: HostGraph, cfg, rng: np.random.Generator,
                        sampler: str = None) -> List[HostGraph]:
    """One epoch's sampled subgraphs of ``g`` for ``sampler`` (default
    cfg.train.sampler; the eval loaders pass cfg.val.sampler, reference
    loader_pyg.py:272-283): cfg.train.iter_per_epoch draws for neighbor
    (batch_size * 8 seeds from the supervised nodes) and the GraphSAINT
    samplers (node_per_graph * 64 nodes or edges, node_per_graph walk
    roots), one partition for random_node and cluster."""
    sampler = sampler or cfg.train.sampler
    iters = cfg.train.iter_per_epoch
    if sampler == "full_batch":
        return [g]
    if sampler == "neighbor":
        base = np.asarray(g.get("node_label_index",
                                np.arange(g.num_nodes)))
        out = []
        for _ in range(iters):
            seeds = rng.choice(base, size=min(cfg.train.batch_size * 8,
                                              len(base)), replace=False)
            out.append(neighbor_sample(g, seeds, cfg.train.neighbor_sizes,
                                       rng))
        return out
    if sampler == "random_node":
        return random_node_parts(g, max(iters, 1), rng)
    if sampler == "saint_node":
        return [saint_node(g, cfg.train.node_per_graph * 64, rng)
                for _ in range(iters)]
    if sampler == "saint_edge":
        return [saint_edge(g, cfg.train.node_per_graph * 64, rng)
                for _ in range(iters)]
    if sampler == "saint_rw":
        return [saint_random_walk(g, cfg.train.node_per_graph,
                                  cfg.train.walk_length, rng)
                for _ in range(iters)]
    if sampler == "cluster":
        return cluster_parts(g, max(iters, 2), rng)
    raise ValueError(f"Unknown sampler {sampler}")
