"""Graph transforms: ego-net extraction (ID-GNN Full), edge-net copies,
shortest-path labels, negative sampling.

The port of graphgym_tpu/data/transforms.py on its numpy path
(reference models/transform.py:11-110).  Every random draw comes from
the caller's numpy Generator in the JAX package's order, so the
supervision it gives is the JAX package's array for array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from graphgym_tpu_torch import native
from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data.hostgraph import HostGraph


def ego_nets(g: HostGraph, radius: int = 2) -> HostGraph:
    """ID-GNN Full data transform (reference transform.py:11-39).

    For every node i extract the radius-r ego-net; build one disjoint
    union graph where center i keeps id i and its other ego members get
    fresh ids >= n.  ``node_id_index = arange(n)`` marks the centers.
    Node features/labels are copied from the original node of each ego
    member; node_label_index (supervised centers) is preserved.

    The union comes from the port's native library (``native.ego_union``,
    ``ego_nets_plain``'s arrays) where radius <= 4; radius > 4
    short-circuits to n copies of the full graph (transform.py:18-19),
    ``ego_nets_plain``'s own path.
    """
    if radius > 4:
        return ego_nets_plain(g, radius)
    us, ur, orig_of = native.ego_union(g.senders, g.receivers, g.num_nodes,
                                       radius)
    return _union(g, np.stack([us, ur]), orig_of)


def _union(g: HostGraph, edge_index: np.ndarray,
           orig_of: np.ndarray) -> HostGraph:
    """The union graph: ``edge_index`` (int32), each node's features
    copied from its original node ``orig_of``, the centers marked."""
    n = g.num_nodes
    out = HostGraph(len(orig_of), edge_index.astype(np.int32))
    for key, val in g.feats.items():
        if key.startswith("node_") and key != "node_label_index" \
                and len(val) == n:
            out[key] = np.asarray(val)[orig_of]
        else:
            out[key] = val
    out["node_id_index"] = np.arange(n)
    return out


def ego_nets_plain(g: HostGraph, radius: int = 2) -> HostGraph:
    """The plain version of ``ego_nets`` (the JAX package's numpy path):
    the ego sets from the all-pairs hop distances, a loop over the egos
    that relabels each one's members in ascending original id and takes
    its induced edges by a mask over the whole edge list, in its
    order."""
    n = g.num_nodes
    if radius > 4:
        ego_sets = [np.arange(n)] * n
    else:
        ego_sets = st.ego_radius_nodes(g, radius)

    # Per-ego relabeling: center i -> i; the remaining members of ego i
    # get consecutive new ids starting at the running bias (>= n), in
    # original member order.
    mapped_ids = []
    bias = n
    for i in range(n):
        members = ego_sets[i]
        others = members != i
        mapped = np.full(len(members), i, np.int64)
        mapped[others] = bias + np.arange(int(others.sum()))
        bias += int(others.sum())
        mapped_ids.append(mapped)

    total_nodes = bias
    # Union edges: induced subgraph edges of each ego, relabeled.
    s_all, r_all = [], []
    senders, receivers = g.senders, g.receivers
    for i in range(n):
        members = ego_sets[i]
        member_set = np.zeros(n, bool)
        member_set[members] = True
        emask = member_set[senders] & member_set[receivers]
        lookup = np.full(n, -1, np.int64)
        lookup[members] = mapped_ids[i]
        s_all.append(lookup[senders[emask]])
        r_all.append(lookup[receivers[emask]])
    edge_index = np.stack([np.concatenate(s_all),
                           np.concatenate(r_all)]).astype(np.int32)

    # original node id of each union node
    orig_of = np.empty(total_nodes, np.int64)
    for i in range(n):
        orig_of[mapped_ids[i]] = ego_sets[i]
    return _union(g, edge_index, orig_of)


def edge_nets(g: HostGraph) -> HostGraph:
    """Edge-prediction transform (reference transform.py:41-65): n copies
    of the graph; node j of copy i gets id i*n + j; link prediction
    becomes conditional node classification: node_label = edge_label,
    node_label_index = edge_label_index[1] + edge_label_index[0] * n;
    centers node_id_index = arange(0, n*n, n+1)."""
    n = g.num_nodes
    offs = (np.arange(n, dtype=np.int64) * n)[:, None]
    s_all = (g.senders[None, :] + offs).reshape(-1)
    r_all = (g.receivers[None, :] + offs).reshape(-1)
    out = HostGraph(n * n, np.stack([s_all, r_all]).astype(np.int32))
    for key, val in g.feats.items():
        if key.startswith("node_") and key != "node_label_index" \
                and len(val) == n:
            val = np.asarray(val)
            out[key] = np.tile(val, (n,) + (1,) * (val.ndim - 1))
    out["node_id_index"] = np.arange(0, n * n, n + 1)
    eli = g.get("edge_label_index")
    if eli is not None:
        out["node_label"] = _scatter_edge_labels(g["edge_label"], eli, n)
        out["node_label_index"] = eli[1] + eli[0] * n
    return out


def _scatter_edge_labels(edge_label, edge_label_index, n):
    """node_label over the n*n union at the supervised positions; other
    entries 0 (node_label_index masks them)."""
    labels = np.zeros(n * n, dtype=np.asarray(edge_label).dtype)
    labels[edge_label_index[1] + edge_label_index[0] * n] = edge_label
    return labels


def path_len_labels(g: HostGraph, num_label: int = 1000,
                    rng: Optional[np.random.Generator] = None) -> None:
    """Shortest-path prediction labels (reference transform.py:68-91):
    ``num_label`` node pairs drawn with replacement, label min(dist, 4),
    unreachable pairs dropped."""
    rng = rng or np.random.default_rng()
    pairs = rng.integers(0, g.num_nodes, size=(2, num_label))
    # BFS from the drawn sources only, O(S * E)
    srcs, inv = np.unique(pairs[0], return_inverse=True)
    d = st.bfs_from_sources(g, srcs)[inv, pairs[1]]
    keep = d >= 0
    g["edge_label_index"] = pairs[:, keep].astype(np.int32)
    g["edge_label"] = np.minimum(d[keep], 4).astype(np.int64)


def negative_sampling(edge_index: np.ndarray, num_nodes: int,
                      num_samples: int,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """[2, num_samples] int32 non-edges (reference transform.py:101-110
    via PyG negative_sampling): rejection sampling in rounds against the
    sorted edge keys, dropping self-loops, edges and repeats in draw
    order; after 20 rounds (a dense graph) the count is filled with
    random non-self pairs, which may be edges, so the shape is fixed."""
    rng = rng or np.random.default_rng()
    n = np.int64(num_nodes)
    edge_keys = np.sort(edge_index[0].astype(np.int64) * n
                        + edge_index[1].astype(np.int64))

    def is_edge(keys):
        if not len(edge_keys):
            return np.zeros(len(keys), bool)
        pos = np.minimum(np.searchsorted(edge_keys, keys),
                         len(edge_keys) - 1)
        return edge_keys[pos] == keys

    out = np.zeros(0, np.int64)
    rounds = 0
    while len(out) < num_samples and rounds < 20:
        rounds += 1
        m = max(256, 2 * (num_samples - len(out)))
        u = rng.integers(0, num_nodes, size=m).astype(np.int64)
        v = rng.integers(0, num_nodes, size=m).astype(np.int64)
        keys = u * n + v
        keys = keys[(u != v) & ~is_edge(keys)]
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
        if len(out):
            keys = keys[~np.isin(keys, out)]
        out = np.concatenate([out, keys])[:num_samples]
    while len(out) < num_samples:
        m = num_samples - len(out)
        u = rng.integers(0, num_nodes, size=m).astype(np.int64)
        v = rng.integers(0, num_nodes, size=m).astype(np.int64)
        out = np.concatenate([out, (u * n + v)[u != v]])[:num_samples]
    return np.stack([out // n, out % n]).astype(np.int32)
