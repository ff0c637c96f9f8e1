"""Graph transforms: ego-net extraction for ID-GNN Full.

The port of ``ego_nets`` from graphgym_tpu/data/transforms.py on its
numpy path (reference models/transform.py:11-39).  The edge-net,
path-length and negative-sampling transforms belong to other tasks
(ROADMAP A13b).
"""

from __future__ import annotations

import numpy as np

from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data.hostgraph import HostGraph


def ego_nets(g: HostGraph, radius: int = 2) -> HostGraph:
    """ID-GNN Full data transform (reference transform.py:11-39).

    For every node i extract the radius-r ego-net; build one disjoint
    union graph where center i keeps id i and its other ego members get
    fresh ids >= n.  ``node_id_index = arange(n)`` marks the centers.
    Node features/labels are copied from the original node of each ego
    member; node_label_index (supervised centers) is preserved.

    radius > 4 short-circuits to n copies of the full graph
    (transform.py:18-19).
    """
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

    out = HostGraph(total_nodes, edge_index)
    for key, val in g.feats.items():
        if key.startswith("node_") and key != "node_label_index" \
                and len(val) == n:
            out[key] = np.asarray(val)[orig_of]
        else:
            out[key] = val
    out["node_id_index"] = np.arange(n)
    return out
