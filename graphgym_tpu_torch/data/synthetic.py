"""Synthetic graph corpus generator without networkx.

The counterpart of graphgym_tpu/data/synthetic.py:20-58 (reference
datasets/syn_graph.py:25-87): ba = powerlaw_cluster_graph(n, 2, p),
ws = connected_watts_strogatz_graph(n, 4, p), p ~ U[0, 1], rejection
sampled into an 8 x 8 (average path length x clustering) histogram with
``num_graphs // 64`` graphs per bin.  Node features are constant 1.

The JAX package draws its graphs with networkx.  This module gives the
same graphs, edge for edge and in the same edge order, from the same
seed, without it:

* the two generators are networkx 3.6's, draw for draw
  (networkx/generators/random_graphs.py: ``watts_strogatz_graph``,
  ``connected_watts_strogatz_graph``, ``_random_subset``,
  ``powerlaw_cluster_graph``) on a ``random.Random(seed)``, as
  networkx's ``py_random_state`` makes of an int seed;
* the graph keeps networkx's adjacency order: one insertion-ordered
  dict of neighbours per node, so a removed and re-added edge moves to
  the end of both endpoints' dicts, and ``G.edges()`` yields each edge
  once at its first endpoint in node order;
* the rejection statistics are ``nx.is_connected``,
  ``nx.average_shortest_path_length`` (a float sum of integer hop
  distances, exact, over n (n - 1)) and ``nx.average_clustering`` (the
  per-node values t / (d (d - 1)) summed in node order by the builtin
  ``sum``), computed with data/structure.py, so a value on a bin edge
  lands in networkx's bin.  Its hop distances and triangle counts come
  from the port's native library (integers only), so a 500-node
  attempt takes milliseconds: the whole loop of 51,200 attempts
  regenerates ws500 or ba500 in minutes, where the numpy BFS took about
  an hour (``python -m graphgym_tpu_torch.exp.corpus_time`` times it).
"""

from __future__ import annotations

import pickle
import random
from typing import Dict, List

import numpy as np

from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data.hostgraph import HostGraph

_PL_RANGE = (1.8, 3.0)   # average path length histogram bounds
_CC_RANGE = (0.0, 0.6)   # clustering histogram bounds
_BINS = 8                # histogram bins per axis


# ------------------------------------------------------------ generators

def _watts_strogatz(n: int, k: int, p: float,
                    rng: random.Random) -> List[Dict[int, None]]:
    """networkx.watts_strogatz_graph on an adjacency of ordered dicts."""
    if k > n:
        raise ValueError("k>n, choose smaller k or larger n")
    nodes = list(range(n))
    adj: List[Dict[int, None]] = [{} for _ in nodes]
    if k == n:   # networkx returns the complete graph
        for u in nodes:
            for v in nodes[u + 1:]:
                adj[u][v] = None
                adj[v][u] = None
        return adj
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[:j]):
            adj[u][v] = None
            adj[v][u] = None
    for j in range(1, k // 2 + 1):
        for u, v in zip(nodes, nodes[j:] + nodes[:j]):
            if rng.random() < p:
                w = rng.choice(nodes)
                while w == u or w in adj[u]:
                    w = rng.choice(nodes)
                    if len(adj[u]) >= n - 1:
                        break   # skip this rewiring
                else:
                    del adj[u][v]
                    del adj[v][u]
                    adj[u][w] = None
                    adj[w][u] = None
    return adj


def _connected_watts_strogatz(n: int, k: int, p: float, tries: int,
                              rng: random.Random) -> List[Dict[int, None]]:
    """networkx.connected_watts_strogatz_graph: redraw on the same rng
    until connected, at most ``tries`` times."""
    for _ in range(tries):
        adj = _watts_strogatz(n, k, p, rng)
        if _is_connected(_host_graph(adj)):
            return adj
    raise RuntimeError("Maximum number of tries exceeded")


def _random_subset(seq: list, m: int, choice) -> set:
    """networkx's _random_subset: m distinct draws of rng.choice(seq)."""
    targets = set()
    while len(targets) < m:
        targets.add(choice(seq))
    return targets


def _powerlaw_cluster(n: int, m: int, p: float,
                      rng: random.Random) -> List[Dict[int, None]]:
    """networkx.powerlaw_cluster_graph (Holme-Kim) on an adjacency of
    ordered dicts; nodes are created in label order, as networkx does."""
    if m < 1 or n < m:
        raise ValueError(f"must have m>1 and m<n, m={m},n={n}")
    if p > 1 or p < 0:
        raise ValueError(f"p must be in [0,1], p={p}")
    choice, uniform = rng.choice, rng.random
    adj: List[Dict[int, None]] = [{} for _ in range(n)]
    repeated_nodes = list(range(m))
    for source in range(m, n):
        src_adj = adj[source]
        possible_targets = _random_subset(repeated_nodes, m, choice)
        target = possible_targets.pop()
        src_adj[target] = None
        adj[target][source] = None
        repeated_nodes.append(target)
        count = 1
        while count < m:
            if uniform() < p:   # clustering step: add a triangle
                neighborhood = [nbr for nbr in adj[target]
                                if nbr not in src_adj and nbr != source]
                if neighborhood:
                    nbr = choice(neighborhood)
                    src_adj[nbr] = None
                    adj[nbr][source] = None
                    repeated_nodes.append(nbr)
                    count += 1
                    continue
            target = possible_targets.pop()
            src_adj[target] = None
            adj[target][source] = None
            repeated_nodes.append(target)
            count += 1
        repeated_nodes.extend([source] * m)
    return adj


# ------------------------------------------------------------ statistics

def _is_connected(g: HostGraph) -> bool:
    """nx.is_connected (a graph of no nodes raises there; none is made)."""
    return int(st.connected_components(g).max()) == 0


def _avg_clustering(g: HostGraph) -> float:
    """nx.average_clustering: the per-node t / (d (d - 1)) (0 where t =
    0) summed in node order by the builtin sum, as networkx's
    sum(c.values()), over n."""
    return sum(st.clustering_coefficient(g).tolist()) / g.num_nodes


def _host_graph(adj: List[Dict[int, None]]) -> HostGraph:
    """from_networkx of the graph: its edges in G.edges() order (each
    once, at its first endpoint in node order), then their reverses;
    node_feature ones [n, 1] float32."""
    edges = []
    for u, nbrs in enumerate(adj):   # nodes are 0..n-1 in node order
        edges.extend((u, v) for v in nbrs if v >= u)
    e = np.asarray(edges, np.int32).reshape(-1, 2)
    e = np.concatenate([e, e[:, ::-1]], axis=0)
    g = HostGraph(len(adj), e.T.copy())
    g.feats["node_feature"] = np.ones((len(adj), 1), np.float32)
    return g


# ---------------------------------------------------------------- corpus

def generate_syn_graphs(kind: str = "ba", num_graphs: int = 256,
                        n: int = 64, seed: int = 0) -> List[HostGraph]:
    """The rejection-sampled corpus of graphgym_tpu/data/synthetic.py
    (at its 8 bins), graph for graph: the same numpy draws (p, then the
    generator's int seed) per attempt, at most num_graphs * 200
    attempts."""
    if kind not in ("ba", "ws"):
        raise ValueError(f"Unknown synthetic kind {kind}")
    rng = np.random.default_rng(seed)
    per_bin = max(num_graphs // (_BINS * _BINS), 1)
    counts = np.zeros((_BINS, _BINS), np.int64)
    pl_edges = np.linspace(*_PL_RANGE, _BINS + 1)
    cc_edges = np.linspace(*_CC_RANGE, _BINS + 1)
    out: List[HostGraph] = []
    attempts = 0
    while len(out) < num_graphs and attempts < num_graphs * 200:
        attempts += 1
        p = float(rng.uniform(0, 1))
        gen = random.Random(int(rng.integers(1 << 31)))
        if kind == "ba":
            g = _host_graph(_powerlaw_cluster(n, 2, p, gen))
            if not _is_connected(g):
                continue
        else:
            g = _host_graph(_connected_watts_strogatz(n, 4, p, 100, gen))
        cc = _avg_clustering(g)
        j = int(np.clip(np.digitize(cc, cc_edges) - 1, 0, _BINS - 1))
        if counts[:, j].min() >= per_bin:
            continue   # every bin of this clustering is full
        pl = st.graph_avg_path_len(g)
        i = int(np.clip(np.digitize(pl, pl_edges) - 1, 0, _BINS - 1))
        if counts[i, j] >= per_bin:
            continue
        counts[i, j] += 1
        out.append(g)
    return out


def save_syn(path: str, graphs) -> None:
    with open(path, "wb") as f:
        pickle.dump(graphs, f)
