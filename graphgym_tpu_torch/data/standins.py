"""Seeded stand-ins for real datasets, written in their published raw
formats.

The raw files of the ID-GNN paper's real datasets (Cora's Planetoid
pickles, ENZYMES' TU text files) are not in the repository.  This module
writes files in those formats, at the published sizes, with content
drawn from a seed with numpy only, so that the port's parsers
(``data/loaders.load_planetoid``, ``load_tu``) and everything after
them run at the real shapes.  The content is not the real data: no
accuracy measured on it says anything about the real datasets.

    write_planetoid_standin(root, "cora", seed)  -> root/cora/raw/ind.cora.*
    write_tu_standin(root, "ENZYMES", seed)      -> root/ENZYMES/raw/ENZYMES_*

``CORA`` and ``ENZYMES`` hold the published sizes; smaller ones are
passed as keyword overrides (the tests' small sets).
"""

from __future__ import annotations

import collections
import os
import pickle
from typing import Dict, Optional

import numpy as np

# Cora (Planetoid split): 2,708 nodes, 5,429 edges in ind.cora.graph,
# 1,433 binary features (about 18 nonzeros a row), 7 classes; 140 rows
# in x, 1,708 in allx, 1,000 test indices in 1,708-2,707
CORA = dict(nodes=2708, edges=5429, features=1433, nnz=18, classes=7,
            x_rows=140, allx_rows=1708, test_rows=1000)
# ENZYMES (TU): 600 graphs in 6 classes, 19,580 nodes (2-126 a graph),
# 37,282 undirected edges, 3 node labels and 18 node attributes;
# ``large``: the graphs drawn big enough for 100 undirected edges or
# more, so that tu_simple_filter keeps 100 such graphs on a node task
ENZYMES = dict(graphs=600, classes=6, nodes=19580, min_nodes=2,
               max_nodes=126, edges=37282, node_labels=3, attributes=18,
               large=110)


# ------------------------------------------------------------- writers

def write_planetoid(base: str, name: str, x, tx, allx, y, ty, ally,
                    graph: Dict[int, list], test_index) -> None:
    """ind.<name>.{x,tx,allx,y,ty,ally,graph} as Python 2-compatible
    pickles (protocol 2; the feature matrices scipy CSR matrices, the
    graph a defaultdict of neighbour lists) and ind.<name>.test.index as
    text, one index a line."""
    from scipy import sparse

    os.makedirs(base, exist_ok=True)
    lname = name.lower()
    objs = dict(x=sparse.csr_matrix(x), tx=sparse.csr_matrix(tx),
                allx=sparse.csr_matrix(allx), y=np.asarray(y),
                ty=np.asarray(ty), ally=np.asarray(ally),
                graph=collections.defaultdict(list, graph))
    for suffix, obj in objs.items():
        with open(os.path.join(base, f"ind.{lname}.{suffix}"), "wb") as f:
            pickle.dump(obj, f, protocol=2)
    np.savetxt(os.path.join(base, f"ind.{lname}.test.index"),
               np.asarray(test_index), fmt="%d")


def write_tu(base: str, name: str, edges: np.ndarray, indicator: np.ndarray,
             graph_labels: Optional[np.ndarray] = None,
             node_labels: Optional[np.ndarray] = None,
             node_attributes: Optional[np.ndarray] = None,
             edge_labels: Optional[np.ndarray] = None,
             edge_attributes: Optional[np.ndarray] = None) -> None:
    """<name>_A.txt ("u, v" a line, 1-based node ids, [E, 2] ``edges``
    given 0-based), <name>_graph_indicator.txt (1-based graph ids,
    ``indicator`` given 0-based) and each optional file given, comma
    separated, one row a line."""
    os.makedirs(base, exist_ok=True)

    def path(suffix):
        return os.path.join(base, f"{name}_{suffix}.txt")

    np.savetxt(path("A"), np.asarray(edges) + 1, fmt="%d", delimiter=", ")
    np.savetxt(path("graph_indicator"), np.asarray(indicator) + 1, fmt="%d")
    for suffix, arr, fmt in (("graph_labels", graph_labels, "%d"),
                             ("node_labels", node_labels, "%d"),
                             ("edge_labels", edge_labels, "%d"),
                             ("node_attributes", node_attributes, "%.6f"),
                             ("edge_attributes", edge_attributes, "%.6f")):
        if arr is not None:
            np.savetxt(path(suffix), np.asarray(arr), fmt=fmt,
                       delimiter=", ")


# ------------------------------------------------------------- draws

def preferential_attachment(n: int, edges: int,
                            rng: np.random.Generator) -> np.ndarray:
    """[edges, 2] distinct undirected pairs (u < v) on n nodes: node t
    attaches two edges to earlier nodes drawn by degree (the repeated-
    endpoint list of a Barabasi-Albert draw, as data/synthetic.py's
    generators do), the rest drawn between endpoints picked by degree,
    so a few early nodes become hubs."""
    ends = [0, 1]
    pairs = {(0, 1)}
    for t in range(2, n):
        for _ in range(2 if t > 2 else 1):
            u = ends[int(rng.integers(len(ends)))]
            if u != t and (u, t) not in pairs:
                pairs.add((u, t))
                ends += [u, t]
    while len(pairs) < edges:
        u, v = (ends[int(i)] for i in rng.integers(len(ends), size=2))
        if u != v and (min(u, v), max(u, v)) not in pairs:
            pairs.add((min(u, v), max(u, v)))
            ends += [u, v]
    out = np.asarray(sorted(pairs), np.int64)
    return out[np.sort(rng.permutation(len(out))[:edges])]


def write_planetoid_standin(root: str, name: str = "cora", seed: int = 0,
                            **sizes) -> str:
    """Planetoid files of ``name`` at CORA's sizes (or ``sizes``) under
    root/<name in lower case>/raw; returns that directory.  The graph is a
    preferential-attachment draw (a hub of degree ~170 at Cora's size);
    each node's class is uniform, its words half from its class's
    vocabulary, half from the whole; the test indices are the last
    test_rows nodes in a random order."""
    s = {**CORA, **sizes}
    rng = np.random.default_rng(seed)
    n, d, c = s["nodes"], s["features"], s["classes"]
    pairs = preferential_attachment(n, s["edges"], rng)
    graph: Dict[int, list] = {i: [] for i in range(n)}
    for u, v in pairs.tolist():
        graph[u].append(v)
        graph[v].append(u)
    labels = rng.integers(c, size=n)
    vocab = np.array_split(rng.permutation(d), c)
    feat = np.zeros((n, d), np.float32)
    for i in range(n):
        k = max(int(rng.poisson(s["nnz"])), 1)
        own = rng.choice(vocab[labels[i]], size=min(k // 2,
                                                    len(vocab[labels[i]])),
                         replace=False)
        feat[i, own] = 1
        feat[i, rng.choice(d, size=k - len(own), replace=False)] = 1
    onehot = np.eye(c, dtype=np.int32)[labels]
    test = n - s["test_rows"] + rng.permutation(s["test_rows"])
    a = s["allx_rows"]
    base = os.path.join(root, name.lower(), "raw")
    write_planetoid(base, name, feat[:s["x_rows"]], feat[test], feat[:a],
                    onehot[:s["x_rows"]], onehot[test], onehot[:a], graph,
                    test)
    return base


def _sizes(rng: np.random.Generator, s: dict) -> np.ndarray:
    """Graph sizes in [min_nodes, max_nodes] summing to ``nodes``:
    ``large`` graphs from the upper range, the others from the lower,
    then moved a node at a time to the exact sum; the bounds are both
    reached."""
    g, lo, hi, total = s["graphs"], s["min_nodes"], s["max_nodes"], s["nodes"]
    big = s["large"]
    ratio = s["edges"] / total             # undirected edges a node
    least_big = int(np.ceil(100 / ratio)) + 2
    sizes = np.concatenate([
        rng.integers(min(least_big, hi), hi + 1, size=big),
        rng.integers(lo, max(least_big, lo + 1), size=g - big)])
    sizes[0], sizes[-1] = hi, lo
    while sizes.sum() != total:
        step = 1 if sizes.sum() < total else -1
        i = int(rng.integers(1, g - 1))
        small = i >= big
        top = least_big - 1 if small else hi
        bottom = lo if small else least_big
        if bottom <= sizes[i] + step <= top:
            sizes[i] += step
    return rng.permutation(sizes)


def _graph_edges(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """[m, 2] distinct undirected pairs on n nodes: a random tree, then
    random pairs (m is clipped to [n - 1, n (n - 1) / 2])."""
    m = min(max(m, n - 1), n * (n - 1) // 2)
    order = rng.permutation(n)
    pairs = {tuple(sorted((int(order[i]), int(order[rng.integers(i)]))))
             for i in range(1, n)}
    while len(pairs) < m:
        u, v = (int(x) for x in rng.integers(n, size=2))
        if u != v:
            pairs.add((min(u, v), max(u, v)))
    return np.asarray(sorted(pairs), np.int64).reshape(-1, 2)


def write_tu_standin(root: str, name: str = "ENZYMES", seed: int = 0,
                     **sizes) -> str:
    """TU files of ``name`` at ENZYMES' sizes (or ``sizes``) under
    root/<name>/raw; returns that directory.  Each graph a random tree
    plus random edges, its undirected edge count proportional to its
    nodes and the total exact; graph labels uniform in 0..classes-1,
    node labels in 0..node_labels-1, node attributes normal (no file at
    attributes=0)."""
    s = {**ENZYMES, **sizes}
    rng = np.random.default_rng(seed)
    sizes_ = _sizes(rng, s)
    ratio = s["edges"] / s["nodes"]
    want = np.maximum(np.round(sizes_ * ratio).astype(np.int64), sizes_ - 1)
    cap = sizes_ * (sizes_ - 1) // 2
    want = np.minimum(want, cap)
    while want.sum() != s["edges"]:
        step = 1 if want.sum() < s["edges"] else -1
        i = int(rng.integers(len(want)))
        if sizes_[i] - 1 <= want[i] + step <= cap[i]:
            want[i] += step
    edges, offset = [], 0
    for n, m in zip(sizes_.tolist(), want.tolist()):
        e = _graph_edges(n, m, rng) + offset
        # both directions, each undirected edge's two lines together
        edges.append(np.stack([e, e[:, ::-1]], axis=1).reshape(-1, 2))
        offset += n
    total = int(sizes_.sum())
    base = os.path.join(root, name, "raw")
    write_tu(base, name, np.concatenate(edges),
             np.repeat(np.arange(len(sizes_)), sizes_),
             graph_labels=rng.integers(s["classes"], size=len(sizes_)),
             node_labels=rng.integers(s["node_labels"], size=total),
             node_attributes=(rng.normal(size=(total, s["attributes"]))
                              if s["attributes"] else None))
    return base
