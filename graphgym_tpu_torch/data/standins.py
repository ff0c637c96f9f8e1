"""Seeded stand-ins for real datasets, written in their published raw
formats.

The raw files of the ID-GNN paper's real datasets (Cora's Planetoid
pickles, ENZYMES' TU text files, OGB's csv.gz directories) are not in
the repository.  This module writes files in those formats, at the
published sizes, with content drawn from a seed with numpy only, so
that the port's parsers (``data/loaders.load_planetoid``, ``load_tu``,
``data/ogb.load_ogb``) and everything after them run at the real
shapes.  The content is not the real data: no accuracy measured on it
says anything about the real datasets.

    write_planetoid_standin(root, "cora", seed)  -> root/cora/raw/ind.cora.*
    write_tu_standin(root, "ENZYMES", seed)      -> root/ENZYMES/raw/ENZYMES_*
    write_molhiv_standin(root, seed)             -> root/ogbg_molhiv/{raw,split}
    write_arxiv_standin(root, seed)              -> root/ogbn_arxiv/{raw,split}

``CORA``, ``ENZYMES``, ``MOLHIV`` and ``ARXIV`` hold the published
sizes; smaller ones are passed as keyword overrides (the tests' small
sets).  The csv.gz files are written by ``write_csv_gz``: each distinct
value formatted once, the rows joined, gzip at level 1 (np.savetxt
formats value by value, ~1 us each: about a minute at arxiv's 21.7 M
feature values).
"""

from __future__ import annotations

import collections
import gzip
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
# ogbg-molhiv (OGB): 41,127 molecules, about 25.5 atoms and 27.5 bonds
# each (a bond listed once in raw/edge.csv.gz), 9 atom and 3 bond
# feature columns, binary labels about 3.5% positive, the scaffold split
# 32,901 / 4,113 / 4,113; atoms of up to ``max_nodes``
MOLHIV = dict(graphs=41127, mean_nodes=25.5, max_nodes=222, rings=3.0,
              positive=0.035, split=(32901, 4113, 4113))
# ogbn-arxiv (OGB): 169,343 papers, 1,166,243 directed citations, 128
# float features, 40 classes, the time split 90,941 / 29,799 / 48,603
ARXIV = dict(nodes=169343, edges=1166243, features=128, classes=40,
             split=(90941, 29799, 48603))


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
    attributes=0), and with ``edge_labels`` > 0 an edge label file,
    each undirected edge's label uniform in 0..edge_labels-1 on both
    its lines (ENZYMES has none)."""
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
    graph_labels = rng.integers(s["classes"], size=len(sizes_))
    node_labels = rng.integers(s["node_labels"], size=total)
    attributes = (rng.normal(size=(total, s["attributes"]))
                  if s["attributes"] else None)
    edge_labels = None
    if s.get("edge_labels"):
        edge_labels = np.repeat(rng.integers(s["edge_labels"],
                                             size=int(want.sum())), 2)
    write_tu(base, name, np.concatenate(edges),
             np.repeat(np.arange(len(sizes_)), sizes_),
             graph_labels=graph_labels, node_labels=node_labels,
             node_attributes=attributes, edge_labels=edge_labels)
    return base


# ------------------------------------------------------------------- OGB

def write_csv_gz(path: str, arr: np.ndarray, decimals: int = 0) -> None:
    """``arr`` (2-D, or 1-D as one column) as comma-separated rows in a
    gzip file (level 1): integers as written, or with ``decimals``
    digits after the point (rounded to them).  Each distinct value is
    formatted once and looked up."""
    arr = np.asarray(arr)
    arr = arr[:, None] if arr.ndim == 1 else arr
    q = (np.round(arr * 10.0 ** decimals) if decimals else arr) \
        .astype(np.int64)
    lo = int(q.min()) if q.size else 0
    hi = int(q.max()) if q.size else 0
    if decimals:
        lut = np.array([f"{v / 10 ** decimals:.{decimals}f}"
                        for v in range(lo, hi + 1)], dtype=object)
    else:
        lut = np.array([str(v) for v in range(lo, hi + 1)], dtype=object)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt", compresslevel=1) as f:
        f.write("\n".join(map(",".join, lut[q - lo].tolist())))
        if q.size:
            f.write("\n")


def _write_split(base: str, parts) -> None:
    for name, idx in zip(("train", "valid", "test"), parts):
        write_csv_gz(os.path.join(base, f"{name}.csv.gz"), idx)


def _categorical(rng: np.random.Generator, n: int, probs) -> np.ndarray:
    p = np.asarray(probs, np.float64)
    return rng.choice(len(p), size=n, p=p / p.sum())


def write_molhiv_standin(root: str, seed: int = 0, **sizes) -> str:
    """ogbg-molhiv's raw directory at MOLHIV's sizes (or ``sizes``)
    under root/ogbg_molhiv; returns that directory.  Each molecule a
    random tree (an atom bonded to one of the three before it) plus
    ring closures (an atom to the one five before it, a Poisson count
    of mean ``rings``), sizes drawn around ``mean_nodes`` (the first
    molecule at max_nodes, the second at 2 atoms); atom columns within
    ATOM_FEATURE_DIMS, mostly carbon, bond columns within
    BOND_FEATURE_DIMS; labels 1 with probability ``positive``; the
    split a seeded permutation (split/scaffold)."""
    s = {**MOLHIV, **sizes}
    rng = np.random.default_rng(seed)
    g = s["graphs"]
    n = np.maximum(np.round(rng.gamma(6.0, s["mean_nodes"] / 6.0, g)),
                   2).astype(np.int64)
    n = np.minimum(n, s["max_nodes"])
    n[0], n[min(1, g - 1)] = s["max_nodes"], 2
    total = int(n.sum())
    first = np.repeat(np.cumsum(n) - n, n)
    local = np.arange(total) - first
    back = rng.integers(1, 4, size=total)
    parent = local - np.minimum(back, np.maximum(local, 1))
    tree = np.stack([local, parent], axis=1)[local > 0]
    graph_of = np.repeat(np.arange(g), n)[local > 0]
    edges, counts = [tree], np.bincount(graph_of, minlength=g)
    rings = np.minimum(rng.poisson(s["rings"], g), np.maximum(n - 5, 0))
    ring_edges = [np.stack([u, u - 5], axis=1) for u in
                  (5 + rng.permutation(int(m) - 5)[:int(r)]
                   for m, r in zip(n.tolist(), rings.tolist()))]
    # graph-major: each molecule's tree bonds, then its ring closures
    starts = np.concatenate([[0], np.cumsum(counts)])
    per = []
    for gi in range(g):
        per.append(tree[starts[gi]:starts[gi + 1]])
        per.append(ring_edges[gi].reshape(-1, 2))
    edges = np.concatenate(per).astype(np.int64)
    num_edges = counts + rings
    atom = np.stack([
        _categorical(rng, total, [.005, 0, 0, 0, 0, .72, .1, .1, .01, 0,
                                  0, 0, 0, 0, .005, .02, .02, 0, 0, 0, 0,
                                  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                  .01, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                  0, 0, 0, 0, 0, 0, .01]),
        _categorical(rng, total, [.97, .015, .015, 0]),
        _categorical(rng, total, [.01, .25, .35, .3, .08, .01]),
        _categorical(rng, total, [0, 0, 0, 0, .01, .97, .02]),
        _categorical(rng, total, [.55, .25, .15, .05]),
        _categorical(rng, total, [.999, .001]),
        _categorical(rng, total, [0, .05, .45, .5]),
        _categorical(rng, total, [.55, .45]),
        _categorical(rng, total, [.45, .55])], axis=1)
    m = len(edges)
    bond = np.stack([_categorical(rng, m, [.55, .1, .02, .33]),
                     _categorical(rng, m, [.97, .01, .01, .01]),
                     _categorical(rng, m, [.5, .5])], axis=1)
    label = (rng.random(g) < s["positive"]).astype(np.int64)
    parts = np.split(rng.permutation(g), np.cumsum(s["split"])[:-1])
    base = os.path.join(root, "ogbg_molhiv")
    raw = os.path.join(base, "raw")
    write_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), n)
    write_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"), num_edges)
    write_csv_gz(os.path.join(raw, "edge.csv.gz"), edges)
    write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), atom)
    write_csv_gz(os.path.join(raw, "edge-feat.csv.gz"), bond)
    write_csv_gz(os.path.join(raw, "graph-label.csv.gz"), label)
    _write_split(os.path.join(base, "split", "scaffold"),
                 [np.sort(p) for p in parts])
    return base


def write_arxiv_standin(root: str, seed: int = 0, **sizes) -> str:
    """ogbn-arxiv's raw directory at ARXIV's sizes (or ``sizes``) under
    root/ogbn_arxiv; returns that directory.  Papers in time order, each
    citation from a uniform paper to an earlier one drawn toward the
    first papers (u^1.5 of its index), the directed pairs distinct;
    features a class centre plus noise, at 4 decimals; the time split
    the first, middle and last papers (split/time)."""
    s = {**ARXIV, **sizes}
    rng = np.random.default_rng(seed)
    n, e = s["nodes"], s["edges"]
    seen = np.zeros(0, np.int64)
    while len(seen) < e:
        src = rng.integers(1, n, size=e)
        dst = (src * rng.random(e) ** 1.5).astype(np.int64)
        seen = np.unique(np.concatenate([seen, src * n + dst]))
    keep = np.sort(rng.permutation(len(seen))[:e])
    pairs = np.stack([seen[keep] // n, seen[keep] % n], axis=1)
    label = rng.integers(s["classes"], size=n)
    centre = rng.normal(scale=0.5, size=(s["classes"], s["features"]))
    feat = centre[label] + rng.normal(scale=0.5, size=(n, s["features"]))
    a, b = s["split"][0], s["split"][0] + s["split"][1]
    base = os.path.join(root, "ogbn_arxiv")
    raw = os.path.join(base, "raw")
    write_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), [n])
    write_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"), [e])
    write_csv_gz(os.path.join(raw, "edge.csv.gz"), pairs)
    write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), feat, decimals=4)
    write_csv_gz(os.path.join(raw, "node-label.csv.gz"), label)
    _write_split(os.path.join(base, "split", "time"),
                 [np.arange(a), np.arange(a, b), np.arange(b, n)])
    return base
