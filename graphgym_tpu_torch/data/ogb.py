"""OGB raw-directory loaders (the port of graphgym_tpu/data/ogb.py): no
``ogb`` package, no network access.

Parses the on-disk layout that OGB's download step leaves under
``<root>/<name with '-' -> '_'>/``:

    raw/num-node-list.csv.gz     one row per graph: node count
    raw/num-edge-list.csv.gz     one row per graph: edge count
    raw/edge.csv.gz              all edges, rows "src,dst" (graph-major)
    raw/node-feat.csv.gz         optional [sum(N), F] node features
    raw/node-label.csv.gz        node-prop targets (ogbn)
    raw/graph-label.csv.gz       graph-prop targets (ogbg)
    split/<scheme>/{train,valid,test}.csv.gz
        ogbn: node indices; ogbg: graph indices
        ogbl: positive edges ("src,dst"), plus {valid,test}_neg.csv.gz

and carries the official split indices to ``ogb_split_dataset``, which
the loader's ``split_dataset`` takes ahead of the ratio split (reference
loader_pyg.py:84-138 ``load_ogb``, loader.py:118-124).  Array for array
the JAX package's parse, with its choices: ogbn edges made undirected
and deduplicated, ogbg edges kept as the raw file lists them (no
reverse edges added), and ``raw/edge-feat.csv.gz`` read by neither.

A link split stored as a torch ``.pt`` file is read with
``torch.load(weights_only=True)`` (tensors, dicts and lists only), where
the JAX package unpickles anything; csv.gz takes precedence.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional

import numpy as np

from graphgym_tpu_torch.data.hostgraph import HostGraph


def _read_csv_gz(path: str, dtype) -> Optional[np.ndarray]:
    """Read a csv.gz (or plain csv) into a 2-D array; None if absent."""
    if not os.path.exists(path):
        alt = path[:-3] if path.endswith(".gz") else path + ".gz"
        if not os.path.exists(alt):
            return None
        path = alt
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def ogb_dir(name: str, dataset_dir: str) -> str:
    """OGB convention: dashes in the dataset name become underscores in
    the directory (ogbn-arxiv -> <root>/ogbn_arxiv); the name as given
    is tried second."""
    for cand in (name.replace("-", "_"), name):
        path = os.path.join(dataset_dir, cand)
        if os.path.isdir(path):
            return path
    raise FileNotFoundError(
        f"OGB raw directory for {name!r} not found under {dataset_dir} "
        "(expected the standard csv.gz layout; no network access to "
        "download it)")


def _split_scheme_dir(root: str) -> str:
    """The first split scheme under root/split/, in name order."""
    split_root = os.path.join(root, "split")
    if not os.path.isdir(split_root):
        raise FileNotFoundError(f"{root} has no split/ directory")
    schemes = sorted(d for d in os.listdir(split_root)
                     if os.path.isdir(os.path.join(split_root, d)))
    if not schemes:
        raise FileNotFoundError(f"{split_root} has no split scheme")
    return os.path.join(split_root, schemes[0])


def _read_split_indices(scheme_dir: str) -> Dict[str, np.ndarray]:
    out = {}
    for part in ("train", "valid", "test"):
        idx = _read_csv_gz(os.path.join(scheme_dir, f"{part}.csv.gz"),
                           np.int64)
        if idx is None:
            raise FileNotFoundError(f"{scheme_dir}/{part}.csv.gz missing")
        out[part] = idx.reshape(-1)
    return out


def _read_split_edges(scheme_dir: str) -> Dict[str, np.ndarray]:
    """Link splits: train / valid / test positive edges and valid / test
    negatives, each [K, 2]; csv.gz preferred, a torch .pt file (a
    tensor, or ogb's {'edge': tensor} / {'edge_neg': tensor}) read as
    tensors only."""
    out = {}
    for part in ("train", "valid", "test", "valid_neg", "test_neg"):
        arr = _read_csv_gz(os.path.join(scheme_dir, f"{part}.csv.gz"),
                           np.int64)
        pt = os.path.join(scheme_dir, f"{part}.pt")
        if arr is None and os.path.exists(pt):
            import torch
            t = torch.load(pt, map_location="cpu", weights_only=True)
            if isinstance(t, dict):
                t = t.get("edge", t.get("edge_neg"))
            arr = np.asarray(t, np.int64)
        if arr is not None:
            out[part] = arr.reshape(-1, 2)
    for req in ("train", "valid", "test"):
        if req not in out:
            raise FileNotFoundError(
                f"{scheme_dir}/{req}.csv.gz (or .pt) missing")
    return out


def _raw_graph_arrays(root: str):
    raw = os.path.join(root, "raw")
    num_nodes = _read_csv_gz(os.path.join(raw, "num-node-list.csv.gz"),
                             np.int64)
    num_edges = _read_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"),
                             np.int64)
    edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    if num_nodes is None or edges is None:
        raise FileNotFoundError(f"{raw} missing num-node-list/edge files")
    node_feat = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"),
                             np.float32)
    return (num_nodes.reshape(-1),
            None if num_edges is None else num_edges.reshape(-1),
            edges, node_feat)


def load_ogb_node(name: str, dataset_dir: str) -> List[HostGraph]:
    """ogbn-*: one graph, its edges undirected and deduplicated
    (reference loader_pyg.py:92-93), and the official train / val /
    test node indices, sorted, as ``_ogb_train`` / ``_ogb_val`` /
    ``_ogb_test`` beside the ``_ogb_split`` marker."""
    root = ogb_dir(name, dataset_dir)
    num_nodes, _, edges, node_feat = _raw_graph_arrays(root)
    n = int(num_nodes.sum())
    s, d = edges[:, 0], edges[:, 1]
    pairs = np.unique(np.stack([np.concatenate([s, d]),
                                np.concatenate([d, s])], axis=1), axis=0)
    g = HostGraph(n, pairs.T.astype(np.int32))
    if node_feat is not None:
        g["node_feature"] = node_feat.astype(np.float32)
    label = _read_csv_gz(os.path.join(root, "raw", "node-label.csv.gz"),
                         np.float64)
    if label is not None:
        lab = label.reshape(n, -1)
        g["node_label"] = (lab.astype(np.int64).reshape(-1)
                           if lab.shape[1] == 1 else lab)
    splits = _read_split_indices(_split_scheme_dir(root))
    g.feats["_ogb_split"] = np.array(0)     # marker; arrays below
    g.feats["_ogb_train"] = np.sort(splits["train"]).astype(np.int64)
    g.feats["_ogb_val"] = np.sort(splits["valid"]).astype(np.int64)
    g.feats["_ogb_test"] = np.sort(splits["test"]).astype(np.int64)
    return [g]


def load_ogb_graph(name: str, dataset_dir: str) -> List[HostGraph]:
    """ogbg-*: one HostGraph a graph, its edges 0-based within the graph
    and as the raw file lists them, no edge features; each graph's
    official part (0 train, 1 valid, 2 test, -1 none) as ``_ogb_part``
    (reference loader.py:118-124).  A graph label that is integral is
    kept as int64, else as float32."""
    root = ogb_dir(name, dataset_dir)
    num_nodes, num_edges, edges, node_feat = _raw_graph_arrays(root)
    if num_edges is None:
        raise FileNotFoundError("ogbg needs raw/num-edge-list.csv.gz")
    graph_label = _read_csv_gz(
        os.path.join(root, "raw", "graph-label.csv.gz"), np.float64)
    splits = _read_split_indices(_split_scheme_dir(root))
    part_of = np.full(len(num_nodes), -1, np.int64)
    for pi, part in enumerate(("train", "valid", "test")):
        part_of[splits[part]] = pi

    graphs: List[HostGraph] = []
    e_off = n_off = 0
    for gi, (nn, ne) in enumerate(zip(num_nodes.tolist(),
                                      num_edges.tolist())):
        e = edges[e_off:e_off + ne]
        g = HostGraph(nn, e.T.astype(np.int32) if ne
                      else np.zeros((2, 0), np.int32))
        if node_feat is not None:
            g["node_feature"] = node_feat[n_off:n_off + nn]
        if graph_label is not None:
            lab = graph_label[gi].reshape(-1)
            g["graph_label"] = (lab.astype(np.int64)
                                if np.allclose(lab, np.round(lab))
                                else lab.astype(np.float32))
        g.feats["_ogb_part"] = np.array(int(part_of[gi]))
        graphs.append(g)
        e_off += ne
        n_off += nn
    return graphs


def load_ogb_link(name: str, dataset_dir: str) -> List[HostGraph]:
    """ogbl-*: one graph whose message edges are the train positives in
    both directions; each split's supervision edges as ``_ogbl_*``
    (reference loader_pyg.py:104-133)."""
    root = ogb_dir(name, dataset_dir)
    num_nodes, _, _, node_feat = _raw_graph_arrays(root)
    n = int(num_nodes.sum())
    splits = _read_split_edges(_split_scheme_dir(root))
    train_pos = splits["train"]
    msg = np.concatenate([train_pos, train_pos[:, ::-1]], axis=0)
    g = HostGraph(n, msg.T.astype(np.int32))
    if node_feat is not None:
        g["node_feature"] = node_feat.astype(np.float32)
    g.feats["_ogb_split"] = np.array(1)
    for part in ("train", "valid", "test", "valid_neg", "test_neg"):
        if part in splits:
            g.feats[f"_ogbl_{part}"] = splits[part].astype(np.int64)
    return [g]


def load_ogb(name: str, dataset_dir: str) -> List[HostGraph]:
    if name.startswith("ogbn"):
        return load_ogb_node(name, dataset_dir)
    if name.startswith("ogbg"):
        return load_ogb_graph(name, dataset_dir)
    if name.startswith("ogbl"):
        return load_ogb_link(name, dataset_dir)
    raise ValueError(f"OGB dataset {name!r}: unknown prefix "
                     "(expected ogbn-/ogbg-/ogbl-)")


# ------------------------------------------------------------------ splits

def has_ogb_split(graphs: List[HostGraph]) -> bool:
    g0 = graphs[0] if graphs else None
    return g0 is not None and ("_ogb_split" in g0 or "_ogb_part" in g0)


def ogb_split_dataset(graphs: List[HostGraph], cfg,
                      rng: np.random.Generator) -> List[List[HostGraph]]:
    """The official OGB split in place of the ratio split (reference:
    the masks and graph-index attributes of loader_pyg.load_ogb).

    Graph property: each graph goes to its ``_ogb_part`` (removed from
    the graph); a graph of no part is dropped.  Link property: one copy
    of the graph a split, its supervision the split's positives then its
    negatives (the split's own, else drawn 1:1 by ``negative_sampling``
    on ``rng``), labels 1 then 0.  Node property: one copy a split, its
    ``node_label_index`` the split's official indices."""
    g0 = graphs[0]
    if "_ogb_part" in g0:                       # graph property
        splits = [[], [], []]
        for g in graphs:
            pi = int(g.feats.pop("_ogb_part"))
            if pi >= 0:
                splits[pi].append(g)
        return splits

    if "_ogbl_train" in g0.feats:               # link property
        from graphgym_tpu_torch.data.transforms import negative_sampling
        splits = []
        neg_keys = {"train": None, "valid": "_ogbl_valid_neg",
                    "test": "_ogbl_test_neg"}
        for part in ("train", "valid", "test"):
            gg = _without_ogb_keys(g0.copy())
            pos = g0.feats[f"_ogbl_{part}"].T           # [2, K]
            nk = neg_keys[part]
            if nk is not None and nk in g0.feats:
                neg = g0.feats[nk].T
            else:
                neg = negative_sampling(g0.edge_index, g0.num_nodes,
                                        pos.shape[1], rng)
            gg["edge_label_index"] = np.concatenate(
                [pos, neg], axis=1).astype(np.int32)
            gg["edge_label"] = np.concatenate(
                [np.ones(pos.shape[1]), np.zeros(neg.shape[1])]
            ).astype(np.int64)
            splits.append([gg])
        return splits

    splits = []                                 # node property
    for key in ("_ogb_train", "_ogb_val", "_ogb_test"):
        gg = g0.copy()
        idx = gg.feats.pop(key)
        gg = _without_ogb_keys(gg)
        gg["node_label_index"] = idx.astype(np.int64)
        splits.append([gg])
    return splits


def _without_ogb_keys(g: HostGraph) -> HostGraph:
    for k in [k for k in g.feats if k.startswith("_ogb")]:
        del g.feats[k]
    return g
