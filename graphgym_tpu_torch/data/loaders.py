"""Dataset loading, splitting, transforms and GraphBatch batching.

The port of graphgym_tpu/data/loaders.py for the node, graph, edge and
link_pred tasks (reference graphgym/loader.py:24-260):
  load graphs -> feature augmentation -> label replacement (path-length
  labels on the edge task) -> split with its edge supervision -> ego or
  edge transform per split -> padded GraphBatches with the packed SpMM
  layouts.

Formats (cfg.dataset.format, 'Tfg-' prefixes accepted): 'nx' = pickled
graph lists or the regenerated synthetic corpora; 'PyG' / 'Planetoid' =
the raw files behind PyG's datasets, parsed natively (Planetoid, TU,
Karate, the GNN-benchmark npz, PPI, QM7b, MNIST superpixels); 'TU' =
raw TU files; 'OGB' = OGB raw directories (data/ogb.py), whose official
split replaces the ratio split; 'syn' = generated on the fly.
cfg.dataset.cache_save / cache_load keep the processed splits in the
JAX package's cache file.

Batches always carry the packs their layer consumes, on CPU and CUDA
alike (the port has no COO path); a graph task's batches the pack of
its head's pooling; a batch with supervised node pairs the pair pack of
the edge head's gather; and a batch whose supervised node index repeats
a node the label pack of the node head's gather (``graphs/packing.
build_gather_packs``), so no gather on a training path has a
float-atomic backward; a model with a built-in node or edge encoder
the embedding pack of its lookup (``build_embed_pack``); an
edge-feature conv the 'edge' pack and the gather packs of its messages,
and generalogbconv the embedding pack of its bond tables where the batch
has edge features (graphs/packing.py).  Batches carry
the graphs' edge features where every graph has them.  A train split
with cfg.train.sampler other than full_batch (an eval split with
cfg.val.sampler) draws sampled subgraphs each epoch
(``SamplerLoader``, data/samplers.py); cfg.train.sample_node
(cfg.val.sample_node) supervises a fresh subset of nodes each epoch.
What the port does not run yet raises NotImplementedError naming its
ROADMAP item: mesh plans (A16).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import List, Optional, Sequence

import numpy as np

from graphgym_tpu_torch import register
from graphgym_tpu_torch.data.augment import FeatureAugment, replace_label
from graphgym_tpu_torch.data.hostgraph import HostGraph, from_networkx
from graphgym_tpu_torch.data.transforms import (edge_nets, ego_nets,
                                                negative_sampling,
                                                path_len_labels)
from graphgym_tpu_torch.graphs.container import (GraphBatch, bucket_size,
                                                 build_graph_batch)
from graphgym_tpu_torch.graphs.packing import (BOND_FEATURE_DIMS,
                                               EDGE_BOND, EDGE_ENCODER,
                                               EMBED_TABLES, LABELS,
                                               NODE_ENCODER, PAIRS,
                                               build_embed_pack,
                                               build_gather_packs,
                                               build_packs, build_pool_packs,
                                               coo_kinds,
                                               host_pool,
                                               kinds_for_cfg, pack_chunks,
                                               pad_packs)

# the repository's own corpus directory, searched after cfg.dataset.dir
_REPO_DATASETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "datasets")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class _CorpusUnpickler(pickle.Unpickler):
    """Reads the corpus pickles without the JAX package: they name the
    class ``graphgym_tpu.data.hostgraph.HostGraph``, which maps to the
    port's own HostGraph (same fields), and numpy 2's ``numpy._core``,
    which maps to ``numpy.core`` under numpy 1.x."""

    def find_class(self, module, name):
        if module == "graphgym_tpu.data.hostgraph" and name == "HostGraph":
            return HostGraph
        if module.startswith("numpy._core") \
                and int(np.__version__.split(".")[0]) < 2:
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


# Synthetic corpora regenerated from seed 0 when no pickle exists:
# name -> (generator kind, nodes per graph), as in
# graphgym_tpu/data/loaders.py:63-70.  scalefree / smallworld are the
# ID-GNN paper's names for the ba / ws families, so they regenerate the
# same graphs as ba / ws (not the shipped datasets/ws.pkl).
_REGENERABLE = {
    "ba": ("ba", 64), "ws": ("ws", 64),
    "scalefree": ("ba", 64), "smallworld": ("ws", 64),
    "ba500": ("ba", 500), "ws500": ("ws", 500),
}
_REGEN_GRAPHS = 256


def _find(fname: str, dataset_dir: str) -> Optional[str]:
    for d in (dataset_dir, _REPO_DATASETS):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            return path
    return None


def load_nx(name: str, dataset_dir: str) -> List[HostGraph]:
    """Pickled graph lists (reference load_nx, loader.py:78-92):
    HostGraphs or networkx graphs, from ``<name>.pkl`` (shipped, or
    written by the JAX package) under dataset_dir or the repository's
    datasets/.  Failing that, a known synthetic corpus is read from the
    port's own cache ``<name>.torch.pkl``, or regenerated without
    networkx (data/synthetic.py, graph-identical to the JAX package's)
    and cached there under dataset_dir: a file the JAX package never
    opens, read back only from there."""
    path = _find(f"{name}.pkl", dataset_dir)
    cache = os.path.join(dataset_dir, f"{name}.torch.pkl")
    if path is None and os.path.exists(cache):
        path = cache
    if path is None and name in _REGENERABLE:
        from graphgym_tpu_torch.data.synthetic import (generate_syn_graphs,
                                                       save_syn)
        kind, n = _REGENERABLE[name]
        logging.warning("%s.pkl not found; regenerating the %s synthetic "
                        "corpus from seed 0", name, kind)
        graphs = generate_syn_graphs(kind=kind, num_graphs=_REGEN_GRAPHS,
                                     n=n)
        os.makedirs(dataset_dir, exist_ok=True)
        save_syn(cache + ".tmp", graphs)
        os.replace(cache + ".tmp", cache)
        return graphs
    if path is None:
        raise FileNotFoundError(
            f"{name}.pkl not found under {dataset_dir} or {_REPO_DATASETS}")
    with open(path, "rb") as f:
        graphs = _CorpusUnpickler(f).load()
    if not isinstance(graphs, list):
        graphs = [graphs]
    return [g if isinstance(g, HostGraph) else from_networkx(g)
            for g in graphs]


# ------------------------------------------------------------ raw formats
#
# The parsers of graphgym_tpu/data/loaders.py:107-388, array for array.
# Raw files are looked up under cfg.dataset.dir, then the repository's
# datasets/; in each, under <subname>/raw, <subname>, then the directory.

def _find_raw(fname: str, dataset_dir: str, subname: str) -> str:
    for d in (dataset_dir, _REPO_DATASETS):
        for sub in (os.path.join(d, subname, "raw"),
                    os.path.join(d, subname), d):
            path = os.path.join(sub, fname)
            if os.path.exists(path):
                return path
    raise FileNotFoundError(
        f"{fname} not found under {dataset_dir} or {_REPO_DATASETS}")


# What a Planetoid pickle may build: numpy arrays, scipy sparse matrices
# and the graph's dict of lists, under Python 2's module names too (the
# published files are Python 2 pickles)
_PLANETOID_GLOBALS = {
    (m, n) for m in ("builtins", "__builtin__")
    for n in ("list", "dict", "set", "tuple", "object", "int", "float")
} | {(m, n) for m in ("copyreg", "copy_reg")
     for n in ("_reconstructor", "__newobj__")} | {
    ("collections", "defaultdict"), ("collections", "OrderedDict"),
    ("_codecs", "encode"), ("numpy", "ndarray"), ("numpy", "dtype")
} | {(f"numpy.{core}.{m}", n) for core in ("core", "_core")
     for m, n in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                  ("numeric", "_frombuffer"))}


class _PlanetoidUnpickler(_CorpusUnpickler):
    """The Planetoid files come from outside the program: their pickles
    may name only ``_PLANETOID_GLOBALS`` and scipy's sparse matrix
    classes (unpickling them needs scipy)."""

    def find_class(self, module, name):
        sparse = module.startswith("scipy.sparse") \
            and name.endswith(("_matrix", "_array"))
        if not sparse and (module, name) not in _PLANETOID_GLOBALS:
            raise pickle.UnpicklingError(
                f"a Planetoid file may not build {module}.{name}")
        return super().find_class(module, name)


def load_planetoid(name: str, dataset_dir: str) -> List[HostGraph]:
    """The raw Planetoid files (ind.<name>.{x,tx,allx,y,ty,ally,graph,
    test.index}), the format behind PyG's Planetoid('Cora' / 'CiteSeer'
    / 'PubMed') at reference loader.py:32-33 (graphgym_tpu/data/
    loaders.py:107-168).  Row i of tx / ty is node test.index[i]:
    CiteSeer's gaps in it are isolated nodes that keep zero features
    (and label 0).  Edges are symmetrized and deduplicated."""
    lname = name.lower()
    base = next((c for d in (dataset_dir, _REPO_DATASETS)
                 for c in (os.path.join(d, name, "raw"),
                           os.path.join(d, name),
                           os.path.join(d, lname, "raw"), d)
                 if os.path.exists(os.path.join(c, f"ind.{lname}.graph"))),
                None)
    if base is None:
        raise FileNotFoundError(
            f"Planetoid raw files for {name} not found (need "
            f"ind.{lname}.* under {dataset_dir} or {_REPO_DATASETS})")

    def read(suffix):
        with open(os.path.join(base, f"ind.{lname}.{suffix}"), "rb") as f:
            return _PlanetoidUnpickler(f, encoding="latin1").load()

    def dense(m):
        return np.asarray(m.todense()) if hasattr(m, "todense") \
            else np.asarray(m)

    tx, allx = dense(read("tx")), dense(read("allx"))
    ty, ally = np.asarray(read("ty")), np.asarray(read("ally"))
    graph = read("graph")
    test_idx = np.loadtxt(os.path.join(base, f"ind.{lname}.test.index"),
                          dtype=np.int64)
    n = int(test_idx.max()) + 1
    feat = np.zeros((n, allx.shape[1]), np.float32)
    labels = np.zeros((n, ally.shape[1]), np.float32)
    feat[:allx.shape[0]] = allx
    labels[:ally.shape[0]] = ally
    feat[test_idx] = tx
    labels[test_idx] = ty
    edges = [(u, v) for u, nbrs in graph.items() for v in nbrs
             if u < n and v < n]
    edge_index = np.asarray(edges, np.int32).T
    und = np.unique(np.concatenate([edge_index, edge_index[::-1]], axis=1),
                    axis=1)
    g = HostGraph(n, und.astype(np.int32))
    g["node_feature"] = feat
    g["node_label"] = labels.argmax(-1).astype(np.int64)
    return [g]


def _one_hot(labels: np.ndarray, width: int) -> np.ndarray:
    out = np.zeros((len(labels), width), np.float32)
    out[np.arange(len(labels)), labels] = 1
    return out


def load_tu(name: str, dataset_dir: str) -> List[HostGraph]:
    """Raw TU files (DS_A.txt, DS_graph_indicator.txt and the optional
    DS_graph_labels, DS_node_labels, DS_node_attributes, DS_edge_labels
    and DS_edge_attributes), the format behind TUDataset at reference
    loader.py:34-53 (graphgym_tpu/data/loaders.py:171-232).  Ids are
    1-based.  node_feature = the attributes, then the one-hot node
    labels (width: the largest label + 1), or a constant 1 where there
    is neither; edge_feature likewise from the edge attributes and
    labels; graph_label the file's integer label."""
    base = os.path.dirname(_find_raw(f"{name}_A.txt", dataset_dir, name))

    def maybe(suffix):
        path = os.path.join(base, f"{name}_{suffix}.txt")
        return np.loadtxt(path, delimiter=",", ndmin=2) \
            if os.path.exists(path) else None

    a = np.loadtxt(os.path.join(base, f"{name}_A.txt"),
                   delimiter=",").astype(np.int64) - 1
    indicator = np.loadtxt(os.path.join(
        base, f"{name}_graph_indicator.txt")).astype(np.int64) - 1
    glabels = maybe("graph_labels")
    nlabels, nattrs = maybe("node_labels"), maybe("node_attributes")
    elabels, eattrs = maybe("edge_labels"), maybe("edge_attributes")

    num_graphs = int(indicator.max()) + 1
    offsets = np.zeros(num_graphs + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(indicator, minlength=num_graphs))
    edge_graph = indicator[a[:, 0]]
    graphs = []
    for gi in range(num_graphs):
        lo, hi = offsets[gi], offsets[gi + 1]
        em = edge_graph == gi
        g = HostGraph(int(hi - lo), (a[em] - lo).T.astype(np.int32))
        feats = []
        if nattrs is not None:
            feats.append(nattrs[lo:hi].astype(np.float32))
        if nlabels is not None:
            feats.append(_one_hot(nlabels[lo:hi].astype(np.int64)
                                  .reshape(-1), int(nlabels.max()) + 1))
        if not feats:
            feats.append(np.ones((int(hi - lo), 1), np.float32))
        g["node_feature"] = np.concatenate(feats, axis=1)
        efeats = []
        if eattrs is not None:
            efeats.append(eattrs[em].astype(np.float32))
        if elabels is not None:
            efeats.append(_one_hot(elabels[em].astype(np.int64).reshape(-1),
                                   int(elabels.max()) + 1))
        if efeats:
            g["edge_feature"] = np.concatenate(efeats, axis=1)
        if glabels is not None:
            g["graph_label"] = np.asarray(
                [int(glabels[gi].reshape(-1)[0])], np.int64)
        graphs.append(g)
    return graphs


def tu_simple_filter(graphs: List[HostGraph]) -> List[HostGraph]:
    """Reference loader.py:45-53, for the node tasks on TU data: the 100
    graphs with the fewest directed edges among those with at least
    200 (both directions counted), in a stable order."""
    sizes = np.array([g.num_edges if g.num_edges >= 200 else 9999
                      for g in graphs])
    return [graphs[i] for i in np.argsort(sizes, kind="stable")[:100]]


_KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8),
    (0, 10), (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21),
    (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21),
    (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
    (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10),
    (5, 16), (6, 16), (8, 30), (8, 32), (8, 33), (9, 33), (13, 33),
    (14, 32), (14, 33), (15, 32), (15, 33), (18, 32), (18, 33), (19, 33),
    (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27), (23, 29),
    (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29),
    (26, 33), (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32),
    (30, 33), (31, 32), (31, 33), (32, 33))
_KARATE_LABELS = (1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 1, 1, 0,
                  1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)


def load_karate() -> List[HostGraph]:
    """Zachary's karate club (reference loader.py:54-55 KarateClub): 34
    nodes, 78 undirected edges, identity features, community labels."""
    arr = np.asarray(_KARATE_EDGES, np.int32)
    g = HostGraph(34, np.concatenate([arr, arr[:, ::-1]], axis=0).T
                  .astype(np.int32))
    g["node_feature"] = np.eye(34, dtype=np.float32)
    g["node_label"] = np.asarray(_KARATE_LABELS, np.int64)
    return [g]


def _csr_to_dense(data, indices, indptr, shape) -> np.ndarray:
    out = np.zeros(shape, np.float32)
    out[np.repeat(np.arange(shape[0]), np.diff(indptr)), indices] = data
    return out


def load_npz_graph(fname: str, dataset_dir: str) -> List[HostGraph]:
    """The GNN-benchmark npz format behind PyG's Coauthor / Amazon
    (reference loader.py:56-66): a CSR adjacency (adj_*), CSR or dense
    attributes (attr_*), integer labels; symmetrized, self loops
    dropped (PyG read_npz)."""
    path = _find_raw(fname, dataset_dir, fname.split(".")[0])
    with np.load(path) as z:
        n = int(z["adj_shape"][0])
        rows = np.repeat(np.arange(n), np.diff(z["adj_indptr"]))
        cols = np.asarray(z["adj_indices"], np.int64)
        if "attr_matrix" in z:
            x = np.asarray(z["attr_matrix"], np.float32)
        else:
            x = _csr_to_dense(z["attr_data"], z["attr_indices"],
                              z["attr_indptr"], (n, int(z["attr_shape"][1])))
        labels = np.asarray(z["labels"], np.int64)
    s, r = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    keep = s != r
    pairs = np.unique(np.stack([s[keep], r[keep]], axis=1), axis=0)
    g = HostGraph(n, pairs.T.astype(np.int32))
    g["node_feature"] = x
    g["node_label"] = labels
    return [g]


def load_ppi(dataset_dir: str) -> List[HostGraph]:
    """The GraphSAGE PPI files behind PyG's PPI (reference
    loader.py:69-70): per split {split}_graph.json (node-link),
    _feats.npy, _labels.npy (multi-label), _graph_id.npy; one graph per
    protein graph, its links symmetrized."""
    import json

    base = os.path.dirname(_find_raw("train_graph.json", dataset_dir, "PPI"))
    graphs = []
    for split in ("train", "valid", "test"):
        gpath = os.path.join(base, f"{split}_graph.json")
        if not os.path.exists(gpath):
            continue
        with open(gpath) as f:
            links = json.load(f)["links"]
        feats = np.load(os.path.join(base, f"{split}_feats.npy"))
        labels = np.load(os.path.join(base, f"{split}_labels.npy"))
        gids = np.load(os.path.join(base, f"{split}_graph_id.npy"))
        links = np.asarray([(l["source"], l["target"]) for l in links],
                           np.int64).reshape(-1, 2)
        for gid in np.unique(gids):
            nodes = np.where(gids == gid)[0]
            lo, hi = nodes.min(), nodes.max() + 1
            inside = ((links >= lo) & (links < hi)).all(axis=1)
            e = links[inside] - lo
            pairs = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
            g = HostGraph(int(hi - lo), pairs.T.astype(np.int32)
                          if len(pairs) else np.zeros((2, 0), np.int32))
            g["node_feature"] = feats[lo:hi].astype(np.float32)
            g["node_label"] = labels[lo:hi].astype(np.int64)
            graphs.append(g)
    return graphs


def load_qm7b(dataset_dir: str) -> List[HostGraph]:
    """qm7b.mat behind PyG's QM7b (reference loader.py:71-72): each
    Coulomb matrix of X [N, 23, 23] a dense weighted graph, its entry
    the 1-wide edge_feature; the targets T [N, 14] the graph_label."""
    from scipy.io import loadmat

    mat = loadmat(_find_raw("qm7b.mat", dataset_dir, "QM7b"))
    coulomb = np.asarray(mat["X"], np.float32)
    targets = np.asarray(mat["T"], np.float32)
    graphs = []
    for adj, target in zip(coulomb, targets):
        s, r = np.nonzero(adj)
        g = HostGraph(adj.shape[0], np.stack([s, r]).astype(np.int32))
        g["edge_feature"] = adj[s, r][:, None]
        g["node_feature"] = np.ones((adj.shape[0], 1), np.float32)
        g["graph_label"] = target
        graphs.append(g)
    return graphs


def load_mnist_superpixels(dataset_dir: str) -> List[HostGraph]:
    """MNISTSuperpixels.pt behind PyG's MNIST (reference
    loader.py:67-68): a torch-saved [train, test] pair of lists of
    per-graph dicts (x, edge_index, pos, y); node_feature = x then
    pos.  The file comes from outside the program: torch.load builds
    only tensors and plain containers from it."""
    import torch

    path = _find_raw("MNISTSuperpixels.pt", dataset_dir, "MNIST")
    graphs = []
    for split in torch.load(path, weights_only=True):
        for d in split:
            x = np.asarray(d["x"], np.float32)
            g = HostGraph(x.shape[0],
                          np.asarray(d["edge_index"], np.int32).reshape(2, -1))
            pos = d.get("pos")
            g["node_feature"] = x if pos is None else np.concatenate(
                [x, np.asarray(pos, np.float32)], axis=1)
            g["graph_label"] = np.asarray(
                [int(np.asarray(d["y"]).reshape(-1)[0])], np.int64)
            graphs.append(g)
    return graphs


def _load_pyg(name: str, cfg) -> List[HostGraph]:
    """The PyG dataset names the reference's loader.py:30-72 reads, each
    from its raw files (graphgym_tpu/data/loaders.py:402-431)."""
    d = cfg.dataset.dir
    if name in ("Cora", "CiteSeer", "PubMed"):
        return load_planetoid(name, d)
    if name == "Karate":
        return load_karate()
    if name.startswith("TU_"):
        # TU_IMDB is IMDB-MULTI (reference loader.py:36-40)
        return _load_tu_task("IMDB-MULTI" if name[3:] == "IMDB"
                             else name[3:], cfg)
    if "Coauthor" in name:
        return load_npz_graph("ms_academic_cs.npz" if "CS" in name
                              else "ms_academic_phy.npz", d)
    if "Amazon" in name:
        return load_npz_graph("amazon_electronics_computers.npz"
                              if "Computers" in name
                              else "amazon_electronics_photo.npz", d)
    if name == "PPI":
        return load_ppi(d)
    if name == "QM7b":
        return load_qm7b(d)
    if name == "MNIST":
        return load_mnist_superpixels(d)
    raise ValueError(f"PyG dataset {name} not supported natively; "
                     "provide raw files or use nx format")


def _load_tu_task(name: str, cfg) -> List[HostGraph]:
    """A TU dataset, cut by tu_simple_filter off the graph task where
    cfg.dataset.tu_simple asks."""
    graphs = load_tu(name, cfg.dataset.dir)
    if cfg.dataset.tu_simple and cfg.dataset.task != "graph":
        graphs = tu_simple_filter(graphs)
    return graphs


def load_dataset(cfg) -> List[HostGraph]:
    fmt = cfg.dataset.format
    if fmt.startswith("Tfg-"):
        fmt = fmt[4:]
    name = cfg.dataset.name
    for func in register.loader_dict.values():
        graphs = func(fmt, name, cfg.dataset.dir)
        if graphs is not None:
            return graphs
    if fmt == "nx":
        return load_nx(name, cfg.dataset.dir)
    if fmt in ("PyG", "Planetoid"):
        return _load_pyg(name, cfg)
    if fmt == "TU":
        return _load_tu_task(name, cfg)
    if fmt == "OGB":
        # the raw directory and its official split, no `ogb` package
        # (reference loader_pyg.py:84-138, loader.py:118-124)
        from graphgym_tpu_torch.data.ogb import load_ogb
        return load_ogb(name, cfg.dataset.dir)
    if fmt == "syn":
        from graphgym_tpu_torch.data.synthetic import generate_syn_graphs
        return generate_syn_graphs(name, seed=cfg.seed)
    raise ValueError(f"Unknown data format: {cfg.dataset.format}")


# ----------------------------------------------------------------- splits

def split_dataset(graphs: List[HostGraph], cfg,
                  rng: np.random.Generator) -> List[List[HostGraph]]:
    """DeepSNAP-style random split (reference loader.py:227-230;
    graphgym_tpu/data/loaders.py:451-556).

    Inductive: the list of graphs is partitioned, and every split's
    graphs get their default supervision (``_default_supervision``).
    A graph task is always inductive, whatever cfg.dataset.transductive
    says.  Transductive: each split shares the graphs; a node task
    partitions node_label_index by ratio, a link or edge task the
    undirected edge pairs (``_transductive_pairs``).  Graphs that carry
    an official OGB split are split by it instead (data/ogb.py
    ``ogb_split_dataset``; graphgym_tpu/data/loaders.py:459-463)."""
    from graphgym_tpu_torch.data.ogb import has_ogb_split, ogb_split_dataset
    if has_ogb_split(graphs):
        return ogb_split_dataset(graphs, cfg, rng)
    ratios = list(cfg.dataset.split)
    if not cfg.dataset.transductive or cfg.dataset.task == "graph":
        idx = np.arange(len(graphs))
        if cfg.dataset.shuffle_split:
            rng.shuffle(idx)
        bounds = np.cumsum([int(r * len(graphs)) for r in ratios[:-1]])
        splits = [[graphs[i] for i in part]
                  for part in np.split(idx, bounds)]
        for si, part in enumerate(splits):
            for g in part:
                _default_supervision(g, cfg, rng, split_index=si)
        return splits

    splits = [[] for _ in ratios]
    for g in graphs:
        if cfg.dataset.task in ("link_pred", "edge"):
            for si, gg in enumerate(_transductive_pairs(g, cfg, rng,
                                                        ratios)):
                splits[si].append(gg)
            continue
        if cfg.dataset.task != "node":
            raise ValueError(f"Transductive split undefined for task "
                             f"{cfg.dataset.task}")
        n = g.num_nodes
        perm = rng.permutation(n) if cfg.dataset.shuffle_split \
            else np.arange(n)
        bounds = np.cumsum([int(r * n) for r in ratios[:-1]])
        for si, part in enumerate(np.split(perm, bounds)):
            gg = g.copy()
            gg["node_label_index"] = np.sort(part)
            splits[si].append(gg)
    return splits


def _transductive_pairs(g: HostGraph, cfg, rng: np.random.Generator,
                        ratios) -> List[HostGraph]:
    """One copy of ``g`` per split for a transductive link or edge task
    (graphgym_tpu/data/loaders.py:496-556): the undirected pairs (both
    directions together) split by ratio; every split passes messages
    over the train pairs, and under the 'disjoint' edge_train_mode the
    train split re-splits its pairs into message edges and supervision
    (``_disjoint_split``).  Each split's supervision is its positives
    and negatives drawn against the full edge set, at the configured
    ratio on the train split and 1.0 on the others."""
    s, r = g.senders, g.receivers
    upper = s < r
    pairs = np.stack([s[upper], r[upper]], axis=0)
    m = pairs.shape[1]
    perm = rng.permutation(m)
    bounds = np.cumsum([int(rt * m) for rt in ratios[:-1]])
    parts = np.split(perm, bounds)
    train_pairs = pairs[:, parts[0]]
    msg_edges = np.concatenate([train_pairs, train_pairs[::-1]], axis=1)
    disjoint = cfg.dataset.edge_train_mode == "disjoint"
    out = []
    for si, part in enumerate(parts):
        gg = g.copy()
        if si == 0 and disjoint:
            msg_pairs, pos = _disjoint_split(
                train_pairs, cfg.dataset.edge_message_ratio, rng)
            _set_message_edges(gg, g.edge_index, g.get("edge_feature"),
                               np.concatenate([msg_pairs, msg_pairs[::-1]],
                                              axis=1))
        else:
            pos = pairs[:, part]
            _set_message_edges(gg, g.edge_index, g.get("edge_feature"),
                               msg_edges)
        num_neg = int(pos.shape[1]
                      * (cfg.dataset.edge_negative_sampling_ratio
                         if si == 0 else 1.0))
        neg = negative_sampling(g.edge_index, g.num_nodes, num_neg, rng)
        _set_supervision(gg, pos, neg)
        if si == 0 and disjoint and cfg.dataset.resample_disjoint:
            # the loader re-splits message and supervision each epoch
            # (reference config.py:159-160)
            gg["_train_pairs"] = train_pairs.astype(np.int32)
            _keep_full_edges(gg, g.edge_index, g.get("edge_feature"))
        elif si == 0 and cfg.dataset.resample_negative:
            # the loader re-draws the negatives each epoch against the
            # full edge set (reference config.py:162-163)
            gg["_pos_pairs"] = pos.astype(np.int32)
            gg["_full_edge_index"] = g.edge_index.astype(np.int32)
        out.append(gg)
    return out


def _set_supervision(g: HostGraph, pos: np.ndarray, neg: np.ndarray) -> None:
    """edge_label_index = positives then negatives, edge_label 1 / 0."""
    g["edge_label_index"] = np.concatenate([pos, neg], axis=1).astype(
        np.int32)
    g["edge_label"] = np.concatenate(
        [np.ones(pos.shape[1]), np.zeros(neg.shape[1])]).astype(np.int64)


def _keep_full_edges(g: HostGraph, edge_index: np.ndarray,
                     edge_feature) -> None:
    g["_full_edge_index"] = edge_index.astype(np.int32)
    if edge_feature is not None:
        g["_full_edge_feature"] = np.asarray(edge_feature)


def _default_supervision(g: HostGraph, cfg,
                         rng: Optional[np.random.Generator] = None,
                         split_index: int = 0) -> None:
    """An inductive split's supervision (graphgym_tpu/data/loaders.py:
    562-660).  A node task supervises every node.  A link or edge task
    supervises by cfg.dataset.edge_train_mode:

    - 'all': message edges = supervision positives = the full edge set,
      plus sampled negatives;
    - 'disjoint' (link_pred only): every split's graphs hold the
      supervision positives out of the message graph: message edges
      are edge_message_ratio of the undirected pairs, supervision the
      rest plus negatives (DeepSNAP's disjoint edge_train_mode,
      reference config.py:150-155).

    The negatives are drawn against the full edge set, at the
    configured ratio on the train split and 1.0 on the others
    (reference loader.py:231-233).  With the environment variable
    GRAPHGYM_LINK_BOTH_DIRS=1 (the JAX package's protocol probe,
    graphgym_tpu/data/loaders.py:613-617) the positives are stored in
    both directions, as DeepSNAP stores undirected supervision edges,
    before the negatives are drawn, so their count doubles too."""
    if cfg.dataset.task == "node" and "node_label_index" not in g:
        g["node_label_index"] = np.arange(g.num_nodes)
    if cfg.dataset.task not in ("link_pred", "edge") \
            or "edge_label_index" in g:
        return
    rng = rng or np.random.default_rng(cfg.seed)
    s, r = g.senders, g.receivers
    upper = s < r
    pairs = np.stack([s[upper], r[upper]], axis=0)
    if pairs.shape[1] == 0:   # directed-only storage: every edge
        pairs = g.edge_index
    full_edge_index = g.edge_index
    full_edge_feature = g.get("edge_feature")
    disjoint = (cfg.dataset.task == "link_pred"
                and cfg.dataset.edge_train_mode == "disjoint")
    if disjoint:
        msg_pairs, pos = _disjoint_split(
            pairs, cfg.dataset.edge_message_ratio, rng)
        # the link_eval_message_full probe keeps the full graph as the
        # eval splits' message graph
        if split_index == 0 or not cfg.dataset.get(
                "link_eval_message_full", False):
            _set_message_edges(g, full_edge_index, full_edge_feature,
                               np.concatenate([msg_pairs, msg_pairs[::-1]],
                                              axis=1))
    else:
        pos = pairs
    if os.environ.get("GRAPHGYM_LINK_BOTH_DIRS") == "1":
        pos = np.concatenate([pos, pos[::-1]], axis=1)
    ratio = (cfg.dataset.edge_negative_sampling_ratio
             if split_index == 0 else 1.0)
    neg = negative_sampling(full_edge_index, g.num_nodes,
                            max(int(pos.shape[1] * ratio), 1), rng)
    _set_supervision(g, pos, neg)
    if split_index == 0 and disjoint and cfg.dataset.resample_disjoint:
        g["_train_pairs"] = pairs.astype(np.int32)
        _keep_full_edges(g, full_edge_index, full_edge_feature)
    elif (split_index == 0 and cfg.dataset.resample_negative) or (
            split_index >= 1
            and cfg.dataset.get("link_eval_resample_negative", False)):
        # redraws exclude the full edge set, held-out positives too
        g["_pos_pairs"] = pos.astype(np.int32)
        g["_full_edge_index"] = full_edge_index.astype(np.int32)


def _disjoint_split(pairs: np.ndarray, message_ratio: float, rng):
    """Split undirected train pairs [2, M] into (message, supervision)
    (reference cfg.dataset.edge_message_ratio, config.py:152-155), both
    halves non-empty where M >= 2."""
    m = pairs.shape[1]
    k = int(message_ratio * m)
    if m >= 2:
        k = min(max(k, 1), m - 1)
    perm = rng.permutation(m)
    return pairs[:, perm[:k]], pairs[:, perm[k:]]


def _set_message_edges(gg: HostGraph, orig_edge_index: np.ndarray,
                       orig_edge_feature, new_edges: np.ndarray) -> None:
    """Replace gg's edge set, keeping per-edge features aligned by
    looking each new (u, v) up in the original edge list (0 where it is
    not there)."""
    gg.edge_index = new_edges.astype(np.int32)
    gg._csr_indptr = gg._csr_indices = None
    if orig_edge_feature is None:
        return
    n = np.int64(gg.num_nodes)
    old_key = orig_edge_index[0].astype(np.int64) * n + orig_edge_index[1]
    order = np.argsort(old_key, kind="stable")
    new_key = new_edges[0].astype(np.int64) * n + new_edges[1]
    loc = np.clip(np.searchsorted(old_key[order], new_key), 0,
                  max(len(old_key) - 1, 0))
    hit = old_key[order][loc] == new_key
    out = np.array(np.asarray(orig_edge_feature)[np.where(hit, order[loc],
                                                          0)])
    out[~hit] = 0
    gg["edge_feature"] = out


# ------------------------------------------------------------ create_dataset

def _cache_path(cfg) -> str:
    """The processed-dataset cache file, the JAX package's key and name
    (graphgym_tpu/data/loaders.py:684-693): a digest of the main options
    only (reference config.py:188-192's caveat), under dataset.dir where
    that is a directory, else the working directory."""
    import hashlib

    key = "|".join(str(v) for v in (
        cfg.dataset.name, cfg.dataset.format, cfg.dataset.task,
        cfg.dataset.transform, cfg.dataset.augment_label,
        cfg.dataset.augment_feature, cfg.gnn.layers_mp,
        cfg.dataset.split, cfg.seed))
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(cfg.dataset.dir if os.path.isdir(cfg.dataset.dir)
                        else ".", f"cache_{digest}.pkl")


def create_dataset(cfg, rng: Optional[np.random.Generator] = None
                   ) -> List[List[HostGraph]]:
    """Full pipeline (reference create_dataset, loader.py:191-244).  The
    edge transform rewrites cfg.dataset.task to 'node', as in the JAX
    package: its link or edge supervision becomes node labels of the
    edge-net union.  cfg.dataset.cache_load reads the processed splits
    from ``_cache_path`` where that file exists (one the JAX package
    wrote too: ``_CorpusUnpickler``), cache_save writes them there; as
    in the JAX package the save's key is taken after the pipeline, so
    an edge transform's cache (task rewritten) is never found again."""
    if cfg.dataset.task not in ("node", "graph", "link_pred", "edge"):
        raise ValueError(f"Unknown task {cfg.dataset.task!r}")
    if cfg.dataset.cache_load:
        path = _cache_path(cfg)
        if os.path.exists(path):
            with open(path, "rb") as f:
                splits = _CorpusUnpickler(f).load()
            set_dataset_info(splits, cfg)
            logging.info("Loaded cached dataset from %s", path)
            return splits
    rng = rng or np.random.default_rng(cfg.seed)
    t1 = time.time()
    graphs = load_dataset(cfg)
    # min-node filter (loader.py:129-138), none on a graph task
    min_node = 0 if cfg.dataset.task == "graph" else 5
    graphs = [g for g in graphs if g.num_nodes > min_node]

    t2 = time.time()
    if cfg.dataset.remove_feature:
        for g in graphs:
            g["node_feature"] = np.ones((g.num_nodes, 1), np.float32)
    FeatureAugment(rng).augment(graphs, cfg)
    if cfg.dataset.augment_label:
        for g in graphs:
            replace_label(g, cfg)
    # ID-GNN path-prediction labels (loader.py:162-164)
    if cfg.dataset.task == "edge" and "id" in cfg.gnn.layer_type:
        for g in graphs:
            path_len_labels(g, rng=rng)

    t3 = time.time()
    splits = split_dataset(graphs, cfg, rng)

    t4 = time.time()
    if cfg.dataset.transform == "ego":
        radius = cfg.gnn.layers_mp
        splits = [[ego_nets(g, radius=radius) for g in part]
                  for part in splits]
    elif cfg.dataset.transform == "edge":
        splits = [[edge_nets(g) for g in part] for part in splits]
        cfg.dataset.task = "node"
    elif cfg.dataset.transform != "none":
        raise ValueError(f"Unknown transform {cfg.dataset.transform!r}")
    t5 = time.time()
    logging.info(
        "Load: %.4fs, Before split: %.4fs, Split: %.4fs, "
        "After split: %.4fs", t2 - t1, t3 - t2, t4 - t3, t5 - t4)
    set_dataset_info(splits, cfg)
    if cfg.dataset.cache_save:
        path = _cache_path(cfg)
        try:
            with open(path, "wb") as f:
                pickle.dump(splits, f)
            logging.info("Cached dataset to %s", path)
        except OSError as exc:
            logging.warning("dataset cache_save failed: %s", exc)
    return splits


def set_dataset_info(splits, cfg) -> None:
    """Fill cfg.share dims (reference loader_pyg.py:165-191): the classes
    of the task's labels, graph, edge or node; and where the graphs have
    edge features, their width into cfg.dataset.edge_dim, which the
    edge-feature convs read (the JAX layers take it from the batch).  A binary link or edge
    task decodes to one score (dim_out 1) unless its edge_decoding is
    'concat'."""
    g0 = splits[0][0]
    dim_in = int(np.asarray(g0["node_feature"]).shape[-1]) \
        if "node_feature" in g0 else 1
    for key in cfg.dataset.augment_feature:
        dim_in += int(np.asarray(g0[key]).shape[-1])
    cfg.share.dim_in = dim_in
    if "edge_feature" in g0:
        ef = np.asarray(g0["edge_feature"])
        cfg.dataset.edge_dim = int(ef.shape[1]) if ef.ndim > 1 else 1
    task = cfg.dataset.task
    if task in ("edge", "link_pred"):
        found = [np.asarray(g["edge_label"]).reshape(-1)
                 for part in splits for g in part if "edge_label" in g]
        labels = np.concatenate(found) if found else np.array([0, 1])
    else:
        key = "graph_label" if task == "graph" else "node_label"
        labels = np.concatenate([np.asarray(g[key]).reshape(-1)
                                 for part in splits for g in part])
    if task == "graph":
        label_width = int(np.asarray(g0["graph_label"]).reshape(-1).size)
    elif task == "node" and "node_label" in g0:
        nl = np.asarray(g0["node_label"])
        label_width = int(nl.shape[-1]) if nl.ndim > 1 else 1
    else:
        label_width = 1
    if "classification" in cfg.dataset.task_type:
        if label_width > 1:
            cfg.share.dim_out = label_width
        elif task in ("edge", "link_pred") \
                and cfg.model.edge_decoding != "concat":
            cfg.share.dim_out = 1
        else:
            num = int(labels.max()) + 1 if labels.size else 2
            cfg.share.dim_out = max(num, 2)
    else:
        cfg.share.dim_out = label_width
    cfg.share.num_splits = len(splits)


# ----------------------------------------------------------------- batching

def graph_to_arrays(g: HostGraph, cfg):
    """Assemble final node features: [augment feats..., node_feature]
    (order of the reference Preprocess dim_dict,
    feature_augment.py:314-333)."""
    feats = []
    for key in cfg.dataset.augment_feature:
        v = np.asarray(g[key], np.float32)
        feats.append(v if v.ndim > 1 else v[:, None])
    if "node_feature" in g:
        v = np.asarray(g["node_feature"], np.float32)
        feats.append(v if v.ndim > 1 else v[:, None])
    if not feats:
        feats.append(np.ones((g.num_nodes, 1), np.float32))
    return np.concatenate(feats, axis=1)


class GraphLoader:
    """Batched loader producing static-shape GraphBatches (host numpy).

    All batches share one padded (nodes, edges, labels, supervised
    pairs) bucket, and one chunk count per pack (``_share_pack_shapes``);
    train batches are re-partitioned each epoch when there is more than
    one (the reference reshuffles via DataLoader, loader.py:247-251),
    and re-collated when their link supervision is redrawn
    (``_resample``)."""

    def __init__(self, graphs: Sequence[HostGraph], cfg, *,
                 batch_size: int, shuffle: bool,
                 rng: Optional[np.random.Generator] = None):
        if cfg.tpu.mesh_shape:
            raise _not_ported("multi-device layouts", "A16")
        self.graphs = list(graphs)
        self.cfg = cfg
        self.batch_size = max(1, min(batch_size, len(self.graphs)))
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng(cfg.seed)
        self._cached: Optional[List[GraphBatch]] = None
        self._chunks: dict = {}     # pack kind -> (fwd, bwd) chunks
        self._plan_shapes()

    def _plan_shapes(self):
        bs = self.batch_size
        sizes = [(g.num_nodes, g.num_edges,
                  len(g["node_label_index"]) if "node_label_index" in g
                  else g.num_nodes,
                  len(g["node_id_index"]) if "node_id_index" in g else 0,
                  g["edge_label_index"].shape[1]
                  if "edge_label_index" in g else 0)
                 for g in self.graphs]

        def worst(k):    # worst-case batch = the bs largest graphs
            return sum(sorted((s[k] for s in sizes), reverse=True)[:bs])

        pad = bucket_size if self.cfg.tpu.pad_buckets else (lambda n: n)
        self.pad_nodes = pad(worst(0) + 1)
        self.pad_edges = pad(max(worst(1), 1))
        self.pad_labels = pad(max(worst(2), 1))
        self.pad_ids = pad(max(worst(3), 1))
        self.pad_edge_labels = pad(max(worst(4), 1))

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def batches(self, epoch: int = 0) -> List[GraphBatch]:
        resampled = self._resample()
        sampled = self._sample_nodes()
        # with one batch per epoch shuffling cannot change its
        # composition: collate once and reuse
        static = ((not self.shuffle or len(self) == 1) and not resampled
                  and not sampled)
        if static and self._cached is not None:
            return self._cached
        order = np.arange(len(self.graphs))
        if self.shuffle and len(self.graphs) > 1 and not static:
            order = self.rng.permutation(order)
        out = self._collate_all(
            [[self.graphs[j] for j in order[i:i + self.batch_size]]
             for i in range(0, len(order), self.batch_size)])
        if static:
            self._cached = out
        return out

    def _collate_all(self, parts: List[List[HostGraph]]
                     ) -> List[GraphBatch]:
        """The batches of ``parts``, collated side by side (host_pool:
        _collate reads the graphs and the loader's shapes and writes
        nothing shared), their packs at the loader's shared shapes."""
        out = (list(host_pool("collate").map(self._collate, parts))
               if len(parts) > 1 else [self._collate(p) for p in parts])
        return self._share_pack_shapes(out)

    def _sample_nodes(self) -> bool:
        """Per-epoch node sampling on a node task (reference
        cfg.train.sample_node / node_per_graph, config.py:218-221; the
        eval twin cfg.val.*, config.py:204-206; graphgym_tpu/data/
        loaders.py:936-958): each graph supervises node_per_graph nodes
        drawn without replacement from its full supervision (kept as
        ``_full_label_index`` at the first draw), sorted, on this
        loader's Generator.  Returns whether it drew."""
        group = self.cfg.train if self.shuffle else self.cfg.val
        if not (group.sample_node and self.cfg.dataset.task == "node"):
            return False
        for g in self.graphs:
            base = g.get("_full_label_index")
            if base is None:
                base = np.asarray(g.get("node_label_index",
                                        np.arange(g.num_nodes)))
                g["_full_label_index"] = base
            sel = self.rng.choice(base, size=min(group.node_per_graph,
                                                 len(base)), replace=False)
            g["node_label_index"] = np.sort(sel)
        return True

    def _resample(self) -> bool:
        """Redraw the link supervision of this epoch, where the config
        asks for it (graphgym_tpu/data/loaders.py:886-938), on this
        loader's Generator: on the train split, resample_disjoint
        re-splits each graph's pairs into message edges and positives
        and draws new negatives, resample_negative draws new negatives;
        on an eval split, link_eval_resample_negative draws new
        negatives.  The counts follow the ratios, so the shapes stay.
        Returns whether anything was redrawn."""
        cfg = self.cfg.dataset
        resample_disjoint = (self.shuffle and cfg.resample_disjoint
                             and any("_train_pairs" in g
                                     for g in self.graphs))
        for g in self.graphs if resample_disjoint else ():
            if "_train_pairs" not in g:
                continue
            msg_pairs, pos = _disjoint_split(
                g["_train_pairs"], cfg.edge_message_ratio, self.rng)
            _set_message_edges(g, g["_full_edge_index"],
                               g.get("_full_edge_feature"),
                               np.concatenate([msg_pairs, msg_pairs[::-1]],
                                              axis=1))
            neg = negative_sampling(
                g["_full_edge_index"], g.num_nodes,
                int(pos.shape[1] * cfg.edge_negative_sampling_ratio),
                self.rng)
            _set_supervision(g, pos, neg)
        resample = ((cfg.resample_negative if self.shuffle
                     else cfg.get("link_eval_resample_negative", False))
                    and any("_pos_pairs" in g for g in self.graphs))
        for g in self.graphs if resample else ():
            if "_pos_pairs" not in g:
                continue
            pos = g["_pos_pairs"]
            neg = negative_sampling(
                g.get("_full_edge_index", g.edge_index), g.num_nodes,
                g["edge_label_index"].shape[1] - pos.shape[1], self.rng)
            g["edge_label_index"] = np.concatenate(
                [pos, neg], axis=1).astype(np.int32)
        return bool(resample_disjoint or resample)

    def _share_pack_shapes(self, batches: List[GraphBatch]
                           ) -> List[GraphBatch]:
        """Pad each batch's packs to the loader's chunk counts, the most
        each kind's fwd and bwd pack has needed so far: a pack's chunk
        count is bucketed per batch, and the batches of one loader can
        land in different buckets.  One shape for all of them is one
        captured program on the card (train/graphed.py)."""
        for b in batches:
            for kind, counts in pack_chunks(b.packs or {}).items():
                self._chunks[kind] = tuple(
                    max(x, y) for x, y in zip(
                        self._chunks.get(kind, (0, 0)), counts))
        return [b if not b.packs or pack_chunks(b.packs) == self._chunks
                else b.replace(packs=pad_packs(b.packs, self._chunks))
                for b in batches]

    def _collate(self, graphs: List[HostGraph]) -> GraphBatch:
        cfg = self.cfg
        xs, ss, rs, gids = [], [], [], []
        node_labels, label_idx, id_idx, graph_labels = [], [], [], []
        edge_labels, edge_label_idx, edge_feats = [], [], []
        offset = 0
        for gi, g in enumerate(graphs):
            xs.append(graph_to_arrays(g, cfg))
            ss.append(g.senders + offset)
            rs.append(g.receivers + offset)
            gids.append(np.full(g.num_nodes, gi, np.int32))
            if "edge_feature" in g:
                ef = np.asarray(g["edge_feature"], np.float32)
                edge_feats.append(ef if ef.ndim > 1 else ef[:, None])
            if "node_label" in g:
                node_labels.append(
                    np.asarray(g["node_label"]).reshape(g.num_nodes, -1))
            if "node_label_index" in g:
                label_idx.append(np.asarray(g["node_label_index"]) + offset)
            if "node_id_index" in g:
                id_idx.append(np.asarray(g["node_id_index"]) + offset)
            if "graph_label" in g:
                graph_labels.append(np.asarray(g["graph_label"]).reshape(-1))
            if "edge_label" in g:
                edge_labels.append(np.asarray(g["edge_label"]).reshape(-1))
            if "edge_label_index" in g:
                edge_label_idx.append(np.asarray(g["edge_label_index"])
                                      + offset)
            offset += g.num_nodes

        node_label = graph_label = None
        if node_labels:
            nl = np.concatenate(node_labels, axis=0)
            node_label = nl.squeeze(-1) if nl.shape[-1] == 1 else nl
        if graph_labels:
            gl = np.stack(graph_labels)       # [G, 1] or [G, T]
            graph_label = gl[:, 0] if gl.shape[-1] == 1 else gl
        label_index = None
        if label_idx:
            label_index = np.concatenate(label_idx)
        elif cfg.dataset.task == "node":
            label_index = np.arange(offset)
        # supervised pairs padded to the split-wide bucket, the padding
        # pairs at the padding node, label 0 and masked out
        pairs = {}
        if edge_labels:
            el = np.concatenate(edge_labels)
            pairs["edge_label"] = _pad1(el, self.pad_edge_labels, 0)
            pairs["edge_label_mask"] = _pad1(
                np.ones(len(el), bool), self.pad_edge_labels, False)
        if edge_label_idx:
            eli = np.concatenate(edge_label_idx, axis=1)
            pad_node = self.pad_nodes - 1
            pairs["edge_label_index"] = np.stack([
                _pad1(eli[0], self.pad_edge_labels, pad_node),
                _pad1(eli[1], self.pad_edge_labels, pad_node)])
        batch = build_graph_batch(
            np.concatenate(ss), np.concatenate(rs), np.concatenate(xs),
            graph_ids=np.concatenate(gids),
            num_graphs=len(graphs) + 1,   # + padding graph slot
            node_label=node_label,
            node_label_index=label_index,
            graph_label=graph_label,
            node_id_index=(np.concatenate(id_idx) if id_idx else None),
            edge_feat=(np.concatenate(edge_feats)
                       if edge_feats and len(edge_feats) == len(graphs)
                       else None),
            pad_nodes_to=self.pad_nodes,
            pad_edges_to=self.pad_edges, **pairs)
        kinds = (coo_kinds(cfg.gnn) if cfg.tpu.spmm_impl == "xla"
                 else kinds_for_cfg(cfg.gnn))
        if kinds:
            batch = batch.replace(packs=build_packs(
                batch.senders, batch.receivers, batch.edge_weight,
                batch.node_mask, batch.num_nodes,
                kinds=[k for k in kinds if k != EDGE_BOND],
                chunks=self._chunks))
        if EDGE_BOND in kinds and batch.edge_feat is not None:
            batch.packs[EDGE_BOND] = (build_embed_pack(
                batch.edge_feat, BOND_FEATURE_DIMS, False),)
        # re-pad the variable-length index lists to the split-wide bucket
        if batch.node_label_index is not None:
            batch = _repad_index(batch, "node_label_index", "label_mask",
                                 self.pad_labels)
        if batch.node_id_index is not None:
            batch = _repad_index(batch, "node_id_index", "id_mask",
                                 self.pad_ids)
        gathers = {}
        if batch.edge_label_index is not None:
            gathers[PAIRS] = build_gather_packs(
                batch.edge_label_index.reshape(-1),
                np.tile(batch.edge_label_mask, 2), batch.num_nodes,
                self._chunks.get(PAIRS, (0, 0)))
        if batch.node_label_index is not None:
            real = batch.node_label_index[batch.label_mask]
            if len(np.unique(real)) < len(real):
                gathers[LABELS] = build_gather_packs(
                    batch.node_label_index, batch.label_mask,
                    batch.num_nodes, self._chunks.get(LABELS, (0, 0)))
        if gathers:
            batch = batch.replace(packs={**(batch.packs or {}), **gathers})
        if cfg.dataset.task == "graph" \
                and cfg.model.graph_pooling not in register.pooling_dict:
            ego = cfg.dataset.transform == "ego"
            batch = batch.replace(packs={
                **(batch.packs or {}),
                **build_pool_packs(
                    batch.graph_ids, batch.node_mask, batch.num_graphs,
                    cfg.model.graph_pooling,
                    batch.node_id_index if ego else None,
                    batch.id_mask if ego else None, chunks=self._chunks)})
        embeds = self._embed_packs(batch)
        if embeds:
            batch = batch.replace(packs={**(batch.packs or {}), **embeds})
        return batch

    def _embed_packs(self, batch: GraphBatch) -> dict:
        """The embedding pack of each built-in encoder the model runs
        (nn/encoders.py; a registered encoder of the same name replaces
        it and takes none): the node encoder's over node_feat, the edge
        encoder's over edge_feat where the batch has it."""
        d = self.cfg.dataset
        if self.cfg.gnn.layer_type.startswith("Tfg-"):
            return {}
        out = {}
        for kind, on, name, registered, feat in (
                (NODE_ENCODER, d.node_encoder, d.node_encoder_name,
                 register.node_encoder_dict, batch.node_feat),
                (EDGE_ENCODER, d.edge_encoder, d.edge_encoder_name,
                 register.edge_encoder_dict, batch.edge_feat)):
            if on and name in EMBED_TABLES and name not in registered \
                    and feat is not None:
                out[kind] = (build_embed_pack(feat, *EMBED_TABLES[name]),)
        return out


def _pad1(x, n, fill):
    if len(x) >= n:
        return x[:n]
    return np.concatenate([x, np.full(n - len(x), fill, dtype=x.dtype)])


def _repad_index(batch: GraphBatch, key: str, mask_key: str,
                 target: int) -> GraphBatch:
    pad_node = batch.num_nodes - 1
    idx = _pad1(np.asarray(getattr(batch, key)), target, pad_node)
    mask = _pad1(np.asarray(getattr(batch, mask_key)), target, False)
    return batch.replace(**{key: idx, mask_key: mask})


class SamplerLoader(GraphLoader):
    """A loader that draws fresh sampled subgraphs of its graphs each
    epoch (reference get_loader, loader_pyg.py:204-255;
    graphgym_tpu/data/loaders.py:1183-1225): ``sampler`` (default
    cfg.train.sampler) through data/samplers.make_sampled_graphs on the
    loader's Generator, the first draw in ``__init__``.  The node, edge
    and label buckets are twice the first draw's (bucketed); a later
    draw with a graph past them re-buckets (another captured program).
    The batches take the drawn subgraphs in order, batch_size at a time,
    and their packs the loader's running chunk counts."""

    def __init__(self, graphs: Sequence[HostGraph], cfg, *,
                 batch_size: int, rng: Optional[np.random.Generator] = None,
                 sampler: Optional[str] = None):
        self.base_graphs = list(graphs)
        self.cfg = cfg
        self.sampler_kind = sampler or cfg.train.sampler
        self.sample_rng = rng or np.random.default_rng(cfg.seed)
        super().__init__(self._draw(), cfg, batch_size=batch_size,
                         shuffle=False, rng=self.sample_rng)
        self.pad_nodes = bucket_size(self.pad_nodes * 2)
        self.pad_edges = bucket_size(self.pad_edges * 2)
        self.pad_labels = bucket_size(self.pad_labels * 2)

    def _draw(self) -> List[HostGraph]:
        from graphgym_tpu_torch.data.samplers import make_sampled_graphs
        return [sub for g in self.base_graphs
                for sub in make_sampled_graphs(g, self.cfg, self.sample_rng,
                                               sampler=self.sampler_kind)]

    def batches(self, epoch: int = 0) -> List[GraphBatch]:
        self.graphs = self._draw()
        for g in self.graphs:
            if g.num_nodes + 1 > self.pad_nodes \
                    or g.num_edges > self.pad_edges:
                self.pad_nodes = bucket_size(max(self.pad_nodes,
                                                 g.num_nodes + 1))
                self.pad_edges = bucket_size(max(self.pad_edges,
                                                 g.num_edges))
                self.pad_labels = max(self.pad_labels, self.pad_nodes)
        return self._collate_all(
            [self.graphs[i:i + self.batch_size]
             for i in range(0, len(self.graphs), self.batch_size)])


def create_loader(splits: List[List[HostGraph]], cfg) -> List[GraphLoader]:
    """One loader per split; train shuffles (reference create_loader,
    loader.py:247-260); a split whose sampler (cfg.train.sampler for
    train, cfg.val.sampler for the others, reference loader_pyg.py:
    258-285) is not full_batch gets a ``SamplerLoader``.  Each loader
    gets its own seeded Generator, as in the JAX package: the prefetch
    worker collates the next train epoch while the eval loaders draw."""
    rngs = [np.random.default_rng([cfg.seed, i])
            for i in range(len(splits))]
    out = []
    for i, part in enumerate(splits):
        sampler = cfg.train.sampler if i == 0 else cfg.val.sampler
        if sampler != "full_batch":
            out.append(SamplerLoader(part, cfg,
                                     batch_size=cfg.train.batch_size,
                                     rng=rngs[i], sampler=sampler))
        else:
            out.append(GraphLoader(part, cfg,
                                   batch_size=cfg.train.batch_size,
                                   shuffle=(i == 0), rng=rngs[i]))
    return out
