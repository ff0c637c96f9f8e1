"""Dataset loading, splitting, transforms and GraphBatch batching.

The port of graphgym_tpu/data/loaders.py for the node, graph, edge and
link_pred tasks on pickled or regenerated synthetic graph corpora
(reference graphgym/loader.py:24-260):
  load graphs -> feature augmentation -> label replacement (path-length
  labels on the edge task) -> split with its edge supervision -> ego or
  edge transform per split -> padded GraphBatches with the packed SpMM
  layouts.

Batches always carry the packs their layer consumes, on CPU and CUDA
alike (the port has no COO path); a graph task's batches the pack of
its head's pooling; a batch with supervised node pairs the pair pack of
the edge head's gather; and a batch whose supervised node index repeats
a node the label pack of the node head's gather (``graphs/packing.
build_gather_packs``), so no gather on a training path has a
float-atomic backward.  What the port does not run yet raises
NotImplementedError naming its ROADMAP item: other formats, samplers,
dataset caches, node sampling (A13c), mesh plans.
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
from graphgym_tpu_torch.graphs.packing import (LABELS, PAIRS,
                                               build_gather_packs,
                                               build_packs, build_pool_packs,
                                               host_pool,
                                               kinds_for_layer, pack_chunks,
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


def load_dataset(cfg) -> List[HostGraph]:
    fmt = cfg.dataset.format
    if fmt.startswith("Tfg-"):
        fmt = fmt[4:]
    for func in register.loader_dict.values():
        graphs = func(fmt, cfg.dataset.name, cfg.dataset.dir)
        if graphs is not None:
            return graphs
    if fmt == "nx":
        return load_nx(cfg.dataset.name, cfg.dataset.dir)
    raise _not_ported(f"dataset format {cfg.dataset.format!r}", "A13c")


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
    undirected edge pairs (``_transductive_pairs``)."""
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
    (reference loader.py:231-233).  The JAX package's
    GRAPHGYM_LINK_BOTH_DIRS probe, which doubles the positives, is not
    ported."""
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

def create_dataset(cfg, rng: Optional[np.random.Generator] = None
                   ) -> List[List[HostGraph]]:
    """Full pipeline (reference create_dataset, loader.py:191-244).  The
    edge transform rewrites cfg.dataset.task to 'node', as in the JAX
    package: its link or edge supervision becomes node labels of the
    edge-net union."""
    if cfg.dataset.task not in ("node", "graph", "link_pred", "edge"):
        raise ValueError(f"Unknown task {cfg.dataset.task!r}")
    if cfg.dataset.cache_load or cfg.dataset.cache_save:
        raise _not_ported("the processed-dataset cache", "A13c")
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
    return splits


def set_dataset_info(splits, cfg) -> None:
    """Fill cfg.share dims (reference loader_pyg.py:165-191): the classes
    of the task's labels, graph, edge or node.  A binary link or edge
    task decodes to one score (dim_out 1) unless its edge_decoding is
    'concat'."""
    g0 = splits[0][0]
    dim_in = int(np.asarray(g0["node_feature"]).shape[-1]) \
        if "node_feature" in g0 else 1
    for key in cfg.dataset.augment_feature:
        dim_in += int(np.asarray(g0[key]).shape[-1])
    cfg.share.dim_in = dim_in
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
        if cfg.tpu.dtype not in ("float32", "f32", ""):
            raise _not_ported(f"dtype {cfg.tpu.dtype!r}", "A14")
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
        sample_group = self.cfg.train if self.shuffle else self.cfg.val
        if sample_group.sample_node:
            raise _not_ported("per-epoch node sampling", "A13c")
        resampled = self._resample()
        # with one batch per epoch shuffling cannot change its
        # composition: collate once and reuse
        static = (not self.shuffle or len(self) == 1) and not resampled
        if static and self._cached is not None:
            return self._cached
        order = np.arange(len(self.graphs))
        if self.shuffle and len(self.graphs) > 1 and not static:
            order = self.rng.permutation(order)
        # the batches collate side by side (host_pool): _collate reads
        # the graphs and the loader's shapes and writes nothing shared
        parts = [[self.graphs[j] for j in order[i:i + self.batch_size]]
                 for i in range(0, len(order), self.batch_size)]
        out = (list(host_pool("collate").map(self._collate, parts))
               if len(parts) > 1 else [self._collate(p) for p in parts])
        out = self._share_pack_shapes(out)
        if static:
            self._cached = out
        return out

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
        edge_labels, edge_label_idx = [], []
        offset = 0
        for gi, g in enumerate(graphs):
            xs.append(graph_to_arrays(g, cfg))
            ss.append(g.senders + offset)
            rs.append(g.receivers + offset)
            gids.append(np.full(g.num_nodes, gi, np.int32))
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
            pad_nodes_to=self.pad_nodes,
            pad_edges_to=self.pad_edges, **pairs)
        kinds = kinds_for_layer(cfg.gnn.layer_type, cfg.gnn.agg,
                                cfg.gnn.normalize_adj)
        if kinds:
            batch = batch.replace(packs=build_packs(
                batch.senders, batch.receivers, batch.edge_weight,
                batch.node_mask, batch.num_nodes, kinds=kinds,
                chunks=self._chunks))
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
        return batch


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


def create_loader(splits: List[List[HostGraph]], cfg) -> List[GraphLoader]:
    """One loader per split; train shuffles (reference create_loader,
    loader.py:247-260).  Each loader gets its own seeded Generator, as
    in the JAX package."""
    if cfg.train.sampler != "full_batch" or cfg.val.sampler != "full_batch":
        raise _not_ported("graph samplers", "A13c")
    rngs = [np.random.default_rng([cfg.seed, i])
            for i in range(len(splits))]
    return [GraphLoader(part, cfg, batch_size=cfg.train.batch_size,
                        shuffle=(i == 0), rng=rngs[i])
            for i, part in enumerate(splits)]
