"""Dataset loading, splitting, transforms and GraphBatch batching.

The port of graphgym_tpu/data/loaders.py for node and graph tasks on
pickled or regenerated synthetic graph corpora (reference
graphgym/loader.py:24-260):
  load graphs -> feature augmentation -> label replacement -> split
  -> ego transform per split -> padded GraphBatches with the packed
  SpMM layouts.

Batches always carry the packs their layer consumes, on CPU and CUDA
alike (the port has no COO path), and a graph task's batches the pack
of its head's pooling.  What the slice does not need raises
NotImplementedError naming its ROADMAP item: other formats, the link
and edge tasks, samplers, dataset caches, mesh plans.
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
from graphgym_tpu_torch.data.transforms import ego_nets
from graphgym_tpu_torch.graphs.container import (GraphBatch, bucket_size,
                                                 build_graph_batch)
from graphgym_tpu_torch.graphs.packing import (build_packs, build_pool_packs,
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
    raise _not_ported(f"dataset format {cfg.dataset.format!r}", "A13b")


# ----------------------------------------------------------------- splits

def split_dataset(graphs: List[HostGraph], cfg,
                  rng: np.random.Generator) -> List[List[HostGraph]]:
    """DeepSNAP-style random split (reference loader.py:227-230;
    graphgym_tpu/data/loaders.py:451-495).

    Transductive: each split shares the graphs; node_label_index is
    partitioned by ratio.  Inductive: the list of graphs is partitioned;
    on a node task every node is supervised.  A graph task is always
    inductive, whatever cfg.dataset.transductive says."""
    ratios = list(cfg.dataset.split)
    if not cfg.dataset.transductive or cfg.dataset.task == "graph":
        idx = np.arange(len(graphs))
        if cfg.dataset.shuffle_split:
            rng.shuffle(idx)
        bounds = np.cumsum([int(r * len(graphs)) for r in ratios[:-1]])
        splits = [[graphs[i] for i in part]
                  for part in np.split(idx, bounds)]
        if cfg.dataset.task == "node":
            for part in splits:
                for g in part:
                    if "node_label_index" not in g:
                        g["node_label_index"] = np.arange(g.num_nodes)
        return splits

    splits = [[] for _ in ratios]
    for g in graphs:
        n = g.num_nodes
        perm = rng.permutation(n) if cfg.dataset.shuffle_split \
            else np.arange(n)
        bounds = np.cumsum([int(r * n) for r in ratios[:-1]])
        for si, part in enumerate(np.split(perm, bounds)):
            gg = g.copy()
            gg["node_label_index"] = np.sort(part)
            splits[si].append(gg)
    return splits


# ------------------------------------------------------------ create_dataset

def create_dataset(cfg, rng: Optional[np.random.Generator] = None
                   ) -> List[List[HostGraph]]:
    """Full pipeline (reference create_dataset, loader.py:191-244), for
    the node and graph tasks."""
    if cfg.dataset.task not in ("node", "graph"):
        raise _not_ported(f"task {cfg.dataset.task!r}", "A13b")
    if cfg.dataset.cache_load or cfg.dataset.cache_save:
        raise _not_ported("the processed-dataset cache", "A13b")
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

    t3 = time.time()
    splits = split_dataset(graphs, cfg, rng)

    t4 = time.time()
    if cfg.dataset.transform == "ego":
        radius = cfg.gnn.layers_mp
        splits = [[ego_nets(g, radius=radius) for g in part]
                  for part in splits]
    elif cfg.dataset.transform != "none":
        raise _not_ported(f"transform {cfg.dataset.transform!r}", "A13b")
    t5 = time.time()
    logging.info(
        "Load: %.4fs, Before split: %.4fs, Split: %.4fs, "
        "After split: %.4fs", t2 - t1, t3 - t2, t4 - t3, t5 - t4)
    set_dataset_info(splits, cfg)
    return splits


def set_dataset_info(splits, cfg) -> None:
    """Fill cfg.share dims (reference loader_pyg.py:165-191): a graph
    task's classes are its graph labels'."""
    g0 = splits[0][0]
    dim_in = int(np.asarray(g0["node_feature"]).shape[-1]) \
        if "node_feature" in g0 else 1
    for key in cfg.dataset.augment_feature:
        dim_in += int(np.asarray(g0[key]).shape[-1])
    cfg.share.dim_in = dim_in
    key = "graph_label" if cfg.dataset.task == "graph" else "node_label"
    labels = np.concatenate([np.asarray(g[key]).reshape(-1)
                             for part in splits for g in part])
    if cfg.dataset.task == "graph":
        label_width = int(np.asarray(g0["graph_label"]).reshape(-1).size)
    else:
        nl = np.asarray(g0["node_label"])
        label_width = int(nl.shape[-1]) if nl.ndim > 1 else 1
    if "classification" in cfg.dataset.task_type:
        if label_width > 1:
            cfg.share.dim_out = label_width
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

    All batches share one padded (nodes, edges, labels) bucket, and
    one chunk count per pack (``_share_pack_shapes``); train batches
    are re-partitioned each epoch when there is more than one (the
    reference reshuffles via DataLoader, loader.py:247-251)."""

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
                  len(g["node_id_index"]) if "node_id_index" in g else 0)
                 for g in self.graphs]

        def worst(k):    # worst-case batch = the bs largest graphs
            return sum(sorted((s[k] for s in sizes), reverse=True)[:bs])

        pad = bucket_size if self.cfg.tpu.pad_buckets else (lambda n: n)
        self.pad_nodes = pad(worst(0) + 1)
        self.pad_edges = pad(max(worst(1), 1))
        self.pad_labels = pad(max(worst(2), 1))
        self.pad_ids = pad(max(worst(3), 1))

    def __len__(self):
        return (len(self.graphs) + self.batch_size - 1) // self.batch_size

    def batches(self, epoch: int = 0) -> List[GraphBatch]:
        sample_group = self.cfg.train if self.shuffle else self.cfg.val
        if sample_group.sample_node:
            raise _not_ported("per-epoch node sampling", "A13b")
        # with one batch per epoch shuffling cannot change its
        # composition: collate once and reuse
        static = not self.shuffle or len(self) == 1
        if static and self._cached is not None:
            return self._cached
        order = np.arange(len(self.graphs))
        if self.shuffle and not static:
            order = self.rng.permutation(order)
        out = [self._collate([self.graphs[j]
                              for j in order[i:i + self.batch_size]])
               for i in range(0, len(order), self.batch_size)]
        out = self._share_pack_shapes(out)
        if static:
            self._cached = out
        return out

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
        batch = build_graph_batch(
            np.concatenate(ss), np.concatenate(rs), np.concatenate(xs),
            graph_ids=np.concatenate(gids),
            num_graphs=len(graphs) + 1,   # + padding graph slot
            node_label=node_label,
            node_label_index=label_index,
            graph_label=graph_label,
            node_id_index=(np.concatenate(id_idx) if id_idx else None),
            pad_nodes_to=self.pad_nodes,
            pad_edges_to=self.pad_edges)
        kinds = kinds_for_layer(cfg.gnn.layer_type, cfg.gnn.agg,
                                cfg.gnn.normalize_adj)
        if kinds:
            batch = batch.replace(packs=build_packs(
                batch.senders, batch.receivers, batch.edge_weight,
                batch.node_mask, batch.num_nodes, kinds=kinds))
        # re-pad the variable-length index lists to the split-wide bucket
        if batch.node_label_index is not None:
            batch = _repad_index(batch, "node_label_index", "label_mask",
                                 self.pad_labels)
        if batch.node_id_index is not None:
            batch = _repad_index(batch, "node_id_index", "id_mask",
                                 self.pad_ids)
        if cfg.dataset.task == "graph" \
                and cfg.model.graph_pooling not in register.pooling_dict:
            ego = cfg.dataset.transform == "ego"
            batch = batch.replace(packs={
                **(batch.packs or {}),
                **build_pool_packs(
                    batch.graph_ids, batch.node_mask, batch.num_graphs,
                    cfg.model.graph_pooling,
                    batch.node_id_index if ego else None,
                    batch.id_mask if ego else None)})
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
        raise _not_ported("graph samplers", "A13b")
    rngs = [np.random.default_rng([cfg.seed, i])
            for i in range(len(splits))]
    return [GraphLoader(part, cfg, batch_size=cfg.train.batch_size,
                        shuffle=(i == 0), rng=rngs[i])
            for i, part in enumerate(splits)]
