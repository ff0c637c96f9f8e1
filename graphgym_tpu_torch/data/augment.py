"""Feature augmentation: structural node/graph features, binning,
label replacement.

The port of graphgym_tpu/data/augment.py (reference
models/feature_augment.py:46-310): the feature functions over HostGraph
on the numpy algorithms of data.structure, the ID-GNN Fast identity
features (ops/identity.py, on the config's device), and their
representations: 'original' keeps the raw values, 'position' is a
transformer-style sin/cos encoding, and balanced / equal_width /
bounded binning one-hot-encodes; labels use balanced binning for
classification tasks.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from graphgym_tpu_torch import register
from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data.hostgraph import HostGraph
from graphgym_tpu_torch.device import resolve_device
from graphgym_tpu_torch.ops.identity import compute_identity_host


# ----------------------------------------------------------------- features

def _degree(g: HostGraph, **kw):
    return st.degrees(g).astype(np.float64)


def _betweenness(g: HostGraph, **kw):
    return st.betweenness_centrality(g)


def _path_len(g: HostGraph, **kw):
    return st.avg_shortest_path_len(g)


def _pagerank(g: HostGraph, **kw):
    return st.pagerank(g)


def _clustering(g: HostGraph, **kw):
    return st.clustering_coefficient(g)


def _identity(g: HostGraph, feature_dim: int = 1, device: str = "cpu",
              **kw):
    """diag(Â^1..Â^feature_dim) (reference identity_fun,
    feature_augment.py:75-79), computed on ``device`` (cfg.device)."""
    return compute_identity_host(g.edge_index, g.num_nodes, feature_dim,
                                 resolve_device(device))


def _const(g: HostGraph, **kw):
    return np.ones(g.num_nodes, np.float64)


def _onehot(g: HostGraph, rng: Optional[np.random.Generator] = None,
            **kw):
    rng = rng or np.random.default_rng()
    return rng.permutation(g.num_nodes).astype(np.int64)


def _graph_laplacian_spectrum(g: HostGraph, feature_dim: int = 4, **kw):
    spec = st.laplacian_spectrum(g)[1:]
    return spec[:feature_dim]


def _graph_path_len(g: HostGraph, **kw):
    return np.array([st.graph_avg_path_len(g)])


def _graph_clustering(g: HostGraph, **kw):
    return np.array([st.clustering_coefficient(g).mean()])


FEATURE_FUNCS = {
    "node_degree": _degree,
    "node_betweenness_centrality": _betweenness,
    "node_path_len": _path_len,
    "node_pagerank": _pagerank,
    "node_clustering_coefficient": _clustering,
    "node_identity": _identity,
    "node_const": _const,
    "node_onehot": _onehot,
    "edge_path_len": _path_len,
    "graph_laplacian_spectrum": _graph_laplacian_spectrum,
    "graph_path_len": _graph_path_len,
    "graph_clustering_coefficient": _graph_clustering,
}


# ------------------------------------------------------------------ binning

def get_bin_edges(values: np.ndarray, feature_dim: int,
                  method: str) -> np.ndarray:
    """Bin-edge computation (reference _get_bin_edges,
    feature_augment.py:208-245)."""
    if method == "balanced":
        sorted_arr = np.sort(values)
        idx = np.linspace(0, len(values), num=feature_dim,
                          endpoint=False).astype(int)
        bins = sorted_arr[idx]
        uniq = np.unique(bins)
        if len(uniq) < len(bins):
            logging.warning("%d bins collapsed due to balanced binning",
                            len(bins) - len(uniq))
            bins = uniq
        return bins
    if method == "equal_width":
        return np.linspace(values.min(), values.max(), num=feature_dim)
    if method == "bounded":
        return np.arange(feature_dim)
    raise ValueError(f"Bin method {method} not supported")


def bin_values(values: np.ndarray, bin_edges: np.ndarray) -> np.ndarray:
    """np.digitize - 1 (reference _bin_features,
    feature_augment.py:135-146)."""
    feat = np.digitize(values, bin_edges) - 1
    return np.clip(feat, 0, len(bin_edges) - 1)


def one_hot(vals: np.ndarray, dim: int) -> np.ndarray:
    out = np.zeros((len(vals), dim), np.float32)
    out[np.arange(len(vals)), vals.astype(int)] = 1.0
    return out


def position_encoding(pos: np.ndarray, feature_dim: int, scale: float,
                      wavelength: float = 10000.0) -> np.ndarray:
    """Transformer-style encoding (reference _position_features,
    feature_augment.py:178-200): [cos || sin] over feature_dim//2
    frequencies."""
    pos = np.asarray(pos, np.float64).reshape(-1) * scale
    cyc = np.arange(feature_dim // 2, dtype=np.float64) / (feature_dim // 2)
    angles = pos[:, None] / wavelength ** cyc[None, :]
    return np.concatenate([np.cos(angles), np.sin(angles)],
                          axis=-1).astype(np.float32)


# ------------------------------------------------------------- augmentation

class FeatureAugment:
    """Applies cfg.dataset.augment_feature / augment_label to a list of
    HostGraphs (one dataset, pre-split) and records the realized dims
    (graphgym_tpu/data/augment.py:151-228)."""

    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.feature_funcs = dict(FEATURE_FUNCS)
        self.feature_funcs.update(register.feature_augment_dict)
        self.rng = rng or np.random.default_rng(0)

    def _compute_raw(self, graphs: Sequence[HostGraph], key: str,
                     dim: int, as_label: bool, device: str) -> str:
        out_key = key + "_label" if as_label else key
        fn = self.feature_funcs[key]
        for g in graphs:
            if out_key not in g:
                g[out_key] = np.asarray(
                    fn(g, feature_dim=dim, rng=self.rng, device=device))
        return out_key

    def _represent(self, graphs: Sequence[HostGraph], out_key: str,
                   dim: int, method: str, as_label: bool) -> int:
        """Convert raw values into the final representation; returns the
        realized feature dim (or number of label classes)."""
        if method == "original":
            for g in graphs:
                v = np.asarray(g[out_key])
                if not as_label and v.ndim == 1:
                    v = v[:, None]
                g[out_key] = (v.astype(np.int64) if as_label
                              else v.astype(np.float32))
            v0 = graphs[0][out_key]
            return (int(np.concatenate(
                [np.asarray(g[out_key]).reshape(-1)
                 for g in graphs]).max()) + 1 if as_label
                else int(v0.shape[-1]) if v0.ndim > 1 else 1)
        if method == "position":
            all_vals = np.concatenate(
                [np.asarray(g[out_key]).reshape(-1) for g in graphs])
            scale = dim / 2 / max(all_vals.max(), 1e-12)
            for g in graphs:
                g[out_key] = position_encoding(g[out_key], dim, scale)
            return dim
        # binning
        all_vals = np.concatenate(
            [np.asarray(g[out_key]).reshape(-1) for g in graphs])
        bins = get_bin_edges(all_vals, dim, method)
        realized = len(bins)
        for g in graphs:
            binned = bin_values(np.asarray(g[out_key]).reshape(-1), bins)
            g[out_key] = binned if as_label else one_hot(binned, realized)
        return realized

    def augment(self, graphs: Sequence[HostGraph], cfg) -> Dict[str, int]:
        """Returns realized dims; updates cfg.dataset.augment_feature_dims
        and augment_label_dims in place like the reference
        (loader.py:157-159)."""
        feat_dims: List[int] = []
        for key, dim in zip(cfg.dataset.augment_feature,
                            cfg.dataset.augment_feature_dims):
            out_key = self._compute_raw(graphs, key, dim, False, cfg.device)
            feat_dims.append(self._represent(
                graphs, out_key, dim, cfg.dataset.augment_feature_repr,
                as_label=False))
        cfg.dataset.augment_feature_dims = feat_dims

        label_dim = None
        if cfg.dataset.augment_label:
            out_key = self._compute_raw(
                graphs, cfg.dataset.augment_label,
                cfg.dataset.augment_label_dims, True, cfg.device)
            method = ("balanced"
                      if "classification" in cfg.dataset.task_type
                      else "original")
            label_dim = self._represent(
                graphs, out_key, cfg.dataset.augment_label_dims, method,
                as_label=True)
            cfg.dataset.augment_label_dims = label_dim
        return {"feat_dims": feat_dims, "label_dim": label_dim}


def replace_label(g: HostGraph, cfg) -> None:
    """Overwrite task labels with an augmented structural label
    (reference _replace_label, feature_augment.py:27-41)."""
    if not cfg.dataset.augment_label:
        return
    label = g[cfg.dataset.augment_label + "_label"]
    if cfg.dataset.task == "node":
        g["node_label"] = label
    elif cfg.dataset.task in ("edge", "link_pred"):
        g["edge_label"] = label
    elif cfg.dataset.task == "graph":
        g["graph_label"] = label
    else:
        raise ValueError(f"Unknown task type: {cfg.dataset.task}")
