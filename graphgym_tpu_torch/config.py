"""Config system: nested attribute config with YAML merge + dotted CLI
overrides.

The port's copy of graphgym_tpu/config.py, with the same defaults and
the same merge and assert semantics, so every YAML under configs/ and
grids/ merges identically.  ``set_cfg`` imports the port's own contrib
package (graphgym_tpu_torch.contrib, the copy of the JAX one) and then
applies every registered config group, as graphgym_tpu/config.py:327-335
does.  One difference: ``cfg.device`` takes ``auto | cuda | cpu``
(``auto`` means cuda).

The ``tpu.*`` group stays readable so that configs naming it merge; the
port reads ``tpu.pad_buckets`` from it and nothing else.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Any, Dict, List

import yaml

from graphgym_tpu_torch import register


class CfgNode(dict):
    """Attribute-style nested dict with type-checked merging."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # ------------------------------------------------------------- merging
    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        for key, value in other.items():
            if key not in self:
                # Permissive like registered-config extension: new keys
                # are allowed at the top of a group.
                self[key] = (CfgNode(value) if isinstance(value, dict)
                             else value)
                continue
            cur = self[key]
            if isinstance(cur, CfgNode) or isinstance(cur, dict):
                if not isinstance(value, dict):
                    raise TypeError(
                        f"Cannot merge non-dict into group '{key}'")
                node = self[key]
                if not isinstance(node, CfgNode):
                    node = CfgNode(node)
                    self[key] = node
                node.merge_from_dict(value)
            else:
                self[key] = _coerce(value, cur, key)

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def merge_from_list(self, opts: List[str]) -> None:
        """['gnn.dim_inner', '64', 'optim.base_lr', '0.1'] style
        overrides (reference run/main.py:28)."""
        assert len(opts) % 2 == 0, "Override list must be key value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            leaf = parts[-1]
            if isinstance(value, str):
                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            if leaf in node:
                node[leaf] = _coerce(value, node[leaf], key)
            else:
                node[leaf] = value

    # --------------------------------------------------------------- misc
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v)
                for k, v in self.items()}

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=True)


def _coerce(value: Any, reference_value: Any, key: str) -> Any:
    if reference_value is None or value is None:
        return value
    want = type(reference_value)
    if isinstance(value, want) and not (
            isinstance(value, bool) != isinstance(reference_value, bool)):
        return value
    if want is float and isinstance(value, int):
        return float(value)
    if want is int and isinstance(value, float) and value == int(value):
        return int(value)
    if want is list and isinstance(value, (list, tuple)):
        return list(value)
    if want is str:
        return str(value)
    if want is bool and isinstance(value, (int, str)):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    raise TypeError(
        f"Config key '{key}': cannot coerce {value!r} "
        f"({type(value).__name__}) to {want.__name__}")


def set_cfg(cfg: CfgNode) -> CfgNode:
    """Populate default options (reference config.py:14-424)."""
    # -------------------------------------------------- basic
    cfg.print = "both"              # stdout / file / both
    cfg.device = "auto"             # cpu / cuda / auto (= cuda)
    cfg.out_dir = "results"
    cfg.cfg_dest = "config.yaml"
    cfg.seed = 1
    cfg.round = 4
    cfg.tensorboard_each_run = False
    cfg.tensorboard_agg = True
    cfg.num_workers = 0
    cfg.num_threads = 6
    cfg.metric_best = "auto"
    cfg.metric_agg = "argmax"
    cfg.view_emb = False
    cfg.gpu_mem = False
    cfg.params = 0                  # filled with model param count

    # -------------------------------------------------- shared (set by data)
    cfg.share = CfgNode()
    cfg.share.dim_in = 1
    cfg.share.dim_out = 1
    cfg.share.num_splits = 1

    # -------------------------------------------------- dataset
    cfg.dataset = CfgNode()
    cfg.dataset.name = "Cora"
    cfg.dataset.format = "PyG"      # PyG / nx / OGB / syn (+ 'Tfg-' prefix)
    cfg.dataset.dir = "./datasets"
    cfg.dataset.task = "node"       # node / edge / graph / link_pred
    cfg.dataset.task_type = "classification"
    cfg.dataset.transductive = True
    cfg.dataset.split = [0.8, 0.1, 0.1]
    cfg.dataset.shuffle_split = True
    cfg.dataset.node_encoder = False
    cfg.dataset.node_encoder_name = "Atom"
    cfg.dataset.node_encoder_bn = True
    cfg.dataset.edge_encoder = False
    cfg.dataset.edge_encoder_name = "Bond"
    cfg.dataset.edge_encoder_bn = True
    cfg.dataset.encoder_dim = 128
    cfg.dataset.edge_dim = 128
    cfg.dataset.edge_train_mode = "all"
    cfg.dataset.edge_message_ratio = 0.8
    cfg.dataset.edge_negative_sampling_ratio = 1.0
    cfg.dataset.resample_disjoint = False
    cfg.dataset.resample_negative = False
    # ws link-deficit ablation switches (round 5, VERDICT r4 weak #1;
    # probe-only — committed parity rows keep both False):
    # eval splits keep ALL edges in the message graph (supervision
    # positives visible to message passing — the "leaky val" protocol
    # hypothesis for the DeepSNAP plain-layer link_pred path)
    cfg.dataset.link_eval_message_full = False
    # re-draw eval-split negatives at every eval epoch (best-val then
    # maxes over negative-set realizations — a systematic upward bias
    # the reference would have if DeepSNAP resamples on __getitem__)
    cfg.dataset.link_eval_resample_negative = False
    cfg.dataset.augment_feature = []
    cfg.dataset.augment_feature_dims = []
    cfg.dataset.augment_feature_repr = "original"
    cfg.dataset.augment_label = ""
    cfg.dataset.augment_label_dims = 0
    cfg.dataset.transform = "none"  # none / ego / edge
    cfg.dataset.cache_save = False
    cfg.dataset.cache_load = False
    cfg.dataset.remove_feature = False
    cfg.dataset.tu_simple = True
    cfg.dataset.to_undirected = False

    # -------------------------------------------------- train
    cfg.train = CfgNode()
    cfg.train.mode = "standard"
    cfg.train.batch_size = 16
    cfg.train.sampler = "full_batch"
    cfg.train.sample_node = False
    cfg.train.node_per_graph = 32
    cfg.train.eval_period = 10
    cfg.train.ckpt_period = 100
    cfg.train.auto_resume = False
    cfg.train.epoch_resume = -1
    cfg.train.ckpt_clean = True
    cfg.train.iter_per_epoch = 32
    cfg.train.walk_length = 4
    cfg.train.neighbor_sizes = [20, 15, 10, 5]

    # -------------------------------------------------- val
    cfg.val = CfgNode()
    cfg.val.sample_node = False
    cfg.val.sampler = "full_batch"
    cfg.val.node_per_graph = 32
    # 'weighted' = size-weighted split accuracy (exact); 'batch' = the
    # reference's mean-of-per-batch-accuracies (train.py:107) — parity
    # runs use 'batch' so unequal last batches match the reference
    cfg.val.accuracy_average = "weighted"

    # -------------------------------------------------- model
    cfg.model = CfgNode()
    cfg.model.type = "gnn"
    cfg.model.match_upper = True
    cfg.model.loss_fun = "cross_entropy"
    cfg.model.size_average = "mean"
    cfg.model.thresh = 0.5
    cfg.model.edge_decoding = "dot"
    cfg.model.graph_pooling = "add"

    # -------------------------------------------------- gnn
    cfg.gnn = CfgNode()
    cfg.gnn.layers_pre_mp = 0
    cfg.gnn.layers_mp = 2
    cfg.gnn.layers_post_mp = 0
    cfg.gnn.dim_inner = 16
    cfg.gnn.layer_type = "generalconv"
    cfg.gnn.stage_type = "stack"
    cfg.gnn.skip_every = 1
    cfg.gnn.batchnorm = True
    cfg.gnn.act = "relu"
    cfg.gnn.dropout = 0.0
    cfg.gnn.agg = "add"
    cfg.gnn.flow = "source_to_target"
    cfg.gnn.normalize_adj = False
    cfg.gnn.msg_direction = "single"
    cfg.gnn.self_msg = "concat"
    cfg.gnn.att_heads = 1
    # attention-coefficient dropout (TPU-build extension; the reference's
    # tfg GAT exposes drop_rate=0.0, TfgIDLayer.py:180-201, but no config
    # knob ever sets it)
    cfg.gnn.att_dropout = 0.0
    cfg.gnn.att_final_linear = False
    cfg.gnn.att_final_linear_bn = False
    # GIN aggregation ablation (TPU-build extension): 'sum' is correct
    # GIN; 'gcn'/'gcn_noself'/'mean' probe the reference's unpinned
    # 2021 tf_geometric GIN internals (docs/PARITY_NOTES.md outliers)
    cfg.gnn.gin_agg = "sum"
    cfg.gnn.l2norm = True
    cfg.gnn.keep_edge = 0.5

    # -------------------------------------------------- optim
    cfg.optim = CfgNode()
    cfg.optim.optimizer = "adam"
    cfg.optim.base_lr = 0.01
    cfg.optim.weight_decay = 5e-4
    cfg.optim.momentum = 0.9
    cfg.optim.scheduler = "cos"
    cfg.optim.steps = [30, 60, 90]
    cfg.optim.lr_decay = 0.1
    cfg.optim.max_epoch = 200

    # -------------------------------------------------- bn / mem
    cfg.bn = CfgNode()
    cfg.bn.eps = 1e-5
    cfg.bn.mom = 0.1
    # no cfg.mem group: the reference's mem.inplace only toggled torch
    # in-place activations (reference models/act.py:7-13); under XLA,
    # buffer reuse and jit donation (train/loop.py donated steps) cover
    # that permanently, so the knob would be dead — permissive merge
    # still accepts YAMLs that set it.

    # -------------------------------------------------- tpu group
    # The JAX package's device group, kept with its defaults so that
    # configs setting any of these keys still merge.  The port reads
    # pad_buckets; loaders raise on a non-empty mesh_shape (multi-GPU
    # is ROADMAP A16) and on a dtype other than float32 (A14).
    cfg.tpu = CfgNode()
    cfg.tpu.spmm_impl = "auto"
    cfg.tpu.dtype = "float32"
    cfg.tpu.pad_buckets = True       # quarter-step shape bucketing
    cfg.tpu.mesh_shape = []
    cfg.tpu.mesh_axes = ["edge", "feature"]
    cfg.tpu.partition = "auto"
    cfg.tpu.donate_state = True
    cfg.tpu.prefetch = True
    cfg.tpu.profile = False
    cfg.tpu.profile_epochs = 3
    cfg.tpu.remat = False
    cfg.tpu.max_host_rss_gb = 48.0

    # contrib auto-import (reference config.py:7 `from
    # graphgym.contrib.config import *`) then user-registered
    # extensions (reference config.py:422-424)
    try:
        import graphgym_tpu_torch.contrib  # noqa: F401
    except Exception as exc:  # contrib must never break core
        logging.warning("contrib import failed: %s", exc)
    for func in register.config_dict.values():
        func(cfg)
    return cfg


def assert_cfg(cfg: CfgNode) -> None:
    """Validation / auto-correction (reference config.py:427-447)."""
    if cfg.dataset.task not in ("node", "edge", "graph", "link_pred"):
        raise ValueError(
            f"Task {cfg.dataset.task} not supported, must be one of "
            "node, edge, graph, link_pred")
    if ("classification" in cfg.dataset.task_type
            and cfg.model.loss_fun == "mse"):
        cfg.model.loss_fun = "cross_entropy"
        logging.warning(
            "model.loss_fun changed to cross_entropy for classification.")
    if (cfg.dataset.task_type == "regression"
            and cfg.model.loss_fun == "cross_entropy"):
        cfg.model.loss_fun = "mse"
        logging.warning("model.loss_fun changed to mse for regression.")
    if cfg.dataset.task == "graph" and cfg.dataset.transductive:
        cfg.dataset.transductive = False
        logging.warning(
            "dataset.transductive changed to False for graph task.")
    if cfg.gnn.layers_post_mp < 1:
        cfg.gnn.layers_post_mp = 1
        logging.warning("Layers after message passing should be >=1")
    if cfg.device not in ("auto", "cuda", "cpu"):
        raise ValueError(
            f"device {cfg.device!r} not supported, must be one of "
            "auto, cuda, cpu")


def get_cfg() -> CfgNode:
    return set_cfg(CfgNode())


def load_cfg(path: str, opts: List[str] | None = None) -> CfgNode:
    c = get_cfg()
    c.merge_from_file(path)
    if opts:
        c.merge_from_list(opts)
    assert_cfg(c)
    return c


def dump_cfg(cfg: CfgNode) -> None:
    """Write resolved config to <out_dir>/<cfg_dest>
    (reference config.py:450-454)."""
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, cfg.cfg_dest), "w") as f:
        f.write(cfg.dump())


def get_parent_dir(out_dir: str, fname: str) -> str:
    """results/<cfg-name>/, the parent of the seed directories."""
    fname = os.path.basename(fname)
    if fname.endswith(".yaml"):
        fname = fname[:-5]
    return os.path.join(out_dir, fname)


def update_out_dir(cfg: CfgNode, out_dir: str, fname: str) -> None:
    """results/<cfg-name>/<seed>/ layout (reference config.py:457-464)."""
    cfg.out_dir = os.path.join(get_parent_dir(out_dir, fname),
                               str(cfg.seed))
    os.makedirs(cfg.out_dir, exist_ok=True)
