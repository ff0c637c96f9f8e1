"""The port's parity tool: the reference's configs trained for their
full length through the port, against the reference's numbers.

    python -m graphgym_tpu_torch.exp.parity \\
        --configs configs/idgin_ws.yaml configs/idgat_ws.yaml \\
        --repeat 3 --out DIR [--opts dataset.dir D ...]

    python -m graphgym_tpu_torch.exp.parity --points graph_ws500 \\
        --repeat 3 --out DIR [--opts dataset.dir D ...]

For each config it runs ``graphgym_tpu_torch.main --cfg C --repeat N``
(in this process, each seed timed), reads the seed aggregate the entry
point writes (``exp/agg.py``: ``DIR/runs/<config>/agg/val/best.json``)
and holds its mean best val accuracy to PARITY.md's pass rule
(results/parity/PARITY.md:1, ``pass_2sigma`` of tools/run_parity.py):
|delta| <= max(2 sqrt(sigma_ref^2 + sigma_ours^2), 0.03).  The
reference's mean and sigma, and the JAX package's own result beside
them, come from results/parity/parity.json, which this tool reads and
never writes.  Where the JAX package's own row misses the reference
(the reference's failing rows, ROADMAP "C"), the port is held to the
JAX package's result instead, and the row says so.  Where the JAX
package's own CPU run of the config at the same seeds is recorded
(``JAX_CPU_RUNS``), the row is judged against it too, by the same rule,
beside the first judgement.  A grid point (``POINTS``: a base config
and a grid's overrides, by name) has no parity.json row: it is
reported, and judged against ``JAX_CPU_RUNS`` where that holds the
point, and against the reference's row of the config a point names
after its overrides (the GIN aggregation ablation's points).  The
table is written as DIR/parity.md and DIR/parity.json, and nowhere
else.  Each row names the run's tpu.dtype (``--opts tpu.dtype
bfloat16``: mixed precision; the table writes it after the config where
it is not float32), and a bf16 row is judged against the same rows as
the f32 one of its config, the same model at another dtype.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PARITY_JSON = os.path.join(ROOT, "results", "parity", "parity.json")
LINK_PARITY_JSON = os.path.join(ROOT, "results", "parity",
                                "link_parity.json")
FLOOR = 0.03    # PARITY.md's floor on the band

# The JAX package's own runs of a config on a CPU at the seeds the port's
# run takes (1-3), where parity.json's row came from another protocol
# (tools/run_parity.py: a constant learning rate, batch-averaged
# accuracy, a TPU) than ``main --cfg`` (the config's cosine schedule,
# size-weighted accuracy): ``JAX_PLATFORMS=cpu python -m
# graphgym_tpu.main --cfg configs/<config> --repeat 3 tpu.spmm_impl xla``
# with jax_default_matmul_precision pinned to "highest", on 3-4 cores of
# an 8-core Intel Xeon; each seed's best val accuracy and
# agg/val/best.json's mean and std.  The row is judged against them as
# well, by the same rule.
JAX_CPU_RUNS = {
    "ginconvFast_ba.yaml": dict(
        best_val_acc_per_seed=[0.89, 0.9017, 0.8652], mean=0.8856,
        std=0.0152),
    "gatconvFast_ba.yaml": dict(
        best_val_acc_per_seed=[0.5658, 0.5716, 0.5176], mean=0.5517,
        std=0.0242),
    # the smallworld and scalefree configs with a parity.json row (the
    # JAX package's own corpora regenerated under dataset.dir), whose
    # single-seed rows came from tools/run_parity.py's protocol (the
    # smallworld Fast rows sit at its collapse, 0.1574)
    "gcnconvFast_smallworld.yaml": dict(
        best_val_acc_per_seed=[0.7031, 0.7448, 0.6875], mean=0.7118,
        std=0.0242),
    "gatconvFast_smallworld.yaml": dict(
        best_val_acc_per_seed=[0.6042, 0.6875, 0.6068], mean=0.6328,
        std=0.0387),
    "gcnconv_smallworld.yaml": dict(
        best_val_acc_per_seed=[0.5208, 0.4688, 0.4896], mean=0.4931,
        std=0.0214),
    "gatconv_smallworld.yaml": dict(
        best_val_acc_per_seed=[0.2109, 0.1979, 0.3464], mean=0.2517,
        std=0.0671),
    "gcnconvFast_scalefree.yaml": dict(
        best_val_acc_per_seed=[0.7643, 0.8001, 0.7865], mean=0.7836,
        std=0.0148),
    "gatconvFast_scalefree.yaml": dict(
        best_val_acc_per_seed=[0.5658, 0.5716, 0.5169], mean=0.5514,
        std=0.0245),
    "gcnconv_scalefree.yaml": dict(
        best_val_acc_per_seed=[0.6582, 0.6751, 0.5931], mean=0.6421,
        std=0.0354),
    "gatconv_scalefree.yaml": dict(
        best_val_acc_per_seed=[0.4362, 0.4134, 0.3548], mean=0.4015,
        std=0.0343),
    "idgcn_smallworld.yaml": dict(
        best_val_acc_per_seed=[1.0, 0.9922, 0.9948], mean=0.9957,
        std=0.0032),
    # a grid point (POINTS) the same way: --cfg configs/idgcn_ws.yaml
    # --repeat 3 <its overrides> tpu.spmm_impl xla, with dataset.dir
    # holding the port's regenerated ws500 (28 graphs) pickled as the
    # JAX package's HostGraphs in ws500.pkl (the JAX package's own
    # networkx loop computes the path length on all 51,200 attempts, for
    # hours); 3 cores.  6 val graphs: an accuracy moves by 1/6.
    "graph_ws500": dict(
        best_val_acc_per_seed=[0.6667, 0.6667, 0.6667], mean=0.6667,
        std=0.0),
    # round1att's points: --cfg configs/design/design_v1att.yaml
    # --repeat 3 <its overrides> tpu.spmm_impl xla, the JAX package's own
    # scalefree corpus regenerated under dataset.dir; the graph point's
    # dropout masks are the JAX package's draws
    "design_att_sf_mul": dict(
        best_val_acc_per_seed=[0.4887, 0.5836, 0.555], mean=0.5424,
        std=0.0397),
    "design_att_sf_add_graph": dict(
        best_val_acc_per_seed=[0.4167, 0.2917, 0.375], mean=0.3611,
        std=0.052),
    # the GIN aggregation ablation's points the same way: --cfg
    # configs/<config>.yaml --repeat 3 gnn.gin_agg <agg> tpu.spmm_impl
    # xla, the JAX package's own ba corpus regenerated under dataset.dir;
    # the runs' aggregates and each seed's val curve are under
    # results/parity/jax_cpu_gin_ablation/<point>/
    "ginconv_ba_gcn": dict(
        best_val_acc_per_seed=[0.6673, 0.6673, 0.6302], mean=0.6549,
        std=0.0175),
    "ginconv_ba_gcn_noself": dict(
        best_val_acc_per_seed=[0.6335, 0.6615, 0.6367], mean=0.6439,
        std=0.0125),
    "ginconv_ba_mean": dict(
        best_val_acc_per_seed=[0.4362, 0.4134, 0.3548], mean=0.4015,
        std=0.0343),
    "ginconvFast_ba_gcn": dict(
        best_val_acc_per_seed=[0.9355, 0.9512, 0.9414], mean=0.9427,
        std=0.0065),
}


# grids/IDGNN/graph.txt's synthetic chunks (:35-47 plain, :50-61 ID) on
# the 500-node corpora, each a base config and the grid's overrides: the
# ID chunk's gcnidconv on ba500 and the plain chunk's gatconv with
# node_identity features on ws500 (the corpora regenerated from seed 0
# where dataset.dir holds neither)
GRAPH_GRID = ("dataset.format", "nx", "dataset.task", "graph",
              "dataset.transductive", "False", "dataset.augment_label",
              "graph_clustering_coefficient", "gnn.layers_pre_mp", "1",
              "gnn.layers_mp", "3", "gnn.layers_post_mp", "3")
# grids/design/round1att.txt's synthetic chunks on the design_v1att base
# (dim_inner 256, batch 128, 100 epochs: the base's), at scalefree:
# gmulconv on the node chunk (:44-61) and gaddconv on the graph chunk
# (:82-99)
ROUND1ATT_GRID = ("dataset.format", "nx", "dataset.name", "scalefree",
                  "dataset.transductive", "True", "gnn.batchnorm", "True",
                  "gnn.agg", "add", "optim.optimizer", "adam",
                  "optim.base_lr", "0.01")
# grids/IDGNN/link.txt's ID chunk (:21-34: the edge-net transform, 5 MP
# layers at the base's 128, batch 32, 100 epochs) with the disjoint
# protocol of results/parity/LINK_PARITY.md, at gatidconv on ba
LINK_ID_GRID = ("dataset.format", "nx", "dataset.transductive", "False",
                "dataset.augment_label", "", "gnn.layers_pre_mp", "1",
                "gnn.layers_mp", "5", "gnn.layers_post_mp", "1",
                "train.batch_size", "32", "dataset.transform", "edge",
                "dataset.task", "link_pred", "dataset.augment_feature", "[]",
                "dataset.edge_train_mode", "disjoint", "optim.max_epoch",
                "100")
# the ID-GNN paper's real-dataset chunks, each on the config of its
# dataset: grids/IDGNN/node.txt:22-34 (Cora, transductive, the class
# labels, gatidconv at 2 MP layers) and graph_enzyme.txt:21-33 at its
# first layer type (TU_ENZYMES, the graph task, ego at r = 3); their raw
# files under dataset.dir (data/loaders.py's parsers)
CORA_GRID = ("dataset.format", "PyG", "dataset.name", "Cora",
             "dataset.transform", "ego", "dataset.task", "node",
             "dataset.transductive", "True", "dataset.augment_feature", "[]",
             "dataset.augment_label", "", "gnn.layers_pre_mp", "1",
             "gnn.layers_mp", "2", "gnn.layers_post_mp", "1",
             "gnn.layer_type", "gatidconv", "optim.max_epoch", "100")
ENZYMES_GRID = ("dataset.format", "PyG", "dataset.name", "TU_ENZYMES",
                "dataset.transform", "ego", "dataset.task", "graph",
                "dataset.transductive", "False", "dataset.augment_feature",
                "[]", "dataset.augment_label", "", "gnn.layers_pre_mp", "1",
                "gnn.layers_mp", "3", "gnn.layers_post_mp", "3",
                "gnn.layer_type", "gcnidconv", "optim.max_epoch", "100")
# grids/IDGNN/graph_ogb.txt's ID chunk (:21-33) at its first layer type
# on configs/design/design_v2ogb.yaml (the Atom encoder and its BN at
# encoder_dim 300, dim_inner 300, batch 128, add pooling, PReLU): ego at
# r = 3, 1 / 3 / 3 layers, 100 epochs; the grid's
# dataset.feature_encoder_name, a key neither package reads.  And
# ogbn-arxiv on configs/design/design_v2.yaml (generalconv, 2 MP layers
# at 256), full batch, its official time split.  Both from the OGB raw
# directories under dataset.dir (data/ogb.py).
OGB_ID_GRID = ("dataset.format", "OGB", "dataset.name", "ogbg-molhiv",
               "dataset.transform", "ego", "dataset.task", "graph",
               "dataset.transductive", "False", "dataset.augment_feature",
               "[]", "dataset.augment_label", "",
               "dataset.feature_encoder_name", "Atom",
               "gnn.layers_pre_mp", "1", "gnn.layers_mp", "3",
               "gnn.layers_post_mp", "3", "gnn.layer_type", "gcnidconv",
               "optim.max_epoch", "100")
# A point is (base config, overrides) or (base config, overrides, the
# config whose parity.json row it is judged against).  The GIN
# aggregation ablation (cfg.gnn.gin_agg; docs/PARITY_NOTES.md:43-75):
# the reference's ginconv / ginconvFast configs on ba with the JAX
# package's candidate aggregations, each judged against the reference's
# row of its config.
POINTS = {
    **{f"{cfg}_{agg}": (cfg, ("gnn.gin_agg", agg), cfg)
       for cfg, agg in (("ginconv_ba", "gcn"), ("ginconv_ba", "gcn_noself"),
                        ("ginconv_ba", "mean"), ("ginconvFast_ba", "gcn"))},
    "ogbg_molhiv_gcnid": ("design/design_v2ogb", OGB_ID_GRID),
    "ogbn_arxiv_design": ("design/design_v2", (
        "dataset.format", "OGB", "dataset.name", "ogbn-arxiv")),
    "cora_gatid": ("idgcn_Cora", CORA_GRID),
    "idgraph_enzymes": ("idgcn_ENZYMES", ENZYMES_GRID),
    "linkid_ba": ("idgcn_ba", LINK_ID_GRID + (
        "dataset.name", "ba", "gnn.layer_type", "gatidconv")),
    "design_att_sf_mul": ("design/design_v1att", ROUND1ATT_GRID + (
        "dataset.task", "node", "dataset.augment_feature",
        "['node_pagerank']", "dataset.augment_label",
        "node_clustering_coefficient", "gnn.layer_type", "gmulconv",
        "gnn.layers_pre_mp", "1", "gnn.layers_mp", "4",
        "gnn.layers_post_mp", "1", "gnn.stage_type", "stack", "gnn.act",
        "relu", "gnn.dropout", "0.0")),
    "design_att_sf_add_graph": ("design/design_v1att", ROUND1ATT_GRID + (
        "dataset.task", "graph", "dataset.augment_feature",
        "['node_onehot']", "dataset.augment_label", "graph_path_len",
        "gnn.layer_type", "gaddconv", "gnn.layers_pre_mp", "2",
        "gnn.layers_mp", "2", "gnn.layers_post_mp", "2",
        "gnn.stage_type", "skipsum", "gnn.act", "prelu", "gnn.dropout",
        "0.3")),
    "idgraph_ba500": ("idgcn_ba", GRAPH_GRID + (
        "dataset.name", "ba500", "dataset.transform", "ego",
        "dataset.augment_feature", "[]", "gnn.layer_type", "gcnidconv")),
    "graph_ws500": ("idgcn_ws", GRAPH_GRID + (
        "dataset.name", "ws500", "dataset.transform", "none",
        "dataset.augment_feature", "['node_identity']", "gnn.layer_type",
        "gatconv")),
}


def point_config(name: str) -> Tuple[str, List[str]]:
    """A grid point's base config file and overrides."""
    base, opts = POINTS[name][:2]
    return os.path.join(ROOT, "configs", f"{base}.yaml"), list(opts)


def pass_rule(delta: float, sigma_ref: float,
              sigma_ours: float) -> Tuple[bool, float]:
    """(passes, limit): PARITY.md's rule, |delta| <= limit =
    max(2 sqrt(sigma_ref^2 + sigma_ours^2), 0.03)."""
    limit = max(2 * math.sqrt((sigma_ref or 0.0) ** 2
                              + (sigma_ours or 0.0) ** 2), FLOOR)
    return bool(abs(delta) <= limit), limit


def read_rows(path: str = PARITY_JSON) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def reference(model: str, dataset: str, path: str = PARITY_JSON) -> Dict:
    """parity.json's row of ``model`` on ``dataset``: the reference's
    mean and sigma (``reference``, ``reference_std``) and the JAX
    package's (``ours``, ``ours_std``, ``seeds``, ``pass_2sigma``)."""
    rows = [r for r in read_rows(path)
            if r["model"] == model and r["dataset"] == dataset]
    if len(rows) != 1:
        raise KeyError(f"{path}: {len(rows)} rows for {model} on {dataset}")
    return rows[0]


def link_reference(layer: str, dataset: str, feature: str = "",
                   path: str = LINK_PARITY_JSON) -> Dict:
    """link_parity.json's row of ``layer`` on ``dataset`` with node
    feature ``feature`` ('' for none)."""
    rows = [r for r in read_rows(path) if r["layer"] == layer
            and r["dataset"] == dataset and r["feature"] == feature]
    if len(rows) != 1:
        raise KeyError(f"{path}: {len(rows)} rows for {layer} on "
                       f"{dataset} ({feature!r})")
    return rows[0]


def config_key(cfg_file: str) -> Tuple[str, str]:
    """(model, dataset) of a config named <model>_<dataset>.yaml, as
    parity.json names its rows (idgin_ba.yaml: idgin, ba)."""
    stem = os.path.splitext(os.path.basename(cfg_file))[0]
    model, _, dataset = stem.rpartition("_")
    return model, dataset


def _read_stats(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summarize(parent: str, seconds: Sequence[float] = ()) -> Dict:
    """The summary of the seed runs under ``parent`` (main's
    <out_dir>/<config>): each seed's best val accuracy and epochs, the
    aggregate's mean and std (agg/val/best.json), ``seconds`` (each
    seed's run) and the median ``time_iter`` of every train step."""
    with open(os.path.join(parent, "agg", "val", "best.json")) as f:
        best = json.loads(f.readline())
    per_seed, time_iter, epochs = [], [], []
    for seed in sorted(d for d in os.listdir(parent) if d.isdigit()):
        val = _read_stats(os.path.join(parent, seed, "val", "stats.json"))
        train = _read_stats(os.path.join(parent, seed, "train",
                                         "stats.json"))
        per_seed.append(max(s["accuracy"] for s in val))
        time_iter += [s["time_iter"] for s in train]
        epochs.append(len(train))
    return dict(seeds=len(per_seed), epochs=epochs,
                best_val_acc_per_seed=per_seed, mean=best["accuracy"],
                std=best.get("accuracy_std", 0.0),
                seconds_per_run=list(seconds),
                time_iter_median_s=float(np.median(time_iter)))


def run_config(cfg_file: str, repeat: int, out_dir: str,
               overrides: Sequence[str] = ()) -> Tuple[list, Dict]:
    """Train ``cfg_file`` through graphgym_tpu_torch.main with ``repeat``
    seeds into ``out_dir`` (its earlier runs of the config removed), each
    seed's run (data, model, training) timed; (main's results,
    ``summarize``'s summary)."""
    from graphgym_tpu_torch import main as port_main

    parent = os.path.join(
        out_dir, os.path.splitext(os.path.basename(cfg_file))[0])
    shutil.rmtree(parent, ignore_errors=True)   # stats.json appends
    seconds, real = [], port_main.run_single

    def timed(*args):
        t0 = time.perf_counter()
        result = real(*args)
        seconds.append(time.perf_counter() - t0)
        return result
    port_main.run_single = timed
    try:
        results = port_main.main(["--cfg", cfg_file, "--repeat", str(repeat)]
                                 + list(overrides) + ["out_dir", out_dir])
    finally:
        port_main.run_single = real
    return results, summarize(parent, seconds)


def parity_row(cfg_file: str, summary: Dict,
               path: str = PARITY_JSON) -> Dict:
    """One row of the table: the port's summary (``run_config``) beside
    parity.json's row for the config, judged by ``pass_rule`` against
    the reference, or against the JAX package where the JAX package's
    own row misses the reference."""
    model, dataset = config_key(cfg_file)
    ref = reference(model, dataset, path)
    mean, std = summary["mean"], summary["std"]
    passes_ref, limit_ref = pass_rule(mean - ref["reference"],
                                      ref["reference_std"], std)
    row = dict(config=os.path.basename(cfg_file), model=model,
               dataset=dataset, port=mean, port_std=std,
               seeds=summary["seeds"],
               seconds_per_run=summary["seconds_per_run"],
               time_iter_median_s=summary["time_iter_median_s"],
               jax=ref["ours"], jax_std=ref["ours_std"],
               jax_seeds=ref["seeds"], jax_passes=ref["pass_2sigma"],
               reference=ref["reference"],
               reference_std=ref["reference_std"],
               delta=mean - ref["reference"], limit=limit_ref,
               passes_reference=passes_ref, judged_against="reference",
               passes=passes_ref, note=ref.get("note", ""))
    if not ref["pass_2sigma"]:
        passes, limit = pass_rule(mean - ref["ours"], ref["ours_std"], std)
        row.update(judged_against="jax", delta_jax=mean - ref["ours"],
                   limit_jax=limit, passes=passes)
    cpu = JAX_CPU_RUNS.get(os.path.basename(cfg_file))
    if cpu is not None:
        passes, limit = pass_rule(mean - cpu["mean"], cpu["std"], std)
        row.update(jax_cpu=cpu["mean"], jax_cpu_std=cpu["std"],
                   delta_jax_cpu=mean - cpu["mean"], limit_jax_cpu=limit,
                   passes_jax_cpu=passes)
    return row


def point_row(name: str, summary: Dict,
              path: str = PARITY_JSON) -> Dict:
    """One row of the table for a grid point: the port's summary,
    judged against the JAX package's run where ``JAX_CPU_RUNS`` holds
    the point, and against the reference's row of the config the point
    names (``POINTS``; that row's JAX result is the config's own, not
    the point's, so the JAX column stays empty).  A point that names
    none has no reference."""
    mean, std = summary["mean"], summary["std"]
    row = dict(config=name, model=name, dataset=None, port=mean,
               port_std=std, seeds=summary["seeds"],
               seconds_per_run=summary["seconds_per_run"],
               time_iter_median_s=summary["time_iter_median_s"],
               reference=None, judged_against=None, passes=None,
               note="no parity.json row")
    cpu = JAX_CPU_RUNS.get(name)
    if len(POINTS[name]) > 2:
        model, dataset = config_key(POINTS[name][2])
        ref = reference(model, dataset, path)
        passes, limit = pass_rule(mean - ref["reference"],
                                  ref["reference_std"], std)
        row.update(model=model, dataset=dataset, jax=None,
                   reference=ref["reference"],
                   reference_std=ref["reference_std"],
                   delta=mean - ref["reference"], limit=limit,
                   passes_reference=passes, judged_against="reference",
                   passes=passes,
                   note=f"the reference's {model} / {dataset} row")
    if cpu is not None:
        passes, limit = pass_rule(mean - cpu["mean"], cpu["std"], std)
        row.update(jax_cpu=cpu["mean"], jax_cpu_std=cpu["std"],
                   delta_jax_cpu=mean - cpu["mean"], limit_jax_cpu=limit,
                   passes_jax_cpu=passes)
    return row


def run_dtype(cfg_file: str, opts: Sequence[str]) -> str:
    """The tpu.dtype a run of ``cfg_file`` with ``opts`` trains in."""
    from graphgym_tpu_torch.config import load_cfg

    return load_cfg(cfg_file, list(opts)).tpu.dtype


def _pm(mean: float, std: float) -> str:
    return f"{mean:.4f}±{std:.4f}"


def table(rows: Sequence[Dict]) -> str:
    """The markdown table of ``parity_row``'s rows."""
    out = ["| config | port (±σ, seeds) | JAX package (±σ, seeds) | "
           "reference (±σ) | delta | limit | judged against | passes | "
           "s per run | median time_iter ms | JAX package on a CPU, the "
           "same seeds: delta / limit, passes |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        runs = ", ".join(f"{s:.1f}" for s in r["seconds_per_run"])
        if r["reference"] is None:       # a grid point: reported
            judged = "— (no row) | — | — | — | — | — | — |"
        else:
            delta, limit = ((r["delta_jax"], r["limit_jax"])
                            if r["judged_against"] == "jax"
                            else (r["delta"], r["limit"]))
            jax = ("—" if r["jax"] is None else
                   f"{_pm(r['jax'], r['jax_std'])} ({r['jax_seeds']})")
            judged = (f"{jax} | {_pm(r['reference'], r['reference_std'])} | "
                      f"{delta:+.4f} | {limit:.4f} | {r['judged_against']} "
                      f"| {r['passes']} |")
        dtype = r.get("dtype", "float32")
        tag = "" if dtype in ("float32", "f32", "") else f" ({dtype})"
        out.append(
            f"| {r['config']}{tag} | {_pm(r['port'], r['port_std'])} "
            f"({r['seeds']}) | {judged} "
            f"{runs} | {1e3 * r['time_iter_median_s']:.2f} | "
            + (f"{_pm(r['jax_cpu'], r['jax_cpu_std'])}: "
               f"{r['delta_jax_cpu']:+.4f} / {r['limit_jax_cpu']:.4f}, "
               f"{r['passes_jax_cpu']} |" if "jax_cpu" in r else "— |"))
    return "\n".join(out) + "\n"


def write(rows: Sequence[Dict], out: str) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "parity.json"), "w") as f:
        json.dump(list(rows), f, indent=1)
    with open(os.path.join(out, "parity.md"), "w") as f:
        f.write(table(rows))


def drop_checkpoints(root: str) -> None:
    """Remove the runs' checkpoint directories (the aggregate and the
    stats stay)."""
    for parent, dirs, _ in os.walk(root):
        if "ckpt" in dirs:
            shutil.rmtree(os.path.join(parent, "ckpt"))
            dirs.remove("ckpt")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    parser = argparse.ArgumentParser(
        description="full-length runs of configs through the port, "
                    "against results/parity/parity.json")
    parser.add_argument("--configs", nargs="+", default=[])
    parser.add_argument("--points", nargs="+", default=[],
                        choices=sorted(POINTS))
    parser.add_argument("--repeat", type=int, default=3)
    parser.add_argument("--out", required=True)
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides for every run (last)")
    args = parser.parse_args(argv)
    if not args.configs and not args.points:
        parser.error("give --configs or --points")
    runs = os.path.join(args.out, "runs")
    jobs = [(cfg_file, [], runs, lambda s, c=cfg_file: parity_row(c, s))
            for cfg_file in args.configs]
    jobs += [(*point_config(name), os.path.join(runs, name),
              lambda s, n=name: point_row(n, s)) for name in args.points]
    rows = []
    for cfg_file, opts, out, row in jobs:
        _, summary = run_config(cfg_file, args.repeat, out,
                                opts + list(args.opts))
        drop_checkpoints(out)
        rows.append(dict(row(summary), dtype=run_dtype(
            cfg_file, opts + list(args.opts))))
        write(rows, args.out)
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
