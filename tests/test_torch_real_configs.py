"""The ID-GNN paper's real-dataset points through both packages, on
small raw files the tests write in the published formats.

``grids/IDGNN/node.txt:22-34`` (Cora, transductive, ego at r = 2,
gatidconv), ``graph_enzyme.txt:21-33`` at gcnidconv (TU_ENZYMES, the
graph task, ego at r = 3) and ``configs/idgin_PROTEINS.yaml`` (a node
task on TU data, cut by tu_simple): ``create_dataset`` and
``create_loader`` equal the JAX package's, split for split and batch
for batch, array for array; three Adam steps at width 16 from the same
parameters stay within 2e-3 of the JAX package's losses.  Each of the
24 ``configs/*_Cora.yaml`` / ``*_CiteSeer.yaml`` sets ``transductive:
false`` on a one-graph dataset, so its split has no train graph:
``configs/idgcn_Cora.yaml`` raises in both packages.  And ``main`` on
the CPU trains configs/idgin_ENZYMES.yaml from a written TU set and
writes its stats.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu_torch import main as port_main
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, standins
from graphgym_tpu_torch.exp import parity
from graphgym_tpu_torch.graphs.packing import pool_kind
from test_torch_att_layers import three_steps

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# small stand-ins in the published formats: a Cora-shaped Planetoid set
# and two TU sets (ENZYMES' 18 attributes and 3 node labels; PROTEINS'
# 3 node labels), a few graphs of at least 100 undirected edges each
CORA = dict(nodes=90, edges=200, features=50, classes=5, x_rows=20,
            allx_rows=60, test_rows=30)
TU = dict(graphs=20, nodes=420, edges=800, min_nodes=3, max_nodes=70,
          large=4)
POINTS = {
    "cora_gatid": parity.POINTS["cora_gatid"],
    "idgraph_enzymes": parity.POINTS["idgraph_enzymes"],
    "idgin_proteins": ("idgin_PROTEINS", ()),
}


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("raw"))
    standins.write_planetoid_standin(d, "cora", seed=1, **CORA)
    standins.write_tu_standin(d, "ENZYMES", seed=2, **TU)
    standins.write_tu_standin(d, "PROTEINS", seed=3, attributes=0,
                              **TU)
    return d


def both_cfgs(base, opts, d):
    cfg_file = os.path.join(ROOT, "configs", f"{base}.yaml")
    opts = list(opts) + ["gnn.dim_inner", "16", "dataset.dir", d]
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla"])
    return jcfg, load_cfg(cfg_file, opts + ["device", "cpu"])


@functools.lru_cache(maxsize=None)
def point_data(point, d):
    """Both packages' configs (dims set by create_dataset), splits and
    loaders of a point."""
    jcfg, cfg = both_cfgs(*POINTS[point], d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        jsplits = jax_loaders.create_dataset(jcfg)
        splits = loaders.create_dataset(cfg)
        jlds = jax_loaders.create_loader(jsplits, jcfg)
    return jcfg, cfg, jsplits, splits, jlds, loaders.create_loader(splits,
                                                                   cfg)


def assert_batches_equal(jb, b):
    """Every field of the port's host batch against the JAX batch's."""
    for f in dataclasses.fields(b):
        if f.name == "packs":
            continue
        want, got = getattr(jb, f.name), getattr(b, f.name)
        if want is None:
            assert got is None, f.name
            continue
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f.name)


@pytest.mark.parametrize("point,splits,task,packs", [
    ("cora_gatid", (1, 1), "node", {"att"}),
    ("idgraph_enzymes", (16, 4), "graph", {"gcn", "pool_add_ego"}),
    ("idgin_proteins", (9, 3), "node", {"plain"})])
def test_splits_and_batches_match_jax(raw_dir, point, splits, task, packs):
    """Each split's graphs (num_nodes, edges, every feature array: the
    parsed features, the labels, the supervised and ego-center indices)
    and each loader's batches of two epochs; the dims."""
    jcfg, cfg, jsplits, psplits, jlds, lds = point_data(point, raw_dir)
    assert tuple(len(p) for p in psplits) == splits
    assert cfg.dataset.task == task
    assert (cfg.share.dim_in, cfg.share.dim_out) == (jcfg.share.dim_in,
                                                     jcfg.share.dim_out)
    for jpart, part in zip(jsplits, psplits):
        for jg, g in zip(jpart, part):
            assert g.num_nodes == jg.num_nodes
            np.testing.assert_array_equal(g.edge_index, jg.edge_index)
            assert sorted(g.feats) == sorted(jg.feats)
            for key in jg.feats:
                np.testing.assert_array_equal(g[key], np.asarray(jg[key]),
                                              err_msg=key)
    for jld, ld in zip(jlds, lds):
        for epoch in range(2):
            jbs, bs = jld.batches(epoch), ld.batches(epoch)
            assert len(bs) == len(jbs) >= 1
            for jb, b in zip(jbs, bs):
                assert_batches_equal(jb, b)
                assert set(b.packs) == packs
    if point == "idgraph_enzymes":
        assert pool_kind(cfg.model.graph_pooling, True) in packs
        assert cfg.share.dim_in == 21       # 18 attributes, 3 labels
    if point == "cora_gatid":
        assert cfg.share.dim_in == CORA["features"]
        assert cfg.share.dim_out == CORA["classes"]


@pytest.mark.parametrize("point", sorted(POINTS))
def test_three_steps_match_jax(raw_dir, point):
    """Three Adam steps of each package on its first train batch from
    the same parameters (params_from_jax): per-step losses within 2e-3
    (a Tfg model's loss with its kernel L2, 5e-4)."""
    jcfg, cfg, _, _, jlds, lds = point_data(point, raw_dir)
    three_steps(jcfg, cfg, jlds[0].batches(0)[0],
                lds[0].batches(0)[0].to(CPU),
                l2_kernel=5e-4 if cfg.gnn.layer_type.startswith("Tfg-")
                else 0.0)


def test_inductive_cora_configs_raise_in_both(raw_dir):
    """configs/idgcn_Cora.yaml (transductive: false, split [0.8, 0.2])
    on Cora's one graph: int(0.8 x 1) = 0 train graphs, the one graph
    in val, and set_dataset_info's splits[0][0] raises in both
    packages; the port invents no other split."""
    jcfg, cfg = both_cfgs("idgcn_Cora", (), raw_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        with pytest.raises(IndexError):
            jax_loaders.create_dataset(jcfg)
    with pytest.raises(IndexError):
        loaders.create_dataset(cfg)


def test_main_trains_idgin_enzymes_on_the_cpu(raw_dir, tmp_path):
    """python -m graphgym_tpu_torch.main --cfg configs/idgin_ENZYMES.yaml
    dataset.dir <written TU files> device cpu optim.max_epoch 2 (width 8
    here): two finite train losses, val accuracies, the usual layout."""
    out = str(tmp_path / "out")
    port_main.main(["--cfg", os.path.join(ROOT, "configs",
                                          "idgin_ENZYMES.yaml"),
                    "dataset.dir", raw_dir, "device", "cpu",
                    "optim.max_epoch", "2", "gnn.dim_inner", "8", "out_dir",
                    out])
    run = os.path.join(out, "idgin_ENZYMES")
    assert sorted(os.listdir(run)) == ["1", "agg"]
    for split in ("train", "val"):
        with open(os.path.join(run, "1", split, "stats.json")) as f:
            stats = [json.loads(line) for line in f if line.strip()]
        assert len(stats) >= 1
        assert all(np.isfinite(s["loss"]) for s in stats)
    assert os.path.exists(os.path.join(run, "agg", "val", "best.json"))


def test_bench_tu_epoch_reads_the_written_enzymes(raw_dir):
    """graphgym_tpu_torch.bench's graph-task epoch on TU ENZYMES where
    its files are (the ws stand-in where they are not:
    test_torch_bench.py's suite test)."""
    from graphgym_tpu_torch import bench

    dt, eps, source = bench.bench_tu_epoch(epochs=1, device="cpu",
                                           dim_inner=8, dataset_dir=raw_dir)
    assert source == "ENZYMES" and dt > 0 and eps > 0
    # the COO layer route (tpu.spmm_impl xla) on the same files
    dt, eps, source = bench.bench_tu_epoch("xla", epochs=1, device="cpu",
                                           dim_inner=8, dataset_dir=raw_dir)
    assert source == "ENZYMES" and dt > 0 and eps > 0
