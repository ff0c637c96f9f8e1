"""The port's OGB raw-directory loaders (graphgym_tpu_torch/data/ogb.py)
and their official splits against the JAX package's.

On tests/test_ogb.py's fixtures (ogbn, ogbg and ogbl in the csv.gz
layout) and on small stand-ins of data/standins.py (ogbg-molhiv's and
ogbn-arxiv's layouts): ``load_ogb`` gives the same graphs array for
array, ``ogb_split_dataset`` the same splits from one seed (the link
split's drawn negatives included), and ``create_dataset`` the same
splits and dims.  A link split stored as ``.pt`` loads in both (a tensor
and ogb's {'edge': tensor}); the port reads it with
``torch.load(weights_only=True)`` and refuses a pickled object the JAX
package would run.  The stand-ins have the sizes asked for, the
edge-feat file the real layout has, and official parts that partition
the graphs or nodes; the OGB splits ride the processed-dataset cache.
"""

import functools
import os

import numpy as np
import pytest
import torch

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.data import ogb as jax_ogb
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders, ogb, standins
from test_ogb import make_ogbg_fixture, make_ogbl_fixture, make_ogbn_fixture

FIXTURES = {"ogbn-toy": make_ogbn_fixture, "ogbg-toy": make_ogbg_fixture,
            "ogbl-toy": make_ogbl_fixture}
# the stand-ins cut to a few graphs / nodes; the layout is the real one
MOLHIV = dict(graphs=48, split=(32, 8, 8))
ARXIV = dict(nodes=600, edges=2400, features=16, classes=5,
             split=(300, 120, 180))
TASKS = {"ogbn-toy": "node", "ogbg-toy": "graph", "ogbl-toy": "link_pred",
         "ogbg-molhiv": "graph", "ogbn-arxiv": "node"}


@pytest.fixture(scope="module")
def ogb_root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ogb"))
    for make in FIXTURES.values():
        make(d)
    standins.write_molhiv_standin(d, seed=1, **MOLHIV)
    standins.write_arxiv_standin(d, seed=2, **ARXIV)
    return d


def assert_graphs_equal(jgraphs, graphs):
    assert len(graphs) == len(jgraphs)
    for jg, g in zip(jgraphs, graphs):
        assert g.num_nodes == jg.num_nodes
        np.testing.assert_array_equal(g.edge_index, jg.edge_index)
        assert g.edge_index.dtype == jg.edge_index.dtype
        assert sorted(g.feats) == sorted(jg.feats)
        for key, want in jg.feats.items():
            got = g.feats[key]
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=key)
            assert np.asarray(got).dtype == np.asarray(want).dtype, key


def configs(name, d, extra=()):
    opts = ["dataset.format", "OGB", "dataset.name", name, "dataset.dir",
            d, "dataset.task", TASKS[name], *extra]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    return jcfg, cfg


@pytest.mark.parametrize("name", sorted(TASKS))
def test_load_ogb_matches_jax(ogb_root, name):
    graphs = ogb.load_ogb(name, ogb_root)
    assert_graphs_equal(jax_ogb.load_ogb(name, ogb_root), graphs)
    assert ogb.has_ogb_split(graphs)


@pytest.mark.parametrize("name", sorted(TASKS))
def test_official_split_matches_jax(ogb_root, name):
    """ogb_split_dataset from one seed: the same parts, graph for graph
    (a link split's train negatives drawn on the Generator), and no
    _ogb key left on a split's graphs."""
    jcfg, cfg = configs(name, ogb_root)
    jparts = jax_ogb.ogb_split_dataset(jax_ogb.load_ogb(name, ogb_root),
                                       jcfg, np.random.default_rng(3))
    parts = ogb.ogb_split_dataset(ogb.load_ogb(name, ogb_root), cfg,
                                  np.random.default_rng(3))
    assert len(parts) == len(jparts) == 3
    for jp, p in zip(jparts, parts):
        assert_graphs_equal(jp, p)
        assert not any(k.startswith("_ogb") for g in p for k in g.feats)


def test_split_dataset_takes_the_official_split(ogb_root):
    """loaders.split_dataset puts the official split ahead of the
    ratio split, whatever dataset.split and transductive say."""
    jcfg, cfg = configs("ogbn-arxiv", ogb_root,
                        ["dataset.split", "[0.5, 0.5]"])
    parts = loaders.split_dataset(ogb.load_ogb("ogbn-arxiv", ogb_root), cfg,
                                  np.random.default_rng(0))
    a, b, _ = ARXIV["split"]
    want = [np.arange(a), np.arange(a, a + b),
            np.arange(a + b, ARXIV["nodes"])]
    for (g,), idx in zip(parts, want):
        np.testing.assert_array_equal(g["node_label_index"], idx)


@functools.lru_cache(maxsize=None)
def both_datasets(name, d, extra=()):
    jcfg, cfg = configs(name, d, extra)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        jsplits = jax_loaders.create_dataset(jcfg)
    return jcfg, cfg, jsplits, loaders.create_dataset(cfg)


@pytest.mark.parametrize("name,extra", [
    ("ogbg-molhiv", ()),
    ("ogbg-molhiv", ("dataset.transform", "ego", "gnn.layers_mp", "2")),
    ("ogbn-arxiv", ()),
    ("ogbn-toy", ()),
    ("ogbl-toy", ()),
])
def test_create_dataset_matches_jax(ogb_root, name, extra):
    jcfg, cfg, jsplits, splits = both_datasets(name, ogb_root, extra)
    assert len(splits) == len(jsplits) == 3
    for jp, p in zip(jsplits, splits):
        assert_graphs_equal(jp, p)
    assert (cfg.share.dim_in, cfg.share.dim_out, cfg.share.num_splits) == (
        jcfg.share.dim_in, jcfg.share.dim_out, jcfg.share.num_splits)


def test_molhiv_standin_sizes_and_layout(ogb_root):
    """The layout of OGB's ogbg-molhiv download, edge-feat.csv.gz
    included (which neither package reads), 9 atom and 3 bond columns
    within their tables, one-direction bonds, the split's sizes."""
    base = os.path.join(ogb_root, "ogbg_molhiv")
    assert sorted(os.listdir(os.path.join(base, "raw"))) == [
        "edge-feat.csv.gz", "edge.csv.gz", "graph-label.csv.gz",
        "node-feat.csv.gz", "num-edge-list.csv.gz", "num-node-list.csv.gz"]
    assert os.listdir(os.path.join(base, "split")) == ["scaffold"]
    graphs = ogb.load_ogb("ogbg-molhiv", ogb_root)
    assert len(graphs) == MOLHIV["graphs"]
    assert graphs[0].num_nodes == standins.MOLHIV["max_nodes"]
    assert graphs[1].num_nodes == 2
    feat = np.concatenate([g["node_feature"] for g in graphs])
    assert feat.shape[1] == 9
    assert np.all(feat.max(0) < [119, 4, 12, 12, 10, 6, 6, 2, 2])
    bond = ogb._read_csv_gz(os.path.join(base, "raw", "edge-feat.csv.gz"),
                            np.int64)
    assert bond.shape == (sum(g.num_edges for g in graphs), 3)
    assert np.all(bond.max(0) < [5, 6, 2]) and bond.min() >= 0
    for g in graphs:        # a child bonded to an earlier atom, once
        assert np.all(g.senders > g.receivers)
        assert len({(s, r) for s, r in g.edge_index.T.tolist()}) \
            == g.num_edges
    parts = [int(g["_ogb_part"]) for g in graphs]
    assert [parts.count(i) for i in range(3)] == list(MOLHIV["split"])


def test_arxiv_standin_sizes(ogb_root):
    (g,) = ogb.load_ogb("ogbn-arxiv", ogb_root)
    raw = ogb._read_csv_gz(os.path.join(ogb_root, "ogbn_arxiv", "raw",
                                        "edge.csv.gz"), np.int64)
    assert raw.shape == (ARXIV["edges"], 2)
    assert len({tuple(e) for e in raw.tolist()}) == ARXIV["edges"]
    assert np.all(raw[:, 0] > raw[:, 1])          # cites earlier papers
    assert g.num_nodes == ARXIV["nodes"]
    assert g["node_feature"].shape == (ARXIV["nodes"], ARXIV["features"])
    assert set(np.unique(g["node_label"])) <= set(range(ARXIV["classes"]))
    assert [len(g[k]) for k in ("_ogb_train", "_ogb_val", "_ogb_test")] \
        == list(ARXIV["split"])


def test_write_csv_gz_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    x = np.round(rng.normal(size=(50, 7)), 4)
    ints = rng.integers(-3, 200, size=(40, 2))
    standins.write_csv_gz(str(tmp_path / "f.csv.gz"), x, decimals=4)
    standins.write_csv_gz(str(tmp_path / "i.csv.gz"), ints)
    got = ogb._read_csv_gz(str(tmp_path / "f.csv.gz"), np.float32)
    np.testing.assert_array_equal(got, x.astype(np.float32))
    np.testing.assert_array_equal(
        ogb._read_csv_gz(str(tmp_path / "i.csv.gz"), np.int64), ints)


@pytest.mark.parametrize("form", ["tensor", "dict"])
def test_pt_link_split_matches_jax(tmp_path, form):
    """ogbl splits stored as torch .pt files (no csv.gz): a bare tensor,
    or ogb's {'edge': ...} / {'edge_neg': ...}."""
    d = str(tmp_path)
    make_ogbl_fixture(d)
    scheme = os.path.join(d, "ogbl_toy", "split", "target")
    for part in ("train", "valid", "test", "valid_neg", "test_neg"):
        path = os.path.join(scheme, f"{part}.csv.gz")
        t = torch.from_numpy(ogb._read_csv_gz(path, np.int64))
        os.remove(path)
        if form == "dict":
            t = {"edge_neg" if part.endswith("neg") else "edge": t}
        torch.save(t, os.path.join(scheme, f"{part}.pt"))
    graphs = ogb.load_ogb("ogbl-toy", d)
    assert_graphs_equal(jax_ogb.load_ogb("ogbl-toy", d), graphs)
    assert graphs[0]["_ogbl_valid_neg"].shape == (5, 2)


class Planted:
    """A pickled object: unpickling it would call print."""

    def __reduce__(self):
        return (print, ("ran",))


def test_pt_split_refuses_a_pickled_object(tmp_path):
    """The port reads .pt splits with weights_only=True: an object that
    is not a tensor, dict or list is refused (the JAX package, with
    weights_only=False, would run its pickle)."""
    d = str(tmp_path)
    make_ogbl_fixture(d)
    scheme = os.path.join(d, "ogbl_toy", "split", "target")
    os.remove(os.path.join(scheme, "train.csv.gz"))
    torch.save(Planted(), os.path.join(scheme, "train.pt"))
    with pytest.raises(Exception, match="[Ww]eights only"):
        ogb.load_ogb("ogbl-toy", d)


def test_missing_directory_and_prefix_raise(ogb_root):
    with pytest.raises(FileNotFoundError, match="ogbg-absent"):
        ogb.load_ogb("ogbg-absent", ogb_root)
    with pytest.raises(ValueError, match="unknown prefix"):
        ogb.load_ogb("toy", ogb_root)


def test_cache_keeps_the_official_split(ogb_root, tmp_path):
    """dataset.cache_save writes the OGB splits and cache_load reads
    them back, graph for graph, with the dims."""
    cache_dir = str(tmp_path)
    os.symlink(os.path.join(ogb_root, "ogbg_molhiv"),
               os.path.join(cache_dir, "ogbg_molhiv"))
    _, cfg = configs("ogbg-molhiv", cache_dir, ["dataset.cache_save",
                                                "True"])
    splits = loaders.create_dataset(cfg)
    _, again = configs("ogbg-molhiv", cache_dir, ["dataset.cache_load",
                                                  "True"])
    for p, q in zip(splits, loaders.create_dataset(again)):
        assert_graphs_equal(p, q)
    assert again.share.dim_out == cfg.share.dim_out == 2
