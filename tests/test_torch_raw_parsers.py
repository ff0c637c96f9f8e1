"""The port's raw-format parsers and dataset cache against the JAX
package's, on files the tests write.

Each parser reads the same files in both packages and must give the
same graphs array for array: num_nodes, edge_index and every feature
array, with their dtypes (``load_planetoid`` on a Cora-shaped stand-in
and on CiteSeer's gaps in test.index; ``load_tu`` with node attributes
and labels, edge attributes and labels, and without features;
``tu_simple_filter``; the ``TU_IMDB`` name; Karate, the GNN-benchmark
npz in both attribute forms, PPI, QM7b, MNIST superpixels).  A
Planetoid pickle naming anything but arrays, sparse matrices and the
graph's lists is refused.  The processed-dataset cache: the JAX
package's file (its key and name) loads in the port, a cache the port
writes reads back the same, and edge features ride the split, the link
supervision and the transforms as in the JAX package.  OGB dispatches
to the OGB loaders (tests/test_torch_ogb.py holds them).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders, standins
from graphgym_tpu_torch.data.hostgraph import HostGraph


@pytest.fixture(autouse=True)
def search_dirs(monkeypatch, tmp_path):
    """Both packages look in the test's directory only (the JAX one's
    own list names ./datasets and a reference checkout), and the JAX
    package takes its numpy transforms."""
    monkeypatch.setattr(jax_loaders, "_SEARCH_DIRS", [])
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(tmp_path / "none"))
    monkeypatch.setattr(jax_native, "load", lambda: None)


def assert_same_graphs(jgraphs, graphs):
    assert len(graphs) == len(jgraphs)
    for jg, g in zip(jgraphs, graphs):
        assert isinstance(g, HostGraph)
        assert g.num_nodes == jg.num_nodes
        assert g.edge_index.dtype == jg.edge_index.dtype
        np.testing.assert_array_equal(g.edge_index, jg.edge_index)
        assert sorted(g.feats) == sorted(jg.feats)
        for key, want in jg.feats.items():
            want = np.asarray(want)
            assert g[key].dtype == want.dtype, key
            np.testing.assert_array_equal(g[key], want, err_msg=key)


# ------------------------------------------------------------ Planetoid

SMALL_CORA = dict(nodes=60, edges=130, features=40, classes=4, x_rows=10,
                  allx_rows=40, test_rows=20)


def test_planetoid_matches_jax(tmp_path):
    """A Cora-shaped stand-in (scipy CSR features, a defaultdict graph,
    Python 2 pickles): the graph symmetrized and deduplicated, tx / ty
    placed at test.index's order, labels the one-hot argmax."""
    base = standins.write_planetoid_standin(str(tmp_path), "cora", seed=1,
                                            **SMALL_CORA)
    assert base == os.path.join(str(tmp_path), "cora", "raw")
    graphs = loaders.load_planetoid("Cora", str(tmp_path))
    assert_same_graphs(jax_loaders.load_planetoid("Cora", str(tmp_path)),
                       graphs)
    (g,) = graphs
    assert g.num_nodes == 60 and g.num_edges == 2 * 130
    assert g["node_feature"].shape == (60, 40)
    assert set(np.unique(g["node_feature"])) <= {0.0, 1.0}


def test_planetoid_citeseer_gaps_match_jax(tmp_path):
    """CiteSeer's test.index skips ids: the nodes it skips are isolated
    and keep zero features and label 0; the rows of tx / ty follow the
    index's own (unsorted) order."""
    rng = np.random.default_rng(4)
    d, c, n_all = 6, 3, 8
    test_index = np.array([14, 9, 11, 8, 13])      # 10 and 12 skipped
    allx = rng.random((n_all, d)).astype(np.float32)
    tx = rng.random((len(test_index), d)).astype(np.float32)
    ally = np.eye(c, dtype=np.int64)[rng.integers(c, size=n_all)]
    ty = np.eye(c, dtype=np.int64)[rng.integers(c, size=len(test_index))]
    graph = {i: [(i + 1) % 15, (i + 3) % 15] for i in range(15)}
    base = tmp_path / "CiteSeer" / "raw"
    standins.write_planetoid(str(base), "citeseer", allx[:3], tx, allx,
                             ally[:3], ty, ally, graph, test_index)
    (g,) = loaders.load_planetoid("CiteSeer", str(tmp_path))
    assert_same_graphs(jax_loaders.load_planetoid("CiteSeer", str(tmp_path)),
                       [g])
    assert g.num_nodes == 15
    for gap in (10, 12):
        assert not g["node_feature"][gap].any()
        assert g["node_label"][gap] == 0
    np.testing.assert_array_equal(g["node_feature"][test_index], tx)


def test_planetoid_pickles_build_only_data(tmp_path):
    """A Planetoid file comes from outside the program: a pickle that
    names any other class or function is refused (checked on the port
    only: the JAX package's loader would build it)."""
    standins.write_planetoid_standin(str(tmp_path), "cora", **SMALL_CORA)
    path = tmp_path / "cora" / "raw" / "ind.cora.graph"
    import collections
    with open(path, "wb") as f:
        pickle.dump(collections.Counter({0: [1]}), f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match="Counter"):
        loaders.load_planetoid("Cora", str(tmp_path))


# ------------------------------------------------------------------- TU

SIZES = (6, 7, 8)


def tu_files(tmp_path, name="FAKE", edge_files=True, node_files=True):
    """Three graphs (a 6-ring with a chord, a 7-path, an 8-ring with two
    chords) in the TU format: node attributes of width 2 and labels
    0..2, edge attributes and labels 0..1 where asked, graph labels."""
    rng = np.random.default_rng(2)
    und = [(i, (i + 1) % 6) for i in range(6)] + [(0, 3)] \
        + [(6 + i, 7 + i) for i in range(6)] \
        + [(13 + i, 13 + (i + 1) % 8) for i in range(8)] \
        + [(13, 17), (14, 19)]
    edges = np.array([e for u, v in und for e in ((u, v), (v, u))])
    indicator = np.repeat([0, 1, 2], SIZES)
    kw = dict(graph_labels=np.array([0, 1, 1]))
    if node_files:
        kw.update(node_labels=rng.integers(3, size=sum(SIZES)),
                  node_attributes=rng.normal(size=(sum(SIZES), 2)))
    if edge_files:
        kw.update(edge_labels=rng.integers(2, size=len(edges)),
                  edge_attributes=rng.normal(size=(len(edges), 1)))
    standins.write_tu(str(tmp_path / name / "raw"), name, edges, indicator,
                      **kw)
    return str(tmp_path)


@pytest.mark.parametrize("edge_files,node_files", [(True, True),
                                                   (False, True),
                                                   (False, False)])
def test_tu_matches_jax(tmp_path, edge_files, node_files):
    """node_feature = the attributes then the one-hot labels (or a
    constant 1), edge_feature = the edge attributes then the one-hot
    edge labels, graph_label; ids 1-based in the files."""
    d = tu_files(tmp_path, edge_files=edge_files, node_files=node_files)
    graphs = loaders.load_tu("FAKE", d)
    assert_same_graphs(jax_loaders.load_tu("FAKE", d), graphs)
    assert [g.num_nodes for g in graphs] == list(SIZES)
    assert graphs[0]["node_feature"].shape == ((6, 5) if node_files
                                               else (6, 1))
    if edge_files:
        assert graphs[2]["edge_feature"].shape == (20, 3)
    else:
        assert "edge_feature" not in graphs[0]


def test_tu_simple_filter_matches_jax(tmp_path):
    """The node tasks' cut of a TU set: the graphs of >= 200 directed
    edges first, fewest first, then the rest in order, 100 at most."""
    base = standins.write_tu_standin(
        str(tmp_path), "ENZYMES", seed=3, graphs=140, nodes=5200,
        edges=10000, min_nodes=3, max_nodes=90, large=50)
    jgraphs = jax_loaders.load_tu("ENZYMES", str(tmp_path))
    graphs = loaders.load_tu("ENZYMES", str(tmp_path))
    assert_same_graphs(jgraphs, graphs)
    kept = loaders.tu_simple_filter(graphs)
    assert_same_graphs(jax_loaders.tu_simple_filter(jgraphs), kept)
    assert len(kept) == 100
    big = sum(g.num_edges >= 200 for g in graphs)
    assert 0 < big < 100
    assert all(g.num_edges >= 200 for g in kept[:big])
    assert os.path.basename(os.path.dirname(base)) == "ENZYMES"


@pytest.mark.parametrize("fmt,name", [("PyG", "TU_IMDB"),
                                      ("TU", "IMDB-MULTI")])
@pytest.mark.parametrize("task", ["node", "graph"])
def test_tu_names_through_load_dataset(tmp_path, fmt, name, task):
    """load_dataset's dispatch: PyG's TU_IMDB reads IMDB-MULTI (the TU
    format names it itself), with the tu_simple cut off the graph
    task: here every graph is under 200 edges, so it keeps them all in
    their order."""
    d = tu_files(tmp_path, name="IMDB-MULTI", node_files=False,
                 edge_files=False)
    opts = ["dataset.format", fmt, "dataset.name", name, "dataset.task",
            task, "dataset.dir", d]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    graphs = loaders.load_dataset(cfg)
    assert_same_graphs(jax_loaders.load_dataset(jcfg), graphs)
    assert [g.num_nodes for g in graphs] == list(SIZES)


# --------------------------------------------------------- other formats

def test_karate_matches_jax():
    assert_same_graphs(jax_loaders.load_karate(), loaders.load_karate())
    assert loaders.load_karate()[0].num_edges == 156


@pytest.mark.parametrize("dense_attr", [True, False])
def test_npz_matches_jax(tmp_path, dense_attr):
    """The GNN-benchmark npz (Coauthor / Amazon): CSR adjacency with a
    self loop and a one-way edge, dense or CSR attributes."""
    rng = np.random.default_rng(0)
    n, d = 7, 5
    indptr = np.array([0, 2, 3, 4, 5, 6, 7, 9])
    indices = np.array([0, 1, 2, 3, 4, 5, 6, 0, 3])
    attr = (rng.random((n, d)) * (rng.random((n, d)) > 0.5)).astype(
        np.float32)
    arrays = dict(adj_data=np.ones(9, np.float32), adj_indices=indices,
                  adj_indptr=indptr, adj_shape=np.array([n, n]),
                  labels=np.arange(n) % 3)
    if dense_attr:
        arrays["attr_matrix"] = attr
    else:
        from scipy import sparse
        csr = sparse.csr_matrix(attr)
        arrays.update(attr_data=csr.data, attr_indices=csr.indices,
                      attr_indptr=csr.indptr, attr_shape=np.array([n, d]))
    (tmp_path / "amazon_electronics_photo").mkdir()
    np.savez(tmp_path / "amazon_electronics_photo" /
             "amazon_electronics_photo.npz", **arrays)
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for c in (cfg, jcfg):
        c.merge_from_list(["dataset.format", "PyG", "dataset.name",
                           "AmazonPhoto", "dataset.dir", str(tmp_path)])
    (g,) = loaders.load_dataset(cfg)
    assert_same_graphs(jax_loaders.load_dataset(jcfg), [g])
    assert not np.any(g.senders == g.receivers)
    np.testing.assert_array_equal(g["node_feature"], attr)


def test_ppi_matches_jax(tmp_path):
    base = tmp_path / "PPI" / "raw"
    base.mkdir(parents=True)
    links = [{"source": 0, "target": 1}, {"source": 1, "target": 2},
             {"source": 3, "target": 4}, {"source": 4, "target": 5},
             {"source": 5, "target": 6}, {"source": 2, "target": 3}]
    rng = np.random.default_rng(1)
    for split, gids in (("train", [0, 0, 0, 1, 1, 1, 1]),
                        ("valid", [2, 2, 2, 2, 2, 2, 2])):
        with open(base / f"{split}_graph.json", "w") as f:
            json.dump({"links": links}, f)
        np.save(base / f"{split}_feats.npy", rng.random((7, 3)))
        np.save(base / f"{split}_labels.npy", rng.integers(2, size=(7, 4)))
        np.save(base / f"{split}_graph_id.npy", np.array(gids))
    graphs = loaders.load_ppi(str(tmp_path))
    assert_same_graphs(jax_loaders.load_ppi(str(tmp_path)), graphs)
    assert [g.num_nodes for g in graphs] == [3, 4, 7]


def test_qm7b_matches_jax(tmp_path):
    from scipy.io import savemat

    rng = np.random.default_rng(0)
    x = np.zeros((3, 6, 6), np.float32)
    for i in range(3):
        m = rng.random((6, 6)).astype(np.float32)
        x[i] = (m + m.T) * (rng.random((6, 6)) > 0.4)
    savemat(tmp_path / "qm7b.mat", {"X": x, "T": rng.random((3, 14))})
    graphs = loaders.load_qm7b(str(tmp_path))
    assert_same_graphs(jax_loaders.load_qm7b(str(tmp_path)), graphs)
    s, r = graphs[1].senders, graphs[1].receivers
    np.testing.assert_array_equal(graphs[1]["edge_feature"][:, 0], x[1][s, r])


def test_mnist_superpixels_matches_jax(tmp_path):
    gen = torch.Generator().manual_seed(0)

    def graph(y, pos=True):
        d = {"x": torch.rand(5, 1, generator=gen),
             "edge_index": torch.tensor([[0, 1, 2, 4], [1, 2, 3, 0]]),
             "y": torch.tensor([y])}
        if pos:
            d["pos"] = torch.rand(5, 2, generator=gen)
        return d

    (tmp_path / "MNIST" / "raw").mkdir(parents=True)
    torch.save([[graph(3), graph(7, pos=False)], [graph(1)]],
               tmp_path / "MNIST" / "raw" / "MNISTSuperpixels.pt")
    graphs = loaders.load_mnist_superpixels(str(tmp_path))
    assert_same_graphs(jax_loaders.load_mnist_superpixels(str(tmp_path)),
                       graphs)
    assert [g["node_feature"].shape[1] for g in graphs] == [3, 1, 3]


def test_syn_and_ogb_dispatch(monkeypatch):
    """'syn' generates the corpus of its name from cfg.seed, as the JAX
    package does (the generator itself is held to the JAX one in
    test_torch_synthetic.py); 'OGB' goes to the OGB loaders, which name
    the raw directory they did not find."""
    calls = []
    from graphgym_tpu_torch.data import synthetic
    monkeypatch.setattr(synthetic, "generate_syn_graphs",
                        lambda kind, seed: calls.append((kind, seed)) or [])
    cfg = get_cfg()
    cfg.merge_from_list(["dataset.format", "syn", "dataset.name", "ws",
                         "seed", "7"])
    assert loaders.load_dataset(cfg) == [] and calls == [("ws", 7)]
    cfg.dataset.format, cfg.dataset.name = "OGB", "ogbg-absent"
    with pytest.raises(FileNotFoundError,
                       match="OGB raw directory for 'ogbg-absent'"):
        loaders.load_dataset(cfg)
    cfg.dataset.format = "unknown"
    with pytest.raises(ValueError, match="Unknown data format"):
        loaders.load_dataset(cfg)


# ---------------------------------------------------------------- cache

def tu_link_cfgs(d, task="graph", transform="none", extra=()):
    opts = ["dataset.format", "TU", "dataset.name", "FAKE", "dataset.task",
            task, "dataset.transform", transform, "dataset.dir", d,
            "gnn.layers_mp", "2", *extra]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    cfg.merge_from_list(opts)
    return jcfg, cfg


def assert_same_splits(jsplits, splits):
    assert len(splits) == len(jsplits)
    for jpart, part in zip(jsplits, splits):
        assert_same_graphs(jpart, part)


def test_cache_written_by_jax_loads_in_the_port(tmp_path):
    """cache_save in the JAX package, cache_load in the port: the same
    file (key and name), read without the JAX package's classes into
    the port's HostGraphs, the dims set from it."""
    d = tu_files(tmp_path)
    jcfg, cfg = tu_link_cfgs(d, extra=("dataset.cache_save", "True"))
    jsplits = jax_loaders.create_dataset(jcfg)
    path = jax_loaders._cache_path(jcfg)
    assert os.path.exists(path) and loaders._cache_path(cfg) == path
    cfg.dataset.cache_save, cfg.dataset.cache_load = False, True
    splits = loaders.create_dataset(cfg)
    assert_same_splits(jsplits, splits)
    assert (cfg.share.dim_in, cfg.share.dim_out, cfg.share.num_splits) == (
        jcfg.share.dim_in, jcfg.share.dim_out, jcfg.share.num_splits)


def test_cache_written_by_the_port_reads_back(tmp_path):
    """The port's own cache: written after the pipeline, read back equal
    (and not rebuilt: load_dataset is not called)."""
    d = tu_files(tmp_path)
    _, cfg = tu_link_cfgs(d, extra=("dataset.cache_save", "True"))
    splits = loaders.create_dataset(cfg)
    _, cfg2 = tu_link_cfgs(d, extra=("dataset.cache_load", "True"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loaders, "load_dataset", None)
        again = loaders.create_dataset(cfg2)
    assert_same_splits(splits, again)
    assert os.path.basename(loaders._cache_path(cfg2)).startswith("cache_")


@pytest.mark.parametrize("task,transform,extra", [
    ("link_pred", "none", ("dataset.edge_train_mode", "disjoint",
                           "dataset.transductive", "False",
                           "dataset.split", "[0.67, 0.33]")),
    ("link_pred", "none", ("dataset.edge_train_mode", "disjoint",
                           "dataset.transductive", "True",
                           "dataset.resample_disjoint", "True")),
    ("link_pred", "edge", ("dataset.edge_train_mode", "all",
                           "dataset.transductive", "True")),
    ("node", "ego", ("dataset.transductive", "True",
                     "dataset.augment_label",
                     "node_clustering_coefficient")),
])
def test_edge_features_ride_the_pipeline_as_in_jax(tmp_path, task,
                                                   transform, extra):
    """TU edge attributes and labels through create_dataset: kept
    aligned with the message edges by the link supervision
    (_set_message_edges, 0 where an edge is new), carried as they are by
    ego_nets and dropped by edge_nets, as in the JAX package."""
    d = tu_files(tmp_path)
    jcfg, cfg = tu_link_cfgs(d, task, transform, extra)
    jsplits = jax_loaders.create_dataset(jcfg)
    splits = loaders.create_dataset(cfg)
    assert_same_splits(jsplits, splits)
    has = ["edge_feature" in g for part in splits for g in part]
    assert any(has) == (transform != "edge")
