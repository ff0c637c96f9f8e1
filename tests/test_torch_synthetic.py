"""The port's networkx-free synthetic corpora against the JAX package's
networkx ones: the same seed gives the same graphs, edge for edge and in
the same edge order; the generators match networkx draw for draw; the
rejection statistics equal networkx's; load_nx regenerates into a cache
of the port's own that the JAX package never opens."""

import os
import pickle
import random

import networkx as nx
import numpy as np
import pytest

import graphgym_tpu.data.loaders as jax_loaders
import graphgym_tpu.data.synthetic as jax_syn
from graphgym_tpu_torch.data import loaders, structure, synthetic as syn
from graphgym_tpu_torch.data.hostgraph import HostGraph


def assert_same_graphs(got, want, port=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, HostGraph) == port
        assert g.num_nodes == w.num_nodes
        assert g.edge_index.dtype == w.edge_index.dtype
        np.testing.assert_array_equal(g.senders, w.senders)
        np.testing.assert_array_equal(g.receivers, w.receivers)
        assert g["node_feature"].dtype == w["node_feature"].dtype
        np.testing.assert_array_equal(g["node_feature"], w["node_feature"])


@pytest.mark.parametrize("kind,num_graphs,seed", [
    ("ba", 8, 0), ("ba", 8, 1), ("ws", 6, 0), ("ws", 6, 1)])
def test_corpus_equals_jax_generator(kind, num_graphs, seed):
    want = jax_syn.generate_syn_graphs(kind=kind, num_graphs=num_graphs,
                                       n=64, seed=seed)
    got = syn.generate_syn_graphs(kind=kind, num_graphs=num_graphs, n=64,
                                  seed=seed)
    assert len(got) >= num_graphs - 2
    assert_same_graphs(got, want)


def nx_of(adj):
    g = nx.Graph()
    g.add_nodes_from(range(len(adj)))
    for u, nbrs in enumerate(adj):
        g.add_edges_from((u, v) for v in nbrs)
    return g


def draws():
    """(p, seed) pairs across the range, a few at the ends."""
    rng = np.random.default_rng(7)
    ps = [0.0, 1.0] + [float(x) for x in rng.uniform(0, 1, 22)]
    return [(p, int(rng.integers(1 << 31))) for p in ps]


@pytest.mark.parametrize("n", [6, 64])
def test_generators_draw_as_networkx(n):
    """Edge lists and adjacency order of the port's generators against
    networkx's for the same (p, seed); n = 6 makes the Watts-Strogatz
    retry loop hit its degree(u) >= n - 1 break."""
    for p, seed in draws():
        want = nx.powerlaw_cluster_graph(n, 2, p, seed=seed)
        got = syn._powerlaw_cluster(n, 2, p, random.Random(seed))
        assert [list(want.adj[u]) for u in want] == [list(a) for a in got]
        want = nx.watts_strogatz_graph(n, 4, p, seed=seed)
        got = syn._watts_strogatz(n, 4, p, random.Random(seed))
        assert [list(want.adj[u]) for u in want] == [list(a) for a in got]
        try:
            want = nx.connected_watts_strogatz_graph(n, 4, p, tries=100,
                                                     seed=seed)
        except nx.NetworkXError:
            with pytest.raises(RuntimeError, match="tries"):
                syn._connected_watts_strogatz(n, 4, p, 100,
                                              random.Random(seed))
            continue
        got = syn._connected_watts_strogatz(n, 4, p, 100,
                                            random.Random(seed))
        assert [list(want.adj[u]) for u in want] == [list(a) for a in got]


@pytest.mark.parametrize("kind", ["ba", "ws"])
def test_rejection_statistics_equal_networkx(kind):
    """Connectivity, average path length and average clustering, bit for
    bit, on graphs the corpus keeps and on ones it rejects."""
    gen = syn._powerlaw_cluster if kind == "ba" else syn._watts_strogatz
    for p, seed in draws():
        adj = gen(64, 2 if kind == "ba" else 4, p, random.Random(seed))
        g, host = nx_of(adj), syn._host_graph(adj)
        connected = syn._is_connected(host)
        assert connected == nx.is_connected(g)
        assert syn._avg_clustering(host) == nx.average_clustering(g)
        if connected:
            assert structure.graph_avg_path_len(host) == \
                nx.average_shortest_path_length(g)
    two_parts = [{1: None}, {0: None, 2: None}, {1: None}, {4: None},
                 {3: None}]
    assert not syn._is_connected(syn._host_graph(two_parts))
    assert not nx.is_connected(nx_of(two_parts))


def test_host_graph_is_from_networkx():
    from graphgym_tpu.data.hostgraph import from_networkx as jax_from_nx

    adj = syn._watts_strogatz(64, 4, 0.6, random.Random(3))
    g = nx_of(adj)
    for v in g.nodes:
        g.nodes[v]["node_feature"] = np.ones(1, np.float32)
    assert_same_graphs([syn._host_graph(adj)], [jax_from_nx(g)])


def test_regenerable_table_is_the_jax_packages():
    assert loaders._REGENERABLE == jax_loaders._REGENERABLE
    assert loaders._REGEN_GRAPHS == 256


REAL_GENERATE = syn.generate_syn_graphs


def small_corpus(monkeypatch, module):
    """Keep regeneration quick: 4 graphs of 16 nodes instead of 256."""
    real = (REAL_GENERATE if module is syn
            else module.generate_syn_graphs)
    monkeypatch.setattr(
        module, "generate_syn_graphs",
        lambda kind, num_graphs, n: real(kind=kind, num_graphs=4, n=16))


def test_load_nx_regenerates_and_reads_its_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(tmp_path / "none"))
    small_corpus(monkeypatch, syn)
    graphs = loaders.load_nx("ba", str(tmp_path))
    assert len(graphs) == 4 and all(g.num_nodes == 16 for g in graphs)
    assert sorted(os.listdir(tmp_path)) == ["ba.torch.pkl"]
    assert_same_graphs(graphs, jax_syn.generate_syn_graphs(
        kind="ba", num_graphs=4, n=16))

    def no_regeneration(**kw):
        raise AssertionError("the cache was not read")
    monkeypatch.setattr(syn, "generate_syn_graphs", no_regeneration)
    assert_same_graphs(loaders.load_nx("ba", str(tmp_path)), graphs)
    # scalefree regenerates the ba family into a file of its own
    small_corpus(monkeypatch, syn)
    assert_same_graphs(loaders.load_nx("scalefree", str(tmp_path)), graphs)
    assert sorted(os.listdir(tmp_path)) == ["ba.torch.pkl",
                                            "scalefree.torch.pkl"]


def test_load_nx_reads_its_cache_only_from_dataset_dir(tmp_path,
                                                        monkeypatch):
    """A port cache in the repository's datasets/ is not read for
    another dataset.dir: load_nx regenerates into that directory, where
    it writes, and reads the cache back from there."""
    repo = tmp_path / "repo"
    repo.mkdir()
    (repo / "ba.torch.pkl").write_bytes(pickle.dumps("stale"))
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(repo))
    small_corpus(monkeypatch, syn)
    out = tmp_path / "out"
    graphs = loaders.load_nx("ba", str(out))
    assert len(graphs) == 4 and os.listdir(out) == ["ba.torch.pkl"]
    monkeypatch.setattr(syn, "generate_syn_graphs", None)
    assert_same_graphs(loaders.load_nx("ba", str(out)), graphs)


def test_jax_load_nx_ignores_the_ports_cache(tmp_path, monkeypatch):
    """After the port cached ba into a directory, the JAX package's
    load_nx, run there, regenerates and writes its own ba.pkl; the port
    then reads that pickle (it comes first), the same graphs."""
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(tmp_path / "none"))
    small_corpus(monkeypatch, syn)
    ported = loaders.load_nx("ba", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_loaders, "_SEARCH_DIRS", [str(tmp_path)])
    small_corpus(monkeypatch, jax_syn)
    jax_graphs = jax_loaders.load_nx("ba", str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["ba.pkl", "ba.torch.pkl"]
    assert_same_graphs(ported, jax_graphs)
    with open(tmp_path / "ba.pkl", "rb") as f:
        assert type(pickle.load(f)[0]).__module__ == \
            "graphgym_tpu.data.hostgraph"
    monkeypatch.setattr(syn, "generate_syn_graphs", None)
    assert_same_graphs(loaders.load_nx("ba", str(tmp_path)), jax_graphs)
    # and the JAX package keeps reading its own pickle
    assert_same_graphs(jax_loaders.load_nx("ba", str(tmp_path)),
                       jax_graphs, port=False)


def test_regenerated_ws_is_the_shipped_corpus():
    """ws regenerated from seed 0 at full size (256 asked) is
    datasets/ws.pkl, graph for graph: 28 graphs, edge for edge."""
    shipped = loaders.load_nx("ws", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "datasets"))
    assert_same_graphs(syn.generate_syn_graphs(kind="ws", num_graphs=256,
                                               n=64, seed=0), shipped)
