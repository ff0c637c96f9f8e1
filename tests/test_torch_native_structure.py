"""The data pipeline's native graph statistics (graphgym_tpu_torch/native:
``bfs_distances``, ``triangle_counts``) against the numpy plain versions
they replace (data/structure.py's ``bfs_from_sources_plain`` and
``triangle_counts_plain``), array for array, dtype and bits: on random
graphs, graphs with isolated nodes and disconnected parts, repeated
edges, self loops and one-way edges, and the synthetic generators'
graphs, at n = 64 and 500; every source, a subset with repeats across
the BFS's 64-source blocks, and capped distances.  The statistics built
on them (average path length, average clustering) equal networkx's
exactly at n = 500, and the rejection-sampled corpora equal the numpy
path's graph for graph.  A failed build raises: the pipeline has no
other BFS.
"""

import random

import networkx as nx
import numpy as np
import pytest

from graphgym_tpu_torch import native
from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data import synthetic as syn
from graphgym_tpu_torch.data.hostgraph import HostGraph


def symmetric(n, s, r):
    s, r = np.asarray(s), np.asarray(r)
    return HostGraph(n, np.stack([np.concatenate([s, r]),
                                  np.concatenate([r, s])]).astype(np.int32))


def graph_of(kind, n, seed):
    """A graph of ``kind``: 'random' (undirected, about 4 edges a node),
    'parts' (two random halves, no edge between them, every tenth node
    isolated), 'multi' (one-way edges, repeats and self loops), 'ws' /
    'ba' (the corpora's generators at a seeded p)."""
    rng = np.random.default_rng(seed)
    if kind in ("ws", "ba"):
        p = float(rng.uniform(0, 1))
        gen = random.Random(int(rng.integers(1 << 31)))
        adj = (syn._watts_strogatz(n, 4, p, gen) if kind == "ws"
               else syn._powerlaw_cluster(n, 2, p, gen))
        return syn._host_graph(adj)
    if kind == "random":
        s, r = rng.integers(0, n, (2, 2 * n))
        keep = s != r
        return symmetric(n, s[keep], r[keep])
    if kind == "parts":
        half = n // 2
        live = np.arange(n)[np.arange(n) % 10 != 0]
        a, b = live[live < half], live[live >= half]
        s = np.concatenate([rng.choice(a, 2 * len(a)),
                            rng.choice(b, 2 * len(b))])
        r = np.concatenate([rng.choice(a, 2 * len(a)),
                            rng.choice(b, 2 * len(b))])
        keep = s != r
        return symmetric(n, s[keep], r[keep])
    s, r = rng.integers(0, n, (2, 3 * n))
    s[: n // 4] = r[: n // 4]                     # self loops
    s[-n // 4:], r[-n // 4:] = s[:n // 4] + 0, r[:n // 4] + 0
    extra = rng.integers(0, 3 * n, n // 2)        # repeated edges
    return HostGraph(n, np.stack([np.concatenate([s, s[extra]]),
                                  np.concatenate([r, r[extra]])]
                                 ).astype(np.int32))


KINDS = ["random", "parts", "multi", "ws", "ba"]


@pytest.mark.parametrize("n", [64, 500])
@pytest.mark.parametrize("kind", KINDS)
def test_bfs_equals_the_plain_version(kind, n):
    g = graph_of(kind, n, 7)
    rng = np.random.default_rng(1)
    some = rng.integers(0, n, 150)                # 3 blocks, repeats
    for sources in (np.arange(n), some, some[:1], some[:0]):
        for cap in (None, 0, 1, 3):
            got = st.bfs_from_sources(g, sources, cap)
            want = st.bfs_from_sources_plain(g, sources, cap)
            assert got.dtype == want.dtype == np.int32
            assert got.shape == want.shape == (len(sources), n)
            np.testing.assert_array_equal(got, want)
    if kind == "parts":
        assert (st.bfs_all_pairs(g) < 0).any()


@pytest.mark.parametrize("n", [64, 500])
@pytest.mark.parametrize("kind", KINDS)
def test_triangle_counts_equal_the_plain_version(kind, n):
    g = graph_of(kind, n, 9)
    got, want = st.triangle_counts(g), st.triangle_counts_plain(g)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if kind in ("ws", "ba"):
        assert got.sum() > 0


def test_statistics_on_graphs_without_edges():
    for n in (1, 5):
        g = HostGraph(n, np.zeros((2, 0), np.int32))
        np.testing.assert_array_equal(st.bfs_all_pairs(g),
                                      np.where(np.eye(n, dtype=bool), 0, -1))
        np.testing.assert_array_equal(st.triangle_counts(g), np.zeros(n))
        np.testing.assert_array_equal(st.clustering_coefficient(g),
                                      np.zeros(n))


def test_bad_inputs_raise():
    g = symmetric(4, [0, 1], [1, 2])
    with pytest.raises(ValueError, match="source"):
        st.bfs_from_sources(g, [4])
    with pytest.raises(ValueError, match="neighbour"):
        native.bfs_distances(np.array([0, 1]), np.array([3]), [0])
    with pytest.raises(ValueError, match="neighbour"):
        native.triangle_counts(np.array([0, 1]), np.array([-1]))
    with pytest.raises(ValueError, match="indptr"):
        native.triangle_counts(np.array([0, 2]), np.array([0]))


def nx_of(g):
    out = nx.Graph()
    out.add_nodes_from(range(g.num_nodes))
    out.add_edges_from(zip(g.senders.tolist(), g.receivers.tolist()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["ws", "ba"])
def test_statistics_equal_networkx_at_500_nodes(kind, seed):
    """The corpus loop's statistics on 500-node draws, bit for bit:
    connectivity, average path length (where connected) and average
    clustering."""
    g = graph_of(kind, 500, seed)
    want = nx_of(g)
    connected = syn._is_connected(g)
    assert connected == nx.is_connected(want)
    assert syn._avg_clustering(g) == nx.average_clustering(want)
    if connected:
        assert st.graph_avg_path_len(g) == \
            nx.average_shortest_path_length(want)


@pytest.mark.parametrize("kind", ["ws", "ba"])
def test_corpus_equals_the_numpy_path(kind, monkeypatch):
    """The rejection loop at n = 500 (6 graphs asked) gives the same
    graphs, edge for edge, on the native statistics and on the numpy
    plain versions."""
    got = syn.generate_syn_graphs(kind, num_graphs=6, n=500)
    monkeypatch.setattr(st, "bfs_from_sources", st.bfs_from_sources_plain)
    monkeypatch.setattr(st, "triangle_counts", st.triangle_counts_plain)
    want = syn.generate_syn_graphs(kind, num_graphs=6, n=500)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.num_nodes == b.num_nodes == 500
        np.testing.assert_array_equal(a.edge_index, b.edge_index)


@pytest.mark.parametrize("how", ["compiler", "source"])
def test_failed_build_raises(how, tmp_path, monkeypatch):
    """With the library unbuilt and its build failing (no compiler, or a
    source the compiler refuses), the statistics raise instead of
    falling back to numpy."""
    source = native.SOURCE
    if how == "compiler":
        monkeypatch.setattr(native, "CXX", "no-such-compiler")
    else:
        source = tmp_path / "graph_native.cpp"
        source.write_text(open(native.SOURCE).read()
                          + "\nint broken() { return not_declared; }\n")
        source = str(source)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.build, "__defaults__",
                        (source, str(tmp_path / "build")))
    g = symmetric(4, [0, 1], [1, 2])
    match = "not found" if how == "compiler" else "not_declared"
    with pytest.raises(RuntimeError, match=match):
        st.bfs_from_sources(g, [0])
    with pytest.raises(RuntimeError, match=match):
        st.clustering_coefficient(g)
    with pytest.raises(RuntimeError, match=match):
        syn.generate_syn_graphs("ws", num_graphs=1, n=20)
