"""The native ego-net union and betweenness (native/graph_native.cpp:
``ego_sizes`` / ``ego_fill``, ``betweenness``) against their plain
versions and the JAX package's native code.

- ``ego_nets`` (the native union) equals ``ego_nets_plain`` (the numpy
  loop, the layout every port test holds) array for array: the union's
  node count, edge_index (values and dtype), every feature copy and
  node_id_index; on the ws corpus, the first ba graphs, the Cora and
  ENZYMES stand-ins, the first molhiv stand-in molecules (edges listed
  once: the BFS follows the out-edges), at radius 1-4 and one radius
  above 4 (n copies of the graph, the plain path), and on hand-made
  graphs with isolated nodes, trailing padding nodes, self-loops,
  repeated edges and one-way edges.  A graph edge outside its nodes
  raises.
- Against the JAX package's native ``ego_union`` (built by its own
  loader into a scratch directory), which numbers the members in BFS
  order: the same union up to the relabeling, i.e. the same members for
  every center and the same induced edges, as a multiset in original
  ids.
- ``betweenness_centrality`` (native) equals the Python loop
  ``betweenness_centrality_plain`` to the bit (so within 1e-12
  relative), normalized or not, on a preferential-attachment graph
  with hubs, a ws graph, a disconnected graph and a directed one with
  repeated edges; and is bitwise the same across runs and at 1, 2, 3
  and 8 threads.
"""

import os
import pickle
import random

import numpy as np
import pytest
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

import graphgym_tpu.native as jax_native
from graphgym_tpu_torch import native
from graphgym_tpu_torch.data import loaders, ogb, standins
from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data import synthetic as syn
from graphgym_tpu_torch.data import transforms as T
from graphgym_tpu_torch.data.hostgraph import HostGraph
from test_torch_fast_ba import ACCEPTED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host(g):
    """A port HostGraph of a pickled (JAX package) one."""
    return HostGraph(g.num_nodes, np.asarray(g.edge_index),
                     {k: np.asarray(v) for k, v in g.feats.items()})


def with_feats(g, seed=0):
    """``g`` with seeded node features and labels, and a supervised
    index, so the union's copies can be held."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    g["node_feature"] = rng.normal(size=(n, 3)).astype(np.float32)
    g["node_label"] = rng.integers(0, 4, n)
    g["node_label_index"] = np.sort(rng.choice(n, max(1, n // 2),
                                               replace=False))
    return g


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """name -> list of port HostGraphs."""
    tmp = str(tmp_path_factory.mktemp("standins"))
    with open(os.path.join(ROOT, "datasets", "ws.pkl"), "rb") as f:
        ws = [host(g) for g in pickle.load(f)[:4]]
    rng, ba = np.random.default_rng(0), []
    for attempt in range(1, ACCEPTED[5] + 1):
        p, seed = float(rng.uniform(0, 1)), int(rng.integers(1 << 31))
        if attempt in ACCEPTED[:6]:
            ba.append(with_feats(syn._host_graph(syn._powerlaw_cluster(
                64, 2, p, random.Random(seed)))))
    standins.write_planetoid_standin(tmp, "cora")
    standins.write_tu_standin(tmp, "ENZYMES")
    standins.write_molhiv_standin(tmp, graphs=40, split=(30, 5, 5))
    return {"ws": ws, "ba": ba,
            "cora": loaders.load_planetoid("Cora", tmp),
            "enzymes": loaders.load_tu("ENZYMES", tmp)[:60],
            "molhiv": ogb.load_ogb_graph("ogbg-molhiv", tmp)}


def handmade():
    """Isolated nodes (3, 7), padding nodes past every edge (8, 9),
    a self-loop, a repeated edge and one-way edges."""
    s = np.array([0, 1, 1, 2, 4, 5, 5, 6, 2, 1, 0, 4], np.int32)
    r = np.array([1, 0, 2, 1, 5, 4, 6, 5, 2, 2, 4, 0], np.int32)
    return [with_feats(HostGraph(10, np.stack([s, r]))),
            with_feats(HostGraph(1, np.zeros((2, 0), np.int32))),
            with_feats(HostGraph(4, np.array([[0, 1, 2], [1, 2, 3]],
                                             np.int32)))]


def assert_same_union(got, want):
    assert got.num_nodes == want.num_nodes
    assert got.edge_index.dtype == want.edge_index.dtype == np.int32
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    assert sorted(got.feats) == sorted(want.feats)
    for key in want.feats:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


CASES = [("ws", r) for r in (1, 2, 3, 4, 5)] + [
    ("ba", r) for r in (1, 2, 3, 4)] + [("enzymes", r) for r in (1, 2, 3, 4)
                                       ] + [("molhiv", r) for r in (1, 2, 3, 4)
                                            ] + [("cora", 1), ("cora", 2)]


@pytest.mark.parametrize("name,radius", CASES)
def test_native_union_equals_the_numpy_union(corpora, name, radius):
    for g in corpora[name]:
        assert_same_union(T.ego_nets(g, radius), T.ego_nets_plain(g, radius))


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
def test_native_union_on_handmade_graphs(radius):
    for g in handmade():
        got = T.ego_nets(g, radius)
        assert_same_union(got, T.ego_nets_plain(g, radius))
        np.testing.assert_array_equal(got["node_id_index"],
                                      np.arange(g.num_nodes))


def test_native_union_refuses_an_edge_outside_the_graph():
    with pytest.raises(ValueError, match="outside"):
        native.ego_union(np.array([0, 3]), np.array([1, 0]), 3, 2)


def members_and_edges(us, ur, orig_of, n):
    """Per center of a union: its members' original ids (a sorted
    array) and its induced edges in original ids (sorted pairs), each
    union node given to the center of its weakly connected component."""
    total = len(orig_of)
    a = coo_matrix((np.ones(len(us)), (us, ur)), shape=(total, total))
    _, comp = connected_components(a, directed=True, connection="weak")
    center_of = np.full(comp.max() + 1, -1)
    center_of[comp[:n]] = np.arange(n)
    assert (center_of[comp[:n]] == np.arange(n)).all()   # one a component
    owner = center_of[comp]
    by_node = np.lexsort((orig_of, owner))
    members = np.split(orig_of[by_node],
                       np.cumsum(np.bincount(owner, minlength=n))[:-1])
    es, er, eo = orig_of[us], orig_of[ur], owner[us]
    by_edge = np.lexsort((er, es, eo))
    cut = np.cumsum(np.bincount(eo, minlength=n))[:-1]
    edges = [np.stack(p) for p in zip(np.split(es[by_edge], cut),
                                      np.split(er[by_edge], cut))]
    return members, edges


@pytest.fixture
def jax_ego_union(tmp_path, monkeypatch):
    """The JAX package's native ego_union, its library built by its own
    loader into ``tmp_path``."""
    monkeypatch.setattr(jax_native, "_so_path",
                        lambda: str(tmp_path / "jax_graph_native.so"))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    assert jax_native.load() is not None
    return jax_native.ego_union


@pytest.mark.parametrize("name", ["ws", "ba", "enzymes", "molhiv", "cora"])
def test_native_union_is_the_jax_union_relabeled(corpora, jax_ego_union,
                                                 name):
    graphs = corpora[name] + (handmade() if name == "ws" else [])
    for radius in ((1, 2) if name == "cora" else (1, 2, 3, 4)):
        for g in graphs[:12]:
            n = g.num_nodes
            us, ur, orig_of = native.ego_union(g.senders, g.receivers, n,
                                               radius)
            jus, jur, jorig, jtotal = jax_ego_union(g.senders, g.receivers,
                                                    n, radius)
            assert jtotal == len(orig_of) and len(jus) == len(us)
            got = members_and_edges(us, ur, orig_of, n)
            want = members_and_edges(jus, jur, jorig, n)
            for c in range(n):
                np.testing.assert_array_equal(got[0][c], want[0][c])
                np.testing.assert_array_equal(got[1][c], want[1][c])


def bc_graphs():
    rng = np.random.default_rng(4)
    pa = standins.preferential_attachment(300, 900, rng)
    und = np.concatenate([pa, pa[:, ::-1]]).T.astype(np.int32)
    with open(os.path.join(ROOT, "datasets", "ws.pkl"), "rb") as f:
        ws = host(pickle.load(f)[0])
    two = np.array([[0, 1, 1, 2, 3, 4, 4, 5, 6, 7],
                    [1, 0, 2, 1, 4, 3, 5, 4, 7, 6]], np.int32)
    directed = np.array([[0, 0, 1, 1, 2, 3, 3, 4, 5, 2, 0],
                         [1, 1, 2, 3, 4, 4, 5, 5, 0, 0, 2]], np.int32)
    return {"hubs": HostGraph(300, und), "ws": ws,
            "disconnected": HostGraph(9, two),
            "directed": HostGraph(6, directed)}


@pytest.mark.parametrize("name", ["hubs", "ws", "disconnected", "directed"])
@pytest.mark.parametrize("normalized", [True, False])
def test_native_betweenness_is_the_python_loop(name, normalized):
    g = bc_graphs()[name]
    want = st.betweenness_centrality_plain(g, normalized)
    got = st.betweenness_centrality(g, normalized)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got, want)
    if name == "hubs":
        assert want.max() > 10 * np.median(want)


def test_native_betweenness_is_bitwise_repeatable():
    g = bc_graphs()["hubs"]
    runs = [native.betweenness(*g.csr(), threads)
            for threads in (1, 2, 3, 8, 8, None)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])
