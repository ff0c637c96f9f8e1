"""The port's feature augmentation (ID-GNN Fast identity features and the
structural features), gcn_norm and compute_identity against the JAX
package, on a few ws graphs: integer-valued features exactly, the rest
at rtol 1e-6, compute_identity and gcn_norm at rtol 1e-5 / atol 1e-6.
The JAX side runs its numpy paths (no native library)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.config import load_cfg as jax_load_cfg
from graphgym_tpu.data import augment as jax_augment
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.ops import identity as jax_identity, sparse as jax_sparse
from graphgym_tpu_torch.config import get_cfg, load_cfg
from graphgym_tpu_torch.data import augment, loaders
from graphgym_tpu_torch.ops import identity, sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = os.path.join(ROOT, "datasets")
INTEGER_VALUED = {"node_degree", "node_const", "node_onehot"}


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def ws_graphs(count=3):
    """The first graphs of the shipped ws corpus, in both packages."""
    return (loaders.load_nx("ws", DATASETS)[:count],
            jax_loaders.load_nx("ws", DATASETS)[:count])


def test_feature_funcs_are_the_jax_packages():
    assert list(augment.FEATURE_FUNCS) == list(jax_augment.FEATURE_FUNCS)


@pytest.mark.parametrize("key", list(jax_augment.FEATURE_FUNCS))
def test_feature_func_matches_jax(key):
    graphs, jgraphs = ws_graphs()
    dim = 10 if key == "node_identity" else 4
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for g, jg in zip(graphs, jgraphs):
        got = np.asarray(augment.FEATURE_FUNCS[key](
            g, feature_dim=dim, rng=rng, device="cpu"))
        want = np.asarray(jax_augment.FEATURE_FUNCS[key](
            jg, feature_dim=dim, rng=jrng))
        assert got.shape == want.shape
        if key in INTEGER_VALUED:
            np.testing.assert_array_equal(got, want)
        elif key == "node_identity":
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


def both_cfgs(**dataset):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_dict({"device": "cpu", "dataset": dataset})
    jcfg.merge_from_dict({"dataset": dataset})
    return cfg, jcfg


@pytest.mark.parametrize("method", ["original", "position", "balanced",
                                    "equal_width", "bounded"])
def test_representations_match_jax(method):
    """FeatureAugment.augment end to end: each representation of three
    features, the realized dims written back, the label bins."""
    feats = ["node_degree", "node_pagerank", "node_identity"]
    dims = [5, 4, 6]
    cfg, jcfg = both_cfgs(augment_feature=feats, augment_feature_dims=dims,
                          augment_feature_repr=method,
                          augment_label="node_clustering_coefficient",
                          augment_label_dims=6)
    graphs, jgraphs = ws_graphs()
    out = augment.FeatureAugment(np.random.default_rng(2)).augment(
        graphs, cfg)
    jout = jax_augment.FeatureAugment(np.random.default_rng(2)).augment(
        jgraphs, jcfg)
    assert out == jout
    assert list(cfg.dataset.augment_feature_dims) == \
        list(jcfg.dataset.augment_feature_dims)
    assert cfg.dataset.augment_label_dims == jcfg.dataset.augment_label_dims
    for g, jg in zip(graphs, jgraphs):
        for key in feats:
            assert g[key].dtype == jg[key].dtype
            np.testing.assert_allclose(g[key], jg[key], rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_array_equal(
            g["node_clustering_coefficient_label"],
            jg["node_clustering_coefficient_label"])


def test_position_encoding_matches_jax():
    pos = np.random.default_rng(0).uniform(0, 30, 50)
    np.testing.assert_allclose(augment.position_encoding(pos, 8, 0.7),
                               jax_augment.position_encoding(pos, 8, 0.7),
                               rtol=1e-6)


def test_fast_dataset_matches_jax():
    """configs/gcnconvFast_ws.yaml's data: identity features of width
    10 before the 1-wide node feature, cfg.share.dim_in 11 in both."""
    cfg_file = os.path.join(ROOT, "configs", "gcnconvFast_ws.yaml")
    jcfg = jax_load_cfg(cfg_file, [])
    cfg = load_cfg(cfg_file, ["device", "cpu"])
    jsplits = jax_loaders.create_dataset(jcfg)
    splits = loaders.create_dataset(cfg)
    assert cfg.share.dim_in == jcfg.share.dim_in == 11
    assert cfg.share.to_dict() == jcfg.share.to_dict()
    assert list(cfg.dataset.augment_feature_dims) == [10]
    for part, jpart in zip(splits, jsplits):
        for g, jg in zip(part, jpart):
            x = loaders.graph_to_arrays(g, cfg)
            assert x.shape == (g.num_nodes, 11)
            np.testing.assert_array_equal(x[:, 10], 1.0)
            np.testing.assert_allclose(
                x, jax_loaders.graph_to_arrays(jg, jcfg), rtol=1e-5,
                atol=1e-6)
            np.testing.assert_array_equal(g["node_label"], jg["node_label"])


def random_graph(seed, n=24, e=60):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = (s + rng.integers(1, n, e)) % n    # no self-loops
    return np.stack([np.concatenate([s, r]), np.concatenate([r, s])])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_identity_matches_jax(seed):
    ei = random_graph(seed)
    got = identity.compute_identity(torch.as_tensor(ei[0]),
                                    torch.as_tensor(ei[1]), 24, 10)
    want = jax_identity.compute_identity(jnp.asarray(ei[0]),
                                         jnp.asarray(ei[1]), 24, 10)
    assert got.shape == (24, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    host = identity.compute_identity_host(ei, 24, 10, torch.device("cpu"))
    np.testing.assert_array_equal(host, got.numpy())


@pytest.mark.parametrize("seed,n", [(3, 24), (3, 26), (4, 24), (5, 30)])
def test_gcn_norm_matches_jax(seed, n):
    """The one setting the port uses (unit weights, a self-loop per node
    slot, no mask) against the JAX package's defaults, also with padding
    slots past the graph's 24 nodes (a loop of weight 1 each)."""
    ei = random_graph(seed)
    got = sparse.gcn_norm(torch.as_tensor(ei[0]), torch.as_tensor(ei[1]),
                          n)
    want = jax_sparse.gcn_norm(jnp.asarray(ei[0]), jnp.asarray(ei[1]),
                               None, n)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].dtype == torch.float32
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_compute_identity_matches_jax(seed):
    """The identity features on the card (the config's default device,
    TF32 off as resolve_device sets it) against the JAX package's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the card's identity path)")
    from graphgym_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    ei = random_graph(seed)
    got = identity.compute_identity_host(ei, 24, 10, device)
    want = jax_identity.compute_identity(jnp.asarray(ei[0]),
                                         jnp.asarray(ei[1]), 24, 10)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    graphs, jgraphs = ws_graphs(2)
    for g, jg in zip(graphs, jgraphs):
        np.testing.assert_allclose(
            augment.FEATURE_FUNCS["node_identity"](g, feature_dim=10,
                                                   device="cuda"),
            jax_augment.FEATURE_FUNCS["node_identity"](jg, feature_dim=10),
            rtol=1e-5, atol=1e-6)
