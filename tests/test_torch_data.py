"""The port's data pipeline against the JAX package's on the main path
(configs/idgcn_ws.yaml, seed 1): the same splits, labels and ego-net
unions, and every GraphBatch array equal, packs included.

The JAX side runs its numpy paths: its native library's clustering
coefficient can differ by one ulp and move a node across a label-bin
edge, and its native packer orders a row's slots differently.
"""

import os

import numpy as np
import pytest
import torch

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import load_cfg as jax_load_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.data.hostgraph import HostGraph
from graphgym_tpu_torch.graphs.container import GraphBatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "idgcn_ws.yaml")
ARRAYS = ("senders", "receivers", "edge_weight", "node_feat", "node_mask",
          "edge_mask", "graph_ids", "node_label", "node_label_index",
          "label_mask", "node_id_index", "id_mask")
PACK_FIELDS = ("senders", "weights", "local_rows", "tiles")


@pytest.fixture(scope="module")
def both():
    """(jax cfg, jax splits, jax loaders, cfg, splits, loaders)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        jcfg = jax_load_cfg(CFG, ["tpu.spmm_impl", "pallas"])
        jsplits = jax_loaders.create_dataset(jcfg)
        jloaders = jax_loaders.create_loader(jsplits, jcfg)
        jbatches = [ld.batches(0) for ld in jloaders]
    cfg = load_cfg(CFG, ["device", "cpu"])
    splits = loaders.create_dataset(cfg)
    lds = loaders.create_loader(splits, cfg)
    return jcfg, jsplits, jbatches, cfg, splits, lds


def test_corpus_loads_without_jax_classes():
    graphs = loaders.load_nx("ws", os.path.join(ROOT, "datasets"))
    assert len(graphs) == 28
    assert all(type(g) is HostGraph for g in graphs)
    assert graphs[0].feats["node_feature"].shape == (64, 1)


def test_splits_match_jax(both):
    jcfg, jsplits, _, cfg, splits, _ = both
    assert cfg.share.to_dict() == jcfg.share.to_dict()
    assert cfg.dataset.augment_label_dims == jcfg.dataset.augment_label_dims
    assert [len(p) for p in splits] == [len(p) for p in jsplits] == [22, 6]
    for part, jpart in zip(splits, jsplits):
        for g, jg in zip(part, jpart):
            assert g.num_nodes == jg.num_nodes
            np.testing.assert_array_equal(g.edge_index, jg.edge_index)
            assert sorted(g.feats) == sorted(jg.feats)
            for key in g.feats:
                np.testing.assert_array_equal(g[key], jg[key], key)


@pytest.mark.parametrize("split", [0, 1])
def test_batches_match_jax(both, split):
    _, _, jbatches, _, _, lds = both
    batches = lds[split].batches(0)
    assert len(batches) == len(jbatches[split]) == 1
    for b, jb in zip(batches, jbatches[split]):
        assert b.num_graphs == jb.num_graphs
        for name in ARRAYS:
            got, want = getattr(b, name), np.asarray(getattr(jb, name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, name)
        for p, jp in zip(b.packs["gcn"], jb.packs["gcn"]):
            for f in PACK_FIELDS:
                np.testing.assert_array_equal(getattr(p, f), getattr(jp, f),
                                              f)


def test_main_path_shapes(both):
    """The train batch at the shapes PERF.md records for the main path."""
    *_, lds = both
    b = lds[0].batches(0)[0]
    assert b.num_nodes == 49152 and b.num_edges == 163840
    assert b.node_label_index.shape == b.node_id_index.shape == (1536,)
    assert int(b.edge_mask.sum()) == 138566
    for p in b.packs["gcn"]:
        assert p.senders.shape == (448, 1024)
        assert p.row_range.shape == (49152, 2)


def test_batch_to_device(both):
    *_, lds = both
    b = lds[1].batches(0)[0]
    t = b.to(torch.device("cpu"))
    assert isinstance(t, GraphBatch)
    assert t.senders.dtype == t.node_id_index.dtype == torch.int64
    assert t.node_feat.dtype == torch.float32 and t.node_mask.dtype == torch.bool
    fwd, _ = t.packs["gcn"]
    assert fwd.senders.dtype == torch.int32
    np.testing.assert_array_equal(fwd.row_range.numpy(),
                                  b.packs["gcn"][0].row_range)


def test_unported_options_raise():
    """What the loaders do not run yet raises naming its ROADMAP item:
    multi-device layouts (A16).  bfloat16 (A14) builds its loaders
    (mixed precision casts in the step, tests/test_torch_bf16.py); OGB,
    the samplers and node sampling (A13c) run (tests/test_torch_ogb.py,
    test_torch_samplers.py)."""
    cfg = load_cfg(CFG, ["device", "cpu", "tpu.mesh_shape", "[2]"])
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        loaders.create_loader([[], []], cfg)
    cfg = load_cfg(CFG, ["device", "cpu", "tpu.dtype", "bfloat16"])
    assert len(loaders.create_loader([[], []], cfg)) == 2
