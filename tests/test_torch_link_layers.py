"""grids/IDGNN/link.txt's other layer types on ws against the JAX package,
and its GRAPHGYM_LINK_BOTH_DIRS probe.

tests/test_torch_link.py holds the link and edge points at gcnidconv /
gcnconv.  Here: three Adam steps of the plain chunk (link.txt:5-18:
node_identity features, no transform, dot decoding) at sageconv,
gatconv and ginconv, of the ID chunk (link.txt:21-34: the edge-net
transform) at sageidconv, gatidconv and ginidconv, and of the edge task
(path.txt:21-34) at the three ID types, from the same parameters on the
same seeded features: per-step losses within 2e-3 of the JAX package's,
its learning rates (two layers of width 16 on the first 5 ws graphs).
The same on ba: tests/test_torch_link_layers_ba.py.  With
GRAPHGYM_LINK_BOTH_DIRS=1 the supervision's positives are stored in
both directions before the negatives are drawn: the draws equal the
JAX package's, array for array.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_graph_task import to_numpy
from test_torch_link import (EDGE_ID, LINK_ID, LINK_PLAIN, SMALL,
                             assert_graphs_equal, cut_corpus, ring_graphs)
from test_torch_torchpath import OneBatch, seeded_features
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAIN_TYPES = ("sageconv", "gatconv", "ginconv")
ID_TYPES = ("sageidconv", "gatidconv", "ginidconv")
CHUNKS = {"link": LINK_PLAIN, "linkid": LINK_ID, "edgeid": EDGE_ID}


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    return (str(tmp_path_factory.mktemp("jax")),
            str(tmp_path_factory.mktemp("port")))


@functools.lru_cache(maxsize=None)
def layer_data(base, chunk, layer_type, jdir, pdir):
    """Both packages' configs (task and dims set by create_dataset) and
    loaders of ``chunk`` on configs/<base>.yaml at ``layer_type``."""
    cfg_file = os.path.join(ROOT, "configs", f"{base}.yaml")
    opts = list(CHUNKS[chunk]) + list(SMALL) + ["gnn.layer_type",
                                                layer_type]
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla", "dataset.dir",
                                 jdir])
    cfg = load_cfg(cfg_file, opts + ["device", "cpu", "dataset.dir", pdir])
    with pytest.MonkeyPatch.context() as mp:
        cut_corpus(mp, jdir, pdir)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
        lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    return jcfg, cfg, jlds, lds


def assert_three_steps_match(jcfg, cfg, jlds, lds):
    """Three Adam steps of both packages on their first train batch with
    the same seeded features, from the JAX model's parameters."""
    jbatch, batch = seeded_features(jlds[0].batches(0)[0],
                                    lds[0].batches(0)[0].to(CPU))
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        model))
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    assert all(map(np.isfinite, rec.losses))
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)


@pytest.mark.parametrize("chunk,layer_type", [
    *(("link", t) for t in PLAIN_TYPES), *(("linkid", t) for t in ID_TYPES),
    *(("edgeid", t) for t in ID_TYPES)])
def test_three_steps_match_jax_ws(chunk, layer_type, corpus_dirs):
    """The link chunks and the edge task on ws at each other layer
    type: the edge head's dot decoding of the pairs on the plain chunk,
    the node head on the edge-net union on the ID ones."""
    jcfg, cfg, jlds, lds = layer_data("idgcn_ws", chunk, layer_type,
                                      *corpus_dirs)
    assert cfg.dataset.task == jcfg.dataset.task == (
        "link_pred" if chunk == "link" else "node")
    assert cfg.share.dim_out == jcfg.share.dim_out
    assert_three_steps_match(jcfg, cfg, jlds, lds)


@pytest.mark.parametrize("mode", ["disjoint", "all"])
@pytest.mark.parametrize("split_index", [0, 1])
def test_link_both_dirs_draws_as_jax(mode, split_index, monkeypatch):
    """GRAPHGYM_LINK_BOTH_DIRS=1: the positives in both directions, then
    the negatives at the split's ratio of their doubled count; the
    message edges, supervision and resample fields equal the JAX
    package's array for array, and the positives are twice those of a
    draw without the variable."""
    opts = ["dataset.task", "link_pred", "dataset.edge_train_mode", mode,
            "dataset.edge_negative_sampling_ratio", "2.0",
            "dataset.resample_negative", "True"]
    jcfg, cfg = jax_get_cfg(), load_cfg(
        os.path.join(ROOT, "configs", "idgcn_ws.yaml"), opts)
    jcfg.merge_from_list(opts)
    positives = {}
    for both in ("", "1"):
        monkeypatch.setenv("GRAPHGYM_LINK_BOTH_DIRS", both)
        jgs, gs = ring_graphs(seed=8)
        jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
        for jg, g in zip(jgs, gs):
            jax_loaders._default_supervision(jg, jcfg, jrng, split_index)
            loaders._default_supervision(g, cfg, rng, split_index)
            assert_graphs_equal(jg, g)
        positives[both] = [int(g["edge_label"].sum()) for g in gs]
        g = gs[-1]
        n_pos = positives[both][-1]
        pos = g["edge_label_index"][:, :n_pos]
        if both:
            half = n_pos // 2
            np.testing.assert_array_equal(pos[:, half:], pos[::-1, :half])
        assert len(g["edge_label"]) - n_pos == (
            2 * n_pos if split_index == 0 else n_pos)
    assert positives["1"] == [2 * p for p in positives[""]]
