"""The port's graph samplers (graphgym_tpu_torch/data/samplers.py), its
SamplerLoader and per-epoch node sampling against the JAX package's.

From one seed every sampler kind draws the same subgraphs as the JAX
package, draw for draw over two epochs, leaving the Generator in the
same state; ``SamplerLoader`` (train.sampler, and val.sampler on the
eval splits) gives the same batches over three epochs, a draw that
outgrows the buckets re-bucketing in both; train.sample_node /
val.sample_node supervise the same nodes each epoch.  A sampled or
node-sampled training with the epoch prefetch on is bitwise the serial
one: every batch, every loss.  On ogbn-arxiv's layout (a small
stand-in, data/standins.py) and its official split.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.data import samplers as jax_samplers
from graphgym_tpu.data.hostgraph import HostGraph as JaxHostGraph
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders, samplers, standins
from graphgym_tpu_torch.data.hostgraph import HostGraph
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from test_torch_prefetch import Recorded, assert_same_batches
from test_torch_real_configs import assert_batches_equal

CPU = torch.device("cpu")
KINDS = ("full_batch", "neighbor", "saint_node", "saint_edge", "saint_rw",
         "random_node", "cluster")
ARXIV = dict(nodes=400, edges=1500, features=8, classes=4,
             split=(200, 80, 120))
SMALL = ["train.iter_per_epoch", "3", "train.batch_size", "4",
         "train.node_per_graph", "6", "train.neighbor_sizes", "[4, 2]",
         "train.walk_length", "3", "val.node_per_graph", "10",
         "gnn.dim_inner", "8", "gnn.layers_mp", "2", "optim.max_epoch", "3",
         "train.eval_period", "1"]


def graph_pair(n=120, e=400, seed=0):
    """One graph in both packages' HostGraph: a random directed edge set
    with node features, labels and a supervised half of the nodes."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    feats = dict(node_feature=rng.normal(size=(n, 3)).astype(np.float32),
                 node_label=rng.integers(0, 3, n),
                 node_label_index=np.sort(rng.permutation(n)[:n // 2]))
    return (JaxHostGraph(n, ei.copy(), {k: v.copy() for k, v in
                                        feats.items()}),
            HostGraph(n, ei.copy(), {k: v.copy() for k, v in feats.items()}))


def assert_graphs_equal(jgs, gs):
    assert len(gs) == len(jgs)
    for jg, g in zip(jgs, gs):
        assert g.num_nodes == jg.num_nodes
        np.testing.assert_array_equal(g.edge_index, jg.edge_index)
        assert sorted(g.feats) == sorted(jg.feats)
        for k in jg.feats:
            np.testing.assert_array_equal(g[k], np.asarray(jg[k]),
                                          err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_sampler_draws_match_jax(kind):
    jg, g = graph_pair()
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(SMALL)
    cfg.merge_from_list(SMALL)
    jrng, rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        jgs = jax_samplers.make_sampled_graphs(jg, jcfg, jrng, sampler=kind)
        gs = samplers.make_sampled_graphs(g, cfg, rng, sampler=kind)
        assert_graphs_equal(jgs, gs)
        assert len(gs) >= 1
    assert rng.bit_generator.state == jrng.bit_generator.state


def test_unknown_sampler_raises():
    _, g = graph_pair()
    with pytest.raises(ValueError, match="Unknown sampler"):
        samplers.make_sampled_graphs(g, get_cfg(), np.random.default_rng(0),
                                     sampler="metis")


@pytest.fixture(scope="module")
def arxiv_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("arxiv"))
    standins.write_arxiv_standin(d, seed=4, **ARXIV)
    return d


def opts(d, extra):
    return ["dataset.format", "OGB", "dataset.name", "ogbn-arxiv",
            "dataset.task", "node", "dataset.dir", d,
            "gnn.layer_type", "generalconv", *SMALL, *extra]


@functools.lru_cache(maxsize=None)
def both_loaders(d, extra):
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts(d, extra) + ["tpu.spmm_impl", "xla"])
    cfg.merge_from_list(opts(d, extra) + ["device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
    return jlds, loaders.create_loader(loaders.create_dataset(cfg), cfg)


@pytest.mark.parametrize("extra", [
    ("train.sampler", "neighbor"),
    ("train.sampler", "saint_rw"),
    ("train.sampler", "cluster", "val.sampler", "random_node"),
])
def test_sampler_loader_batches_match_jax(arxiv_dir, extra):
    """Three epochs of every loader, batch for batch; before the last,
    the train loader's node bucket is cut in both so that its draw
    re-buckets."""
    jlds, lds = both_loaders(arxiv_dir, extra)
    kinds = [type(ld).__name__ for ld in lds]
    assert kinds[0] == "SamplerLoader"
    assert kinds[1:] == (["SamplerLoader"] * 2 if "val.sampler" in extra
                         else ["GraphLoader"] * 2)
    for epoch in range(3):
        if epoch == 2:
            jlds[0].pad_nodes = lds[0].pad_nodes = 16
        for jld, ld in zip(jlds, lds):
            jbs, bs = jld.batches(epoch), ld.batches(epoch)
            assert len(bs) == len(jbs) >= 1
            for jb, b in zip(jbs, bs):
                assert_batches_equal(jb, b)
        assert lds[0].pad_nodes == jlds[0].pad_nodes
    assert lds[0].pad_nodes > 16                  # re-bucketed
    assert lds[0].sample_rng.bit_generator.state \
        == jlds[0].sample_rng.bit_generator.state


def test_node_sampling_matches_jax(arxiv_dir):
    """train.sample_node / val.sample_node: the supervised nodes of each
    loader's batch, epoch by epoch, as the JAX package draws them."""
    jlds, lds = both_loaders(arxiv_dir, ("train.sample_node", "True",
                                         "val.sample_node", "True"))
    seen = []
    for epoch in range(3):
        for jld, ld in zip(jlds, lds):
            (jb,), (b,) = jld.batches(epoch), ld.batches(epoch)
            assert_batches_equal(jb, b)
        real = b.node_label_index[b.label_mask]
        assert len(real) == 10
        seen.append(tuple(real))
    assert len(set(seen)) == 3                    # a fresh draw an epoch
    (b,) = lds[0].batches(3)
    assert int(b.label_mask.sum()) == 6


def run(d, extra, prefetch):
    cfg = get_cfg()
    cfg.merge_from_list(opts(d, extra) + [
        "device", "cpu", "out_dir", d, "tpu.prefetch", str(prefetch)])
    lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    recorded = [Recorded(ld) for ld in lds]
    torch.manual_seed(0)
    tr = Trainer(build_model(cfg, CPU), lds, cfg, CPU)
    losses, real_step = [], tr.train_step

    def step(batch):
        out = real_step(batch)
        losses.append(out[0].detach().numpy().copy())
        return out
    tr.train_step = step
    result = tr.run()
    return result, losses, recorded


@pytest.mark.parametrize("extra", [("train.sampler", "saint_edge"),
                                   ("train.sample_node", "True")])
def test_prefetched_sampled_training_is_the_serial_one(arxiv_dir, extra):
    result_s, losses_s, rec_s = run(arxiv_dir, extra, False)
    result_p, losses_p, rec_p = run(arxiv_dir, extra, True)
    assert [c[1].startswith("prefetch") for c in rec_p[0].calls][-2:] \
        == [True, True]
    assert all(c[1] == threading.main_thread().name for c in rec_s[0].calls)
    for s, p in zip(rec_s, rec_p):
        assert len(s.calls) == len(p.calls)
        for (_, _, a), (_, _, b) in zip(s.calls, p.calls):
            assert_same_batches(a, b)
    assert len(losses_s) == len(losses_p) >= 3
    for a, b in zip(losses_s, losses_p):
        assert a.tobytes() == b.tobytes()
    assert result_s == result_p
