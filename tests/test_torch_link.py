"""The port's link-prediction and edge tasks against the JAX package's.

From one numpy seed each of these must equal the JAX package's array
for array: ``negative_sampling``, ``_disjoint_split``,
``_default_supervision`` (disjoint and all, train and eval ratios), the
transductive pair split, ``path_len_labels`` and ``edge_nets``;
``create_dataset`` on the three grid points the card runs (dim_out, the
task rewritten to node by the edge transform); the loaders' batches
with ``resample_disjoint`` and ``resample_negative`` over three epochs;
the collated ``edge_label``, ``edge_label_index`` and
``edge_label_mask``.  Against tolerances: the gather packs' forward and
backward against ``index_select`` / ``index_add_`` with repeated nodes
(the edge head's pairs and the node head's repeated supervised nodes);
``GNNEdgeHead`` with dot, cosine and concat decoding, the flax head's
variables carried across (logits rtol 1e-4 / atol 1e-5, gradients
rtol 1e-3 / atol 1e-5); BCE (1-D and multi-label) and MSE against the
JAX ``compute_loss``; three Adam steps of the ID link point, the plain
link point (dot decoding) and the edge-task point within 2e-3 of the
JAX package; ``main`` on the CPU.  The points are the grid's
(``grids/IDGNN/link.txt:21-34``, ``:5-18``, ``path.txt:21-34``) at two
layers of width 16 on the first 5 ws graphs (6 regenerated ba graphs
for the concat point).
"""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.data.synthetic as jax_syn
import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.data import transforms as jax_tf
from graphgym_tpu.data.hostgraph import HostGraph as JaxHostGraph
from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.nn import heads as jax_heads
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu.train.loss import LossOptions as JaxLossOptions
from graphgym_tpu.train.loss import compute_loss as jax_compute_loss
from graphgym_tpu_torch import main as port_main
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.data import transforms as tf
from graphgym_tpu_torch.data.hostgraph import HostGraph
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.graphs.packing import (LABELS, PAIRS,
                                               build_gather_packs)
from graphgym_tpu_torch.nn import heads
from graphgym_tpu_torch.nn.model import build_model, options_from_cfg
from graphgym_tpu_torch.train.graphed import signature
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_graph_task import Holder, to_numpy
from test_torch_torchpath import OneBatch, seeded_features
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
SMALL = ("gnn.layers_mp", "2", "gnn.dim_inner", "16")
# the grid's chunks (the ID chunks with the disjoint link protocol of
# results/parity/LINK_PARITY.md), on configs/idgcn_ws.yaml or _ba.yaml
LINK_ID = ("dataset.transform", "edge", "dataset.task", "link_pred",
           "dataset.augment_label", "", "gnn.layer_type", "gcnidconv",
           "train.batch_size", "32", "dataset.edge_train_mode", "disjoint")
EDGE_ID = ("dataset.transform", "edge", "dataset.task", "edge",
           "dataset.augment_label", "", "gnn.layer_type", "gcnidconv",
           "train.batch_size", "32")
LINK_PLAIN = ("dataset.transform", "none", "dataset.task", "link_pred",
              "dataset.augment_label", "", "gnn.layer_type", "gcnconv",
              "dataset.augment_feature", "['node_identity']",
              "train.batch_size", "32", "dataset.edge_train_mode",
              "disjoint")
POINTS = {"linkid_ws": ("idgcn_ws", LINK_ID),
          "edgeid_ws": ("idgcn_ws", EDGE_ID),
          "link_ws": ("idgcn_ws", LINK_PLAIN),
          "link_ba": ("idgcn_ba", LINK_PLAIN + ("model.edge_decoding",
                                                "concat"))}
GRAPHS = 5


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def ring_graphs(seed=0, count=3, n=12):
    """Both packages' HostGraphs of ``count`` small graphs: a ring plus
    seeded chords, both directions stored (the corpora's form)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        s = np.arange(n)
        r = (s + 1) % n
        cs, cr = rng.integers(0, n, (2, n // 2))
        keep = cs != cr
        pairs = {(int(a), int(b)) for a, b in zip(
            np.concatenate([s, cs[keep]]), np.concatenate([r, cr[keep]]))}
        pairs |= {(b, a) for a, b in pairs}
        ei = np.array(sorted(pairs), np.int32).T
        feat = rng.normal(size=(n, 2)).astype(np.float32)
        out.append((ei, feat))
    return ([JaxHostGraph(n, ei.copy(), {"node_feature": f.copy()})
             for ei, f in out],
            [HostGraph(n, ei.copy(), {"node_feature": f.copy()})
             for ei, f in out])


def assert_graphs_equal(jg, g, keys=None):
    np.testing.assert_array_equal(g.edge_index, jg.edge_index)
    assert g.num_nodes == jg.num_nodes
    for key in keys if keys is not None else sorted(jg.feats):
        np.testing.assert_array_equal(g[key], np.asarray(jg[key]),
                                      err_msg=key)
    if keys is None:
        assert sorted(g.feats) == sorted(jg.feats)


# --------------------------------------------------- transforms, splits


@pytest.mark.parametrize("num_samples", [1, 40, 150])
def test_negative_sampling_matches_jax(num_samples):
    """Rejection sampling in rounds against the edge set, the same draws
    in the same order; 150 of a 12-node graph's 108 non-edges exhausts
    the rounds and fills with random non-self pairs."""
    (jg, *_), (g, *_) = ring_graphs()
    want = jax_tf.negative_sampling(jg.edge_index, 12, num_samples,
                                    np.random.default_rng(7))
    got = tf.negative_sampling(g.edge_index, 12, num_samples,
                               np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, num_samples) and got.dtype == np.int32
    assert (got[0] != got[1]).all()


def test_disjoint_split_matches_jax():
    pairs = np.random.default_rng(1).integers(0, 50, (2, 17))
    for ratio in (0.8, 0.0, 1.0):
        want = jax_loaders._disjoint_split(pairs, ratio,
                                           np.random.default_rng(3))
        got = loaders._disjoint_split(pairs, ratio,
                                      np.random.default_rng(3))
        for w, x in zip(want, got):
            np.testing.assert_array_equal(x, w)
        assert got[0].shape[1] and got[1].shape[1]


@pytest.mark.parametrize("task,mode", [("link_pred", "disjoint"),
                                       ("link_pred", "all"),
                                       ("edge", "all"),
                                       ("edge", "disjoint")])
@pytest.mark.parametrize("split_index", [0, 1])
def test_default_supervision_matches_jax(task, mode, split_index):
    """An inductive split's supervision: the message edges, positives
    and negatives (ratio 2 on the train split, 1 on eval), the resample
    fields; 'disjoint' holds the positives out of the message graph on
    link_pred only."""
    jgs, gs = ring_graphs(seed=4)
    opts = ["dataset.task", task, "dataset.edge_train_mode", mode,
            "dataset.edge_negative_sampling_ratio", "2.0",
            "dataset.resample_disjoint", "True"]
    jcfg, cfg = jax_get_cfg(), load_cfg(
        os.path.join(ROOT, "configs", "idgcn_ws.yaml"), opts)
    jcfg.merge_from_list(opts)
    jrng, rng = np.random.default_rng(5), np.random.default_rng(5)
    for jg, g in zip(jgs, gs):
        jax_loaders._default_supervision(jg, jcfg, jrng, split_index)
        loaders._default_supervision(g, cfg, rng, split_index)
        assert_graphs_equal(jg, g)
    held_out = task == "link_pred" and mode == "disjoint"
    n_pos = int(g["edge_label"].sum())
    if held_out:
        keys = set(map(tuple, g.edge_index.T.tolist()))
        pos = g["edge_label_index"][:, :n_pos].T.tolist()
        assert not any(tuple(p) in keys for p in pos)
    assert len(g["edge_label"]) - n_pos == (
        2 * n_pos if split_index == 0 else n_pos)
    assert ("_train_pairs" in g) == (held_out and split_index == 0)


@pytest.mark.parametrize("mode", ["disjoint", "all"])
@pytest.mark.parametrize("resample", ["resample_disjoint",
                                      "resample_negative"])
def test_transductive_pair_split_matches_jax(mode, resample):
    """The transductive link split: undirected pairs by ratio, the
    train pairs as every split's message graph (re-split under
    'disjoint'), negatives per split, the resample fields."""
    jgs, gs = ring_graphs(seed=6)
    opts = ["dataset.task", "link_pred", "dataset.transductive", "True",
            "dataset.split", "[0.6, 0.2, 0.2]",
            "dataset.edge_train_mode", mode, f"dataset.{resample}", "True"]
    jcfg, cfg = jax_get_cfg(), load_cfg(
        os.path.join(ROOT, "configs", "idgcn_ws.yaml"), opts)
    jcfg.merge_from_list(opts)
    want = jax_loaders.split_dataset(jgs, jcfg, np.random.default_rng(2))
    got = loaders.split_dataset(gs, cfg, np.random.default_rng(2))
    assert [len(p) for p in got] == [len(p) for p in want] == [3, 3, 3]
    for jpart, part in zip(want, got):
        for jg, g in zip(jpart, part):
            assert_graphs_equal(jg, g)


def test_path_len_labels_and_edge_nets_match_jax():
    """path_len_labels (1000 pairs drawn with replacement, min(dist, 4),
    unreachable dropped) on a graph with an isolated part, then
    edge_nets: the n copies, the centers, the scattered node labels and
    the supervised union index, which repeats nodes."""
    (jg, *_), (g, *_) = ring_graphs(seed=8)
    # two more nodes joined to each other only: some pairs unreachable
    extra = np.array([[12, 13], [13, 12]], np.int32)
    jg = JaxHostGraph(14, np.concatenate([jg.edge_index, extra], 1),
                      {"node_feature": np.ones((14, 1), np.float32)})
    g = HostGraph(14, np.concatenate([g.edge_index, extra], 1),
                  {"node_feature": np.ones((14, 1), np.float32)})
    jax_tf.path_len_labels(jg, rng=np.random.default_rng(9))
    tf.path_len_labels(g, rng=np.random.default_rng(9))
    assert_graphs_equal(jg, g)
    assert len(g["edge_label"]) < 1000
    assert set(np.unique(g["edge_label"])) <= set(range(5))
    jout, out = jax_tf.edge_nets(jg), tf.edge_nets(g)
    assert_graphs_equal(jout, out)
    assert out.num_nodes == 14 * 14
    np.testing.assert_array_equal(out["node_id_index"],
                                  np.arange(0, 196, 15))
    idx = out["node_label_index"]
    assert len(np.unique(idx)) < len(idx)       # drawn with replacement


# ------------------------------------------------------------ the points


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")


def point_cfgs(point, jdir, pdir, extra=()):
    base, opts = POINTS[point]
    cfg_file = os.path.join(ROOT, "configs", f"{base}.yaml")
    opts = list(opts) + list(SMALL) + list(extra)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla", "dataset.dir",
                                 jdir])
    cfg = load_cfg(cfg_file, opts + ["device", "cpu", "dataset.dir", pdir])
    return cfg_file, opts, jcfg, cfg


def cut_corpus(mp, jdir, pdir):
    """Both packages load their corpus cut to its first GRAPHS graphs;
    a regenerated one (ba) is generated at 10 graphs."""
    for module in (syn, jax_syn):
        real = module.generate_syn_graphs
        mp.setattr(module, "generate_syn_graphs",
                   lambda kind, num_graphs, n, real=real: real(
                       kind=kind, num_graphs=10, n=n))
    mp.setattr(jax_loaders, "_SEARCH_DIRS",
               [jdir] + list(jax_loaders._SEARCH_DIRS))
    for module in (jax_loaders, loaders):
        real = module.load_dataset
        mp.setattr(module, "load_dataset",
                   lambda cfg, real=real: real(cfg)[:GRAPHS])
    mp.setattr(jax_native, "load", lambda: None)


@functools.lru_cache(maxsize=None)
def point_data(point, jdir, pdir, extra=()):
    """Both packages' configs (task and dims set by create_dataset) and
    loaders of a point."""
    _, _, jcfg, cfg = point_cfgs(point, jdir, pdir, extra)
    with pytest.MonkeyPatch.context() as mp:
        cut_corpus(mp, jdir, pdir)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
        lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    return jcfg, cfg, jlds, lds


BATCH_FIELDS = ("senders", "receivers", "node_mask", "edge_mask",
                "node_label", "node_label_index", "label_mask",
                "node_id_index", "id_mask", "edge_label",
                "edge_label_index", "edge_label_mask")


def assert_batches_equal(jb, b):
    for field in BATCH_FIELDS:
        want, got = getattr(jb, field), getattr(b, field)
        if want is None:
            assert got is None, field
            continue
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=field)
    np.testing.assert_allclose(b.node_feat, np.asarray(jb.node_feat),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("point,task,dim_out,packs", [
    ("linkid_ws", "node", 2, {"gcn"}),
    ("edgeid_ws", "node", 5, {"gcn", LABELS}),
    ("link_ws", "link_pred", 1, {"gcn", PAIRS}),
    ("link_ba", "link_pred", 2, {"gcn", PAIRS})])
def test_create_dataset_and_batches_match_jax(point, task, dim_out, packs,
                                              corpus_dirs):
    """create_dataset on each point (the edge transform rewrites the
    task to node; dim_out 2 for the ID link point, 5 path-length
    classes, 1 for dot decoding, 2 for concat) and every split's
    batches: supervision, labels, message edges, the collated pairs
    (padded at the padding node, label 0, masked), features.  The
    port's batches carry the gather packs: 'pairs' on a link batch,
    'labels' where the supervised index repeats (the edge task)."""
    jcfg, cfg, jlds, lds = point_data(point, *map(str, corpus_dirs))
    assert cfg.dataset.task == jcfg.dataset.task == task
    assert cfg.share.dim_out == jcfg.share.dim_out == dim_out
    assert cfg.share.dim_in == jcfg.share.dim_in
    assert [len(ld.graphs) for ld in lds] == [4, 1]
    for jld, ld in zip(jlds, lds):
        assert ld.pad_edge_labels == jld.pad_edge_labels
        for jb, b in zip(jld.batches(0), ld.batches(0)):
            assert_batches_equal(jb, b)
            assert set(b.packs) == packs
            if b.edge_label_index is not None:
                pad = ~b.edge_label_mask
                assert pad.any() and not b.edge_label[pad].any()
                assert (b.edge_label_index[:, pad] == b.num_nodes - 1).all()


@pytest.mark.parametrize("extra", [("dataset.resample_disjoint", "True"),
                                   ("dataset.resample_negative", "True"),
                                   ("dataset.link_eval_resample_negative",
                                    "True")])
def test_resampled_batches_match_jax(extra, corpus_dirs):
    """The plain link point at two train batches of 2 graphs, with the
    supervision redrawn each epoch: the batches of three epochs, train
    and val, equal the JAX loaders' (the re-split message edges and
    positives, the negatives, the batch order)."""
    jcfg, cfg, jlds, lds = point_data(
        "link_ws", *map(str, corpus_dirs),
        extra + ("train.batch_size", "2"))
    assert len(lds[0]) == 2
    seen = set()
    for epoch in range(3):
        for jld, ld in zip(jlds, lds):
            for jb, b in zip(jld.batches(epoch), ld.batches(epoch)):
                assert_batches_equal(jb, b)
                seen.add(b.edge_label_index.tobytes())
    assert len(seen) > 3        # redrawn: not the same batches each epoch


# ------------------------------------------------------ the gather packs


def gather_case(entries=40, nodes=9, pad=5, d=6, seed=0):
    rng = np.random.default_rng(seed)
    index = np.concatenate([rng.integers(0, nodes - 1, entries),
                            np.full(pad, nodes - 1)])
    mask = np.arange(entries + pad) < entries
    x = rng.normal(size=(nodes, d)).astype(np.float32)
    g = rng.normal(size=(entries + pad, d)).astype(np.float32)
    return index, mask, x, g


def test_gather_pack_matches_index_select():
    """K1's plain versions on a gather pack: forward the rows
    x[index] (zero rows at padding entries), backward the sum of each
    node's entries, as index_select's gradient (index_add_) gives them,
    with nodes repeated up to 9 times; bitwise, as both sum a node's
    entries in index order."""
    index, mask, x, g = gather_case()
    fwd, bwd = (p._replace(**{f: torch.from_numpy(getattr(p, f))
                              for f in p._fields})
                for p in build_gather_packs(index, mask, len(x)))
    assert np.bincount(index[mask]).max() >= 5
    xt = torch.from_numpy(x).requires_grad_()
    out = heads.K.SpmmPackFn.apply(fwd, bwd, xt)
    (out * torch.from_numpy(g)).sum().backward()
    idx = torch.from_numpy(index)
    m = torch.from_numpy(mask)[:, None]
    want = torch.where(m, torch.from_numpy(x).index_select(0, idx), 0.0)
    assert torch.equal(out.detach(), want)
    want_grad = torch.zeros_like(xt).index_add_(
        0, idx, torch.where(m, torch.from_numpy(g), 0.0))
    assert torch.equal(xt.grad, want_grad)
    assert fwd.row_range.shape == (len(index), 2)
    assert bwd.row_range.shape == (len(x), 2)


def test_node_head_gathers_repeated_labels_on_the_pack():
    """gather_supervised takes the 'labels' pack where the loader gave
    one: the same predictions as index_select and the same gradient as
    index_add_, the labels gathered as before."""
    index, mask, x, g = gather_case(seed=1)
    n = len(x)
    b = build_graph_batch(np.array([0]), np.array([1]), x,
                          node_label=np.arange(n) % 3,
                          node_label_index=index[mask],
                          pad_nodes_to=n)
    b = b.replace(node_label_index=index, label_mask=mask)
    b = b.replace(packs={LABELS: build_gather_packs(index, mask, n)}).to(CPU)
    xt = torch.from_numpy(x).requires_grad_()
    pred, label, got_mask = heads.gather_supervised(b, xt)
    (pred * torch.from_numpy(g)).sum().backward()
    x2 = torch.from_numpy(x).requires_grad_()
    want = x2.index_select(0, b.node_label_index)
    (want * torch.from_numpy(g) * b.label_mask[:, None]).sum().backward()
    torch.testing.assert_close(pred[b.label_mask], want[b.label_mask],
                               rtol=0, atol=0)
    torch.testing.assert_close(xt.grad, x2.grad, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(label, (index % n) % 3)
    assert torch.equal(got_mask, b.label_mask)


# -------------------------------------------------------- the edge head


def pair_batches(d=6, seed=2):
    """Both packages' batch of 3 rings (17 real nodes, padded to 24)
    with 20 supervised pairs (nodes repeated) padded to 26 at the
    padding node, seeded features nonzero on the padding rows."""
    rng = np.random.default_rng(seed)
    sizes, n_pad = (6, 4, 7), 24
    starts = np.cumsum((0,) + sizes)[:-1]
    s = np.concatenate([st + np.arange(n) for st, n in zip(starts, sizes)])
    r = np.concatenate([st + (np.arange(n) + 1) % n
                        for st, n in zip(starts, sizes)])
    eli = rng.integers(0, sum(sizes), (2, 20))
    eli = np.concatenate([eli, np.full((2, 6), n_pad - 1)], 1)
    label = np.concatenate([rng.integers(0, 2, 20), np.zeros(6, int)])
    mask = np.arange(26) < 20
    feat = np.ones((sum(sizes), d), np.float32)
    kw = dict(edge_label=label, edge_label_index=eli, edge_label_mask=mask,
              pad_nodes_to=n_pad, pad_edges_to=20)
    jb = jax_container.build_graph_batch(s, r, feat, **kw)
    b = build_graph_batch(s, r, feat, **kw)
    b = b.replace(packs={PAIRS: build_gather_packs(
        eli.reshape(-1), np.tile(mask, 2), n_pad)}).to(CPU)
    x = (rng.normal(size=(n_pad, d)) * 2).astype(np.float32)
    return jb, b, x


@pytest.mark.parametrize("decoding,dim_out", [("dot", 1),
                                              ("cosine_similarity", 1),
                                              ("concat", 2)])
def test_edge_head_matches_jax(decoding, dim_out):
    """GNNEdgeHead (a 2-layer MLP with BatchNorm: over the nodes for dot
    and cosine, over the pair slots masked by edge_label_mask for
    concat) with the flax head's variables: train-mode predictions at
    the real pairs, the gradients of every parameter and of x, the
    BatchNorm statistics, eval-mode predictions."""
    jb, b, x = pair_batches()
    jhead = jax_heads.GNNEdgeHead(dim_out, decoding=decoding,
                                  layers_post_mp=2, dim_inner=8,
                                  gain=math.sqrt(2))
    jb = jb.replace(node_feat=jnp.asarray(x))
    variables = to_numpy(dict(jhead.init(jax.random.PRNGKey(0), jb,
                                         False)))
    mask = np.asarray(b.edge_label_mask)
    cot = np.random.default_rng(4).normal(
        size=(26,) + ((dim_out,) if dim_out > 1 else ())).astype(np.float32)
    cot[~mask] = 0

    def jax_loss(p, v):
        (pred, _, _), mut = jhead.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jb.replace(node_feat=v), True, mutable=["batch_stats"])
        return jnp.sum(pred * cot), (pred, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                                 jnp.asarray(x))
    head = heads.GNNEdgeHead(x.shape[1], dim_out, decoding=decoding,
                             layers_post_mp=2, dim_inner=8,
                             generator=torch.Generator().manual_seed(0))
    holder = Holder(head)
    holder.load_state_dict(params_from_jax(
        {k: {"post_mp": v} for k, v in variables.items()}, holder))
    xt = torch.from_numpy(x).requires_grad_()
    pred, label, got_mask = head(b.replace(node_feat=xt))
    (pred * torch.from_numpy(cot)).sum().backward()
    assert pred.shape == np.shape(want)
    np.testing.assert_allclose(pred.detach().numpy()[mask],
                               np.asarray(want)[mask], **LOGIT_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    grads = params_from_jax({"post_mp": to_numpy(gp)}, holder)
    for name, p in holder.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    new = params_from_jax({"params": {"post_mp": variables["params"]},
                           "batch_stats": {"post_mp": to_numpy(stats)}},
                          holder)
    for name, buf in holder.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new[name].numpy(),
                                   err_msg=name, **LOGIT_TOL)
    np.testing.assert_array_equal(label, np.asarray(jb.edge_label))
    np.testing.assert_array_equal(got_mask, mask)
    head.eval()
    want_eval = jhead.apply({"params": variables["params"],
                             "batch_stats": stats}, jb, False)[0]
    with torch.no_grad():
        got_eval = head(b.replace(node_feat=torch.from_numpy(x)))[0]
    np.testing.assert_allclose(got_eval.numpy()[mask],
                               np.asarray(want_eval)[mask], **LOGIT_TOL)


def test_edge_head_needs_the_pair_pack():
    _, b, x = pair_batches()
    head = heads.GNNEdgeHead(x.shape[1], 1,
                             generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="'pairs' gather pack"):
        head(b.replace(node_feat=torch.from_numpy(x), packs=None))
    with pytest.raises(ValueError, match="Unknown edge decoding"):
        heads.GNNEdgeHead(4, 1, decoding="hadamard",
                          generator=torch.Generator())


# ------------------------------------------------------------- the loss


@pytest.mark.parametrize("case", ["bce_1d", "bce_column", "multi_label",
                                  "mse_1d", "mse_multi", "ce_multi"])
@pytest.mark.parametrize("size_average", ["mean", "sum"])
def test_losses_match_jax(case, size_average):
    """BCE with logits (1-D, an [L, 1] column squeezed, multi-label rows
    averaged over classes), MSE (1-D and multi-target) and multi-class
    CE against the JAX compute_loss, masked: loss and score."""
    rng = np.random.default_rng(12)
    n, c = 15, 4
    mask = np.arange(n) < 11
    pred = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    loss_fun = "mse" if case.startswith("mse") else "cross_entropy"
    if case == "bce_1d" or case == "mse_1d":
        pred, true = pred[:, 0], rng.integers(0, 2, n)
    elif case == "bce_column":
        pred, true = pred[:, :1], rng.integers(0, 2, (n, 1))
    elif case in ("multi_label", "mse_multi"):
        true = rng.integers(0, 2, (n, c))
    else:
        true = rng.integers(0, c, n)
    if loss_fun == "mse":
        true = true.astype(np.float32) + rng.normal(size=true.shape)
    jloss, jscore = jax_compute_loss(
        jnp.asarray(pred), jnp.asarray(true), jnp.asarray(mask),
        JaxLossOptions(loss_fun=loss_fun, size_average=size_average))
    loss, score = compute_loss(
        torch.from_numpy(pred), torch.from_numpy(np.asarray(true)),
        torch.from_numpy(mask),
        LossOptions(loss_fun=loss_fun, size_average=size_average))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore),
                               rtol=1e-6, atol=1e-7)


def test_registered_loss_takes_precedence(monkeypatch):
    from graphgym_tpu_torch import register

    def first_none(pred, true, mask, opts):
        return None

    def constant(pred, true, mask, opts):
        return pred.sum() * 0 + 7.0, pred
    monkeypatch.setitem(register.loss_dict, "a_none", first_none)
    monkeypatch.setitem(register.loss_dict, "b_constant", constant)
    loss, _ = compute_loss(torch.ones(3, 2), torch.zeros(3, dtype=torch.long),
                           None, LossOptions())
    assert loss.item() == 7.0


# ------------------------------------------------ the model and training


def test_options_and_heads_by_task(corpus_dirs):
    """The edge and link tasks build the edge head with the config's
    decoding on the torch path (the edge transform's points the node
    head); a head registered for the task comes first; the Tfg models
    stay node models."""
    from graphgym_tpu_torch import register

    for point, head in (("linkid_ws", heads.GNNNodeHead),
                        ("link_ws", heads.GNNEdgeHead),
                        ("link_ba", heads.GNNEdgeHead)):
        _, cfg, _, _ = point_data(point, *map(str, corpus_dirs))
        model = build_model(cfg, CPU)
        assert type(model.post_mp) is head
        if head is heads.GNNEdgeHead:
            assert model.post_mp.decoding == cfg.model.edge_decoding
    cfg = load_cfg(os.path.join(ROOT, "configs", "idgcn_ws.yaml"),
                   ["device", "cpu", "dataset.task", "edge",
                    "gnn.layer_type", "gcnconv"])
    cfg.share.dim_in, cfg.share.dim_out = 1, 1
    calls = []

    class Constant(torch.nn.Module):
        def __init__(self, opts, dim_in, generator):
            super().__init__()
            calls.append((opts.task, dim_in))

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(register.head_dict, "edge", Constant)
        assert isinstance(build_model(cfg, CPU).post_mp, Constant)
    assert calls == [("edge", cfg.gnn.dim_inner)]
    cfg.gnn.layer_type = "Tfg-idgcn"
    with pytest.raises(NotImplementedError, match="node models"):
        options_from_cfg(cfg)


@pytest.mark.parametrize("point", ["linkid_ws", "link_ws", "edgeid_ws"])
def test_three_steps_match_jax(point, corpus_dirs):
    """Three Adam steps of the ID link point (gcnidconv on the edge-net
    union), the plain link point (gcnconv, node_identity features, dot
    decoding; BCE on the sigmoid scores) and the edge-task point
    (path-length classes; the supervised index repeats, so the port
    gathers on the 'labels' pack) from the same parameters
    (params_from_jax), each package on its own first train batch with
    the same seeded features: per-step losses within 2e-3, the logged
    lrs."""
    jcfg, cfg, jlds, lds = point_data(point, *map(str, corpus_dirs))
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
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert all(map(np.isfinite, rec.losses))


def test_batch_fields_move_and_sign(corpus_dirs):
    """GraphBatch.to moves the pair fields (int64 indices and labels,
    the bool mask) and the gather pack; the captured step's signature
    holds each of them."""
    _, _, _, lds = point_data("link_ws", *map(str, corpus_dirs))
    b = lds[0].batches(0)[0]
    moved = b.to(CPU)
    assert moved.edge_label_index.dtype == torch.int64
    assert moved.edge_label.dtype == torch.int64
    assert moved.edge_label_mask.dtype == torch.bool
    paths = {p for p, *_ in signature(moved)}
    assert {"edge_label", "edge_label_index", "edge_label_mask",
            "packs.pairs.0.senders", "packs.pairs.1.row_range"} <= paths


@pytest.mark.parametrize("point,metric", [("linkid_ws", "accuracy"),
                                          ("link_ws", "auc")])
def test_main_trains_on_the_cpu(point, metric, corpus_dirs, tmp_path):
    """``main`` on the CPU for 2 epochs: train and val stats.json hold
    finite losses and the metric the JAX logger reports: accuracy
    (classification_multi: the edge transform makes the ID link point
    a node task), or accuracy and AUC (classification_binary: the plain
    link point's sigmoid scores)."""
    cfg_file, opts, _, _ = point_cfgs(point, *map(str, corpus_dirs))
    with pytest.MonkeyPatch.context() as mp:
        cut_corpus(mp, *map(str, corpus_dirs))
        port_main.main(["--cfg", cfg_file] + opts + [
            "device", "cpu", "optim.max_epoch", "2", "train.eval_period",
            "1", "dataset.dir", str(corpus_dirs[1]), "out_dir",
            str(tmp_path)])
    run = tmp_path / "idgcn_ws" / "1"
    for split in ("train", "val"):
        with open(run / split / "stats.json") as f:
            stats = [json.loads(line) for line in f]
        assert len(stats) == 2
        for s in stats:
            assert math.isfinite(s["loss"]) and 0 <= s[metric] <= 1
            assert ("auc" in s) == (metric == "auc")


def test_eval_selects_by_negative_mse_on_regression():
    """With task_type regression (the mse loss) the eval score is the
    negative MSE of the real slots, as in the JAX Trainer, so the best
    epoch is the largest either way; classification keeps accuracy."""
    score = torch.tensor([0.5, 2.0, 9.0])
    label = torch.tensor([1.0, 1.0, 0.0])
    mask = torch.tensor([True, True, False])
    tr = Trainer.__new__(Trainer)
    tr.loaders = [None, OneBatch(None)]
    tr._place = lambda batch: batch
    tr.eval_step = lambda batch: (torch.tensor(0.0), score, label, mask)
    tr.cfg = load_cfg(os.path.join(ROOT, "configs", "idgcn_ws.yaml"), [])
    tr.task_type = "regression"
    assert tr.eval_epoch(None, 1) == pytest.approx(-(0.25 + 1.0) / 2)
    tr.task_type = "classification"
    assert tr.eval_epoch(None, 1) == 0.5
