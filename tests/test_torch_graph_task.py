"""The port's graph task (graph classification: the loader's graph
split and labels, the pooling packs, ``global_pool`` and the graph
head) against the JAX package's.

Inputs come from a numpy seed and go through both packages.  The JAX
side runs its XLA path (``global_pool`` is jax.ops.segment_sum /
segment_mean / segment_max there, graphgym_tpu/ops/segment.py:37-60);
the port pools on its rectangular packs (K1's and the segmented max's
plain versions on the CPU).  Pooled values at rtol 1e-6 / atol 1e-6
(mean 1e-5: the port divides in the pack's weights, the JAX package
after the sum), their gradients at 1e-5; the graph head's logits at
rtol 1e-4 / atol 1e-5 and gradients at rtol 1e-3 / atol 1e-5, as the
torch-path tests hold a model; three Adam steps of the design grid's
graph point and of an ID-GNN graph point within 2e-3.  The loaders
run on small regenerated corpora (scalefree and ba, 20 and 10 graphs).
"""

import functools
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
from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.nn import heads as jax_heads
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.graphs.packing import build_pool_packs, pool_kind
from graphgym_tpu_torch.nn import heads
from graphgym_tpu_torch.nn.model import build_model, options_from_cfg
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_torchpath import OneBatch, seeded_features
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_TOL = dict(rtol=1e-6, atol=1e-6)
MEAN_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# four real graphs of 6, 4, 0 and 7 nodes (slot 2 empty), 17 real nodes
# padded to 24; slot 4 is the padding graph's
SIZES, N_PAD, G = (6, 4, 0, 7), 24, 5
# ego centers: the first 3, 2, 0 and 4 nodes of each graph, then 3
# padding centers at the padding node
CENTERS = (3, 2, 0, 4)


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def pool_batches(kind, ego, levels=0, d=6):
    """Both packages' batch of the four graphs (a ring in each), graph
    labels, ego centers with padding ones, and x [N_PAD, d] seeded,
    nonzero on the padding rows too (the masks must drop them); with
    ``levels`` x takes that many values (ties in the max).  The port's
    carries the pooling pack of ``kind``."""
    rng = np.random.default_rng(11)
    starts = np.cumsum((0,) + SIZES)[:-1]
    gids = np.repeat(np.arange(len(SIZES)), SIZES)
    s = np.concatenate([st + np.arange(n) for st, n in zip(starts, SIZES)])
    r = np.concatenate([st + (np.arange(n) + 1) % max(n, 1)
                        for st, n in zip(starts, SIZES)])
    n_real = len(gids)
    feat = np.ones((n_real, d), np.float32)
    ids = np.concatenate([st + np.arange(c)
                          for st, c in zip(starts, CENTERS)])
    id_index = np.concatenate([ids, np.full(3, N_PAD - 1)]).astype(np.int32)
    id_mask = np.arange(len(id_index)) < len(ids)
    kw = dict(graph_ids=gids, num_graphs=G, graph_label=np.arange(4) % 3,
              pad_nodes_to=N_PAD, pad_edges_to=32)
    jb = jax_container.build_graph_batch(s, r, feat, **kw).replace(
        node_id_index=jnp.asarray(id_index), id_mask=jnp.asarray(id_mask))
    b = build_graph_batch(s, r, feat, **kw).replace(
        node_id_index=id_index, id_mask=id_mask)
    b = b.replace(packs=build_pool_packs(
        b.graph_ids, b.node_mask, b.num_graphs, kind,
        id_index if ego else None, id_mask if ego else None)).to(CPU)
    x = (rng.integers(-1, 2, (N_PAD, d)) if levels
         else rng.normal(size=(N_PAD, d)) * 3).astype(np.float32)
    return jb, b, x


def jax_pool(jb, x, cot, kind, ego):
    def f(v):
        out = jax_heads.global_pool(
            v, jb.graph_ids, jb.num_graphs, kind=kind,
            node_mask=jb.node_mask,
            id_index=jb.node_id_index if ego else None,
            id_mask=jb.id_mask if ego else None)
        return jnp.sum(out * cot), out
    (_, out), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("ego", [False, True])
@pytest.mark.parametrize("kind,levels", [("add", 0), ("mean", 0),
                                         ("max", 0), ("max", 3)])
def test_global_pool_matches_jax(kind, levels, ego):
    """add / mean / max over the real nodes or, under ego, the real
    centers: padding nodes and padding centers (nonzero x at the
    padding node) take no part, the empty slot 2 and the padding slot 4
    give 0; values and gradients under a seeded cotangent."""
    jb, b, x = pool_batches(kind, ego, levels)
    cot = np.random.default_rng(5).normal(size=(G, x.shape[1])).astype(
        np.float32)
    want, want_grad = jax_pool(jb, x, cot, kind, ego)
    xt = torch.from_numpy(x).requires_grad_()
    out = heads.global_pool(b, xt, kind, ego)
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (G, x.shape[1])
    np.testing.assert_allclose(out.detach().numpy(), want,
                               **(MEAN_TOL if kind == "mean" else POOL_TOL))
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, **POOL_GRAD_TOL)
    assert not out[2].any() and not out[4].any()
    if ego:     # only the real centers receive a gradient
        centers = np.asarray(b.node_id_index)[np.asarray(b.id_mask)]
        others = np.setdiff1d(np.arange(N_PAD), centers)
        assert not xt.grad[others].any()


def test_max_pool_ties_split_evenly():
    """A column constant over a graph: every one of its nodes reaches
    the max, and each gets the cotangent over the graph's node count, as
    jax.ops.segment_max's gradient splits it."""
    jb, b, x = pool_batches("max", False)
    x = x.copy()
    x[:6, 0] = 2.5                               # graph 0, column 0
    cot = np.ones((G, x.shape[1]), np.float32)
    _, want_grad = jax_pool(jb, x, cot, "max", False)
    xt = torch.from_numpy(x).requires_grad_()
    heads.global_pool(b, xt, "max").sum().backward()
    np.testing.assert_allclose(xt.grad[:6, 0].numpy(), np.full(6, 1 / 6),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, **POOL_GRAD_TOL)


def test_registered_pooling_takes_the_node_arrays(monkeypatch):
    """A pooling in register.pooling_dict is called with the node arrays,
    as in the JAX package, and needs no pack."""
    from graphgym_tpu_torch import register

    calls = []

    def first_node(x, graph_ids, num_graphs, node_mask=None, id_index=None,
                   id_mask=None):
        calls.append((num_graphs, id_index is not None))
        return x[:num_graphs]
    monkeypatch.setitem(register.pooling_dict, "first", first_node)
    _, b, x = pool_batches("add", True)
    out = heads.global_pool(b.replace(packs=None), torch.from_numpy(x),
                            "first", ego=True)
    assert calls == [(G, True)] and out.shape == (G, x.shape[1])
    with pytest.raises(ValueError, match="'pool_mean' pack"):
        heads.global_pool(b, torch.from_numpy(x), "mean")


# ------------------------------------------------ rectangular plain versions


def square_of(pack: K.PackedCSR, rows: int, senders: int, n: int):
    """The pack's slots as a square pack of n rows and n senders (the
    same edges and weights, in the same order within each row)."""
    host = K.PackedCSR(*(np.asarray(a) for a in pack))
    rows_of = K.pack_rows(K.PackedCSR(*map(torch.from_numpy, host)))
    s = host.senders.reshape(-1)
    keep = (host.weights.reshape(-1) != 0) & (s < senders)
    sq = K.pack_csr(s[keep], rows_of.reshape(-1).numpy()[keep],
                    host.weights.reshape(-1)[keep], n)
    return K.PackedCSR(*map(torch.from_numpy, sq))


@pytest.mark.parametrize("ego", [False, True])
def test_rectangular_plain_versions_equal_square(ego):
    """K1's and the segmented max's plain versions on a pooling pack (G
    rows from N_PAD senders) and its transpose (N_PAD rows from G) give
    the bits of the same versions on a square pack of the same slots:
    its first G rows forward, and backward on g zero-padded to N_PAD
    rows.  So the square callers and the pooling run one arithmetic."""
    for kind in ("add", "max"):
        _, b, x = pool_batches(kind, ego, levels=3 if kind == "max" else 0)
        fwd, bwd = b.packs[pool_kind(kind, ego)]
        sq_fwd, sq_bwd = (square_of(fwd, G, N_PAD, N_PAD),
                          square_of(bwd, N_PAD, G, N_PAD))
        xt = torch.from_numpy(x)
        g = torch.from_numpy(np.random.default_rng(2).normal(
            size=(G, x.shape[1])).astype(np.float32))
        g_sq = torch.cat([g, g.new_zeros(N_PAD - G, g.shape[1])])
        if kind == "add":
            assert torch.equal(K.spmm_packed_plain(fwd, xt),
                               K.spmm_packed_plain(sq_fwd, xt)[:G])
            assert torch.equal(K.spmm_packed_plain(bwd, g),
                               K.spmm_packed_plain(sq_bwd, g_sq))
            continue
        out, cnt = K.packed_max_plain(fwd, xt)
        sq_out, sq_cnt = K.packed_max_plain(sq_fwd, xt)
        assert torch.equal(out, sq_out[:G]) and torch.equal(cnt, sq_cnt[:G])
        assert (cnt > 1).any()                    # ties, levels 3
        pad = N_PAD - G
        assert torch.equal(
            K.packed_max_bwd_plain(bwd, xt, g, out, cnt),
            K.packed_max_bwd_plain(sq_bwd, xt, g_sq, torch.cat(
                [out, out.new_zeros(pad, out.shape[1])]), torch.cat(
                [cnt, cnt.new_zeros(pad, cnt.shape[1])])))


def test_pool_pack_layout():
    """The pooling packs: the fwd pack's G rows read N_PAD senders (its
    padding sender N_PAD), the bwd pack's N_PAD rows read G (padding
    sender G); mean's weights are 1 over each graph's real count; the
    padding and empty slots' rows are empty."""
    for kind, ego in (("mean", False), ("add", True)):
        _, b, _ = pool_batches(kind, ego)
        fwd, bwd = b.packs[pool_kind(kind, ego)]
        assert fwd.row_range.shape == (G, 2)
        assert bwd.row_range.shape == (N_PAD, 2)
        lengths = (fwd.row_range[:, 1] - fwd.row_range[:, 0]).tolist()
        assert lengths == (list(CENTERS) if ego else list(SIZES)) + [0]
        live = fwd.weights != 0
        # weight 0: padding nodes or centers, and the padding sender
        assert set(fwd.senders[~live].tolist()) <= set(
            range(sum(SIZES), N_PAD + 1))
        assert int(fwd.senders.max()) == N_PAD
        assert int(bwd.senders.max()) == G
        if kind == "mean":
            rows = K.pack_rows(fwd)[live]
            sizes = torch.tensor(SIZES, dtype=torch.float32)
            torch.testing.assert_close(fwd.weights[live],
                                       1.0 / sizes[rows], rtol=0, atol=0)


# ------------------------------------------------------------ the head


class Holder(torch.nn.Module):
    """The head under the model's name, post_mp, so params_from_jax maps
    the flax head's tree."""

    def __init__(self, head):
        super().__init__()
        self.post_mp = head


@pytest.mark.parametrize("ego", [False, True])
@pytest.mark.parametrize("kind", ["add", "mean", "max"])
def test_graph_head_matches_jax(kind, ego):
    """GNNGraphHead (pooling, then the 2-layer MLP with its BatchNorm
    masked to the real graph slots) with the flax head's variables:
    train-mode logits, the gradients of every parameter and of x, the
    BatchNorm running statistics, then eval-mode logits."""
    jb, b, x = pool_batches(kind, ego)
    jhead = jax_heads.GNNGraphHead(3, pooling=kind, ego=ego,
                                   layers_post_mp=2, dim_inner=8,
                                   gain=math.sqrt(2))
    jb = jb.replace(node_feat=jnp.asarray(x))
    variables = to_numpy(dict(jhead.init(jax.random.PRNGKey(0), jb,
                                         False)))
    cot = np.random.default_rng(4).normal(size=(G, 3)).astype(np.float32)

    def jax_loss(p, v):
        (pred, _, _), mut = jhead.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jb.replace(node_feat=v), True, mutable=["batch_stats"])
        return jnp.sum(pred * cot), (pred, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                                 jnp.asarray(x))
    head = heads.GNNGraphHead(x.shape[1], 3, pooling=kind, ego=ego,
                              layers_post_mp=2, dim_inner=8,
                              generator=torch.Generator().manual_seed(0))
    holder = Holder(head)
    holder.load_state_dict(params_from_jax(
        {k: {"post_mp": v} for k, v in variables.items()}, holder))
    xt = torch.from_numpy(x).requires_grad_()
    pred, label, mask = head(b.replace(node_feat=xt))
    (pred * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
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
    np.testing.assert_array_equal(label.numpy(), [0, 1, 2, 0, 0])
    np.testing.assert_array_equal(mask.numpy(), [1, 1, 1, 1, 0])
    head.eval()
    want_eval = jhead.apply({"params": variables["params"],
                             "batch_stats": stats}, jb, False)[0]
    with torch.no_grad():
        got_eval = head(b.replace(node_feat=torch.from_numpy(x)))[0]
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               **LOGIT_TOL)


# ------------------------------------------------- loaders and training

# the design grid's graph chunk (grids/design/round1.txt:81-98) at the
# point results/design_v1_grid_round1 ran, cut to width 16
DESIGN_GRAPH = ("dataset.format", "nx", "dataset.name", "scalefree",
                "dataset.task", "graph", "dataset.transductive", "True",
                "dataset.augment_feature", "['node_const']",
                "dataset.augment_label", "graph_path_len",
                "train.batch_size", "16", "gnn.layers_pre_mp", "2",
                "gnn.layers_mp", "2", "gnn.layers_post_mp", "2",
                "gnn.stage_type", "skipconcat", "gnn.batchnorm", "True",
                "gnn.act", "prelu", "gnn.dropout", "0.0", "gnn.agg",
                "mean", "optim.optimizer", "adam", "optim.base_lr", "0.001",
                "gnn.dim_inner", "16", "optim.max_epoch", "3")
# the ID chunk of grids/IDGNN/graph.txt:49-61 on configs/idgcn_ba.yaml,
# at 2 layers of width 16
ID_GRAPH = ("dataset.task", "graph", "dataset.transform", "ego",
            "dataset.augment_label", "graph_clustering_coefficient",
            "gnn.layers_pre_mp", "1", "gnn.layers_mp", "2",
            "gnn.layers_post_mp", "3", "gnn.layer_type", "gcnidconv",
            "gnn.dim_inner", "16", "optim.max_epoch", "3")
POINTS = {"design": ("design/design_v1", DESIGN_GRAPH, 20),
          "idgraph": ("idgcn_ba", ID_GRAPH, 10)}


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")


@functools.lru_cache(maxsize=None)
def graph_point(point, jdir, pdir, extra=()):
    """Both packages' configs of a graph point and their loaders, on the
    point's corpus regenerated by each package for itself at a cut
    count of graphs (seed 0)."""
    base, opts, count = POINTS[point]
    cfg_file = os.path.join(ROOT, "configs", f"{base}.yaml")
    opts = list(opts) + list(extra)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla", "dataset.dir",
                                 jdir])
    cfg = load_cfg(cfg_file, opts + ["device", "cpu", "dataset.dir", pdir])
    with pytest.MonkeyPatch.context() as mp:
        for module in (syn, jax_syn):
            real = module.generate_syn_graphs
            mp.setattr(module, "generate_syn_graphs",
                       lambda kind, num_graphs, n, real=real: real(
                           kind=kind, num_graphs=count, n=n))
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [jdir])
        mp.setattr(loaders, "_REPO_DATASETS", pdir)
        mp.setattr(jax_native, "load", lambda: None)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
        lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    return jcfg, cfg, jlds, lds


@pytest.mark.parametrize("point,extra", [("design", ("train.batch_size",
                                                     "4")),
                                         ("idgraph", ())])
def test_graph_loader_matches_jax(point, extra, corpus_dirs):
    """The graph task's split (inductive whatever dataset.transductive
    says, no min-node filter), its classes, and the batches of each
    split in the first epoch: graph slots, graph_label, graph_mask,
    graph_ids, node masks and features, the ego centers; no supervised
    node index.  The port's batches carry the pooling pack."""
    jcfg, cfg, jlds, lds = graph_point(point, *map(str, corpus_dirs),
                                       extra)
    assert not cfg.dataset.transductive
    assert cfg.share.dim_out == jcfg.share.dim_out >= 2
    assert cfg.share.dim_in == jcfg.share.dim_in
    assert [len(ld.graphs) for ld in lds] == [len(ld.graphs) for ld in jlds]
    ego = point == "idgraph"
    for jld, ld in zip(jlds, lds):
        jbs, bs = jld.batches(0), ld.batches(0)
        assert len(jbs) == len(bs) == len(ld) >= 1
        for jb, b in zip(jbs, bs):
            assert jb.num_graphs == b.num_graphs
            assert b.node_label_index is None is jb.node_label_index
            for field in ("graph_label", "graph_mask", "graph_ids",
                          "node_mask", "node_feat", "senders",
                          "node_id_index", "id_mask"):
                want, got = getattr(jb, field), getattr(b, field)
                if want is None:
                    assert got is None, field
                    continue
                np.testing.assert_array_equal(got, np.asarray(want),
                                              err_msg=field)
            assert set(b.packs) == {"mean" if point == "design" else "gcn",
                                    pool_kind(cfg.model.graph_pooling, ego)}
    if point == "design":
        assert len(lds[0]) == 4 and len(lds[1]) == 1


@pytest.mark.parametrize("point", sorted(POINTS))
def test_graph_point_three_steps_match_jax(point, corpus_dirs):
    """Three Adam steps of the design grid's graph point (generalconv,
    mean aggregation, skipconcat, PReLU, add pooling) and of the ID-GNN
    graph point (gcnidconv, ego, add pooling of the centers) from the
    same parameters (params_from_jax), each package on its own first
    train batch with the same seeded features (the corpora's are
    constant): per-step losses within 2e-3, the logged lrs."""
    jcfg, cfg, jlds, lds = graph_point(point, *map(str, corpus_dirs))
    jbatch, batch = seeded_features(jlds[0].batches(0)[0],
                                    lds[0].batches(0)[0].to(CPU))
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        model))
    assert isinstance(model.post_mp, heads.GNNGraphHead)
    assert model.post_mp.ego == (point == "idgraph")
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert all(map(np.isfinite, rec.losses))


def test_pre_mp_kernel_gradient_cancels_in_f32(corpus_dirs):
    """Why the card-vs-CPU model check holds a Linear kernel's gradient
    by its sum of |terms| where f32 cannot hold it elementwise: on the
    ID-GNN graph point (ba's 1-wide input, pre-MP Linear then
    BatchNorm, which undoes the kernel's scale) with seeded normal
    features, the CPU's own f32 gradient of the pre-MP kernel misses
    the float64 one (the same parameters and batch) at rtol 1e-3 /
    atol 1e-5, within 1e-5 x its sum of |terms| (|x|^T |d|) + 1e-6;
    every other leaf holds float64's elementwise."""
    _, cfg, _, lds = graph_point("idgraph", *map(str, corpus_dirs))
    batch = lds[0].batches(0)[0].to(CPU)
    assert batch.node_feat.shape[1] == 1
    gen = torch.Generator().manual_seed(3)
    batch = batch.replace(node_feat=torch.randn(
        batch.node_feat.shape, generator=gen) * batch.node_mask[:, None])
    model = build_model(cfg, CPU)
    m64 = build_model(cfg, CPU)
    m64.load_state_dict(model.state_dict())
    m64.double()
    terms = {}

    def hook(mod, inputs, out):
        x = inputs[0].node_feat.detach().abs()

        def keep(d):
            terms["pre"] = x.t() @ d.detach().abs()
        out.node_feat.register_hook(keep)
    model.pre_mp[0].layer.register_forward_hook(hook)
    grads = []
    for m, b in ((model, batch),
                 (m64, batch.replace(node_feat=batch.node_feat.double()))):
        pred, label, mask = m(b)
        torch.nn.functional.cross_entropy(pred[mask], label[mask]).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    g32, g64 = grads
    key = "pre_mp.0.layer.kernel"
    for k in g32:
        close = torch.isclose(g32[k].double(), g64[k], **GRAD_TOL)
        assert close.all() == (k != key), k
    err = (g32[key].double() - g64[key]).abs()
    assert (err <= 1e-5 * terms["pre"].double() + 1e-6).all()


def test_tfg_models_and_other_tasks_raise():
    """The Tfg models stay node models, as in the JAX package, and raise
    on the graph, link and edge tasks; the torch path takes all three."""
    for cfg_name, task in (("idgcn_ws", "graph"), ("idgcn_ws", "link_pred"),
                           ("design/design_v1", "edge")):
        cfg = load_cfg(os.path.join(ROOT, "configs", f"{cfg_name}.yaml"),
                       ["device", "cpu", "dataset.task", task,
                        "gnn.layer_type", "Tfg-idgcn"])
        cfg.share.dim_in, cfg.share.dim_out = 1, 2
        with pytest.raises(NotImplementedError, match="node models"):
            options_from_cfg(cfg)
        cfg.gnn.layer_type = "gcnidconv"
        assert options_from_cfg(cfg).task == task
