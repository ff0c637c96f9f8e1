"""The synthetic chunks of grids/IDGNN/graph.txt (ws500 and ba500: graphs
of 500 nodes, graph_clustering_coefficient labels, l_pre 1 / l_mp 3 /
l_post 3) in the port against the JAX package.

Each package regenerates both corpora for itself at a cut count of 6
graphs (seed 0; the JAX package with networkx, its native library off,
the port on its native BFS and triangle counts): the same graphs, edge
for edge.  The loaders of the plain chunk (:35-47, no transform, with
and without node_identity features) and of the ID chunk (:50-61, ego at
r = 3) give the same batches, field for field, on both corpora.  Three
Adam steps of each of the grid's eight layer types (gcnconv, sageconv,
gatconv, ginconv on the plain chunk with node_identity on ws500;
gcnidconv, sageidconv, gatidconv, ginidconv on the ID chunk on ba500),
at 2 layers of width 16, from the same parameters (params_from_jax),
each package on its own first train batch: losses within 2e-3.  The ID
chunk's features are a constant 1, so both take the same seeded ones
(the pre-MP BatchNorm would normalize rounding noise); the identity
features are the loader's own.  The JAX side runs its XLA path.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax

import graphgym_tpu.data.synthetic as jax_syn
import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.graphs.packing import pool_kind
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_torchpath import OneBatch, seeded_features
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT = 6
GRID = ("dataset.format", "nx", "dataset.task", "graph",
        "dataset.transductive", "False", "dataset.augment_label",
        "graph_clustering_coefficient", "gnn.layers_pre_mp", "1",
        "gnn.layers_mp", "3", "gnn.layers_post_mp", "3")
CHUNKS = {
    "plain": ("dataset.transform", "none", "dataset.augment_feature", "[]",
              "gnn.layer_type", "gcnconv"),
    "identity": ("dataset.transform", "none", "dataset.augment_feature",
                 "['node_identity']", "gnn.layer_type", "gcnconv"),
    "id": ("dataset.transform", "ego", "dataset.augment_feature", "[]",
           "gnn.layer_type", "gcnidconv"),
}
SMALL = ("gnn.dim_inner", "16", "gnn.layers_mp", "2", "optim.max_epoch",
         "3")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    return (str(tmp_path_factory.mktemp("jax")),
            str(tmp_path_factory.mktemp("port")))


@functools.lru_cache(maxsize=None)
def corpora(name, jdir, pdir):
    """Each package's corpus ``name`` regenerated at COUNT graphs into its
    directory (later loaders read it back from there)."""
    with cut_corpora(jdir, pdir):
        return (jax_loaders.load_nx(name, jdir),
                loaders.load_nx(name, pdir))


@contextlib.contextmanager
def cut_corpora(jdir, pdir):
    """Both generators cut to COUNT graphs, each package's corpus
    directory its only one, the JAX native library off."""
    with pytest.MonkeyPatch.context() as mp:
        for module in (syn, jax_syn):
            real = module.generate_syn_graphs
            mp.setattr(module, "generate_syn_graphs",
                       lambda kind, num_graphs, n, real=real: real(
                           kind=kind, num_graphs=COUNT, n=n))
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [jdir])
        mp.setattr(loaders, "_REPO_DATASETS", pdir)
        mp.setattr(jax_native, "load", lambda: None)
        yield


@functools.lru_cache(maxsize=None)
def grid_point(name, chunk, jdir, pdir, extra=()):
    """Both packages' configs of a chunk's point on corpus ``name`` and
    their loaders (idgcn_ws.yaml as the base: batch 128, split [0.8,
    0.2], add pooling)."""
    corpora(name, jdir, pdir)
    cfg_file = os.path.join(ROOT, "configs", "idgcn_ws.yaml")
    opts = (list(GRID) + ["dataset.name", name] + list(CHUNKS[chunk])
            + list(extra))
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla", "dataset.dir",
                                 jdir])
    cfg = load_cfg(cfg_file, opts + ["device", "cpu", "dataset.dir", pdir])
    with cut_corpora(jdir, pdir):
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
        lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    return jcfg, cfg, jlds, lds


@pytest.mark.parametrize("name", ["ws500", "ba500"])
def test_corpora_equal_the_jax_packages(name, corpus_dirs):
    jgraphs, graphs = corpora(name, *corpus_dirs)
    assert len(graphs) == len(jgraphs) == COUNT
    for jg, g in zip(jgraphs, graphs):
        assert g.num_nodes == jg.num_nodes == 500
        np.testing.assert_array_equal(g.edge_index, jg.edge_index)
        np.testing.assert_array_equal(g["node_feature"], jg["node_feature"])


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
@pytest.mark.parametrize("name", ["ws500", "ba500"])
def test_loader_batches_equal_the_jax_packages(name, chunk, corpus_dirs):
    """Every split's batches: graph slots, labels and masks, graph ids,
    node masks and features (the identity features on the plain chunk),
    senders, ego centers, bit for bit, but the identity features
    (float32 powers of A in each package: rtol 1e-5, as tests/
    test_torch_fast.py holds them); the port's carry the layer's pack and
    the pooling pack (500-slot rows, or one a center under ego)."""
    jcfg, cfg, jlds, lds = grid_point(name, chunk, *corpus_dirs)
    assert cfg.share.dim_in == jcfg.share.dim_in
    assert cfg.share.dim_out == jcfg.share.dim_out >= 2
    assert [len(ld.graphs) for ld in lds] == [len(ld.graphs) for ld in jlds]
    ego = chunk == "id"
    for jld, ld in zip(jlds, lds):
        jbs, bs = jld.batches(0), ld.batches(0)
        assert len(jbs) == len(bs) == 1
        for jb, b in zip(jbs, bs):
            assert jb.num_graphs == b.num_graphs
            for field in ("graph_label", "graph_mask", "graph_ids",
                          "node_mask", "node_feat", "senders", "receivers",
                          "edge_mask", "node_id_index", "id_mask"):
                want, got = getattr(jb, field), getattr(b, field)
                if want is None:
                    assert got is None, field
                    continue
                if field == "node_feat" and chunk == "identity":
                    # diag(A^k) / its row of powers: two float32 programs
                    np.testing.assert_allclose(got, np.asarray(want),
                                               rtol=1e-5, atol=1e-7)
                    continue
                np.testing.assert_array_equal(got, np.asarray(want),
                                              err_msg=field)
            pool = pool_kind(cfg.model.graph_pooling, ego)
            assert set(b.packs) == {"gcn", pool}
            fwd = b.packs[pool][0]
            spans = fwd.row_range[:, 1] - fwd.row_range[:, 0]
            real = int(np.sum(np.asarray(b.graph_mask)))
            assert (spans[:real] == 500).all()
    if chunk == "identity":
        assert cfg.share.dim_in == 11


LAYERS = {"gcnconv": ("ws500", "identity"), "sageconv": ("ws500", "identity"),
          "gatconv": ("ws500", "identity"), "ginconv": ("ws500", "identity"),
          "gcnidconv": ("ba500", "id"), "sageidconv": ("ba500", "id"),
          "gatidconv": ("ba500", "id"), "ginidconv": ("ba500", "id")}


def trainers(layer_type, corpus_dirs):
    """The JAX package's Trainer and the port's on each package's first
    train batch of the layer's point, the port model holding the JAX
    initial parameters (params_from_jax)."""
    name, chunk = LAYERS[layer_type]
    jcfg, cfg, jlds, lds = grid_point(
        name, chunk, *corpus_dirs,
        extra=SMALL + ("gnn.layer_type", layer_type))
    jbatch, batch = jlds[0].batches(0)[0], lds[0].batches(0)[0].to(CPU)
    if chunk == "id":
        jbatch, batch = seeded_features(jbatch, batch)
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(jax_state(jtr, model))
    return jtr, Trainer(model, [OneBatch(batch)], cfg, CPU), cfg, batch


def jax_state(jtr, model):
    return params_from_jax(jax.tree_util.tree_map(
        np.array, {"params": jtr.state.params,
                   "batch_stats": jtr.state.batch_stats}), model)


@pytest.mark.parametrize("layer_type",
                         sorted(set(LAYERS) - {"ginidconv"}))
def test_three_steps_match_jax(layer_type, corpus_dirs):
    jtr, tr, _, _ = trainers(layer_type, corpus_dirs)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    assert all(map(np.isfinite, rec.losses))
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)


def train_loss(cfg, batch, state):
    """The port's train-mode loss on ``batch`` at a state dict."""
    model = build_model(cfg, CPU)
    model.load_state_dict(state)
    model.train()
    with torch.no_grad():
        pred, label, mask = model(batch)
        return compute_loss(pred, label, mask, LossOptions())[0].item()


class TermSums(TorchFunctionMode):
    """Each parameter's gradient's sum of |terms|, per entry, on a train
    step: x @ p adds |x|^T |d|, x * p adds |x| |d| and x + p adds |d|,
    summed over the rows p is broadcast across (d the result's
    gradient)."""

    def __init__(self, model):
        super().__init__()
        self.names = {id(p): k for k, p in model.named_parameters()}
        self.scale = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = getattr(func, "__name__", "").strip("_").lstrip("r")
        if len(args) != 2 or op not in ("matmul", "mul", "add") \
                or not getattr(out, "requires_grad", False):
            return out
        for p, other in (args, args[::-1]):
            name = self.names.get(id(p))
            if name is None:
                continue
            other = (other.detach().abs() if isinstance(other, torch.Tensor)
                     else abs(other))

            def grad(d, name=name, p=p, other=other, op=op):
                d = d.detach().abs()
                s = (other.t() @ d if op == "matmul" else
                     other * d if op == "mul" else d)
                s = s.reshape(-1, *p.shape).sum(0)
                self.scale[name] = self.scale.get(name, 0) + s
            out.register_hook(grad)
        return out


def gradients(cfg, batch, state, dtype=torch.float32):
    """The port's train-step loss gradients at a state dict in
    ``dtype``, Adam's L2 term apart (its first moment takes their sum);
    in f32 also each entry's sum of |terms| (TermSums, plus |wd * p|)."""
    model = build_model(cfg, CPU)
    model.load_state_dict(state)
    model.to(dtype).train()
    sums = TermSums(model)
    with sums if dtype == torch.float32 else contextlib.nullcontext():
        pred, label, mask = model(batch.replace(
            node_feat=batch.node_feat.to(dtype)))
        compute_loss(pred, label, mask, LossOptions())[0].backward()
    wd = cfg.optim.weight_decay
    params = dict(model.named_parameters())
    return ({k: p.grad for k, p in params.items()},
            {k: wd * p.detach() for k, p in params.items()},
            {k: sums.scale[k] + wd * params[k].detach().abs()
             for k in sums.scale})


def jax_gradients(jtr, model, first_moments):
    """The JAX package's gradient of its last step (Adam's L2 term in),
    from its first moment and the one before (``first_moments``):
    optax.scale_by_adam's b1 = 0.9."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jtr.state.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")]
    mu = params_from_jax(jax.tree_util.tree_map(
        np.array, {"params": adam.mu, "batch_stats": jtr.state.batch_stats}),
        model)
    grads = {k: (mu[k] - 0.9 * first_moments.get(k, 0.0)) / (1 - 0.9)
             for k, _ in model.named_parameters()}
    first_moments.update({k: mu[k] for k, _ in model.named_parameters()})
    return grads


def test_ginidconv_three_steps_part_only_at_rounding_level(corpus_dirs):
    """ginidconv's three Adam steps on ba500's ID chunk (ROADMAP C10).
    The first step's loss within 2e-3.  Adam's first step moves each
    entry by lr times the sign of its gradient whatever its size, so an
    entry whose exact gradient lies within rounding of 0 (the pre-MP
    kernel's cancelling sums, GIN's MLP biases in front of the layer's
    BatchNorm) parts by 2 lr in any two float32 programs.  After step 1
    every entry that parts from the JAX package's by more than 1e-5 is
    such an entry: its float64 gradient (the port's, Adam's L2 term in)
    lies within 1e-5 x its sum of |terms| + 1e-6 of 0 (chip_smoke.py's
    hold_sums rule).  At each of the three steps the port's gradient at
    the JAX package's state equals the JAX package's gradient (from its
    Adam first moments) at rtol 1e-3, atol 1e-5, but where its terms
    cancel so far that the rule's rounding passes 1e-3 of the float64
    value (the pre-MP kernel's, whose f32 sums part from float64 by a
    share of their sum of |terms| in either package): where such an
    entry parts from the JAX package's, the port's lies within the rule
    of the float64 gradient, or no farther from it than the JAX
    package's.  From the second step the losses part by
    more than 2e-3 only through the parted entries: the port's loss at
    the JAX package's state after each step equals the JAX package's
    next loss within 1e-4 (the forward at 81,920 nodes), and the port's
    own state after step 1 with those entries set to the JAX package's
    gives the JAX package's second loss within 2e-3."""
    jtr, tr, cfg, batch = trainers("ginidconv", corpus_dirs)
    init = {k: v.clone() for k, v in tr.model.state_dict().items()}
    jrec, rec = StepRecorder(), StepRecorder()
    jstates, states, jgrads, moments = [], [], [], {}
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
        jgrads.append(jax_gradients(jtr, tr.model, moments))
        jstates.append(jax_state(jtr, tr.model))
        states.append({k: v.clone() for k, v in
                       tr.model.state_dict().items()})
    assert all(map(np.isfinite, rec.losses))
    np.testing.assert_allclose(rec.losses[0], jrec.losses[0], atol=2e-3)
    for step, (state, want) in enumerate(zip([init] + jstates[:2],
                                             jgrads)):
        loss, l2, scale = gradients(cfg, batch, state)
        exact = gradients(cfg, batch, state, torch.float64)[0]
        for name in loss:
            limit = 1e-5 * scale.get(name, torch.zeros(())) + 1e-6
            if step == 0:    # Adam's first step: the sign of loss + L2
                parted = (states[0][name] - jstates[0][name]).abs() > 1e-5
                assert ((exact[name] + l2[name]).abs() <= limit)[
                    parted].all(), name
            apart = ~torch.isclose(loss[name] + l2[name], want[name],
                                   rtol=1e-3, atol=1e-5)
            # a sum whose terms cancel so far that its rounding passes
            # the relative tolerance: there the port against float64
            cancels = exact[name].abs() * 1e-3 < limit
            assert not (apart & ~cancels).any(), (step, name)
            off = (loss[name] - exact[name]).abs()
            jax_off = (want[name] - l2[name] - exact[name]).abs()
            assert (off <= torch.maximum(limit, jax_off))[apart].all(), \
                (step, name)
    mixed = {k: torch.where((states[0][k] - jstates[0][k]).abs() > 1e-5,
                            jstates[0][k], states[0][k])
             for k in states[0]}
    for k in range(2):
        np.testing.assert_allclose(train_loss(cfg, batch, jstates[k]),
                                   jrec.losses[k + 1], atol=1e-4)
    np.testing.assert_allclose(train_loss(cfg, batch, mixed),
                               jrec.losses[1], atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
