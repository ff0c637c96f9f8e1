"""The port's GraphGym torch-path node model against the JAX package's:
pre-MP Linear + BN + act, the stack or skip stage of GeneralLayer(conv)
with BN, dropout, act and the L2 norm, and the node head's MLP.

For each of the eight torch-path layer types of the ID-GNN grid's
synthetic node chunks (grids/IDGNN/node.txt:70-96 and gatidconv /
gatconv), on its config at gnn.dim_inner 16 (ws, 6 graphs per split;
the ID layers on configs/idgcn_ws.yaml, the plain ones on
configs/gcnconvFast_ws.yaml), parameters carried over by
params_from_jax: logits in train and eval mode (rtol 1e-4 / atol
1e-5), every parameter gradient (rtol 1e-3 / atol 1e-5), the BatchNorm
running statistics after the train-mode forward (rtol 1e-4 / atol
1e-5), and per-step losses over 3 Adam steps (weight decay, no kernel
L2) within 2e-3.  Also: gatidconv on a small regenerated ba corpus;
PReLU, skipsum / skipconcat, layers_pre_mp 2 and layers_post_mp 2;
dropout's rate and scale; the init gains; SAGEIDConv's K1 mean against
the JAX COO mean.  The JAX side runs its numpy host paths and its
plain XLA SpMM (tpu.spmm_impl xla, SPMM_IMPL below), not the Pallas
kernel, whose f32 path drops a low-order product that the model's
BatchNorms scale past the tolerances.
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
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu.train.loss import LossOptions as JaxLossOptions
from graphgym_tpu.train.loss import compute_loss as jax_compute_loss
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.nn import id_layers, layers
from graphgym_tpu_torch.nn.act import PReLU
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_spmm import random_graph
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ID_TYPES = ["gcnidconv", "sageidconv", "ginidconv", "gatidconv"]
PLAIN_TYPES = ["gcnconv", "sageconv", "ginconv", "gatconv"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# The JAX side takes its plain XLA path: the Pallas kernels' f32 path
# keeps two bf16 planes and drops lo * lo (spmm_kernel.py:343-369,
# :570-572), an error of ~1.5e-5 of each term that the four BatchNorms
# of a torch-path model scale up past the tolerances.
SPMM_IMPL = "xla"


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def overrides_of(layer_type, extra=()):
    """The grid point's overrides at width 16 (gatidconv / gatconv at
    layers_mp 2, as node.txt:6-18 and :37-49 run them)."""
    out = ["gnn.layer_type", layer_type, "gnn.dim_inner", "16"]
    if layer_type.startswith("gat"):
        out += ["gnn.layers_mp", "2"]
    return out + list(extra)


def config_file(layer_type):
    name = "idgcn_ws" if layer_type in ID_TYPES else "gcnconvFast_ws"
    return os.path.join(ROOT, "configs", f"{name}.yaml")


def configs(layer_type, extra=(), cfg_file=None):
    cfg_file = cfg_file or config_file(layer_type)
    opts = overrides_of(layer_type, extra)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", SPMM_IMPL])
    return jcfg, load_cfg(cfg_file, opts + ["device", "cpu"])


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def seeded_features(jbatch, batch, seed=3):
    """Both packages' batch with the same seeded normal features on the
    real nodes.  ws's own are a constant 1 (the ID configs): the pre-MP
    Linear makes every row the same, so its BatchNorm normalizes the
    rounding of the row mean, and any two f32 programs part from there
    in train mode."""
    feat = np.random.default_rng(seed).normal(
        size=np.shape(batch.node_feat)).astype(np.float32)
    feat *= np.asarray(batch.node_mask)[:, None]
    return (jbatch.replace(node_feat=jnp.asarray(feat)),
            batch.replace(node_feat=torch.from_numpy(feat)))


class OneBatch:
    """A loader of one fixed batch (duck-typed for both Trainers)."""

    shuffle = False

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return 1

    def batches(self, epoch=0):
        return [self.batch]


@functools.lru_cache(maxsize=None)
def grid_point(layer_type, extra=()):
    """Both packages' configs (their dataset widths set) and the train
    batch of each (6 graphs per split, seeded features)."""
    jcfg, cfg = configs(layer_type, extra)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        jsplits = [p[:6] for p in jax_loaders.create_dataset(jcfg)]
        jloaders = jax_loaders.create_loader(jsplits, jcfg)
    lds = loaders.create_loader([p[:6] for p in loaders.create_dataset(cfg)],
                                cfg)
    assert len(lds[0]) == len(jloaders[0]) == 1
    jbatch, batch = seeded_features(jloaders[0].batches(0)[0],
                                    lds[0].batches(0)[0].to(CPU))
    return jcfg, cfg, jbatch, batch


@functools.lru_cache(maxsize=None)
def model_pair(layer_type, extra=()):
    """The JAX model and its variables, the port's config, and the
    train batch of each package (grid_point)."""
    jcfg, cfg, jbatch, batch = grid_point(layer_type, extra)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(dict(jmodel.init(jax.random.PRNGKey(0), jbatch,
                                          False)))
    return jmodel, variables, jbatch, cfg, batch


def port_model(cfg, variables):
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(variables, model))
    return model


def check_against_jax(jmodel, variables, jbatch, model, batch):
    """Train-mode logits, gradients of the masked CE and BN running
    statistics, then eval-mode logits, each package on its own batch."""
    params, stats = variables["params"], variables.get("batch_stats", {})

    def jax_loss(p):
        (pred, label, mask), mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, jbatch, True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        loss, _ = jax_compute_loss(pred, label, mask, JaxLossOptions())
        return loss, (pred, mut.get("batch_stats", {}))

    # one compiled program, not one per primitive as eager JAX takes
    (want_loss, (want, new_stats)), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params)
    model.train()
    pred, label, mask = model(batch)
    loss, _ = compute_loss(pred, label, mask, LossOptions())
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(to_numpy(grads), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    want_state = params_from_jax(to_numpy(
        {"params": params, "batch_stats": new_stats}), model)
    buffers = dict(model.named_buffers())
    for name, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want_state[name].numpy(),
                                   err_msg=name, **LOGIT_TOL)
    want_eval, _, _ = jax.jit(lambda v: jmodel.apply(v, jbatch, False))(
        {"params": params, "batch_stats": new_stats})
    model.eval()
    with torch.no_grad():
        got_eval, _, _ = model(batch)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               **LOGIT_TOL)
    return buffers


@pytest.mark.parametrize("layer_type", ID_TYPES + PLAIN_TYPES)
def test_layer_type_matches_jax(layer_type):
    """Each grid layer type at its config (pre-MP 1, MP 3 or 2,
    post-MP 1, BatchNorm, L2 norm): logits, gradients, statistics."""
    jmodel, variables, jbatch, cfg, batch = model_pair(layer_type)
    model = port_model(cfg, variables)
    buffers = check_against_jax(jmodel, variables, jbatch, model, batch)
    # BN after pre-MP and after each MP layer; no conv bias under BN
    assert len(buffers) == 2 * (1 + cfg.gnn.layers_mp)
    assert not any(name.endswith("layer.bias") for name, _ in
                   model.named_parameters() if name.startswith("mp."))


VARIANTS = {
    "prelu": ("ginidconv", ("gnn.act", "prelu")),
    "skipsum": ("gcnidconv", ("gnn.stage_type", "skipsum")),
    "skipconcat": ("sageconv", ("gnn.stage_type", "skipconcat")),
    "skipsum_prelu": ("ginidconv", ("gnn.stage_type", "skipsum",
                                    "gnn.act", "prelu")),
    "skip_every_2": ("gcnconv", ("gnn.stage_type", "skipconcat",
                                 "gnn.layers_mp", "4", "gnn.skip_every",
                                 "2", "gnn.act", "prelu")),
    "pre_mp_2": ("gcnidconv", ("gnn.layers_pre_mp", "2")),
    "post_mp_2": ("ginconv", ("gnn.layers_post_mp", "2",
                              "gnn.act", "prelu")),
    "no_bn_no_l2": ("sageidconv", ("gnn.batchnorm", "False",
                                   "gnn.l2norm", "False")),
    "mlp": ("mlp", ("gnn.layers_post_mp", "2")),
    "linear": ("linear", ()),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_variant_matches_jax(variant):
    """PReLU (learnable in the GeneralLayers; the skip stage's merge
    takes the fixed 0.25 leaky ReLU), skip stages, a second pre-MP
    layer (flax ``Linear_1``), a second head layer, the wrapper without
    BN and L2 norm, and the 'mlp' / 'linear' layer types."""
    layer_type, extra = VARIANTS[variant]
    jmodel, variables, jbatch, cfg, batch = model_pair(layer_type, extra)
    model = port_model(cfg, variables)
    check_against_jax(jmodel, variables, jbatch, model, batch)
    params = variables["params"]
    names = dict(model.named_parameters())
    if variant == "prelu":
        assert sorted(params["mp"]["GeneralLayer_2"]) == [
            "MaskedBatchNorm_0", "PReLU_0"]
        assert isinstance(model.mp.layers[2].act, PReLU)
        assert "pre_mp.0.act.slope" in names
    if variant == "skipsum_prelu":
        # skip_every 1: the layers have no activation, so no PReLU
        assert "PReLU_0" not in params["mp"]["GeneralLayer_0"]
        assert not any(".act." in n for n in names if n.startswith("mp."))
    if variant == "pre_mp_2":
        assert params["Linear_1"]["kernel"].shape == (16, 16)
        np.testing.assert_array_equal(
            names["pre_mp.1.layer.kernel"].detach().numpy(),
            params["Linear_1"]["kernel"])
    if variant == "post_mp_2":
        assert sorted(params["post_mp"]["MLP_0"]) == [
            "GeneralLayer_0", "Linear_0", "Linear_1"]
        assert "post_mp.mlp.layers.0.act.slope" in names
    if variant == "no_bn_no_l2":
        assert not list(model.buffers())
        assert "mp.layers.0.layer.bias" in names


@pytest.mark.parametrize("has_bn,act", [
    (True, "prelu"), (False, "relu"), (True, "lrelu_025")])
def test_general_layer_matches_jax(has_bn, act):
    """GeneralLayer(Linear) alone (the learnable PReLU's slope gradient
    on its own; a bias without BN): output and gradients against the
    JAX layer, on random features with padding rows."""
    from graphgym_tpu.graphs import container as jax_container
    from graphgym_tpu.nn import layers as jax_layers
    from graphgym_tpu_torch.graphs.container import build_graph_batch

    rng = np.random.default_rng(5)
    feat = rng.normal(size=(40, 6)).astype(np.float32)
    s, r = rng.integers(0, 40, 80), rng.integers(0, 40, 80)
    jb = jax_container.build_graph_batch(s, r, feat, pad_nodes_to=48,
                                         pad_edges_to=96)
    b = build_graph_batch(s, r, feat, pad_nodes_to=48,
                          pad_edges_to=96).to(CPU)
    jmod = jax_layers.GeneralLayer(
        jax_layers.Linear(8, use_bias=not has_bn, gain=math.sqrt(2)), 8,
        has_bn=has_bn, act=act)
    mod = layers.GeneralLayer(
        layers.Linear(6, 8, use_bias=not has_bn,
                      generator=torch.Generator()),
        8, has_bn=has_bn, act=act)
    variables = to_numpy(dict(jmod.init(jax.random.PRNGKey(0), jb, False)))
    stats = variables.get("batch_stats", {})
    names = {"layer": "layer", "bn": "MaskedBatchNorm_0",
             "act": "PReLU_0"}
    state = {}
    for name in mod.state_dict():
        mod_name, leaf = name.split(".")
        tree = stats if leaf in ("mean", "var") else variables["params"]
        state[name] = torch.from_numpy(tree[names[mod_name]][leaf])
    mod.load_state_dict(state)
    cot = rng.normal(size=(48, 8)).astype(np.float32)

    def jax_loss(p):
        out, _ = jmod.apply({"params": p, "batch_stats": stats}, jb, True,
                            mutable=["batch_stats"])
        return jnp.sum(out.node_feat * cot), out.node_feat

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        variables["params"])
    out = mod(b).node_feat
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    for name, p in mod.named_parameters():
        mod_name, leaf = name.split(".")
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(grads[names[mod_name]][leaf]),
            err_msg=name, **GRAD_TOL)
    assert ("act.slope" in dict(mod.named_parameters())) == (act == "prelu")


def three_steps(jcfg, cfg, jbatch, batch):
    """Three Adam steps of each package on its train batch from the same
    parameters and statistics: per-step losses."""
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    model = port_model(cfg, to_numpy({"params": jtr.state.params,
                                      "batch_stats": jtr.state.batch_stats}))
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    assert tr.loss_opts.l2_kernel == 0.0
    assert tr.optimizer.param_groups[0]["weight_decay"] == 5e-4
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    return rec.losses


@pytest.mark.parametrize("layer_type", ID_TYPES + PLAIN_TYPES)
def test_three_adam_steps_match_jax(layer_type):
    losses = three_steps(*grid_point(layer_type))
    assert losses[2] < losses[0]


def test_gatidconv_on_regenerated_ba_matches_jax(tmp_path, monkeypatch):
    """gatidconv at its grid point (node.txt:6-18: ba, ego, layers_mp
    2) on a ba corpus each package regenerates for itself (8 graphs of
    64 nodes from seed 0): logits, gradients, statistics, 3 steps."""
    for module in (syn, jax_syn):
        real = module.generate_syn_graphs
        monkeypatch.setattr(
            module, "generate_syn_graphs",
            lambda kind, num_graphs, n, real=real: real(
                kind=kind, num_graphs=8, n=n))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_loaders, "_SEARCH_DIRS", [str(jdir)])
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(pdir))
    cfg_file = os.path.join(ROOT, "configs", "idgcn_ba.yaml")
    jcfg, cfg = configs("gatidconv", cfg_file=cfg_file)
    jcfg.merge_from_dict({"dataset": {"dir": str(jdir)}})
    cfg.merge_from_dict({"dataset": {"dir": str(pdir)}})
    jsplits = jax_loaders.create_dataset(jcfg)
    jbatch = jax_loaders.create_loader(jsplits, jcfg)[0].batches(0)[0]
    batch = loaders.create_loader(loaders.create_dataset(cfg),
                                  cfg)[0].batches(0)[0].to(CPU)
    jbatch, batch = seeded_features(jbatch, batch)
    assert batch.num_nodes == jbatch.num_nodes and "att" in batch.packs
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(dict(jmodel.init(jax.random.PRNGKey(0), jbatch,
                                          False)))
    check_against_jax(jmodel, variables, jbatch,
                      port_model(cfg, variables), batch)
    three_steps(jcfg, cfg, jbatch, batch)


# ----------------------------------------------------------- dropout


def test_dropout_rate_and_scale():
    """Entries kept with probability 1 - rate (within 5 sigma), scaled
    by exactly 1 / (1 - rate), from the generator: one seed, one mask."""
    x = torch.randn(400, 128, generator=torch.Generator().manual_seed(0))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(layers.dropout(x, 0.3, gen))
    y = outs[0]
    assert torch.equal(outs[0], outs[1])
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - 0.7) < 5 * math.sqrt(
        0.3 * 0.7 / n)
    assert torch.equal(y[kept], x[kept] / 0.7)


def test_dropout_in_the_model():
    """gnn.dropout 0.3 (the design_ws point's): train-mode outputs draw
    fresh masks from the model's generator (two models of one seed draw
    the same ones); eval mode drops nothing and equals the dropout-0
    model; a GeneralLayer with dropout and no generator raises."""
    extra = ("gnn.act", "prelu", "gnn.stage_type", "skipsum",
             "gnn.dropout", "0.3")
    _, variables, _, cfg, batch = model_pair("ginidconv", extra)
    a, b = port_model(cfg, variables), port_model(cfg, variables)
    gens = {id(m.dropout_generator): m.dropout_generator
            for m in a.modules() if getattr(m, "dropout", 0)}
    assert len(gens) == 1
    first = a(batch)[0]
    assert torch.equal(first, b(batch)[0])
    assert not torch.equal(first, a(batch)[0])
    cfg0 = cfg.clone()
    cfg0.gnn.dropout = 0.0
    fresh, plain = port_model(cfg, variables), port_model(cfg0, variables)
    for m in (fresh, plain):
        m.eval()
    with torch.no_grad():
        assert torch.equal(fresh(batch)[0], plain(batch)[0])
    with pytest.raises(ValueError, match="dropout_generator"):
        layers.GeneralLayer(torch.nn.Identity(), 4, dropout=0.5)


# ------------------------------------------------------------- inits


def bound(shape, gain):
    field = math.prod(shape[:-2])
    return gain * math.sqrt(6.0 / ((shape[-2] + shape[-1]) * field))


@pytest.mark.parametrize("layer_type", ["ginconv", "ginidconv", "gatconv"])
def test_init_gains(layer_type):
    """xavier_uniform gains as the JAX package draws them: sqrt(2) on
    the pre-MP Linear, the head's MLP and ginconv's MLP (nn.Linear in
    the reference), 1 on conv internals (gatconv's kernel and its 3-D
    att) and ginidconv's MLP.  Each kernel of either package lies within
    its bound and reaches past 0.8 of it, so a gain-1 draw (0.71 of a
    gain-sqrt(2) bound) cannot pass for sqrt(2)."""
    _, variables, _, cfg, _ = model_pair(layer_type)
    model = build_model(cfg, CPU)
    jax_kernels = params_from_jax(variables["params"], model)
    root2 = math.sqrt(2)
    want = {"pre_mp.0.layer.kernel": root2,
            "post_mp.mlp.layers.0.layer.kernel": root2}
    for i in range(cfg.gnn.layers_mp):
        conv = f"mp.layers.{i}.layer."
        if layer_type == "gatconv":
            want[conv + "kernel"] = want[conv + "att"] = 1.0
        else:
            gain = root2 if layer_type == "ginconv" else 1.0
            for k in ("mlp_kernel1", "mlp_kernel2"):
                want[conv + k] = gain
            if layer_type == "ginidconv":
                want[conv + "mlp_id_kernel1"] = gain
                want[conv + "mlp_id_kernel2"] = gain
    params = dict(model.named_parameters())
    assert {n for n in params if "kernel" in n or n.endswith(".att")} \
        == set(want)
    for name, gain in want.items():
        lim = bound(tuple(params[name].shape), gain)
        for got in (params[name].detach(), jax_kernels[name]):
            top = got.abs().max().item()
            assert 0.8 * lim < top <= lim * (1 + 1e-6), (name, top, lim)


# ------------------------------------------------------ SAGEIDConv mean


def test_sageidconv_mean_is_the_jax_coo_mean():
    """K1 on the 'mean' pack gives the JAX COO mean, isolated nodes and
    padding rows included (both 0); SAGEIDConv holds the JAX layer's
    output and gradients on that graph; without a 'mean' pack it
    raises (no index_add fallback)."""
    from graphgym_tpu.graphs import container as jax_container
    from graphgym_tpu.graphs import packing as jax_packing
    from graphgym_tpu.nn import id_layers as jax_id_layers
    from graphgym_tpu.ops import sparse as jax_sp
    from graphgym_tpu_torch.graphs import packing
    from graphgym_tpu_torch.graphs.container import build_graph_batch

    s, r, w, n = random_graph(3, e=900, hot=500)
    real = (w != 0) & (s < 299) & (r < 299)
    s, r = s[real], r[real]
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(299, 8)).astype(np.float32)
    ids = rng.choice(299, 40, replace=False)
    id_index = np.concatenate([ids, np.full(8, n - 1)]).astype(np.int32)
    id_mask = np.arange(48) < 40
    batches = []
    for build, pk in ((jax_container.build_graph_batch, jax_packing),
                      (build_graph_batch, packing)):
        b = build(s, r, feat, pad_nodes_to=n, pad_edges_to=1000)
        b = b.replace(node_id_index=id_index, id_mask=id_mask)
        batches.append(b.replace(packs=pk.build_packs(
            b.senders, b.receivers, b.edge_weight, b.node_mask,
            b.num_nodes, kinds=("mean",))))
    jb, b = batches[0], batches[1].to(CPU)
    isolated = np.setdiff1d(np.arange(299), r)
    assert len(isolated) > 0 and n > 299
    want = np.asarray(jax_sp.spmm(jb.senders, jb.receivers, None,
                                  jb.node_feat, n, reduce="mean",
                                  edge_mask=jb.edge_mask))
    got = layers.packed_spmm(b, "mean", b.node_feat).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[isolated] == 0).all() and (got[299:] == 0).all()

    jmod = jax_id_layers.SAGEIDConv(16, use_bias=True)
    mod = id_layers.SAGEIDConv(8, 16, generator=torch.Generator())
    params = to_numpy(jmod.init(jax.random.PRNGKey(0), jb, False))["params"]
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    cot = rng.normal(size=(n, 16)).astype(np.float32)
    (_, want_out), grads = jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * cot), o))(
            jmod.apply({"params": p}, jb, True).node_feat),
        has_aux=True)(params)
    out = mod(b).node_feat
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **LOGIT_TOL)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[name]),
                                   err_msg=name, **GRAD_TOL)
    with pytest.raises(ValueError, match="'mean' pack"):
        mod(b.replace(packs=None))


# ------------------------------------------------------ not ported yet


@pytest.mark.parametrize("overrides,item", [
    (["gnn.layer_type", "generalogbconv", "dataset.edge_encoder", "True"],
     "A0"),
])
def test_not_ported_raises_naming_the_item(overrides, item):
    """What the port does not run raises naming its ROADMAP item:
    generalogbconv behind an edge encoder (the edge-feature convs, once
    here, build and train in tests/test_torch_edge_convs.py; tpu.remat
    in tests/test_torch_remat.py)."""
    from graphgym_tpu_torch.nn.model import options_from_cfg

    cfg = load_cfg(config_file("gcnidconv"),
                   ["gnn.layer_type", "gcnidconv", "device", "cpu"]
                   + overrides)
    cfg.share.dim_in, cfg.share.dim_out = 1, 6
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        options_from_cfg(cfg)
