"""The port's layers of graphgym_tpu/nn/att_layers.py that read no edge
features, and the Tfg APPNP model, against the JAX package's.

Each layer from the same parameters (copied in by name; the score bias,
the bias and APPNP's biases drawn from a seed, not left at their zero
init) on one random graph with padding nodes (test_torch_max's
``graph_pair``): 'gmulconv' (GeneralMulAttConv at 1 and 4 heads: the
SDDMM's score plus att_bias / sqrt(d), the JAX layer's (dot + att_bias)
/ sqrt(d) up to rounding, then the softmax and K3 on the 'att' pack),
'gaddconv' (the port's GATConv against GeneralAddAttConv),
'sageinitconv' with and without its L2 norm, and 'generalconv_v2' at
every agg x normalize_adj x flow (``v2_kind``'s packs).  Outputs at
rtol 1e-4 / atol 1e-5, input and parameter gradients at rtol 1e-3 /
atol 1e-5.  The JAX layers run their XLA path (COO gathers and segment
reductions); the port's its packs (the kernels' plain versions on the
CPU).

Model level: the Tfg APPNP model's logits, its Tfg loss (the masked
cross entropy plus 5e-4 x the kernels' l2_loss) and gradients; three
Adam steps, per-step losses within 2e-3, of round1att.txt's two
synthetic points (grids/design/round1att.txt:44-61 gmulconv, :82-99
gaddconv on the graph task; configs/design/design_v1att.yaml at
dim_inner 16, a regenerated scalefree corpus of 8 graphs, the graph
point at dropout 0 so the two packages draw no masks) and of Tfg-appnp
on configs/idgcn_ws.yaml (6 graphs a split).
"""

import functools
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
from graphgym_tpu.nn import att_layers as jax_att
from graphgym_tpu.nn import id_layers as jax_idl
from graphgym_tpu.nn import layers as jax_layers
from graphgym_tpu.nn import model as jax_model
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu.train.loss import LossOptions as JaxLossOptions
from graphgym_tpu.train.loss import compute_loss as jax_compute_loss
from graphgym_tpu.train.loss import kernel_l2 as jax_kernel_l2
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.graphs.packing import (build_packs, kinds_for_layer,
                                               v2_kind)
from graphgym_tpu_torch.nn import att_layers, id_layers, layers
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.nn.model import (LAYERS, GNNOptions,
                                         TfgAPPNPNet, build_model,
                                         options_from_cfg)
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss, kernel_l2
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_max import GRAD_TOL, LOGIT_TOL, N_PAD, graph_pair
from test_torch_torchpath import OneBatch, seeded_features, to_numpy
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOWS = ("source_to_target", "target_to_source")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def against_jax(jmod, mod, jb, b, drawn=()):
    """The layer's output and its gradients (parameters and input
    features) under a seeded cotangent, the JAX layer's parameters
    copied into the port's by name, those named in ``drawn`` first
    drawn from a seed."""
    params = to_numpy(jmod.init(jax.random.PRNGKey(0), jb, False))["params"]
    rng = np.random.default_rng(5)
    for name in drawn:
        params[name] = rng.normal(size=params[name].shape).astype(np.float32)
    mod.load_state_dict({k: torch.from_numpy(params[k])
                         for k in mod.state_dict()})
    cot = np.random.default_rng(9).normal(
        size=(N_PAD, mod.kernel.shape[1])).astype(np.float32)

    def jax_loss(p, x):
        out = jmod.apply({"params": p}, jb.replace(node_feat=x),
                         False).node_feat
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jb.node_feat)
    x = b.node_feat.clone().requires_grad_()
    out = mod(b.replace(node_feat=x)).node_feat
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   err_msg=name, **GRAD_TOL)
    return out


def layer(layer_type, heads=1, **opts):
    """The port's conv of ``layer_type`` as its model builds it (LAYERS),
    at width 6 -> 8, no BatchNorm (so a bias)."""
    o = GNNOptions(layer_type=layer_type, dim_in=6, dim_out=8,
                   att_heads=heads, batchnorm=False, **opts)
    return LAYERS[layer_type](6, 8, o, torch.Generator(), None)


@pytest.mark.parametrize("heads", [1, 4])
def test_gmulconv_matches_jax(heads):
    """GeneralMulAttConv (att_layers.py:82-115) at a drawn score bias:
    the score on the SDDMM plus att_bias / sqrt(d)."""
    jb, b = graph_pair(("att",))
    mod = layer("gmulconv", heads)
    assert isinstance(mod, att_layers.GeneralMulAttConv)
    against_jax(jax_att.GeneralMulAttConv(8, heads=heads, use_bias=True),
                mod, jb, b, drawn=("att_bias", "bias"))
    assert mod.att_bias.shape == (1, heads)


@pytest.mark.parametrize("heads", [1, 4])
def test_gaddconv_is_general_add_att_conv(heads):
    """'gaddconv' builds the port's GATConv, no attention dropout, and
    matches GeneralAddAttConv (att_layers.py:41-79), whose sums are
    XLA's segment_sum where the port's are K3."""
    jb, b = graph_pair(("att",))
    mod = layer("gaddconv", heads, att_dropout=0.5)
    assert type(mod) is layers.GATConv and mod.att_dropout == 0.0
    against_jax(jax_att.GeneralAddAttConv(8, heads=heads, use_bias=True),
                mod, jb, b, drawn=("bias",))


@pytest.mark.parametrize("normalize", [False, True])
def test_sageinitconv_matches_jax(normalize):
    """SAGEInitConv (att_layers.py:228-251): [x || mean_nb(x)] W + b on
    the 'mean' pack, with and without the L2 norm (a drawn bias, so no
    row is 0 where the JAX norm's gradient is NaN, ROADMAP C5)."""
    (kind,) = kinds_for_layer("sageinitconv")
    jb, b = graph_pair((kind,))
    mod = att_layers.SAGEInitConv(6, 8, normalize=normalize,
                                  generator=torch.Generator())
    against_jax(jax_att.SAGEInitConv(8, normalize=normalize), mod, jb, b,
                drawn=("bias",))
    built = layer("sageinitconv")
    assert built.bias is not None and not built.normalize


@pytest.mark.parametrize("flow", FLOWS)
@pytest.mark.parametrize("normalize_adj", [False, True])
@pytest.mark.parametrize("agg", ["add", "mean", "max"])
def test_generalconv_v2_matches_jax(agg, normalize_adj, flow):
    """GeneralConvV2 (att_layers.py:184-226) at every agg,
    normalize_adj and flow, on the pack v2_kind names: the directed
    norm's weights, the reversed edges for 'target_to_source'."""
    kinds = kinds_for_layer("generalconv_v2", agg, normalize_adj, flow)
    assert kinds == (v2_kind(agg, normalize_adj, flow),)
    jb, b = graph_pair(kinds)
    mod = layer("generalconv_v2", agg=agg, normalize_adj=normalize_adj,
                flow=flow)
    assert isinstance(mod, att_layers.GeneralConvV2) and mod.kind == kinds[0]
    against_jax(jax_att.GeneralConvV2(8, use_bias=True, agg=agg,
                                      normalize_adj=normalize_adj, flow=flow),
                mod, jb, b, drawn=("bias",))


def test_v2_kinds_and_the_reversed_packs():
    """The flipped flow's pack pair is the pair taken the other way
    round: rev_plain's fwd pack is plain's bwd pack and the other way;
    the directed norm's weights sum to 1 over each row with an
    in-edge."""
    want = {("add", False): "plain", ("max", False): "plain",
            ("mean", False): "mean", ("add", True): "dir",
            ("max", True): "dir", ("mean", True): "dir_mean"}
    for (agg, norm), kind in want.items():
        assert v2_kind(agg, norm, FLOWS[0]) == kind
        assert v2_kind(agg, norm, FLOWS[1]) == "rev_" + kind
    with pytest.raises(ValueError, match="flow"):
        v2_kind("add", False, "both")
    _, b = graph_pair()
    args = (b.senders.numpy(), b.receivers.numpy(), b.edge_weight.numpy(),
            b.node_mask.numpy(), N_PAD)
    packs = build_packs(*args, kinds=("plain", "rev_plain", "dir"))
    for got, want_pack in zip(packs["rev_plain"], packs["plain"][::-1]):
        for field, x, y in zip(got._fields, got, want_pack):
            assert np.array_equal(x, y), field
    fwd = packs["dir"][0]
    sums = np.zeros(N_PAD)
    rows = fwd.tiles[:, None] * K.ROWS_PER_TILE + fwd.local_rows
    np.add.at(sums, rows.reshape(-1), fwd.weights.reshape(-1))
    received = np.bincount(b.receivers.numpy()[b.edge_mask.numpy()],
                           minlength=N_PAD) > 0
    np.testing.assert_allclose(sums[received], 1.0, rtol=1e-6)
    assert not sums[~received].any()


def test_generalmulattconv_is_unknown_in_both():
    """configs/design/design_v1att.yaml names 'generalmulattconv', which
    neither package registers (the grid always sets the layer type):
    both raise 'Unknown layer type'."""
    cfg = load_cfg(os.path.join(ROOT, "configs", "design",
                                "design_v1att.yaml"), ["device", "cpu"])
    assert cfg.gnn.layer_type == "generalmulattconv"
    cfg.share.dim_in, cfg.share.dim_out = 1, 4
    with pytest.raises(ValueError, match="Unknown layer type"):
        options_from_cfg(cfg)
    with pytest.raises(ValueError, match="Unknown layer type"):
        jax_model.make_conv("generalmulattconv", 8, jax_get_cfg().gnn, True)


@pytest.mark.parametrize("cls,jax_cls", [
    (layers.GATConv, jax_layers.GATConv),
    (layers.TfgGATConv, jax_layers.TfgGATConv),
    (id_layers.GATIDConv, jax_idl.GATIDConv),
    (id_layers.TfgIDGAT, jax_idl.TfgIDGAT),
    (att_layers.GeneralMulAttConv, jax_att.GeneralMulAttConv)])
def test_heads_that_do_not_divide_the_width_raise(cls, jax_cls):
    """3 heads on a width of 8: the JAX layer asserts at init, the port
    raises ValueError naming the heads and the width."""
    jb, _ = graph_pair()
    if jax_cls in (jax_idl.GATIDConv, jax_idl.TfgIDGAT):
        jb = jb.replace(id_mask=jnp.ones(jb.node_id_index.shape, bool))
    with pytest.raises(AssertionError):
        jax_cls(8, heads=3).init(jax.random.PRNGKey(0), jb, False)
    with pytest.raises(ValueError, match="3 attention heads do not divide "
                                         "the width 8"):
        cls(6, 8, heads=3, generator=torch.Generator())


def test_params_from_jax_maps_the_new_leaves():
    """att_bias (gmulconv), self_kernel (generalconv_v2) and APPNP's
    kernel<i> / bias<i> land on the port's parameters."""
    jb, _ = graph_pair()
    for layer_type, leaves in (("gmulconv", {"kernel", "att_bias"}),
                               ("generalconv_v2", {"kernel", "self_kernel"}),
                               ("sageinitconv", {"kernel", "bias"})):
        jcfg, cfg = small_configs("idgcn_ws", [
            "gnn.layer_type", layer_type, "gnn.layers_mp", "1"])
        jcfg.share.dim_in = cfg.share.dim_in = 6
        jcfg.share.dim_out = cfg.share.dim_out = 3
        params = to_numpy(jax_build_model(jcfg).init(
            jax.random.PRNGKey(0), jb, False))["params"]
        conv = min(k for k in params["mp"]
                   if not k.startswith("GeneralLayer"))
        assert set(params["mp"][conv]) == leaves, conv
        state = params_from_jax(params, build_model(cfg, CPU))
        for leaf in leaves:
            np.testing.assert_array_equal(
                state[f"mp.layers.0.layer.{leaf}"].numpy(),
                params["mp"][conv][leaf])


# ------------------------------------------------------------ models


def small_configs(base, opts):
    cfg_file = os.path.join(ROOT, "configs", f"{base}.yaml")
    if base.startswith("design"):
        cfg_file = os.path.join(ROOT, "configs", "design", f"{base}.yaml")
    opts = list(opts) + ["gnn.dim_inner", "16"]
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla"])
    return jcfg, load_cfg(cfg_file, opts + ["device", "cpu"])


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")


ROUND1ATT = {
    # round1att.txt:44-61 (gmulconv on the node task) and :82-99
    # (gaddconv on the graph task) at scalefree, width 16
    "mul_node": ("dataset.task", "node", "dataset.augment_feature",
                 "['node_pagerank']", "dataset.augment_label",
                 "node_clustering_coefficient", "gnn.layer_type",
                 "gmulconv", "gnn.layers_pre_mp", "1", "gnn.layers_mp",
                 "4", "gnn.layers_post_mp", "1"),
    "add_graph": ("dataset.task", "graph", "dataset.augment_feature",
                  "['node_onehot']", "dataset.augment_label",
                  "graph_path_len", "gnn.layer_type", "gaddconv",
                  "gnn.layers_pre_mp", "2", "gnn.layers_mp", "2",
                  "gnn.layers_post_mp", "2", "gnn.stage_type", "skipsum",
                  "gnn.act", "prelu"),
}


@functools.lru_cache(maxsize=None)
def round1att_point(case, jdir, pdir):
    """Both packages' configs of a round1att point and the train batch
    of each, on a scalefree corpus each package regenerates for itself
    (8 graphs of 64 nodes, seed 0), seeded features on both."""
    jcfg, cfg = small_configs("design_v1att", [
        "dataset.format", "nx", "dataset.name", "scalefree",
        "dataset.transductive", "True", "optim.max_epoch", "3",
        *ROUND1ATT[case]])
    jcfg.merge_from_list(["dataset.dir", jdir])
    cfg.merge_from_list(["dataset.dir", pdir])
    with pytest.MonkeyPatch.context() as mp:
        for module in (syn, jax_syn):
            real = module.generate_syn_graphs
            mp.setattr(module, "generate_syn_graphs",
                       lambda kind, num_graphs, n, real=real: real(
                           kind=kind, num_graphs=8, n=n))
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [jdir])
        mp.setattr(loaders, "_REPO_DATASETS", pdir)
        mp.setattr(jax_native, "load", lambda: None)
        jbatch = jax_loaders.create_loader(
            jax_loaders.create_dataset(jcfg), jcfg)[0].batches(0)[0]
        lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    assert len(lds[0]) == 1
    jbatch, batch = seeded_features(jbatch, lds[0].batches(0)[0].to(CPU))
    return jcfg, cfg, jbatch, batch


@functools.lru_cache(maxsize=None)
def appnp_point():
    """Tfg-appnp on configs/idgcn_ws.yaml, 6 graphs a split: both
    packages' configs and train batches."""
    jcfg, cfg = small_configs("idgcn_ws", ["gnn.layer_type", "Tfg-appnp"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        jloaders = jax_loaders.create_loader(
            [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    lds = loaders.create_loader([p[:6] for p in loaders.create_dataset(cfg)],
                                cfg)
    assert len(lds[0]) == len(jloaders[0]) == 1
    return jcfg, cfg, jloaders[0].batches(0)[0], lds[0].batches(0)[0].to(CPU)


def test_appnp_logits_and_tfg_loss_match_jax():
    """TfgAPPNPNet (nn/model.py:419-434): the logits at the supervised
    nodes, the Tfg loss (masked cross entropy + 5e-4 x the kernel L2,
    which takes kernel0 and kernel1) and every gradient; seeded
    features on both sides."""
    jcfg, cfg, jbatch, batch = appnp_point()
    jbatch, batch = seeded_features(jbatch, batch)
    jmodel = jax_build_model(jcfg)
    params = to_numpy(jmodel.init(jax.random.PRNGKey(0), jbatch,
                                  False))["params"]
    rng = np.random.default_rng(2)
    for name in ("bias0", "bias1"):
        params["APPNP_0"][name] = rng.normal(
            size=params["APPNP_0"][name].shape).astype(np.float32)

    def jax_loss(p):
        pred, label, mask = jmodel.apply({"params": p}, jbatch, True)
        loss, _ = jax_compute_loss(pred, label, mask, JaxLossOptions())
        return loss + jax_kernel_l2(p, 5e-4), pred

    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params)
    model = build_model(cfg, CPU)
    assert isinstance(model, TfgAPPNPNet)
    assert {k for k, _ in model.named_parameters()} == {
        "appnp.kernel0", "appnp.bias0", "appnp.kernel1", "appnp.bias1"}
    model.load_state_dict(params_from_jax(params, model))
    pred, label, mask = model(batch)
    loss, _ = compute_loss(pred, label, mask, LossOptions())
    loss = loss + kernel_l2(model, 5e-4)
    loss.backward()
    assert pred.shape[1] == cfg.share.dim_out
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(to_numpy(grads), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_appnp_is_a_node_model():
    """Tfg-appnp, as every Tfg model, takes node tasks only."""
    _, cfg, _, _ = appnp_point()
    cfg = cfg.clone()
    cfg.dataset.task = "graph"
    with pytest.raises(NotImplementedError, match="Tfg"):
        build_model(cfg, CPU)


def three_steps(jcfg, cfg, jbatch, batch, l2_kernel):
    """Three Adam steps of each package on its train batch from the same
    parameters and statistics: per-step losses within 2e-3, the logged
    lrs."""
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        model))
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    assert tr.loss_opts.l2_kernel == l2_kernel
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert all(map(np.isfinite, rec.losses))
    return model


@pytest.mark.parametrize("case", sorted(ROUND1ATT))
def test_round1att_three_steps_match_jax(case, corpus_dirs):
    model = three_steps(*round1att_point(case, *map(str, corpus_dirs)),
                        l2_kernel=0.0)
    conv = model.mp.layers[0].layer
    assert type(conv) is (att_layers.GeneralMulAttConv if case == "mul_node"
                          else layers.GATConv)


def test_appnp_three_steps_match_jax():
    three_steps(*appnp_point(), l2_kernel=5e-4)
