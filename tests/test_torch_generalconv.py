"""The port's GraphGym GeneralConv, GeneralIDConv (idconv), ExampleConv
and 'max' aggregation, its SGD and its contrib example, against the JAX
package's.

Inputs come from a numpy seed and go through both packages.  The JAX
layers run their XLA path (graphgym_tpu/ops/sparse.py's COO spmm:
segment_sum / segment_mean / segment_max; they have no Pallas route);
the port's run on its packs (K1 for add and mean, the segmented max's
plain version for max, on the CPU).  Layer outputs are held at rtol
1e-4 / atol 1e-5, gradients at rtol 1e-3 / atol 1e-5, and the losses of
three train steps of a small design point (dim_inner 16, l_mp 2, a
regenerated scalefree corpus of 8 graphs) within 2e-3.  The max itself
and its kernel are tests/test_torch_max.py's.
"""

import functools
import logging
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import graphgym_tpu.data.synthetic as jax_syn
import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.nn import att_layers as jax_att
from graphgym_tpu.nn import id_layers as jax_idl
from graphgym_tpu.nn import layers as jax_layers
from graphgym_tpu.nn import model as jax_model
from graphgym_tpu.nn import norm as jax_norm
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu.train.optim import create_optimizer as jax_optimizer
from graphgym_tpu_torch import register
from graphgym_tpu_torch.config import get_cfg, load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.graphs.packing import kinds_for_layer
from graphgym_tpu_torch.nn import att_layers, id_layers, layers
from graphgym_tpu_torch.nn.act import act_dict
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.nn.norm import l2_normalize
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.optim import SGD, create_optimizer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_max import GRAD_TOL, LOGIT_TOL, N_PAD, N_REAL, graph_pair
from test_torch_torchpath import OneBatch, seeded_features
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def layer_against_jax(jmod, mod, jb, b, names=None):
    """The layer's output and its gradients (parameters and input
    features) under a seeded cotangent, the JAX layer's parameters
    copied into the port's (``names``: port name -> flax name)."""
    params = to_numpy(jmod.init(jax.random.PRNGKey(0), jb, False))["params"]
    names = names or {k: k for k in params}
    mod.load_state_dict({k: torch.from_numpy(params[names[k]])
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
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(gp[names[name]]),
                                   err_msg=name, **GRAD_TOL)
    return out


@pytest.mark.parametrize("normalize_adj", [False, True])
@pytest.mark.parametrize("self_msg", ["none", "add", "concat"])
@pytest.mark.parametrize("agg", ["add", "mean", "max"])
def test_general_conv_matches_jax(agg, self_msg, normalize_adj):
    """GeneralConv (layers.py:606-652) at every agg, self_msg and
    normalize_adj: output, input and parameter gradients."""
    kinds = kinds_for_layer("generalconv", agg, normalize_adj)
    jb, b = graph_pair(kinds)
    jmod = jax_layers.GeneralConv(8, use_bias=True, agg=agg,
                                  self_msg=self_msg,
                                  normalize_adj=normalize_adj)
    mod = layers.GeneralConv(6, 8, use_bias=True, agg=agg,
                             self_msg=self_msg, normalize_adj=normalize_adj,
                             generator=torch.Generator())
    out = layer_against_jax(jmod, mod, jb, b)
    assert hasattr(mod, "self_kernel") == (self_msg == "concat")
    # padding rows: no message, so only the bias (and self terms of 0)
    np.testing.assert_allclose(out[N_REAL:].detach().numpy(),
                               np.broadcast_to(mod.bias.detach().numpy(),
                                               (N_PAD - N_REAL, 8)))
    with pytest.raises(ValueError, match=f"'{kinds[0]}' pack"):
        mod(b.replace(packs=None))


@pytest.mark.parametrize("normalize_adj", [False, True])
@pytest.mark.parametrize("agg", ["add", "mean", "max"])
def test_general_id_conv_matches_jax(agg, normalize_adj):
    """GeneralIDConv (id_layers.py:75-105): the id-colored projection,
    then the aggregation."""
    jb, b = graph_pair(kinds_for_layer("idconv", agg, normalize_adj))
    jmod = jax_idl.GeneralIDConv(8, use_bias=True, agg=agg,
                                 normalize_adj=normalize_adj)
    mod = id_layers.GeneralIDConv(6, 8, use_bias=True, agg=agg,
                                  normalize_adj=normalize_adj,
                                  generator=torch.Generator())
    layer_against_jax(jmod, mod, jb, b)


@pytest.mark.parametrize("use_bias", [True, False])
def test_example_conv_matches_jax(use_bias):
    """ExampleConv (att_layers.py:313-330), the contrib layer's class:
    h + the sum over in-edges, on the 'plain' pack."""
    jb, b = graph_pair(("plain",))
    mod = att_layers.ExampleConv(6, 8, use_bias=use_bias,
                                 generator=torch.Generator())
    layer_against_jax(jax_att.ExampleConv(8, use_bias=use_bias), mod, jb, b)
    assert (mod.bias is not None) == use_bias


# ------------------------------------------------------------ SGD


@pytest.mark.parametrize("momentum,weight_decay,scheduler", [
    (0.9, 5e-4, "cos"), (0.0, 0.0, "none"), (0.5, 1e-2, "steps")])
def test_sgd_matches_optax(momentum, weight_decay, scheduler):
    """SGD over 5 steps against the JAX package's optax chain
    (add_decayed_weights -> trace -> lr; train/optim.py:51-58), the lr
    stepped per optimizer step by each schedule; the same gradients for
    both, drawn from a seed."""
    optim = jax_get_cfg().optim
    optim.merge_from_dict(dict(optimizer="sgd", base_lr=0.1,
                               momentum=momentum, weight_decay=weight_decay,
                               scheduler=scheduler, max_epoch=2,
                               steps=[1]))
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = jax_optimizer(optim, steps_per_epoch=3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    update = jax.jit(lambda g, st, p: (lambda u, st: (
        optax.apply_updates(p, u), st))(*tx.update(g, st, p)))
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt, sched = create_optimizer(list(params.values()), optim, 3)
    assert isinstance(opt, SGD)
    for g in grads:
        jp, state = update({k: jnp.asarray(v) for k, v in g.items()},
                           state, jp)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    state = opt.state[params["a"]]
    assert ("momentum_buffer" in state) == (momentum > 0)


def test_sgd_takes_a_tensor_lr():
    """A 0-d tensor lr (the captured step's) updates as the float one
    does, and the schedule fills it in place."""
    runs = []
    for lr in (0.1, torch.tensor(0.1)):
        p = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
        opt = SGD([p], lr=lr, momentum=0.9, weight_decay=1e-3)
        for step in range(3):
            p.grad = torch.full_like(p, float(step + 1))
            opt.step()
        runs.append(p.detach().clone())
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-6, atol=0)
    cfg = get_cfg()
    cfg.optim.optimizer = "sgd"
    cfg.optim.scheduler = "cos"
    lr = torch.tensor(0.0)
    p = torch.nn.Parameter(torch.zeros(2))
    opt, sched = create_optimizer([p], cfg.optim, 4)
    opt.param_groups[0]["lr"] = lr
    sched.step()
    assert opt.param_groups[0]["lr"] is lr and lr.item() == pytest.approx(
        sched.lr(1))
    cfg.optim.optimizer = "rmsprop"
    with pytest.raises(NotImplementedError, match="A15b"):
        create_optimizer([p], cfg.optim, 4)


# ------------------------------------------------------- contrib


def test_contrib_registers_on_get_cfg():
    """get_cfg imports the port's contrib: the 'example' group, 'swish'
    (F.silu), the 'node_degree_example' augment and the
    'contrib_example' layer resolve."""
    cfg = get_cfg()
    assert cfg.example.sample_arg == 10
    assert "swish" in act_dict
    x = torch.linspace(-3, 3, 7)
    torch.testing.assert_close(act_dict["swish"](x), x * torch.sigmoid(x))
    np.testing.assert_allclose(
        np.asarray(act_dict["swish"](x)),
        np.asarray(jax.nn.silu(jnp.asarray(x.numpy()))), rtol=1e-6)
    assert "node_degree_example" in register.feature_augment_dict
    assert "contrib_example" in register.layer_dict


def test_failed_contrib_import_is_logged(monkeypatch, caplog):
    """A contrib package that fails to import is logged, not raised, as
    in the JAX package (config.py:330-333)."""
    monkeypatch.setitem(sys.modules, "graphgym_tpu_torch.contrib", None)
    with caplog.at_level(logging.WARNING):
        get_cfg()
    assert "contrib import failed" in caplog.text


# ------------------------------------------------ the design points


@pytest.fixture(scope="module")
def corpus_dirs(tmp_path_factory):
    return tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")


DESIGN = {
    # grids/design/round1.txt's synthetic node chunks, cut to width 16,
    # one pre-MP layer and two MP layers, dropout 0
    "add_adam": ("dataset.augment_feature", "['node_pagerank']",
                 "gnn.act", "prelu", "gnn.agg", "add"),
    "mean_sgd_swish": ("dataset.augment_feature", "['node_pagerank']",
                       "gnn.stage_type", "skipconcat", "gnn.batchnorm",
                       "False", "gnn.act", "swish", "gnn.agg", "mean",
                       "optim.optimizer", "sgd", "optim.base_lr", "0.1"),
    "max": ("dataset.augment_feature", "['node_const']", "gnn.stage_type",
            "skipsum", "gnn.agg", "max", "optim.base_lr", "0.001"),
}


@functools.lru_cache(maxsize=None)
def design_point(case, jdir, pdir):
    """Both packages' configs of a design point (configs/design/
    design_v1.yaml with the grid's overrides) and the train batch of
    each, on a scalefree corpus each package regenerates for itself (8
    graphs of 64 nodes, seed 0), seeded features on both."""
    cfg_file = os.path.join(ROOT, "configs", "design", "design_v1.yaml")
    opts = ["dataset.format", "nx", "dataset.name", "scalefree",
            "dataset.augment_label", "node_clustering_coefficient",
            "train.batch_size", "64", "gnn.layers_mp", "2",
            "gnn.dim_inner", "16", "optim.max_epoch", "3",
            *DESIGN[case]]
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


def jax_l2_normalize_clamped(x, axis=-1, eps=1e-12):
    """The JAX package's l2_normalize with the port's clamp of the sum of
    squares (F.normalize's gradient at a zero row: no NaN)."""
    xs = x.astype(jnp.float32)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(xs * xs, axis=axis, keepdims=True),
                                eps * eps))
    return (xs / norm).astype(x.dtype)


def test_l2_normalize_zero_rows():
    """ROADMAP C5: at an all-zero row the JAX package's l2_normalize
    (clamp after the square root) has a NaN gradient, 0 * inf; the
    port's clamps the sum of squares first and gives F.normalize's
    gradient.  Elsewhere the two agree in value and gradient."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    x[2] = 0
    cot = rng.normal(size=(6, 4)).astype(np.float32)
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda v: jnp.sum(jax_norm.l2_normalize(v) * cot)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = (l2_normalize(xt) * torch.from_numpy(cot)).sum()
    got.backward()
    ref = torch.from_numpy(x).requires_grad_()
    (torch.nn.functional.normalize(ref) * torch.from_numpy(cot)).sum() \
        .backward()
    assert np.isnan(np.asarray(want_grad)[2]).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    real = np.arange(6) != 2
    np.testing.assert_allclose(xt.grad.numpy()[real],
                               np.asarray(want_grad)[real], **GRAD_TOL)
    torch.testing.assert_close(xt.grad, ref.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(DESIGN))
def test_design_point_three_steps_match_jax(case, corpus_dirs, monkeypatch):
    """Three train steps of a design point from the same parameters
    (params_from_jax), each package on its own batch: per-step losses
    within 2e-3 and the logged lrs; the model's conv and optimizer are
    the point's.  Without BatchNorm the padding rows stay 0 up to the
    stage's L2 norm, where the JAX package's gradient is NaN (C5): that
    point's JAX side takes the clamped l2_normalize, as the port does."""
    jcfg, cfg, jbatch, batch = design_point(case, *map(str, corpus_dirs))
    if not cfg.gnn.batchnorm:
        monkeypatch.setattr(jax_model, "l2_normalize",
                            jax_l2_normalize_clamped)
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        model))
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    assert isinstance(model.mp.layers[0].layer, layers.GeneralConv)
    assert isinstance(tr.optimizer, SGD) == ("sgd" in case)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert all(map(np.isfinite, rec.losses))


def test_params_from_jax_maps_the_general_convs(corpus_dirs):
    """kernel, self_kernel, id_kernel and bias of GeneralConv,
    GeneralIDConv and the contrib ExampleConv (flax names
    ``mp/<Class>_<i>/<leaf>``) land on the port's layers."""
    jdir, pdir = map(str, corpus_dirs)
    jcfg, cfg, jbatch, _ = design_point("add_adam", jdir, pdir)
    for layer_type, extra, leaves in (
            ("generalconv", ("gnn.batchnorm", "False"),
             {"kernel", "self_kernel", "bias"}),
            ("idconv", (), {"kernel", "id_kernel"}),
            ("contrib_example", ("gnn.batchnorm", "False"),
             {"kernel", "bias"})):
        jc, c = jcfg.clone(), cfg.clone()
        for conf in (jc, c):
            conf.merge_from_list(["gnn.layer_type", layer_type, *extra])
        jb = jbatch
        if layer_type == "idconv":
            jb = jbatch.replace(node_id_index=jnp.arange(4),
                                id_mask=jnp.ones(4, bool))
        params = to_numpy(jax_build_model(jc).init(
            jax.random.PRNGKey(0), jb, False))["params"]
        model = build_model(c, CPU)
        state = params_from_jax(params, model)
        conv = min(k for k in params["mp"]
                   if not k.startswith("GeneralLayer"))
        assert set(params["mp"][conv]) == leaves, conv
        for leaf in leaves:
            np.testing.assert_array_equal(
                state[f"mp.layers.0.layer.{leaf}"].numpy(),
                params["mp"][conv][leaf])
