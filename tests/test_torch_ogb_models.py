"""graph_ogb.txt's molhiv ID point and an ogbn-arxiv design point through
both packages, on small stand-ins in OGB's raw layout.

``ogbg_molhiv_gcnid`` (configs/design/design_v2ogb.yaml with
grids/IDGNN/graph_ogb.txt:21-33 at gcnidconv: the Atom encoder and its
BatchNorm, ego at r = layers_mp, add pooling of the ego centers) and
``ogbn_arxiv_design`` (configs/design/design_v2.yaml on ogbn-arxiv, full
batch, the official time split), each at 2 MP layers and width 16
(encoder_dim 16): the loaders' batches equal the JAX package's; from
carried parameters the train-mode logits and every gradient hold the
usual tolerances (rtol 1e-4 / atol 1e-5, rtol 1e-3 / atol 1e-5), and
three Adam steps stay within 2e-3 of the JAX package's losses; ``main``
trains each point on the CPU.  design_v2ogb.yaml as written
(generalogbconv, 5 MP layers) fails in both packages: the JAX package
asserts that generalogbconv needs integer edge features, which its
ogbg loader never reads, and the port's layer raises naming them at
its first call.
The grid's dataset.feature_encoder_name merges as a new key that
neither package reads.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loss import LossOptions as JaxLossOptions
from graphgym_tpu.train.loss import compute_loss as jax_compute_loss
from graphgym_tpu_torch import main as port_main
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, standins
from graphgym_tpu_torch.exp import parity
from graphgym_tpu_torch.graphs.packing import NODE_ENCODER
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_att_layers import three_steps
from test_torch_real_configs import assert_batches_equal

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
MOLHIV = dict(graphs=40, split=(24, 8, 8))
ARXIV = dict(nodes=500, edges=2000, features=12, classes=5,
             split=(250, 100, 150))
SMALL = ("gnn.layers_mp", "2", "gnn.dim_inner", "16", "dataset.encoder_dim",
         "16", "train.batch_size", "8")


@pytest.fixture(scope="module")
def ogb_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ogb"))
    standins.write_molhiv_standin(d, seed=5, **MOLHIV)
    standins.write_arxiv_standin(d, seed=6, **ARXIV)
    return d


def point_opts(point, d):
    cfg_file, opts = parity.point_config(point)
    return cfg_file, opts + list(SMALL) + ["dataset.dir", d]


@functools.lru_cache(maxsize=None)
def point_data(point, d):
    cfg_file, opts = point_opts(point, d)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla"])
    cfg = load_cfg(cfg_file, opts + ["device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
    return jcfg, cfg, jlds, loaders.create_loader(
        loaders.create_dataset(cfg), cfg)


POINTS = ("ogbg_molhiv_gcnid", "ogbn_arxiv_design")


@pytest.mark.parametrize("point", POINTS)
def test_point_batches_match_jax(ogb_dir, point):
    jcfg, cfg, jlds, lds = point_data(point, ogb_dir)
    assert (cfg.share.dim_in, cfg.share.dim_out) == (jcfg.share.dim_in,
                                                     jcfg.share.dim_out)
    for jld, ld in zip(jlds, lds):
        jbs, bs = jld.batches(0), ld.batches(0)
        assert len(bs) == len(jbs) >= 1
        for jb, b in zip(jbs, bs):
            assert_batches_equal(jb, b)
            assert (NODE_ENCODER in b.packs) == (point == POINTS[0])
    if point == POINTS[0]:
        assert cfg.dataset.transform == "ego" and cfg.share.dim_in == 9
        assert cfg.dataset.feature_encoder_name == "Atom"
        assert len(lds[0]) == 3                  # 24 train graphs, batch 8
    else:
        assert cfg.share.dim_out == ARXIV["classes"]


@pytest.mark.parametrize("point", POINTS)
def test_point_logits_and_gradients_match_jax(ogb_dir, point):
    """Train mode on the first train batch from carried parameters and
    batch statistics: the logits, the loss and every gradient."""
    jcfg, cfg, jlds, lds = point_data(point, ogb_dir)
    jb, b = jlds[0].batches(0)[0], lds[0].batches(0)[0]
    jmodel = jax_build_model(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jb, False))

    def jax_loss(p):
        (pred, label, mask), _ = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, jb,
            True, mutable=["batch_stats"])
        return jax_compute_loss(pred, label, mask, JaxLossOptions())[0], pred

    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables["params"])
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(variables, model))
    model.train()
    pred, label, mask = model(b.to(CPU))
    loss, _ = compute_loss(pred, label, mask, LossOptions())
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                                 model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("point", POINTS)
def test_point_three_steps_match_jax(ogb_dir, point):
    jcfg, cfg, jlds, lds = point_data(point, ogb_dir)
    three_steps(jcfg, cfg, jlds[0].batches(0)[0],
                lds[0].batches(0)[0].to(CPU), l2_kernel=0.0)


@pytest.mark.parametrize("point", POINTS)
def test_main_trains_the_point_on_the_cpu(ogb_dir, point, tmp_path):
    cfg_file, opts = point_opts(point, ogb_dir)
    out = str(tmp_path / "out")
    port_main.main(["--cfg", cfg_file, *opts, "device", "cpu",
                    "optim.max_epoch", "2", "train.eval_period", "1",
                    "out_dir", out])
    name = os.path.splitext(os.path.basename(cfg_file))[0]
    with open(os.path.join(out, name, "1", "train", "stats.json")) as f:
        stats = [json.loads(line) for line in f if line.strip()]
    assert len(stats) == 2 and all(np.isfinite(s["loss"]) for s in stats)


def test_design_v2ogb_as_written_fails_in_both(ogb_dir):
    cfg_file = os.path.join(ROOT, "configs", "design", "design_v2ogb.yaml")
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(cfg_file)
    jcfg.merge_from_list(["dataset.dir", ogb_dir, "gnn.dim_inner", "16",
                          "dataset.encoder_dim", "16",
                          "tpu.spmm_impl", "xla"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
    jb = jlds[0].batches(0)[0]
    assert jb.edge_feat is None
    with pytest.raises(AssertionError, match="generalogbconv needs "
                                             "integer edge features"):
        jax_build_model(jcfg).init(jax.random.PRNGKey(0), jb, False)
    cfg = load_cfg(cfg_file, ["dataset.dir", ogb_dir, "device", "cpu",
                              "gnn.dim_inner", "16", "dataset.encoder_dim",
                              "16"])
    splits = loaders.create_dataset(cfg)
    assert all("edge_feature" not in g for part in splits for g in part)
    b = loaders.create_loader(splits, cfg)[0].batches(0)[0]
    assert b.edge_feat is None and "edge_bond" not in b.packs
    with pytest.raises(ValueError, match="generalogbconv needs integer "
                                         "edge features"):
        build_model(cfg, CPU)(b.to(CPU))
