"""The port's Tfg attention models (Tfg-idgat, Tfg-gatconv) against the
JAX package's, with the flax parameters carried over by
params_from_jax: logits (rtol 1e-4, atol 1e-5), loss (rtol 1e-5),
every parameter gradient (rtol 1e-3, atol 1e-5), the kernel-L2 set,
and two epochs of training (per-step losses within 2e-3).

Setup (as tests/test_torch_model.py): ws, 6 graphs per split, 2 layers,
dim_inner 16, heads 1 and 2; each layer type with its config's
transform (ego for Tfg-idgat, none for Tfg-gatconv).  The JAX side runs
its numpy host paths and the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu.train.loss import LossOptions as JaxLossOptions
from graphgym_tpu.train.loss import compute_loss as jax_compute_loss
from graphgym_tpu.train.loss import kernel_l2 as jax_kernel_l2
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss, kernel_l2
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
TRANSFORM = {"Tfg-idgat": "ego", "Tfg-gatconv": "none"}
CASES = [("Tfg-idgat", 1), ("Tfg-idgat", 2), ("Tfg-gatconv", 1),
         ("Tfg-gatconv", 2)]


def setup_dict(layer_type, heads, **optim):
    return {
        "dataset": {"format": "nx", "name": "ws", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 4,
                    "transform": TRANSFORM[layer_type]},
        "gnn": {"layers_mp": 2, "dim_inner": 16, "layer_type": layer_type,
                "att_heads": heads},
        "train": {"batch_size": 8},
        "optim": {"scheduler": "none", **optim},
    }


def configs(setup):
    jcfg = jax_get_cfg()
    jcfg.merge_from_dict(setup)
    jcfg.merge_from_dict({"tpu": {"spmm_impl": "pallas"}})
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu"})
    return jcfg, cfg


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{lt}-h{h}" for lt, h in CASES])
def model_pair(request):
    layer_type, heads = request.param
    jcfg, cfg = configs(setup_dict(layer_type, heads))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        jsplits = [p[:6] for p in jax_loaders.create_dataset(jcfg)]
        jbatch = jax_loaders.create_loader(jsplits, jcfg)[1].batches(0)[0]
    splits = [p[:6] for p in loaders.create_dataset(cfg)]
    batch = loaders.create_loader(splits, cfg)[1].batches(0)[0]
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jbatch, False)["params"]
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(to_numpy(params), model))
    return layer_type, jmodel, params, jbatch, model, batch.to(CPU)


def test_params_from_jax_maps_attention_layers(model_pair):
    layer_type, _, params, _, model, _ = model_pair
    cls = {"Tfg-idgat": "TfgIDGAT", "Tfg-gatconv": "TfgGATConv"}[layer_type]
    assert sorted(params["mp"]) == [f"{cls}_0", f"{cls}_1"]
    leaves = ["bias", "kernel", "key_bias", "key_kernel", "query_bias",
              "query_kernel"]
    if layer_type == "Tfg-idgat":
        leaves = sorted(leaves + ["id_kernel"])
    assert sorted(params["mp"][f"{cls}_1"]) == leaves
    state = params_from_jax(to_numpy(params), model)
    np.testing.assert_array_equal(
        state["mp.layers.1.layer.query_kernel"].numpy(),
        np.asarray(params["mp"][f"{cls}_1"]["query_kernel"]))


def test_logits_match_jax(model_pair):
    _, jmodel, params, jbatch, model, batch = model_pair
    want, wlabel, wmask = jmodel.apply({"params": params}, jbatch, False)
    model.eval()
    got, label, mask = model(batch)
    assert got.shape == want.shape
    np.testing.assert_array_equal(label.numpy(), np.asarray(wlabel))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_gradients_match_jax(model_pair):
    layer_type, jmodel, params, jbatch, model, batch = model_pair

    def jax_loss(p):
        pred, label, mask = jmodel.apply({"params": p}, jbatch, True)
        loss, _ = jax_compute_loss(pred, label, mask, JaxLossOptions())
        return loss + jax_kernel_l2(p, 5e-4)

    want_loss, jgrads = jax.value_and_grad(jax_loss)(params)
    model.train()
    model.zero_grad()
    pred, label, mask = model(batch)
    loss, _ = compute_loss(pred, label, mask, LossOptions())
    loss = loss + kernel_l2(model, 5e-4)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = params_from_jax(to_numpy(jgrads), model)
    per_layer = 7 if layer_type == "Tfg-idgat" else 6
    assert len(want) == 2 * per_layer + 4
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_kernel_l2_matches_jax(model_pair):
    layer_type, _, params, _, model, _ = model_pair
    want = float(jax_kernel_l2(params, 5e-4))
    got = kernel_l2(model, 5e-4).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    per_layer = 4 if layer_type == "Tfg-idgat" else 3
    names = [n for n, _ in model.named_parameters() if "kernel" in n]
    assert len(names) == 2 * per_layer + 2


def test_heads_must_divide_width():
    """As the JAX layer asserts: a ValueError naming heads and width."""
    _, cfg = configs(setup_dict("Tfg-idgat", 3))
    cfg.share.dim_in, cfg.share.dim_out = 1, 4
    with pytest.raises(ValueError, match="3 attention heads do not divide "
                                         "the width 16"):
        build_model(cfg, CPU)


def test_att_dropout_generator_only_when_asked():
    _, cfg = configs(setup_dict("Tfg-idgat", 1))
    cfg.share.dim_in, cfg.share.dim_out = 1, 4
    convs = [m.layer for m in build_model(cfg, CPU).mp.layers]
    assert all(c.dropout_generator is None for c in convs)
    cfg.gnn.att_dropout = 0.25
    convs = [m.layer for m in build_model(cfg, CPU).mp.layers]
    gen = convs[0].dropout_generator
    assert gen is not None and all(c.dropout_generator is gen
                                   for c in convs)
    assert gen.initial_seed() == cfg.seed


def test_two_epochs_match_jax(monkeypatch):
    """Tfg-idgat training, two epochs from the same parameters: the
    check of tests/test_torch_train.py."""
    monkeypatch.setattr(jax_native, "load", lambda: None)
    jcfg, cfg = configs(setup_dict("Tfg-idgat", 1, scheduler="cos",
                                   max_epoch=2))
    jloaders = jax_loaders.create_loader(
        [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, jtr.state.params), model))
    tr = Trainer(model, lds, cfg, CPU)

    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(2):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 2 * len(lds[0])
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert abs(tr.eval_epoch(None, 1) - jtr.eval_epoch(None, 1)) < 5e-3


def test_att_path_shapes():
    """configs/idgat_ws.yaml's batches at the shapes PERF.md records:
    one batch per split, and the 'att' packs with their slot maps."""
    import os

    from graphgym_tpu_torch.config import load_cfg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_cfg(os.path.join(root, "configs", "idgat_ws.yaml"),
                   ["device", "cpu"])
    lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    want = [(49152, 42442, 448, 181008, 1536, 1408),
            (10240, 10054, 96, 43304, 384, 384)]
    for ld, (n, real, chunks, valid, labels, real_labels) in zip(lds, want):
        (b,) = ld.batches(0)
        fwd, bwd, slot_map = b.packs["att"]
        assert (b.num_nodes, int(b.node_mask.sum())) == (n, real)
        assert fwd.senders.shape == bwd.senders.shape == slot_map.shape \
            == (chunks, 1024)
        assert int((fwd.weights > 0).sum()) == valid
        ranges = fwd.row_range[:, 1] - fwd.row_range[:, 0]
        assert int(ranges.sum()) == valid
        assert b.node_label_index.shape == (labels,)
        assert int(b.label_mask.sum()) == int(b.id_mask.sum()) == real_labels
