"""The port's registries of stages, networks, optimizers and schedulers,
its embedding view and the tensorboard copy of the seed aggregate,
against the JAX package where it has the same.

- A scheduler registered in both packages' ``scheduler_dict``: three
  Adam steps from the same parameters give the JAX package's losses
  within 2e-3 and its learning rates.
- A registered optimizer (torch's RMSprop, which is not capturable)
  trains in the Trainer, and its steps equal the same optimizer run
  directly; ``capturable`` tells it from the port's own optimizers on a
  tensor lr.  An unknown optimizer raises ValueError, as in the JAX
  package.
- A stage registered in ``stage_dict`` builds the MP stage; a network
  registered in ``network_dict`` under model.type builds the model.
- ``view_emb``: the saved .npz projection (matplotlib hidden) equals
  the JAX package's from the same parameters, rtol 1e-4 / atol 1e-5, up
  to the sign of each PCA axis.
- ``agg_runs(tensorboard=True)`` writes the same aggregate files as the
  JAX package's with tensorboardX missing, and adds its event files
  where tensorboardX imports.
"""

import filecmp
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

import graphgym_tpu.native as jax_native
from graphgym_tpu import register as jax_register
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.exp import agg as jax_agg
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch import register
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.exp import agg
from graphgym_tpu_torch.nn.model import GNN, GNNStackStage, build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import compute_loss
from graphgym_tpu_torch.train.optim import SGD, capturable, create_optimizer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_torchpath import OneBatch
from test_torch_train import StepRecorder, setup_dict

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def both_loaders(setup):
    """Both packages' cfgs and loaders of ``setup`` on the first 6 ws
    graphs of each split."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_dict(setup)
    jcfg.merge_from_dict({"tpu": {"spmm_impl": "pallas"}})
    jlds = jax_loaders.create_loader(
        [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu"})
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    return jcfg, jlds, cfg, lds


def halving(optim_cfg, steps_per_epoch):
    """A schedule both packages take: base_lr / (1 + step)."""
    return lambda step: optim_cfg.base_lr / (1.0 + step)


def test_registered_scheduler_matches_jax(monkeypatch):
    """Three steps of ID-GCN (Tfg) on ws under a registered schedule:
    losses within 2e-3 of the JAX package's, the logged lrs its."""
    monkeypatch.setitem(jax_register.scheduler_dict, "halving", halving)
    monkeypatch.setitem(register.scheduler_dict, "halving", halving)
    setup = setup_dict("halving", 8)
    setup["optim"]["max_epoch"] = 3
    jcfg, jlds, cfg, lds = both_loaders(setup)
    assert len(lds[0]) == len(jlds[0]) == 1
    jtr = JaxTrainer(jax_build_model(jcfg), jlds, jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, jtr.state.params), model))
    tr = Trainer(model, lds, cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert rec.lrs == pytest.approx([0.01, 0.005, 0.01 / 3], rel=1e-6)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    assert tr.scheduler.lr(7) == pytest.approx(0.01 / 8)


def rmsprop(params, optim_cfg):
    return torch.optim.RMSprop(params, lr=optim_cfg.base_lr, alpha=0.9,
                               weight_decay=optim_cfg.weight_decay)


def test_registered_optimizer_trains_as_run_directly(monkeypatch):
    """A registered RMSprop (no capturable step) in the Trainer: three
    steps of gcnidconv on ws equal, bitwise, the same optimizer stepped
    directly on the same batch from the same parameters."""
    monkeypatch.setitem(register.optimizer_dict, "rmsprop", rmsprop)
    setup = setup_dict("none", 8)
    setup["gnn"]["layer_type"] = "gcnidconv"
    setup["optim"].update(optimizer="rmsprop", base_lr=0.003,
                          weight_decay=1e-3)
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu"})
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    batch = lds[0].batches(0)[0]
    model = build_model(cfg, CPU)
    direct = build_model(cfg, CPU)
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    assert isinstance(tr.optimizer, torch.optim.RMSprop)
    assert not capturable(tr.optimizer)
    opt = rmsprop(direct.parameters(), cfg.optim)
    rec, losses = StepRecorder(), []
    for epoch in range(3):
        tr.train_epoch(rec, epoch)
        direct.train()
        pred, label, mask = direct(batch.to(CPU))
        loss, _ = compute_loss(pred, label, mask, tr.loss_opts)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert rec.losses == losses
    assert rec.lrs == [0.003] * 3
    for (name, p), q in zip(model.named_parameters(), direct.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_capturable_and_unknown_optimizer():
    """The port's SGD and a capturable Adam on a tensor lr can be
    captured; a float lr or a step without capturable cannot.  An
    optimizer neither registered nor built in raises ValueError."""
    p = torch.nn.Parameter(torch.zeros(3))
    lr = torch.tensor(0.1)
    assert capturable(SGD([p], lr=lr))
    assert capturable(torch.optim.Adam([p], lr=lr, capturable=True))
    assert not capturable(SGD([p], lr=0.1))
    assert not capturable(torch.optim.Adam([p], lr=lr))
    assert not capturable(torch.optim.RMSprop([p], lr=lr))
    cfg = get_cfg()
    cfg.optim.optimizer = "lamb"
    with pytest.raises(ValueError, match="lamb"):
        create_optimizer([p], cfg.optim, 4)


class CountedStage(GNNStackStage):
    built = 0

    def __init__(self, *args):
        super().__init__(*args)
        CountedStage.built += 1


class TaggedGNN(GNN):
    pass


def test_registered_stage_and_network(monkeypatch):
    """stage_dict is consulted after the built-in stages, network_dict
    first in build_model (under cfg.model.type); both are called as the
    built-in ones are, and the models train a step."""
    monkeypatch.setitem(register.stage_dict, "counted", CountedStage)
    monkeypatch.setitem(register.network_dict, "tagged", TaggedGNN)
    setup = setup_dict("none", 8)
    setup["gnn"].update(layer_type="gcnidconv", stage_type="counted")
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu"})
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    built = CountedStage.built
    model = build_model(cfg, CPU)
    assert isinstance(model.mp, CountedStage)
    assert CountedStage.built == built + 1
    cfg.model.type = "tagged"
    tagged = build_model(cfg, CPU)
    assert type(tagged) is TaggedGNN and CountedStage.built == built + 2
    rec = StepRecorder()
    Trainer(tagged, lds, cfg, CPU).train_epoch(rec, 0)
    assert len(rec.losses) == 1 and np.isfinite(rec.losses[0])


def test_view_emb_matches_jax(monkeypatch, tmp_path):
    """The MP stage's output on the val loader's first batch, its real
    nodes projected by PCA and saved as .npz (matplotlib hidden): the
    JAX package's projection and labels from the same parameters, each
    axis up to its sign."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    jcfg, jlds, cfg, lds = both_loaders(setup_dict("none", 8))
    jcfg.out_dir, cfg.out_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg.view_emb = cfg.view_emb = True
    jtr = JaxTrainer(jax_build_model(jcfg), jlds, jcfg,
                     rng=jax.random.PRNGKey(0))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, jtr.state.params), model))
    tr = Trainer(model, lds, cfg, CPU)
    jtr._dump_embeddings()
    path = tr._dump_embeddings()
    assert path == os.path.join(cfg.out_dir, "emb.npz")
    want = np.load(os.path.join(jcfg.out_dir, "emb.npz"))
    got = np.load(path)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["proj"].shape == want["proj"].shape == (
        int(np.sum(lds[-1].batches(0)[0].node_mask)), 2)
    signs = np.sign(np.sum(got["proj"] * want["proj"], axis=0))
    np.testing.assert_allclose(got["proj"] * signs, want["proj"],
                               rtol=1e-4, atol=1e-5)


def seed_runs(root):
    """Two seed directories of a 3-epoch run: train and val stats."""
    for seed, acc in (("1", [0.5, 0.7, 0.6]), ("2", [0.4, 0.8, 0.9])):
        for split in ("train", "val"):
            d = root / seed / split
            d.mkdir(parents=True)
            d.joinpath("stats.json").write_text("".join(
                f'{{"epoch": {e}, "loss": {1.0 / (e + 1)}, '
                f'"accuracy": {a}, "lr": 0.01}}\n'
                for e, a in enumerate(acc)))


def agg_copies(tmp_path, names):
    seed_runs(tmp_path / "base")
    runs = {}
    for name in names:
        shutil.copytree(tmp_path / "base", tmp_path / name)
        runs[name] = str(tmp_path / name)
    return runs


AGG_FILES = [os.path.join("agg", s, f) for s in ("train", "val")
             for f in ("best.json", "stats.json")]


def test_tensorboard_agg_without_tensorboardx(monkeypatch, tmp_path):
    """agg_runs with tensorboard=True (the entry point passes
    cfg.tensorboard_agg) and tensorboardX missing: the same files as
    the JAX package's and as without the option, nothing more."""
    runs = agg_copies(tmp_path, ("jax", "port", "plain"))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    want = jax_agg.agg_runs(runs["jax"], tensorboard=True)
    got = agg.agg_runs(runs["port"], tensorboard=True)
    assert got == want and got["val"]["accuracy"] == 0.8
    agg.agg_runs(runs["plain"])
    for name in ("jax", "port", "plain"):
        parent = runs[name]
        assert sorted(os.path.relpath(os.path.join(d, f), parent)
                      for d, _, fs in os.walk(os.path.join(parent, "agg"))
                      for f in fs) == AGG_FILES, name
        for f in AGG_FILES:
            assert filecmp.cmp(os.path.join(runs["jax"], f),
                               os.path.join(parent, f), shallow=False)


def test_tensorboard_agg_writes_events(tmp_path):
    """Where tensorboardX imports, agg_runs(tensorboard=True) adds an
    event file to each split's aggregate and writes the JSON files as
    without it."""
    pytest.importorskip("tensorboardX")
    runs = agg_copies(tmp_path, ("plain", "events"))
    agg.agg_runs(runs["plain"])
    agg.agg_runs(runs["events"], tensorboard=True)
    for split in ("train", "val"):
        names = os.listdir(os.path.join(runs["events"], "agg", split))
        assert any(n.startswith("events.out.tfevents") for n in names)
    for f in AGG_FILES:
        assert filecmp.cmp(os.path.join(runs["plain"], f),
                           os.path.join(runs["events"], f), shallow=False)
