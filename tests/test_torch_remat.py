"""tpu.remat: the torch-path MP layers recomputed in the backward
(nn/remat.py, GeneralLayer's ``remat``) against the same model without
it, and against the JAX package's ``nn.remat`` model.

- Bitwise on the CPU: three Adam steps of one model with remat on and
  off from the same seed, on the grid points' ws train batch at width
  16 with BatchNorm (tests/test_torch_torchpath.py's configs, the
  port's loader alone): the losses, every gradient, the BatchNorm running
  statistics and the dropout and attention-dropout masks (the forward's
  draws; the recompute draws none, and reads the forward's back) are
  equal, and the model's dropout generator ends in the same state.
  The points: design_ws's (ginidconv, PReLU, skipsum, dropout 0.3),
  gatidconv with attention dropout 0.2 and dropout 0.3, and gcnidconv
  on the stack stage.
- The recompute runs: with remat each MP conv runs twice a train step
  (forward, recompute), once without it and once in eval mode.
- Against the JAX package with tpu.remat True: three Adam steps within
  2e-3 (dropout 0; the JAX side's XLA path, as the torch-path tests).
- The Tfg models ignore the key, as the JAX package's do.
"""

import functools

import pytest
import torch

import graphgym_tpu.native as jax_native
from graphgym_tpu_torch.nn import remat
from graphgym_tpu_torch.nn.model import options_from_cfg
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.nn.model import build_model
from test_torch_torchpath import (CPU, OneBatch, configs, grid_point,
                                  three_steps)

DESIGN_WS = ("gnn.act", "prelu", "gnn.stage_type", "skipsum",
             "gnn.dropout", "0.3")
POINTS = {
    "design_ws": ("ginidconv", DESIGN_WS),
    "gatid_dropout": ("gatidconv", ("gnn.att_dropout", "0.2",
                                    "gnn.dropout", "0.3")),
    "gcnid_stack": ("gcnidconv", ()),
}


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


class Draws:
    """Records the keep masks the model draws (not those a recompute
    reads back) and counts the replayed ones."""

    def __init__(self, mpatch):
        self.drawn, self.replayed = [], 0
        real = remat.keep_draw

        def draw(*args):
            mask = real(*args)
            if remat.recomputing():
                self.replayed += 1
            else:
                self.drawn.append(mask.clone())
            return mask
        mpatch.setattr(remat, "keep_draw", draw)


@functools.lru_cache(maxsize=None)
def port_point(layer_type, extra=()):
    """The port's config of a grid point (tests/test_torch_torchpath.py's
    ``configs``) and its train batch (6 graphs per split)."""
    _, cfg = configs(layer_type, extra)
    lds = loaders.create_loader([p[:6] for p in loaders.create_dataset(cfg)],
                                cfg)
    return cfg, lds[0].batches(0)[0].to(CPU)


def port_model(cfg, on):
    """The port's model of ``cfg`` from its seed, tpu.remat ``on``."""
    cfg = cfg.clone()
    cfg.tpu.remat = on
    return cfg, build_model(cfg, CPU)


def train_three(cfg, batch, on):
    """Three steps of the port's model (tpu.remat ``on``) on ``batch``:
    per step the loss and every gradient; the running statistics, the
    dropout generator's state and the masks drawn."""
    cfg, model = port_model(cfg, on)
    mp = list(model.mp.layers)
    assert mp and all(m.remat == on for m in mp)
    tr = Trainer(model, [OneBatch(batch)], cfg, CPU)
    losses, grads = [], []

    class Rec:
        def update_stats(self, loss, lr, **kw):
            losses.append(loss)

    with pytest.MonkeyPatch.context() as mpatch:
        draws = Draws(mpatch)
        for epoch in range(3):
            tr.train_epoch(Rec(), epoch)
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
    gens = {id(m.dropout_generator): m.dropout_generator
            for m in model.modules()
            if getattr(m, "dropout_generator", None) is not None}
    state = [g.get_state() for g in gens.values()]
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    return losses, grads, buffers, state, draws


@pytest.mark.parametrize("point", sorted(POINTS))
def test_remat_is_bitwise_the_same_training(point):
    cfg, batch = port_point(*POINTS[point])
    plain = train_three(cfg, batch, False)
    rem = train_three(cfg, batch, True)
    assert plain[0] == rem[0] and len(rem[0]) == 3
    for g0, g1 in zip(plain[1], rem[1]):
        assert g0.keys() == g1.keys()
        for name in g0:
            assert torch.equal(g0[name], g1[name]), name
    assert plain[2].keys() == rem[2].keys()
    assert any(n.endswith("bn.mean") for n in rem[2])
    for name in plain[2]:
        assert torch.equal(plain[2][name], rem[2][name]), name
    assert len(plain[3]) == len(rem[3])
    for s0, s1 in zip(plain[3], rem[3]):
        assert torch.equal(s0, s1)
    d0, d1 = plain[4], rem[4]
    assert len(d0.drawn) == len(d1.drawn)
    assert d0.replayed == 0
    if point == "gcnid_stack":
        assert not d1.drawn and not rem[3]
    else:
        assert d1.drawn and d1.replayed >= 1 and rem[3]
    for m0, m1 in zip(d0.drawn, d1.drawn):
        assert torch.equal(m0, m1)


def test_remat_recomputes_each_mp_conv():
    """A train step runs each MP conv twice under remat (the forward and
    its recompute), once without; eval runs it once."""
    cfg, batch = port_point(*POINTS["design_ws"])
    calls = []
    for on, want in ((False, 1), (True, 2)):
        _, model = port_model(cfg, on)
        convs = [m.layer for m in model.mp.layers]
        for conv in convs:
            conv.register_forward_hook(
                lambda mod, args, out: calls.append(mod))
        calls.clear()
        model.train()
        pred, _, _ = model(batch)
        pred.sum().backward()
        assert [calls.count(c) for c in convs] == [want] * len(convs)
        calls.clear()
        model.eval()
        with torch.no_grad():
            model(batch)
        assert [calls.count(c) for c in convs] == [1] * len(convs)


@pytest.mark.parametrize("point", ["design_ws", "gcnid_stack"])
def test_remat_three_adam_steps_match_jax(point):
    """The JAX package's model with tpu.remat True (nn.remat over each
    MP GeneralLayer) against the port's with it: three Adam steps from
    the same parameters, dropout 0."""
    layer_type, extra = POINTS[point]
    extra = tuple(x for i, x in enumerate(extra)
                  if extra[i - i % 2] != "gnn.dropout")
    jcfg, cfg, jbatch, batch = grid_point(layer_type,
                                          extra + ("tpu.remat", "True"))
    assert jcfg.tpu.remat and cfg.tpu.remat and cfg.gnn.dropout == 0
    losses = three_steps(jcfg, cfg, jbatch, batch)
    assert losses[2] < losses[0]


def test_tfg_models_ignore_remat():
    """tpu.remat on a Tfg model: no layer rematerialized (the JAX
    package's Tfg options carry no remat either)."""
    _, cfg = configs("gcnidconv", ("gnn.layer_type", "Tfg-idgcn",
                                   "tpu.remat", "True"))
    cfg.share.dim_in, cfg.share.dim_out = 1, 6
    assert cfg.tpu.remat and not options_from_cfg(cfg).remat
    cfg.gnn.layer_type = "gcnidconv"
    assert options_from_cfg(cfg).remat


def test_remat_cost_tool_on_the_cpu(capsys):
    """exp/remat_cost.py: a grid point (idgraph_ba500's, on ws at a
    small width), both runs on one batch from one seed, STEPS steps
    each, losses bitwise equal, one JSON line; no peak memory off the
    card."""
    import json

    from graphgym_tpu_torch.exp import remat_cost

    out = remat_cost.main(["--point", "idgraph_ba500", "--opts", "device",
                           "cpu", "dataset.name", "ws", "gnn.dim_inner",
                           "8"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["device"] == "cpu" and out["layers_mp"] == 3
    assert out["steps"] == remat_cost.STEPS == 7
    assert out["losses_bitwise_equal"]
    assert len(out["remat"]["losses"]) == remat_cost.STEPS
    assert out["plain"]["peak_memory_bytes"] is None
    with pytest.raises(SystemExit):
        remat_cost.main(["--cfg", "configs/idgcn_ws.yaml"])
