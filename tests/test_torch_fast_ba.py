"""ginconvFast and gatconvFast on ba in the port against the JAX package,
where the port's full runs part from parity.json's JAX row (ROADMAP C8).

The corpus: the 116 ba graphs of seed 0, regenerated by the port's
generator (data/synthetic.py, the JAX package's networkx graphs edge for
edge) at the attempts its rejection loop keeps (``ACCEPTED``, a record
of that loop), held to the whole corpus's digest; the ~50,000 attempts
it rejects are skipped, the draws of each still taken.  Both packages
get the same graphs.

- The identity features (``node_identity``, 10 columns: diag(Â^1..Â^10),
  Â = D^-1/2 (A + I) D^-1/2) of all 116 graphs: the port's
  ``compute_identity_host`` against the JAX package's, through its
  data/augment.py ``_identity``, and both against float64.  Not exact:
  the entries are sums of products of the weights 1 / sqrt(d_u d_v),
  not integer walk counts, and the two programs multiply the matrices
  in different orders; rtol 1e-5 / atol 1e-7 between the two, and each
  within 2e-6 relative of float64 (ba's hubs of 40-50 neighbours
  included).
- Training at the configs' full width (configs/<model>_ba.yaml: pre-MP
  1, 3 x 128 Tfg layers, BatchNorm, L2 norm; batch 48, so 2 train
  batches of the 92 train graphs) from the JAX package's initial
  parameters, 2 epochs (4 Adam steps): per-step losses within 2e-3,
  the learning rates at rtol 1e-6, BatchNorm running statistics at
  rtol 1e-4 / atol 1e-5, eval accuracy within 5e-3.  The JAX side runs
  its XLA route (its Pallas f32 path drops lo * lo, which the
  BatchNorms scale past the tolerances).

The JAX package's own CPU runs of these configs at the port's seeds are
``graphgym_tpu_torch.exp.parity.JAX_CPU_RUNS`` (the command beside it).
"""

import hashlib
import os
import random

import jax
import numpy as np
import pytest
import torch

import graphgym_tpu.data.loaders as jax_loaders
import graphgym_tpu.data.synthetic as jax_syn
import graphgym_tpu.native as jax_native
from graphgym_tpu.config import load_cfg as jax_load_cfg
from graphgym_tpu.data import augment as jax_augment
from graphgym_tpu.data.hostgraph import HostGraph as JaxHostGraph
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.exp import parity
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops.identity import compute_identity_host
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BA_DIGEST = ("fc3beb9b7b0effd6f75f3110d5119f3d"
             "570e40ab93423ced0554a58984554a40")
# the attempts (from 1) that generate_syn_graphs(kind="ba", num_graphs=256,
# n=64, seed=0) keeps, in order; it makes 256 * 200 attempts in all
ACCEPTED = [
    1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 13, 14, 15, 18, 19, 20, 21, 22, 23, 24,
    25, 27, 28, 30, 33, 35, 36, 37, 38, 40, 41, 42, 45, 46, 49, 51, 58, 62,
    65, 70, 71, 73, 76, 88, 90, 91, 103, 108, 109, 114, 118, 122, 124, 125,
    128, 131, 141, 142, 149, 154, 165, 182, 208, 233, 235, 242, 244, 247,
    248, 269, 284, 285, 293, 378, 412, 428, 438, 439, 482, 543, 673, 682,
    810, 863, 1000, 1138, 1201, 1328, 1481, 2167, 2340, 2409, 2648, 2947,
    3056, 3853, 4009, 4488, 4561, 5382, 5616, 9323, 10673, 12238, 12952,
    13079, 14280, 15186, 15617, 15956, 16152, 20320, 30119, 31010, 40218,
    40569]


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


@pytest.fixture(scope="module")
def ba_graphs():
    """The 116 graphs of the ba corpus (the port's HostGraphs), from the
    accepted attempts' own draws, held to the corpus's digest."""
    rng = np.random.default_rng(0)
    keep, graphs = set(ACCEPTED), []
    for attempt in range(1, max(ACCEPTED) + 1):
        p = float(rng.uniform(0, 1))              # each attempt's draws,
        seed = int(rng.integers(1 << 31))         # kept or not
        if attempt in keep:
            graphs.append(syn._host_graph(syn._powerlaw_cluster(
                64, 2, p, random.Random(seed))))
    digest = hashlib.sha256()
    for g in graphs:
        digest.update(np.ascontiguousarray(g.edge_index, np.int32).tobytes())
    assert len(graphs) == 116 and digest.hexdigest() == BA_DIGEST
    return graphs


def jax_graph(g):
    out = JaxHostGraph(g.num_nodes, np.array(g.edge_index, np.int32))
    out.feats["node_feature"] = np.array(g.feats["node_feature"])
    return out


def identity_f64(g, k):
    """diag(Â^1..Â^k) in float64."""
    n = g.num_nodes
    adj = np.eye(n)
    adj[g.edge_index[1], g.edge_index[0]] = 1.0
    dinv = 1.0 / np.sqrt(adj.sum(1))
    norm = dinv[:, None] * adj * dinv[None, :]
    out, p = [], norm
    for _ in range(k):
        out.append(np.diag(p))
        p = p @ norm
    return np.stack(out, 1)


def test_identity_features_of_the_ba_corpus(ba_graphs):
    ports, jaxes = [], []
    for g in ba_graphs:
        port = compute_identity_host(g.edge_index, g.num_nodes, 10, CPU)
        want = np.asarray(jax_augment._identity(jax_graph(g),
                                                feature_dim=10))
        assert port.shape == want.shape == (64, 10)
        assert port.dtype == want.dtype == np.float32
        ref = identity_f64(g, 10)
        for got in (port, want):
            np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-9)
        ports.append(port)
        jaxes.append(want)
    np.testing.assert_allclose(np.stack(ports), np.stack(jaxes), rtol=1e-5,
                               atol=1e-7)
    # hubs: nodes of 40 and more neighbours
    degree = max(int(np.bincount(g.edge_index[1]).max()) for g in ba_graphs)
    assert degree >= 40


def configs(model, tmp_path, monkeypatch, graphs):
    """The config on both sides, each package's corpus generator handing
    out ``graphs`` (and caching them in its own scratch directory)."""
    monkeypatch.setattr(syn, "generate_syn_graphs",
                        lambda kind, num_graphs, n: list(graphs))
    monkeypatch.setattr(jax_syn, "generate_syn_graphs",
                        lambda kind, num_graphs, n: [jax_graph(g)
                                                     for g in graphs])
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_loaders, "_SEARCH_DIRS", [str(jdir)])
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(pdir))
    path = os.path.join(ROOT, "configs", f"{model}_ba.yaml")
    jcfg = jax_load_cfg(path, ["tpu.spmm_impl", "xla",
                               "dataset.dir", str(jdir)])
    cfg = load_cfg(path, ["device", "cpu", "dataset.dir", str(pdir)])
    return jcfg, cfg


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def trainers(model, tmp_path, monkeypatch, graphs, first_batch=False,
             nudge=False):
    """The JAX package's Trainer and the port's, the port's model from
    the JAX package's initial variables (``nudge``: every float
    parameter moved one ulp up); ``first_batch``: each train loader
    hands out its first batch only."""
    jcfg, cfg = configs(model, tmp_path, monkeypatch, graphs)
    assert cfg.gnn.dim_inner == 128 and cfg.gnn.layers_mp == 3
    assert cfg.train.batch_size == 48 and cfg.gnn.batchnorm
    jloaders = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
    lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    assert len(lds[0]) == len(jloaders[0]) == 2      # 48 + 44 graphs
    assert cfg.share.dim_in == jcfg.share.dim_in == 11
    if first_batch:
        for ld in (jloaders[0], lds[0]):
            monkeypatch.setattr(ld, "batches",
                                lambda e, real=ld.batches: real(e)[:1])
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    net = build_model(cfg, CPU)
    state = jax_state(jtr, net)
    if nudge:
        state = {k: torch.nextafter(v, torch.full_like(v, np.inf))
                 if k in dict(net.named_parameters()) else v
                 for k, v in state.items()}
    net.load_state_dict(state)
    return jtr, Trainer(net, lds, cfg, CPU), net


def jax_state(jtr, net):
    """The JAX Trainer's variables as the port model's state dict."""
    return params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        net)


# BatchNorm running statistics: GIN's MLPs hold one BatchNorm a layer
# (its mean and var); the Tfg GAT layers none
BN_STATS = {"ginconvFast": 6, "gatconvFast": 0}


def assert_bn_stats(net, want, model):
    got = net.state_dict()
    stats = [k for k in got if k.endswith(("_bn.mean", "_bn.var"))]
    assert len(stats) == BN_STATS[model]
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def train(jtr, tr, epochs):
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(epochs):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    return np.array(rec.losses), np.array(jrec.losses)


@pytest.mark.parametrize("model", ["ginconvFast", "gatconvFast"])
def test_full_width_first_step_on_ba_matches_jax(model, ba_graphs,
                                                 tmp_path, monkeypatch):
    """One Adam step on the first train batch of 48 graphs: the loss,
    every parameter entry whose gradient lies above rounding level
    (|g| >= 1e-4 of its tensor's largest, in a tensor whose largest is
    at least 1e-6) within 1e-5 after the step, and the BatchNorm running
    statistics.  The entries left out take their first Adam step from
    rounding noise: a bias in front of a BatchNorm has an exact gradient
    of 0 (GIN's MLP biases: largest |g| 1e-9 to 1e-7), and Adam's first
    step moves an entry by about lr times the sign of its gradient
    whatever its size, so such entries part by up to 2 lr in any two
    f32 programs, the port against itself with its weights one ulp
    apart included."""
    jtr, tr, net = trainers(model, tmp_path, monkeypatch, ba_graphs,
                            first_batch=True)
    got, want = train(jtr, tr, 1)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, atol=2e-3)
    state = jax_state(jtr, net)
    beta1 = tr.optimizer.param_groups[0]["betas"][0]
    held = 0
    for name, p in net.named_parameters():
        g = tr.optimizer.state[p]["exp_avg"] / (1 - beta1)
        top = float(g.abs().max())
        if top < 1e-6:
            continue
        keep = g.abs() >= 1e-4 * top
        held += int(keep.sum())
        np.testing.assert_allclose(p.detach()[keep].numpy(),
                                   state[name][keep].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert held > 0.9 * sum(p.numel() for p in net.parameters())
    assert_bn_stats(net, state, model)


@pytest.mark.parametrize("model", ["ginconvFast", "gatconvFast"])
def test_full_width_two_epochs_on_ba_match_jax(model, ba_graphs, tmp_path,
                                               monkeypatch):
    """2 epochs, 4 Adam steps: per-step losses within 2e-3 of the JAX
    package's, BatchNorm running statistics at rtol 1e-4 / atol 1e-5,
    eval accuracy within 5e-3.  ginconvFast's trajectory from the third
    step on follows rounding (its MLP biases' first steps, see the test
    above): there the port's losses are held within 2e-3 plus twice the
    port's own spread when its initial weights move one ulp, and its
    statistics and eval accuracy are not compared."""
    jtr, tr, net = trainers(model, tmp_path, monkeypatch, ba_graphs)
    got, want = train(jtr, tr, 2)
    assert len(got) == len(want) == 4
    if model == "gatconvFast":
        np.testing.assert_allclose(got, want, atol=2e-3)
        assert_bn_stats(net, jax_state(jtr, net), model)
        assert abs(tr.eval_epoch(None, 1) - jtr.eval_epoch(None, 1)) < 5e-3
        return
    _, tr2, _ = trainers(model, tmp_path / "nudged", monkeypatch, ba_graphs,
                         nudge=True)
    spread = np.abs(got - nudged_losses(tr2))
    np.testing.assert_allclose(got[:2], want[:2], atol=2e-3)
    assert (np.abs(got - want) <= 2e-3 + 2 * spread).all(), (got, want,
                                                             spread)


def nudged_losses(tr):
    rec = StepRecorder()
    for epoch in range(2):
        tr.train_epoch(rec, epoch)
    return np.array(rec.losses)


def test_jax_cpu_runs_recorded():
    """The JAX package's CPU runs of the config at seeds 1-3 that the
    parity tool judges the port's ginconvFast ba against as well."""
    run = parity.JAX_CPU_RUNS["ginconvFast_ba.yaml"]
    assert len(run["best_val_acc_per_seed"]) == 3
    assert min(run["best_val_acc_per_seed"]) <= run["mean"] \
        <= max(run["best_val_acc_per_seed"])
