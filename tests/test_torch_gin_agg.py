"""GINConv's cfg.gnn.gin_agg ablation and GCN's ``improved`` on K1's
packs, against the JAX package's COO route (graphgym_tpu/nn/layers.py:
526-540, graphgym_tpu/ops/sparse.py:88-119 ``gcn_norm``).

- Packs: each of 'gcn', 'gcn_noself', 'wmean' and 'gcn_improved': its
  weights edge for edge, and the pack as a dense [rows, senders]
  matrix, equal the JAX package's per-edge weights (``gcn_norm`` with
  and without self-loops and with ``improved``, and the
  weighted-degree division of gin_agg 'mean'), rtol 1e-6, on random graphs with edge weights in
  [0.1, 1.1], weight-0 padding edges and padding nodes, and with
  weights of 1; K1 over the fwd and bwd packs (its plain version here)
  against the JAX COO SpMM and its transpose, rtol 1e-5.  gin_agg 'gcn'
  reads the 'gcn' pack GCNConv reads; 'mean' needs a kind of its own:
  with weights other than 1 it is not SAGE's 'mean'.
- Layers: GINConv at each gin_agg (the torch path's, no BN in its
  MLP: the Tfg one's MLP bias in front of its BN has a gradient of
  exactly 0, rounding noise in both packages; the models below hold
  that form), GCNConv and GCNIDConv with ``improved``, on a graph with
  weights other than 1: forward rtol 1e-4 / atol 1e-5, parameter
  gradients rtol 1e-3 / atol 1e-5.
- Models: three Adam steps of Tfg-ginconv (configs/ginconv_ba.yaml) at
  gcn, gcn_noself and mean and of ginconvFast (configs/
  ginconvFast_ba.yaml) at gcn, the four points of
  results/ablation_gin, on the first 12 graphs of the ba corpus at
  width 16, within 2e-3 of the JAX package (its XLA route, its native
  library off), each package's train batch with the same seeded normal
  features (the configs' own are a constant 1 or ba's identity
  features: under 'mean' every row of a constant input stays the same,
  and the MLPs' BatchNorms normalize the rounding of the row mean); the
  batch carries only the variant's pack.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphgym_tpu.data.loaders as jax_loaders
import graphgym_tpu.data.synthetic as jax_syn
import graphgym_tpu.native as jax_native
from graphgym_tpu.config import load_cfg as jax_load_cfg
from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.ops import sparse as jax_sparse
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.graphs import packing
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.nn import id_layers, layers
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops.cuda.spmm_kernel import spmm_pack_vjp
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_fast_ba import ACCEPTED
from test_torch_gin_sage import flat_state, to_numpy
from test_torch_spmm import pack_tensors, random_graph
from test_torch_torchpath import OneBatch, seeded_features
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("gcn", "gcn_noself", "wmean", "gcn_improved")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def jax_weights(kind, s, r, w, mask, n):
    """The JAX package's (senders, receivers, weights) of the kind's
    aggregation, as its layers compute them on the COO route."""
    args = (jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), n)
    if kind == "wmean":
        deg = jax_sparse.degree(args[1], args[2], n)
        return s, r, np.asarray(args[2] / jnp.maximum(deg, 1.0)[args[1]])
    js, jr, jw = jax_sparse.gcn_norm(
        *args, node_mask=jnp.asarray(mask),
        improved=kind == "gcn_improved",
        add_self_loops=kind != "gcn_noself")
    return np.asarray(js), np.asarray(jr), np.asarray(jw)


def dense(pack, n, cols):
    """A pack as its dense [rows, senders] matrix (weights summed)."""
    a = np.zeros((n, cols + 1))
    rows = (pack.tiles[:, None] * 128 + pack.local_rows).reshape(-1)
    np.add.at(a, (rows, pack.senders.reshape(-1)),
              pack.weights.reshape(-1))
    return a[:, :cols]


def graph(seed, ones=False):
    s, r, w, n = random_graph(seed)
    if ones:
        w = (w != 0).astype(np.float32)
    return s, r, w, np.arange(n) < 300, n


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed,ones", [(0, False), (1, False), (2, True)])
def test_pack_matches_the_jax_weights(kind, seed, ones):
    s, r, w, mask, n = graph(seed, ones)
    fwd, bwd = packing.build_packs(s, r, w, mask, n, kinds=(kind,))[kind]
    js, jr, jw = jax_weights(kind, s, r, w, mask, n)
    # per edge, in the JAX package's order (the edges, then the loops)
    ps, pr, pw = (packing._wmean_weights(s, r, w, n) if kind == "wmean"
                  else packing._gcn_weights(s, r, w, mask, n,
                                            packing.GCN_FILL[kind]))
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_allclose(pw, jw, rtol=1e-6, atol=1e-9)
    want = np.zeros((n, n))
    np.add.at(want, (jr, js), jw.astype(np.float64))
    got = dense(fwd, n, n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(dense(bwd, n, n), want.T, rtol=1e-6,
                               atol=1e-9)
    if kind in ("gcn", "gcn_improved"):   # self-loops on the real nodes
        loops = np.diag(got)
        assert (loops[:300] > 0).all() and (loops[300:] == 0).all()
    x = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm_pack_vjp(pack_tensors(fwd), pack_tensors(bwd), xt)
    cot = np.random.default_rng(seed + 9).normal(size=(n, 8))
    (out * torch.from_numpy(cot.astype(np.float32))).sum().backward()
    want_out = jax_sparse.spmm(jnp.asarray(js), jnp.asarray(jr),
                               jnp.asarray(jw), jnp.asarray(x), n)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want.T @ cot, rtol=1e-5,
                               atol=1e-5)


def test_wmean_is_not_mean_with_weights_other_than_1():
    """gin_agg 'mean' divides by max(the weighted in-degree, 1); SAGE's
    'mean' pack by the count of in-edges of nonzero weight.  Equal where
    every weight is 0 or 1, apart otherwise: a kind of its own."""
    for ones, equal in ((True, True), (False, False)):
        s, r, w, mask, n = graph(3, ones)
        packs = packing.build_packs(s, r, w, mask, n,
                                    kinds=("mean", "wmean"))
        a, b = (dense(packs[k][0], n, n) for k in ("mean", "wmean"))
        assert np.array_equal(a, b) == equal


def test_gin_agg_picks_its_pack():
    """ginconv's pack by gin_agg (GCNConv's own 'gcn' pack for 'gcn');
    the ID GIN takes 'plain' whatever gin_agg, as its JAX layer has no
    agg; an unknown gin_agg raises."""
    for lt in ("ginconv", "Tfg-ginconv"):
        assert [packing.kinds_for_layer(lt, gin_agg=a)
                for a in ("sum", "gcn", "gcn_noself", "mean")] == [
            ("plain",), ("gcn",), ("gcn_noself",), ("wmean",)]
    assert packing.kinds_for_layer("gcnconv") == ("gcn",)
    assert packing.kinds_for_layer("ginidconv", gin_agg="mean") == (
        "plain",)
    with pytest.raises(ValueError, match="gin_agg"):
        packing.kinds_for_layer("ginconv", gin_agg="max")
    with pytest.raises(ValueError, match="gin_agg"):
        layers.GINConv(4, 4, agg="max", generator=torch.Generator())


@pytest.fixture(scope="module")
def weighted_graphs():
    """One random graph with edge weights in [0.1, 1.1] (bf16-exact
    features, 40 ego centers) as a JAX and a port GraphBatch with every
    kind's pack."""
    s, r, w, n = random_graph(11, e=1500, hot=700)
    real = w != 0
    s, r, w = s[real], r[real], w[real]
    rng = np.random.default_rng(11)
    feat = np.asarray(jnp.asarray(rng.normal(size=(299, 8)), jnp.bfloat16)
                      .astype(jnp.float32))
    ids = rng.choice(299, 40, replace=False)
    id_index = np.concatenate([ids, np.full(8, n - 1)]).astype(np.int32)
    id_mask = np.arange(48) < 40
    out = []
    for build in (jax_container.build_graph_batch, build_graph_batch):
        b = build(s, r, feat, edge_weight=w, pad_nodes_to=n,
                  pad_edges_to=1600)
        b = b.replace(node_id_index=id_index, id_mask=id_mask)
        if build is build_graph_batch:
            b = b.replace(packs=packing.build_packs(
                b.senders, b.receivers, b.edge_weight, b.node_mask,
                b.num_nodes, kinds=KINDS)).to(CPU)
        out.append(b)
    assert float(np.asarray(out[0].edge_weight).max()) > 1.0
    return out


def layer_pair(name):
    from graphgym_tpu.nn import id_layers as jax_id_layers
    from graphgym_tpu.nn import layers as jax_layers

    gen = torch.Generator().manual_seed(0)
    if name.startswith("GINConv-"):
        agg = name.split("-", 1)[1]
        return (jax_layers.GINConv(16, agg=agg),
                layers.GINConv(8, 16, agg=agg, generator=gen))
    if name == "GCNConv-improved":
        return (jax_layers.GCNConv(16, use_bias=True, improved=True),
                layers.GCNConv(8, 16, use_bias=True, improved=True,
                               generator=gen))
    return (jax_id_layers.GCNIDConv(16, improved=True),
            id_layers.GCNIDConv(8, 16, improved=True, generator=gen))


@pytest.mark.parametrize("name", ["GINConv-gcn", "GINConv-gcn_noself",
                                  "GINConv-mean", "GCNConv-improved",
                                  "GCNIDConv-improved"])
def test_layer_matches_jax(weighted_graphs, name):
    jb, b = weighted_graphs
    jmod, mod = layer_pair(name)
    variables = to_numpy(dict(jmod.init(jax.random.PRNGKey(0), jb, False)))
    stats = variables.get("batch_stats", {})
    mod.load_state_dict({**flat_state(variables["params"]),
                         **flat_state(stats)})
    cot = np.random.default_rng(8).normal(
        size=(b.num_nodes, 16)).astype(np.float32)

    def jax_loss(p):
        out, mut = jmod.apply({"params": p, "batch_stats": stats}, jb, True,
                              mutable=["batch_stats"])
        return jnp.sum(out.node_feat * cot), (out.node_feat, mut)

    (_, (want, mut)), grads = jax.value_and_grad(
        jax_loss, has_aux=True)(variables["params"])
    mod.train()
    got = mod(b).node_feat
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    want_grads = flat_state(to_numpy(grads))
    assert sorted(want_grads) == sorted(n for n, _ in mod.named_parameters())
    for pname, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[pname].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=pname)
    new_stats = flat_state(to_numpy(mut.get("batch_stats", {})))
    assert sorted(new_stats) == sorted(n for n, _ in mod.named_buffers())
    for bname, buf in mod.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new_stats[bname].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=bname)


# ------------------------------------------------------------ the models


@pytest.fixture(scope="module")
def ba_head():
    """The first 12 graphs of the ba corpus (seed 0: the first 12
    attempts its rejection loop keeps, tests/test_torch_fast_ba.py's
    record, each attempt's draws taken as data/synthetic.py takes
    them)."""
    rng = np.random.default_rng(0)
    keep, graphs = ACCEPTED[:12], []
    for attempt in range(1, keep[-1] + 1):
        p = float(rng.uniform(0, 1))
        seed = int(rng.integers(1 << 31))
        if attempt in keep:
            graphs.append(syn._host_graph(syn._powerlaw_cluster(
                64, 2, p, random.Random(seed))))
    return graphs


def jax_graph(g):
    from graphgym_tpu.data.hostgraph import HostGraph as JaxHostGraph

    out = JaxHostGraph(g.num_nodes, np.array(g.edge_index, np.int32))
    out.feats["node_feature"] = np.array(g.feats["node_feature"])
    return out


@pytest.mark.parametrize("model,agg", [("ginconv", "gcn"),
                                       ("ginconv", "gcn_noself"),
                                       ("ginconv", "mean"),
                                       ("ginconvFast", "gcn")])
def test_three_adam_steps_match_jax(model, agg, ba_head, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(syn, "generate_syn_graphs",
                        lambda kind, num_graphs, n: list(ba_head))
    monkeypatch.setattr(jax_syn, "generate_syn_graphs",
                        lambda kind, num_graphs, n: [jax_graph(g)
                                                     for g in ba_head])
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_loaders, "_SEARCH_DIRS", [str(jdir)])
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(pdir))
    path = os.path.join(ROOT, "configs", f"{model}_ba.yaml")
    opts = ["gnn.gin_agg", agg, "gnn.dim_inner", "16"]
    jcfg = jax_load_cfg(path, opts + ["tpu.spmm_impl", "xla",
                                      "dataset.dir", str(jdir)])
    cfg = load_cfg(path, opts + ["device", "cpu", "dataset.dir", str(pdir)])
    assert cfg.gnn.layer_type == "Tfg-ginconv"
    jloaders = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
    lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    assert len(lds[0]) == len(jloaders[0]) == 1
    (batch,) = lds[0].batches(0)
    assert set(batch.packs) == {packing.gin_kind(agg)}
    jbatch, batch = seeded_features(jloaders[0].batches(0)[0],
                                    batch.to(CPU))
    jtr = JaxTrainer(jax_build_model(jcfg), [OneBatch(jbatch)], jcfg,
                     rng=jax.random.PRNGKey(0))
    net = build_model(cfg, CPU)
    net.load_state_dict(params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        net))
    assert all(m.kind == packing.gin_kind(agg) for m in net.modules()
               if isinstance(m, layers.GINConv))
    tr = Trainer(net, [OneBatch(batch)], cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)


def test_ablation_points_in_the_parity_tool():
    """The parity tool's four ablation points: each config with its
    gin_agg and the config whose reference row judges it; the JAX
    package's CPU runs at the configs' protocol (``JAX_CPU_RUNS``) are
    the committed runs' under results/parity/jax_cpu_gin_ablation (each
    seed's best val accuracy, the aggregate's mean and std); each row
    judged against its config's reference row and the CPU run."""
    import json

    from graphgym_tpu_torch.exp import parity

    ablation = {name: point for name, point in parity.POINTS.items()
                if len(point) > 2}
    assert sorted(ablation) == [
        "ginconvFast_ba_gcn", "ginconv_ba_gcn", "ginconv_ba_gcn_noself",
        "ginconv_ba_mean"]
    summary = dict(seeds=3, best_val_acc_per_seed=[0.64, 0.65, 0.66],
                   mean=0.65, std=0.01, seconds_per_run=[1.0] * 3,
                   time_iter_median_s=0.002)
    runs = os.path.join(ROOT, "results", "parity", "jax_cpu_gin_ablation")
    for name, (cfg, opts, ref_cfg) in ablation.items():
        agg = opts[1]
        assert name == f"{cfg}_{agg}" and ref_cfg == cfg
        path, got_opts = parity.point_config(name)
        assert path == os.path.join(ROOT, "configs", f"{cfg}.yaml")
        assert got_opts == ["gnn.gin_agg", agg]
        cpu = parity.JAX_CPU_RUNS[name]
        per_seed = []
        for seed in ("1", "2", "3"):
            with open(os.path.join(runs, name, seed, "val",
                                   "stats.json")) as f:
                per_seed.append(max(json.loads(line)["accuracy"]
                                    for line in f if line.strip()))
        assert cpu["best_val_acc_per_seed"] == per_seed
        with open(os.path.join(runs, name, "agg", "val", "best.json")) as f:
            best = json.loads(f.readline())
        assert (cpu["mean"], cpu["std"]) == (best["accuracy"],
                                             best["accuracy_std"])
        row = parity.point_row(name, summary)
        ref = parity.reference(*parity.config_key(cfg))
        assert row["judged_against"] == "reference"
        assert row["reference"] == ref["reference"] and row["jax"] is None
        want = parity.pass_rule(0.65 - ref["reference"],
                                ref["reference_std"], 0.01)
        assert (row["passes"], row["limit"]) == want
        assert (row["passes_jax_cpu"], row["limit_jax_cpu"]) == \
            parity.pass_rule(0.65 - cpu["mean"], cpu["std"], 0.01)
        line = parity.table([row]).splitlines()[2]
        assert line.startswith(f"| {name} |") and "| — |" in line
