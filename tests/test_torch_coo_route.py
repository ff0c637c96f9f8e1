"""The MP layers' COO route (cfg.tpu.spmm_impl 'xla', nn/coo.py) against
the JAX package's (its layers on a batch with no pack,
graphgym_tpu/ops/sparse.py:25-57), and the COO ops sddmm_dot and
sddmm_edge_grad.

- Loader: under 'xla' a batch carries the COO entries of its layers'
  edges ('coo', 'coo_loops'; GeneralConv's max also the 'edge' and
  'edge_dst' packs) and none of the MP layers' packs; the attention
  layers and the max over self-loops raise naming ROADMAP A0.  Each
  entry's K2 indexes list every position once, by receiver and by
  sender.
- Layers: GCNConv, GCNIDConv, SAGEConv, SAGEIDConv, GINConv (sum, gcn,
  gcn_noself, mean), GINIDConv, GeneralConv (add, mean, max, mean with
  normalize_adj) and GeneralIDConv (max) on a graph with edge weights
  in [0.1, 1.1], padding edges and padding nodes: forward rtol 1e-4 /
  atol 1e-5, parameter gradients rtol 1e-3 / atol 1e-5 (the
  tests/test_torch_gin_agg.py tolerances); the sums run on K2's plain
  version (every K2 call counted), K1 never.
- Model: three Adam steps of the main path (configs/idgcn_ws.yaml's
  Tfg-idgcn, width 16, 6 ws graphs a split) at 'xla' in both packages
  from the same parameters: losses within 2e-3 in f32 (as
  tests/test_torch_train.py), 1e-3 in bf16 (the JAX package's own bf16
  run; tests/test_torch_bf16.py measures what bf16 moves), the
  validation accuracy within 5e-3.
- Labels: on the main path's model at 'xla' K2's calls are counted
  under the role of each (the sum, the degree, the gather's gradient),
  one each per layer in a train step and the first two in an eval
  forward.
- sddmm_dot and sddmm_edge_grad against the JAX package's on the
  graphs of tests/test_ops.py:109 and tests/test_pallas_kernel.py:109,
  rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.ops import sparse as jax_sparse
from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import get_cfg, load_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.graphs import packing
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.nn import id_layers, layers
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops import sparse
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_gin_sage import flat_state, to_numpy
from test_torch_spmm import random_graph
from test_torch_train import StepRecorder, setup_dict

CPU = torch.device("cpu")
COO_ENTRIES = ("coo", "coo_loops", "edge", "edge_dst")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


@pytest.fixture
def counted(monkeypatch):
    """Counts of the plain versions K2 (segment_sum_plain), K1
    (spmm_packed_plain) and the max (packed_max_plain) run."""
    calls = {"k2": 0, "k1": 0, "max": 0}

    def wrap(name, key):
        fn = getattr(K, name)

        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(K, name, run)
    wrap("segment_sum_plain", "k2")
    wrap("spmm_packed_plain", "k1")
    wrap("packed_max_plain", "max")
    return calls


@pytest.fixture(scope="module")
def weighted_graphs():
    """One random graph with edge weights in [0.1, 1.1] and 40 ego
    centers, as a JAX GraphBatch (no pack: its COO route) and a port
    GraphBatch with the COO route's entries."""
    s, r, w, n = random_graph(11, e=1500, hot=700)
    real = w != 0
    s, r, w = s[real], r[real], w[real]
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(299, 8)).astype(np.float32)
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
                b.num_nodes, kinds=COO_ENTRIES)).to(CPU)
        out.append(b)
    return out


LAYERS = ("GCNConv", "GCNIDConv", "SAGEConv", "SAGEIDConv", "GINConv-sum",
          "GINConv-gcn", "GINConv-gcn_noself", "GINConv-mean", "GINIDConv",
          "GeneralConv-add", "GeneralConv-mean", "GeneralConv-max",
          "GeneralConv-mean-norm", "GeneralIDConv-max")


def layer_pair(name):
    from graphgym_tpu.nn import id_layers as jax_id_layers
    from graphgym_tpu.nn import layers as jax_layers

    gen = torch.Generator().manual_seed(0)
    base, _, arg = name.partition("-")
    if base == "GCNConv":
        return (jax_layers.GCNConv(16, use_bias=True),
                layers.GCNConv(8, 16, use_bias=True, generator=gen))
    if base == "GCNIDConv":
        return (jax_id_layers.GCNIDConv(16),
                id_layers.GCNIDConv(8, 16, generator=gen))
    if base == "SAGEConv":
        return (jax_layers.SAGEConv(16, use_bias=True),
                layers.SAGEConv(8, 16, use_bias=True, generator=gen))
    if base == "SAGEIDConv":
        return (jax_id_layers.SAGEIDConv(16),
                id_layers.SAGEIDConv(8, 16, generator=gen))
    if base == "GINConv":
        return (jax_layers.GINConv(16, agg=arg),
                layers.GINConv(8, 16, agg=arg, generator=gen))
    if base == "GINIDConv":
        return (jax_id_layers.GINIDConv(16),
                id_layers.GINIDConv(8, 16, generator=gen))
    agg, _, norm = arg.partition("-")
    if base == "GeneralConv":
        return (jax_layers.GeneralConv(16, use_bias=True, agg=agg,
                                       normalize_adj=bool(norm)),
                layers.GeneralConv(8, 16, use_bias=True, agg=agg,
                                   normalize_adj=bool(norm),
                                   generator=gen))
    return (jax_id_layers.GeneralIDConv(16, use_bias=True, agg=agg),
            id_layers.GeneralIDConv(8, 16, use_bias=True, agg=agg,
                                    generator=gen))


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax_on_the_coo_route(weighted_graphs, counted, name):
    jb, b = weighted_graphs
    jmod, mod = layer_pair(name)
    variables = to_numpy(dict(jmod.init(jax.random.PRNGKey(0), jb, False)))
    mod.load_state_dict(flat_state(variables["params"]))
    cot = np.random.default_rng(8).normal(
        size=(b.num_nodes, 16)).astype(np.float32)

    def jax_loss(p):
        out = jmod.apply({"params": p}, jb, True)
        return jnp.sum(out.node_feat * cot), out.node_feat

    (_, want), grads = jax.value_and_grad(
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
    # no K1; K2 for the sums (and a gather's gradient where the
    # aggregated rows come from parameters), the max on its kernel
    assert counted["k1"] == 0 and counted["k2"] >= 1
    assert counted["max"] == name.endswith("max")


def test_k2_counts_each_role_under_its_label(monkeypatch):
    """The main path's MP layers at 'xla' (configs/idgcn_ws.yaml, width
    16): a train step runs K2 once per layer for each of the sum by
    receiver, the GCN norm's degree and the gather's gradient, each
    under its own label (the card counts K2's ``launches_by_pack`` by
    that label); an eval forward runs the first two."""
    from collections import Counter

    from graphgym_tpu_torch.nn import coo

    labels = Counter()
    real = K.segment_sum

    def segment_sum(msg, index, pack=""):
        labels[pack] += 1
        return real(msg, index, pack)
    monkeypatch.setattr(K, "segment_sum", segment_sum)
    monkeypatch.setattr(coo, "segment_sum", segment_sum)
    cfg = load_cfg(f"{loaders._REPO_DATASETS}/../configs/idgcn_ws.yaml",
                   ["device", "cpu", "tpu.spmm_impl", "xla",
                    "gnn.dim_inner", "16"])
    splits = [p[:4] for p in loaders.create_dataset(cfg)]
    (batch,) = loaders.create_loader(splits, cfg)[0].batches(0)
    batch = batch.to(CPU)
    model = build_model(cfg, CPU)
    model.train()
    pred, label, mask = model(batch)
    torch.nn.functional.cross_entropy(pred[mask], label[mask]).backward()
    n = cfg.gnn.layers_mp
    assert labels == {coo.COO_SUM: n, coo.COO_DEGREE: n, coo.COO_GRAD: n}
    labels.clear()
    model.eval()
    with torch.no_grad():
        model(batch)
    assert labels == {coo.COO_SUM: n, coo.COO_DEGREE: n}


@pytest.mark.parametrize("layer_type,agg,entries", [
    ("Tfg-idgcn", "add", {"coo_loops"}), ("gcnconv", "add", {"coo_loops"}),
    ("sageconv", "add", {"coo"}), ("ginidconv", "add", {"coo"}),
    ("generalconv", "max", {"coo", "edge", "edge_dst"}),
    ("generalconv", "mean", {"coo"})])
def test_loader_builds_the_coo_entries(layer_type, agg, entries):
    root = loaders._REPO_DATASETS
    cfg = load_cfg(f"{root}/../configs/idgcn_ws.yaml",
                   ["device", "cpu", "tpu.spmm_impl", "xla",
                    "gnn.layer_type", layer_type, "gnn.agg", agg])
    splits = [p[:4] for p in loaders.create_dataset(cfg)]
    (batch,) = loaders.create_loader(splits, cfg)[0].batches(0)
    assert set(batch.packs) == entries
    n, e = batch.num_nodes, batch.num_edges
    for kind in entries & {"coo", "coo_loops"}:
        (edges,) = batch.packs[kind]
        p = e + (n if kind == "coo_loops" else 0)
        assert edges.senders.shape == edges.receivers.shape == (p,)
        for index, rows in ((packing.coo_recv_index(edges), edges.receivers),
                            (packing.coo_send_index(edges), edges.senders)):
            assert index.row_ptr[-1] == p
            np.testing.assert_array_equal(np.sort(index.src), np.arange(p))
            np.testing.assert_array_equal(
                rows[index.src], np.repeat(np.arange(n),
                                           np.diff(index.row_ptr)))


@pytest.mark.parametrize("extra,match", [
    (["gnn.layer_type", "gatidconv"], "'att'"),
    (["gnn.layer_type", "generalconv_v2", "gnn.normalize_adj", "True"],
     "'dir'"),
    (["gnn.layer_type", "generalconv", "gnn.agg", "max",
      "gnn.normalize_adj", "True"], "self-loops")])
def test_what_the_route_does_not_run_raises(extra, match):
    cfg = load_cfg(f"{loaders._REPO_DATASETS}/../configs/idgcn_ws.yaml",
                   ["device", "cpu", "tpu.spmm_impl", "xla"] + extra)
    splits = [p[:2] for p in loaders.create_dataset(cfg)]
    with pytest.raises(NotImplementedError, match="ROADMAP A0") as err:
        loaders.create_loader(splits, cfg)[0].batches(0)
    assert err.match(match)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-3),
                                        ("bfloat16", 1e-3)])
def test_main_path_three_adam_steps_match_jax_on_xla(dtype, atol, counted):
    setup = setup_dict("none", 128)
    setup["gnn"]["layers_mp"] = 3
    setup["optim"]["max_epoch"] = 3
    tpu = {"spmm_impl": "xla", "dtype": dtype}
    jcfg = jax_get_cfg()
    jcfg.merge_from_dict(setup)
    jcfg.merge_from_dict({"tpu": tpu})
    jloaders = jax_loaders.create_loader(
        [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu", "tpu": tpu})
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, jtr.state.params), model))
    tr = Trainer(model, lds, cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(3):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 3
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=atol)
    assert abs(tr.eval_epoch(None, 1) - jtr.eval_epoch(None, 1)) < 5e-3
    # the MP layers on K2, and the Tfg node head gathers on no pack
    assert counted["k1"] == 0 and counted["k2"] > 0


def test_sddmm_dot_matches_jax():
    """tests/test_ops.py:109's case, and a random graph."""
    rng = np.random.default_rng(0)
    for n, e, d in ((8, 20, 6), (50, 400, 16)):
        s = rng.integers(0, n, e)
        r = rng.integers(0, n, e)
        a = rng.normal(size=(n, d)).astype(np.float32)
        b = rng.normal(size=(n, d)).astype(np.float32)
        want = jax_sparse.sddmm_dot(jnp.asarray(s), jnp.asarray(r),
                                    jnp.asarray(a), jnp.asarray(b))
        got = sparse.sddmm_dot(torch.as_tensor(s), torch.as_tensor(r),
                               torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_sddmm_edge_grad_matches_jax():
    """tests/test_pallas_kernel.py:109's graph and shapes."""
    rng = np.random.default_rng(1)
    n, e, d = 100, 400, 16
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    jpack = JK.pack_bidir(s, r, w, n)
    want = JK.sddmm_edge_grad(jpack, jnp.asarray(x), jnp.asarray(g))
    pack = K.pack_bidir(s, r, w, n).to(CPU)
    got = K.sddmm_edge_grad(pack, torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
