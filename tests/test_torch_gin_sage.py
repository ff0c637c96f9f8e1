"""The port's GIN, SAGE and GCN layers, the masked BatchNorm and the
'plain' / 'mean' packs against the JAX package's.

Packs: the 'plain' and 'mean' packs equal the JAX numpy packer's arrays.
MaskedBatchNorm: train and eval output, input and parameter gradients,
and the running statistics after a step, at 1e-6.  Layers (GINConv,
SAGEConv, GCNConv, GINIDConv, TfgIDSAGE) on a random graph whose
features bf16 holds exactly (so the TPU kernel's hi/lo split of the
forward SpMM is exact): forward rtol 1e-4 / atol 1e-5, parameter
gradients rtol 1e-3 / atol 1e-5, running statistics at 1e-6.  Models:
the five new Tfg layer types, eval logits from the same variables
(rtol 1e-4 / atol 1e-5) and the kernel-L2 set; params_from_jax with
batch_stats; two epochs of Tfg-idgin and Tfg-idsage training (ws, 6
graphs per split, 2 layers, width 16, as tests/test_torch_train.py):
per-step losses within 2e-3, running statistics within 1e-5, validation
accuracy within 5e-3.  The JAX side runs its numpy host paths and the
Pallas kernel in interpret mode.
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
from graphgym_tpu.graphs import packing as jax_packing
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu.train.loss import kernel_l2 as jax_kernel_l2
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.graphs import packing
from graphgym_tpu_torch.graphs.container import bucket_size, build_graph_batch
from graphgym_tpu_torch.nn import id_layers, layers, norm
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.loss import kernel_l2
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_spmm import FIELDS, random_graph
from test_torch_train import StepRecorder

CPU = torch.device("cpu")


@pytest.fixture
def jax_numpy_packer(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def flat_state(tree, prefix=""):
    """A flax variables tree as {'a.b.c': tensor}."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(val, dict) or hasattr(val, "items"):
            out.update(flat_state(val, name))
        else:
            out[name] = torch.from_numpy(np.array(val))
    return out


def bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


# --------------------------------------------------------------- packs


@pytest.mark.parametrize("kind", ["plain", "mean"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_mean_packs_match_jax(jax_numpy_packer, kind, seed):
    s, r, w, n = random_graph(seed)
    mask = np.arange(n) < 300
    want = jax_packing.build_packs(s, r, w, mask, n, kinds=(kind,))[kind]
    got = packing.build_packs(s, r, w, mask, n, kinds=(kind,))[kind]
    assert len(got) == 2
    for want_p, got_p in zip(want, got):
        assert got_p.senders.shape[0] == bucket_size(got_p.senders.shape[0])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got_p, f),
                                          getattr(want_p, f), f)
    if kind == "mean":
        # each receiver's weights are the mean of its in-edges' weights,
        # counting the edges of nonzero weight
        fwd, sums = got[0], np.zeros(n)
        np.add.at(sums, (fwd.tiles[:, None] * 128 + fwd.local_rows)
                  .reshape(-1), fwd.weights.reshape(-1))
        count = np.bincount(r[w != 0], minlength=n)
        has = count > 0
        np.testing.assert_allclose(
            sums[has], np.bincount(r, w, minlength=n)[has] / count[has],
            rtol=1e-5)
        assert (sums[~has] == 0).all()


# ---------------------------------------------------------- batch norm


@pytest.mark.parametrize("masked,eps,mom", [(True, 1e-5, 0.1),
                                            (False, 1e-3, 0.3),
                                            (True, 1e-3, 0.3)])
def test_masked_batch_norm_matches_jax(masked, eps, mom):
    from graphgym_tpu.nn.norm import MaskedBatchNorm as JaxBN

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(20, 6)) * 3 + 1).astype(np.float32)
    mask = rng.random(20) > 0.3 if masked else None
    cot = rng.normal(size=(20, 6)).astype(np.float32)
    scale = rng.normal(size=6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    jbn = JaxBN(6, eps=eps, momentum=mom)
    jmask = None if mask is None else jnp.asarray(mask)
    stats = jbn.init(jax.random.PRNGKey(0), x, jmask, False)["batch_stats"]
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def jax_loss(p, xx):
        y, mut = jbn.apply({"params": p, "batch_stats": stats}, xx, jmask,
                           True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (want, new_stats)), (dp, dx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    bn = norm.MaskedBatchNorm(6, eps=eps, momentum=mom)
    bn.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        **flat_state(to_numpy(stats))})
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bn(xt, None if mask is None else torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(bn.scale.grad.numpy(),
                               np.asarray(dp["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(dp["bias"]), **tol)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(new_stats[name]), **tol)
    # eval mode normalizes with the running statistics
    want_eval = jbn.apply({"params": params, "batch_stats": new_stats},
                          jnp.asarray(x), jmask, False)
    bn.eval()
    np.testing.assert_allclose(
        bn(torch.from_numpy(x), None).detach().numpy(),
        np.asarray(want_eval), **tol)


def test_l2_normalize_matches_jax():
    from graphgym_tpu.nn.norm import l2_normalize as jax_l2_normalize

    x = np.random.default_rng(2).normal(size=(5, 4)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(
        norm.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- layers


@pytest.fixture(scope="module")
def layer_graphs():
    """One random graph (bf16-exact features, 40 ego centers plus 8
    masked padding entries) as a JAX GraphBatch and a port GraphBatch,
    both with their 'gcn', 'plain' and 'mean' packs."""
    s, r, w, n = random_graph(7, e=1500, hot=700)
    real = w != 0
    s, r = s[real], r[real]
    rng = np.random.default_rng(7)
    feat = bf16_exact(rng.normal(size=(299, 8)))
    ids = rng.choice(299, 40, replace=False)
    id_index = np.concatenate([ids, np.full(8, n - 1)]).astype(np.int32)
    id_mask = np.arange(48) < 40
    kinds = ("gcn", "plain", "mean")
    batches = []
    for container, pk in ((jax_container, jax_packing),
                          (None, packing)):
        build = (container.build_graph_batch if container
                 else build_graph_batch)
        b = build(s, r, feat, pad_nodes_to=n, pad_edges_to=1600)
        b = b.replace(node_id_index=id_index, id_mask=id_mask)
        batches.append(b.replace(packs=pk.build_packs(
            b.senders, b.receivers, b.edge_weight, b.node_mask,
            b.num_nodes, kinds=kinds)))
    return batches[0], batches[1].to(CPU)


def layer_pair(name):
    """(JAX flax module, port module) of one layer, 8 -> 16."""
    from graphgym_tpu.nn import id_layers as jax_id_layers
    from graphgym_tpu.nn import layers as jax_layers

    gen = torch.Generator().manual_seed(0)
    return {
        "GINConv": (jax_layers.GINConv(16, mlp_bn=True),
                    layers.GINConv(8, 16, mlp_bn=True, generator=gen)),
        "SAGEConv-concat": (
            jax_layers.SAGEConv(16, use_bias=True, combine="concat"),
            layers.SAGEConv(8, 16, use_bias=True, combine="concat",
                            generator=gen)),
        "SAGEConv-sum": (
            jax_layers.SAGEConv(16, use_bias=True, combine="sum"),
            layers.SAGEConv(8, 16, use_bias=True, combine="sum",
                            generator=gen)),
        "GCNConv": (jax_layers.GCNConv(16, use_bias=True),
                    layers.GCNConv(8, 16, use_bias=True, generator=gen)),
        "GINIDConv": (jax_id_layers.GINIDConv(16, mlp_bn=True),
                      id_layers.GINIDConv(8, 16, mlp_bn=True,
                                          generator=gen)),
        "TfgIDSAGE": (jax_id_layers.TfgIDSAGE(16, use_bias=True),
                      id_layers.TfgIDSAGE(8, 16, generator=gen)),
    }[name]


@pytest.mark.parametrize("name", ["GINConv", "SAGEConv-concat",
                                  "SAGEConv-sum", "GCNConv", "GINIDConv",
                                  "TfgIDSAGE"])
def test_layer_matches_jax(layer_graphs, name):
    jb, b = layer_graphs
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
    if new_stats:       # eval mode normalizes with the running statistics
        want_eval = jmod.apply({"params": variables["params"],
                                **mut}, jb, False).node_feat
        mod.eval()
        np.testing.assert_allclose(mod(b).node_feat.detach().numpy(),
                                   np.asarray(want_eval), rtol=1e-4,
                                   atol=1e-5)


def test_gin_agg_other_than_sum_not_ported():
    """Every gin_agg builds, each on its own pack (once only 'sum' was
    ported; the variants against the JAX package in
    tests/test_torch_gin_agg.py); SAGE's concat needs an even width."""
    gen = torch.Generator()
    kinds = {agg: layers.GINConv(4, 4, agg=agg, generator=gen).kind
             for agg in ("sum", "gcn", "gcn_noself", "mean")}
    assert kinds == {"sum": "plain", "gcn": "gcn",
                     "gcn_noself": "gcn_noself", "mean": "wmean"}
    with pytest.raises(ValueError, match="even"):
        layers.SAGEConv(4, 5, combine="concat", generator=gen)


# -------------------------------------------------------------- models


NEW_TYPES = ["Tfg-idgin", "Tfg-idsage", "Tfg-ginconv", "Tfg-sageconv",
             "Tfg-gcnconv"]


def setup_dict(layer_type, **optim):
    return {
        "dataset": {"format": "nx", "name": "ws", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 4,
                    "transform": "ego" if "id" in layer_type else "none"},
        "gnn": {"layers_mp": 2, "dim_inner": 16, "layer_type": layer_type},
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


@pytest.fixture(scope="module", params=NEW_TYPES)
def model_pair(request):
    jcfg, cfg = configs(setup_dict(request.param))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        jsplits = [p[:6] for p in jax_loaders.create_dataset(jcfg)]
        jbatch = jax_loaders.create_loader(jsplits, jcfg)[1].batches(0)[0]
    splits = [p[:6] for p in loaders.create_dataset(cfg)]
    batch = loaders.create_loader(splits, cfg)[1].batches(0)[0]
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(dict(jmodel.init(jax.random.PRNGKey(0), jbatch,
                                          False)))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(variables, model))
    return request.param, jmodel, variables, jbatch, model, batch.to(CPU)


def test_model_logits_and_l2_match_jax(model_pair):
    layer_type, jmodel, variables, jbatch, model, batch = model_pair
    want, _, _ = jmodel.apply(variables, jbatch, False)
    model.eval()
    got, _, _ = model(batch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    l2 = float(jax_kernel_l2(variables["params"], 5e-4))
    assert abs(kernel_l2(model, 5e-4).item() - l2) <= 1e-6 * l2
    has_bn = "gin" in layer_type
    assert bool(variables.get("batch_stats")) == has_bn
    assert len(list(model.buffers())) == (
        {"Tfg-idgin": 8, "Tfg-ginconv": 4}.get(layer_type, 0))


def test_params_from_jax_maps_batch_stats(model_pair):
    """Every parameter and buffer gets its flax leaf; a params tree
    alone (a gradient) maps the parameters; a leaf left over or missing
    on either side raises."""
    layer_type, _, variables, _, model, _ = model_pair
    params, stats = variables["params"], variables.get("batch_stats", {})
    state = params_from_jax(variables, model)
    assert set(state) == set(model.state_dict())
    assert set(params_from_jax(params, model)) == {
        n for n, _ in model.named_parameters()}
    if layer_type == "Tfg-idgin":
        assert sorted(stats["mp"]["GINIDConv_1"]) == ["mlp_bn", "mlp_id_bn"]
        np.testing.assert_array_equal(
            state["mp.layers.1.layer.mlp_id_bn.var"].numpy(),
            stats["mp"]["GINIDConv_1"]["mlp_id_bn"]["var"])
        np.testing.assert_array_equal(
            state["mp.layers.0.layer.mlp_bn.scale"].numpy(),
            params["mp"]["GINIDConv_0"]["mlp_bn"]["scale"])
        short = {"params": params, "batch_stats": {"mp": {
            "GINIDConv_0": stats["mp"]["GINIDConv_0"]}}}
        with pytest.raises(KeyError, match="mp.layers.1.layer.mlp_bn.mean"):
            params_from_jax(short, model)
    stray = {"params": params, "batch_stats": {**stats, "post_mp": {
        "stray": np.zeros(2)}}}
    with pytest.raises(KeyError, match="stray"):
        params_from_jax(stray, model)
    short = {"params": {**params, "post_mp": {
        k: v for k, v in params["post_mp"].items() if k != "head_bias2"}}}
    with pytest.raises(KeyError, match="head_bias2"):
        params_from_jax(short, model)


@pytest.mark.parametrize("layer_type", ["Tfg-idgin", "Tfg-idsage"])
def test_two_epochs_match_jax(monkeypatch, layer_type):
    """Two epochs from the same parameters and running statistics: the
    check of tests/test_torch_train.py, and the running statistics after
    the first step, which both packages take from the same parameters.
    (After it the parameters differ by up to 2 * lr: a bias that feeds a
    BatchNorm has a gradient that is rounding noise in both packages,
    and Adam's first step moves it by about +-lr whatever its size.)"""
    monkeypatch.setattr(jax_native, "load", lambda: None)
    jcfg, cfg = configs(setup_dict(layer_type, scheduler="cos",
                                   max_epoch=2))
    jloaders = jax_loaders.create_loader(
        [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    model = build_model(cfg, CPU)

    def jax_state():
        return params_from_jax(to_numpy({"params": jtr.state.params,
                                         "batch_stats":
                                         jtr.state.batch_stats}), model)

    model.load_state_dict(jax_state())
    tr = Trainer(model, lds, cfg, CPU)
    buffers = dict(model.named_buffers())
    assert len(buffers) == (8 if layer_type == "Tfg-idgin" else 0)
    assert len(lds[0]) == 1

    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(2):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
        if epoch == 0:
            want = jax_state()
            for name, buf in buffers.items():
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                           rtol=0, atol=1e-5, err_msg=name)
    assert len(rec.losses) == len(jrec.losses) == 2
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert abs(tr.eval_epoch(None, 1) - jtr.eval_epoch(None, 1)) < 5e-3


@pytest.mark.parametrize("config,kind", [("idgin_ws", "plain"),
                                         ("idsage_ws", "mean")])
def test_gin_sage_path_shapes(config, kind):
    """The configs' batches at the shapes PERF.md records: one batch
    per split; fwd and bwd packs bucketed from 408 / 87 chunks to 448 /
    96; the slots of nonzero weight, which K1 reads; and the longest
    row of the pack, row 0 of the last tile, which collects the
    bucket-padding chunks and the tile's own padding slots."""
    import os

    from graphgym_tpu_torch.config import load_cfg
    from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_cfg(os.path.join(root, "configs", f"{config}.yaml"),
                   ["device", "cpu"])
    lds = loaders.create_loader(loaders.create_dataset(cfg), cfg)
    want = [(49152, 163840, 408, 448, 138566, 41286),
            (10240, 40960, 87, 96, 33250, 9698)]
    for ld, (n, e, chunks, bucketed, nonzero, longest) in zip(lds, want):
        (b,) = ld.batches(0)
        fwd, bwd = b.packs[kind]
        assert (b.num_nodes, b.num_edges) == (n, e)
        unpadded, _ = K.pack_csr_with_slots(b.senders, b.receivers,
                                            b.edge_weight, n)
        assert unpadded.senders.shape[0] == chunks
        assert fwd.senders.shape == bwd.senders.shape == (bucketed, 1024)
        assert int((fwd.weights != 0).sum()) == nonzero
        assert int((fwd.row_range[:, 1] - fwd.row_range[:, 0]).sum()) \
            == nonzero
        rows = np.bincount((fwd.tiles[:, None] * 128
                            + fwd.local_rows).reshape(-1))
        assert (rows.max(), rows.argmax()) == (longest, n - 128)
