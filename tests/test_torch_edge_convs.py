"""The port's edge-feature convs against the JAX package's.

Layer level, on one random graph with padding nodes and edges and four
edge feature columns (40 real nodes padded to 48, 120 edges padded to
144; rows 30-39 receive nothing, duplicate edges tie in a max): each of
the six layer types from the same parameters (copied in by name, the
bias drawn from a seed), its output and its gradients (parameters, node
features, and the edge features where the JAX layer differentiates
them) under a seeded cotangent, outputs at rtol 1e-4 / atol 1e-5 and
gradients at rtol 1e-3 / atol 1e-5.  generaledgeconv at every agg x
msg_direction x normalize_adj, generalogbconv at every agg x
normalize_adj, splineconv, the attention convs v1 and v2 with their
options; generalsampleedgeconv in eval mode (every edge) and in train
mode against the JAX layer given the port's drawn mask as its edge mask;
its draws' rate, freshness and seeding.  The JAX layers run their XLA
path (gathers and segment reductions), the port's its packs (the
kernels' plain versions on the CPU).

Model level, on a small TU stand-in with four edge label columns (the
one-hot edge features of graphgym_tpu/data/loaders.py:219-227):
configs/design/design_v2ogb.yaml's model at width 16 and 2 MP layers
for each layer type the card runs: both packages' batches equal, and
three Adam steps within 2e-3 of the JAX package's losses; every layer
type builds and trains through ``main``.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.nn import att_layers as jax_att
from graphgym_tpu.nn import layers as jax_layers
from graphgym_tpu_torch import main as port_main
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders, standins
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.graphs.packing import (BOND_FEATURE_DIMS, EDGE,
                                               EDGE_BOND, EDGE_CONVS,
                                               build_embed_pack, build_packs,
                                               edge_index, kinds_for_layer)
from graphgym_tpu_torch.nn import att_layers, layers
from graphgym_tpu_torch.nn.model import LAYERS, GNNOptions
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from test_torch_att_layers import three_steps
from test_torch_real_configs import assert_batches_equal

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
N_REAL, N_PAD, E_REAL, E_PAD, D_EDGE = 40, 48, 120, 144, 4
AGGS = ("add", "mean", "max")


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


@functools.lru_cache(maxsize=None)
def edge_pair(kinds, ids=False):
    """Both packages' batch of one random graph with edge features (with
    ``ids`` integer ids within the bond tables, else reals in [-0.2,
    1.2]); the port's carries the packs ``kinds``."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, N_REAL, E_REAL)
    r = rng.integers(0, 30, E_REAL)
    s[:6], r[:6] = s[6:12], r[6:12]          # duplicate edges: max ties
    feat = rng.normal(size=(N_REAL, 6)).astype(np.float32)
    if ids:
        ef = np.stack([rng.integers(0, BOND_FEATURE_DIMS[i % 3], E_REAL)
                       for i in range(D_EDGE)], 1).astype(np.float32)
    else:
        ef = rng.uniform(-0.2, 1.2, (E_REAL, D_EDGE)).astype(np.float32)
    kw = dict(edge_feat=ef, pad_nodes_to=N_PAD, pad_edges_to=E_PAD)
    jb = jax_container.build_graph_batch(s, r, feat, **kw)
    b = build_graph_batch(s, r, feat, **kw)
    packs = build_packs(b.senders, b.receivers, b.edge_weight, b.node_mask,
                        b.num_nodes,
                        kinds=[k for k in kinds if k != EDGE_BOND])
    if EDGE_BOND in kinds:
        packs[EDGE_BOND] = (build_embed_pack(b.edge_feat, BOND_FEATURE_DIMS,
                                             False),)
    return jb, b.replace(packs=packs).to(CPU)


def layer(layer_type, **opts):
    """The port's conv of ``layer_type`` as its model builds it (LAYERS),
    at width 6 -> 8 with four edge columns, no BatchNorm (so a bias)."""
    o = GNNOptions(layer_type=layer_type, dim_in=6, dim_out=8,
                   batchnorm=False, dim_edge=D_EDGE, **opts)
    return LAYERS[layer_type](6, 8, o, torch.Generator().manual_seed(0),
                              torch.Generator().manual_seed(3))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, name + "."))
        else:
            out[name] = np.array(v)
    return out


def against_jax(jmod, mod, jb, b, train=False, edge_grad=True,
                jax_mask=None):
    """The layer's output and gradients (parameters, node features and,
    with ``edge_grad``, edge features) under a seeded cotangent, from
    the JAX layer's parameters and statistics (its bias drawn from a
    seed), both in train or eval mode.  ``jax_mask`` replaces the JAX
    batch's edge mask."""
    variables = jmod.init(jax.random.PRNGKey(0), jb, False)
    params = flat(variables["params"])
    if "bias" in params:
        params["bias"] = np.random.default_rng(5).normal(
            size=params["bias"].shape).astype(np.float32)
    stats = flat(variables.get("batch_stats", {}))
    mod.load_state_dict({k: torch.from_numpy(v)
                         for k, v in {**params, **stats}.items()})
    mod.train(train)
    cot = np.random.default_rng(9).normal(size=(N_PAD, 8)).astype(np.float32)
    unflat = jax.tree_util.tree_map(np.asarray, variables["params"])

    def put(tree, prefix=""):
        return {k: put(v, f"{prefix}{k}.") if hasattr(v, "items")
                else params[f"{prefix}{k}"] for k, v in tree.items()}
    jparams = put(unflat)
    jb = jb if jax_mask is None else jb.replace(edge_mask=jnp.asarray(
        jax_mask))

    def jax_loss(p, x, e):
        g = jb.replace(node_feat=x, edge_feat=e)
        if "batch_stats" in variables:
            out, _ = jmod.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                g, train, mutable=["batch_stats"])
        else:
            out = jmod.apply({"params": p}, g, train)
        return jnp.sum(out.node_feat * cot), out.node_feat

    (_, want), (gp, gx, ge) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(
            jparams, jb.node_feat, jb.edge_feat)
    x = b.node_feat.clone().requires_grad_()
    e = b.edge_feat.clone().requires_grad_(edge_grad)
    out = mod(b.replace(node_feat=x, edge_feat=e)).node_feat
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    if edge_grad:
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge),
                                   **GRAD_TOL)
    gp = flat(jax.tree_util.tree_map(np.asarray, gp))
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gp[name], err_msg=name,
                                   **GRAD_TOL)
    return out


@pytest.mark.parametrize("normalize_adj", [False, True])
@pytest.mark.parametrize("direction", ["single", "both"])
@pytest.mark.parametrize("agg", AGGS)
def test_generaledgeconv_matches_jax(agg, direction, normalize_adj):
    kinds = kinds_for_layer("generaledgeconv", agg, msg_direction=direction)
    jb, b = edge_pair(kinds)
    opts = dict(agg=agg, msg_direction=direction,
                normalize_adj=normalize_adj)
    mod = layer("generaledgeconv", **opts)
    assert type(mod) is layers.GeneralEdgeConv
    against_jax(jax_layers.GeneralEdgeConv(8, use_bias=True, **opts), mod,
                jb, b)


@pytest.mark.parametrize("self_msg", ["none", "add"])
def test_generaledgeconv_self_messages(self_msg):
    """'add' adds x where the widths agree (here 8 -> 8), else nothing."""
    jb, b = edge_pair(kinds_for_layer("generaledgeconv"))
    for d_in in (6, 8):
        jx = jnp.asarray(np.random.default_rng(d_in).normal(
            size=(N_PAD, d_in)).astype(np.float32))
        o = GNNOptions(layer_type="generaledgeconv", dim_in=d_in, dim_out=8,
                       batchnorm=False, dim_edge=D_EDGE, self_msg=self_msg)
        mod = LAYERS["generaledgeconv"](d_in, 8, o, torch.Generator(), None)
        against_jax(jax_layers.GeneralEdgeConv(8, use_bias=True,
                                               self_msg=self_msg),
                    mod, jb.replace(node_feat=jx),
                    b.replace(node_feat=torch.from_numpy(np.array(jx))))


def test_splineconv_matches_jax():
    """u = clip(e[:, 0], 0, 1) carries its gradient into edge_feat."""
    jb, b = edge_pair(kinds_for_layer("splineconv"))
    mod = layer("splineconv")
    assert type(mod) is layers.SplineConv
    against_jax(jax_layers.SplineConv(8, use_bias=True), mod, jb, b)


@pytest.mark.parametrize("version,heads,direction,final,train", [
    (1, 1, "single", (False, False), False),
    (1, 4, "both", (True, False), False),
    (2, 4, "single", (True, True), True),
    (2, 2, "both", (False, True), False),
])
def test_edge_attention_convs_match_jax(version, heads, direction, final,
                                        train):
    """v1 (score from the message) and v2 (a key projection), the softmax
    over each receiver's real edges (rows 30-39 have none: zero rows),
    with the final linear and its masked BatchNorm in train or eval
    mode."""
    jb, b = edge_pair(kinds_for_layer(f"generaledgeattconvv{version}",
                                      msg_direction=direction))
    opts = dict(msg_direction=direction, att_final_linear=final[0],
                att_final_linear_bn=final[1])
    mod = layer(f"generaledgeattconvv{version}", att_heads=heads, **opts)
    assert type(mod) is att_layers.GeneralEdgeAttConv
    out = against_jax(jax_att.GeneralEdgeAttConv(
        8, heads=heads, use_bias=True, msg_direction=direction,
        final_linear=final[0], final_linear_bn=final[1], version=version),
        mod, jb, b, train=train)
    if not any(final):
        bias = mod.bias.detach()
        assert torch.allclose(out[30:40].detach(), bias.expand(10, 8))


@pytest.mark.parametrize("normalize_adj", [False, True])
@pytest.mark.parametrize("agg", AGGS)
def test_generalogbconv_matches_jax(agg, normalize_adj):
    """The bond tables' lookup on the 'edge_bond' pack (its gradient K2's
    sum), and with normalize_adj the GCN weights of the real edges."""
    jb, b = edge_pair(kinds_for_layer("generalogbconv", agg), ids=True)
    mod = layer("generalogbconv", agg=agg, normalize_adj=normalize_adj)
    assert type(mod) is att_layers.GeneralOGBConv
    assert mod.num_tables == 3
    against_jax(jax_att.GeneralOGBConv(8, use_bias=True, agg=agg,
                                       normalize_adj=normalize_adj),
                mod, jb, b, edge_grad=False)


def test_k2_calls_name_their_pack(monkeypatch):
    """Every K2 sum of generalogbconv names the batch pack its index came
    from (K2's ``launches_by_pack`` on the card): the receivers' sums
    and normalize_adj's degree on 'edge', the bond tables' gradient on
    'edge_bond'; a K2 by-pack count is snapshotted and replayed as the
    other counters are."""
    seen = []
    real = K.segment_sum

    def record(msg, index, pack=""):
        seen.append(pack)
        return real(msg, index, pack)
    monkeypatch.setattr(K, "segment_sum", record)
    _, b = edge_pair(kinds_for_layer("generalogbconv", "add"), ids=True)
    mod = layer("generalogbconv", agg="add", normalize_adj=True)
    out = mod(b).node_feat
    assert seen == [EDGE, EDGE]
    out.sum().backward()
    assert seen == [EDGE, EDGE, EDGE_BOND]
    k2 = K.packed_segment_matmul_cuda
    saved = K.launch_counts()
    try:
        before = K.launch_counts()
        k2.launches += 3
        k2.launches_by_pack[EDGE] += 2
        k2.launches_by_pack[EDGE_BOND] += 1
        delta = K.launches_between(before, K.launch_counts())
        assert delta[k2.__name__][0] == 3
        assert delta[k2.__name__][3] == {EDGE: 2, EDGE_BOND: 1}
        K.set_launch_counts(before)
        K.add_launch_counts(delta)
        K.add_launch_counts(delta)
        assert k2.launches_by_pack[EDGE_BOND] == \
            before[k2.__name__][3][EDGE_BOND] + 2
    finally:
        K.set_launch_counts(saved)


def test_generalogbconv_needs_edge_features():
    jb, b = edge_pair(kinds_for_layer("generalogbconv"), ids=True)
    with pytest.raises(ValueError, match="integer edge features"):
        layer("generalogbconv")(b.replace(edge_feat=None))


SAMPLE = dict(agg="mean", msg_direction="both", normalize_adj=True,
              keep_edge=0.5)


def test_sample_edge_conv_eval_matches_jax():
    """In eval mode every edge: generaledgeconv's function."""
    jb, b = edge_pair(kinds_for_layer("generalsampleedgeconv", "mean",
                                      msg_direction="both"))
    mod = layer("generalsampleedgeconv", **SAMPLE)
    assert mod.sample_rate == 0.5
    against_jax(jax_layers.GeneralEdgeConv(
        8, use_bias=True, agg="mean", msg_direction="both",
        normalize_adj=True, sample_rate=0.5), mod, jb, b)


@pytest.mark.parametrize("agg", AGGS)
def test_sample_edge_conv_train_matches_jax_on_its_mask(agg):
    """In train mode the layer draws its kept edges; given them as its
    edge mask, the JAX layer (eval mode: no draw of its own) computes
    the same output and gradients: the degree, the mean's count and the
    max follow the draw."""
    jb, b = edge_pair(kinds_for_layer("generalsampleedgeconv", agg,
                                      msg_direction="both"))
    mod = layer("generalsampleedgeconv", **{**SAMPLE, "agg": agg})
    mod.train()
    state = mod.sample_generator.get_state()
    live = mod.live_edges(b).numpy()
    mod.sample_generator.set_state(state)
    assert 0 < live.sum() < E_REAL
    against_jax(jax_layers.GeneralEdgeConv(
        8, use_bias=True, agg=agg, msg_direction="both",
        normalize_adj=True), mod, jb, b, train=True, jax_mask=live)


def test_sample_edge_conv_draws():
    """The kept share within 3 sigma of keep_edge over 50 draws, a fresh
    mask each train call, every real edge in eval, and the same masks
    from a generator of the same seed."""
    _, b = edge_pair(kinds_for_layer("generalsampleedgeconv"))
    masks = []
    for _ in range(2):
        mod = layer("generalsampleedgeconv", keep_edge=0.3)
        mod.train()
        masks.append(np.stack([mod.live_edges(b).numpy()
                               for _ in range(50)]))
    draws = masks[0]
    np.testing.assert_array_equal(masks[0], masks[1])
    assert not draws[:, E_REAL:].any()
    trials = 50 * E_REAL
    sigma = np.sqrt(trials * 0.3 * 0.7)
    assert abs(draws.sum() - 0.3 * trials) < 3 * sigma
    assert len({m.tobytes() for m in draws}) == 50
    mod.eval()
    np.testing.assert_array_equal(mod.live_edges(b).numpy(),
                                  np.arange(E_PAD) < E_REAL)


def test_edge_pack_slots():
    """The 'edge' pack: each batch edge in one slot of its receiver's
    row, the slots of no edge pointing past the edges; K2's index lists
    every batch edge once and no slot of no edge, the real edges by
    receiver and then in edge order, each edge's row its receiver, the
    padding edges after the rows, left out."""
    _, b = edge_pair(kinds_for_layer("generaledgeconv"))
    fwd, slots = b.packs[EDGE]
    se = slots.slot_edge.reshape(-1).long()
    held = se < E_PAD
    assert held.sum() == E_PAD
    np.testing.assert_array_equal(se[slots.edge_slot.long()],
                                  np.arange(E_PAD))
    np.testing.assert_array_equal(fwd.weights.reshape(-1)[held],
                                  (b.edge_weight[se[held]] != 0).float())
    order = slots.edge_order.long()
    assert sorted(order.tolist()) == list(range(E_PAD))
    rows = K.index_rows(edge_index(slots), E_PAD)
    real = b.edge_weight[order] != 0
    np.testing.assert_array_equal(rows[real], b.receivers[order][real])
    assert (rows[~real] == b.num_nodes).all() and not real[E_REAL:].any()
    np.testing.assert_array_equal(slots.edge_row[order], rows)
    key = rows * E_PAD + order
    assert torch.all(key[1:] > key[:-1])
    assert slots.row_ptr.numel() == b.num_nodes + 1
    assert slots.row_ptr[-1] == E_REAL


# ---------------------------------------------------------------- models

BONDS = dict(graphs=24, nodes=400, edges=700, min_nodes=8, max_nodes=30,
             large=0, attributes=4, edge_labels=4)
# configs/design/design_v2ogb.yaml on the TU stand-in, no encoders, no
# ego transform, small
BOND_OPTS = ("dataset.format", "PyG", "dataset.name", "TU_BONDS",
             "dataset.transform", "none", "dataset.node_encoder", "False",
             "dataset.edge_encoder", "False", "dataset.split",
             "[0.8, 0.1, 0.1]", "gnn.layers_mp", "2", "gnn.dim_inner", "16",
             "train.batch_size", "32")
# the card's paths: layer type and its overrides
CARD_PATHS = {
    "edge_general": ("generaledgeconv",),
    "edge_sample": ("generalsampleedgeconv", "gnn.keep_edge", "0.5",
                    "gnn.agg", "mean", "gnn.normalize_adj", "True",
                    "gnn.msg_direction", "both"),
    "edge_spline": ("splineconv",),
    "edge_att": ("generaledgeattconvv2", "gnn.att_heads", "4",
                 "gnn.att_final_linear", "True", "gnn.att_final_linear_bn",
                 "True"),
    "edge_ogb": ("generalogbconv",),
}


@pytest.fixture(scope="module")
def bond_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bonds"))
    standins.write_tu_standin(d, "BONDS", seed=5, **BONDS)
    return d


@functools.lru_cache(maxsize=None)
def bond_data(d, path):
    layer_type, *extra = CARD_PATHS[path]
    opts = list(BOND_OPTS) + ["dataset.dir", d, "gnn.layer_type",
                              layer_type, *extra]
    cfg_file = os.path.join(ROOT, "configs", "design", "design_v2ogb.yaml")
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


def test_bond_batches_match_jax(bond_dir):
    """The TU edge labels as four one-hot columns, in both packages'
    batches; the port's carry the edge packs."""
    jcfg, cfg, jlds, lds = bond_data(bond_dir, "edge_ogb")
    assert cfg.dataset.edge_dim == 4
    for jld, ld in zip(jlds, lds):
        jb, b = jld.batches(0)[0], ld.batches(0)[0]
        assert_batches_equal(jb, b)
        assert b.edge_feat.shape[1] == 4
        assert set(b.packs) == {"edge", "edge_src", "edge_bond",
                                "pool_add"}


@pytest.mark.parametrize("path", sorted(CARD_PATHS))
def test_card_path_three_steps_match_jax(bond_dir, path):
    """Three Adam steps of design_v2ogb.yaml's model (pre-MP, BN, PReLU,
    add pooling) at each card path's layer type; the sampling conv draws
    its own masks in each package, so it trains at keep_edge 1 here."""
    jcfg, cfg, jlds, lds = bond_data(bond_dir, path)
    if path == "edge_sample":
        jcfg.gnn.keep_edge = cfg.gnn.keep_edge = 1.0
    model = three_steps(jcfg, cfg, jlds[0].batches(0)[0],
                        lds[0].batches(0)[0].to(CPU), l2_kernel=0.0)
    conv = model.mp.layers[0].layer
    assert type(conv).__name__ == {
        "edge_general": "GeneralEdgeConv", "edge_sample": "GeneralEdgeConv",
        "edge_spline": "SplineConv", "edge_att": "GeneralEdgeAttConv",
        "edge_ogb": "GeneralOGBConv"}[path]


@pytest.mark.parametrize("layer_type", EDGE_CONVS)
def test_edge_layer_types_build_and_train(bond_dir, layer_type, tmp_path):
    """Each of the six layer types builds and trains two epochs through
    the entry point on the CPU."""
    out = str(tmp_path / "out")
    port_main.main(["--cfg", os.path.join(ROOT, "configs", "design",
                                          "design_v2ogb.yaml"),
                    *BOND_OPTS, "dataset.dir", bond_dir, "gnn.layer_type",
                    layer_type, "device", "cpu", "optim.max_epoch", "2",
                    "train.eval_period", "1", "out_dir", out])
    with open(os.path.join(out, "design_v2ogb", "1", "train",
                           "stats.json")) as f:
        losses = [float(line.split('"loss": ')[1].split(",")[0])
                  for line in f if line.strip()]
    assert len(losses) == 2 and all(np.isfinite(losses))
