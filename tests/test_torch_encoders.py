"""The port's feature encoders (graphgym_tpu_torch/nn/encoders.py) and
the batch's edge features against the JAX package's.

Each encoder from carried flax tables: its output (rtol 1e-4, atol
1e-5) and its tables' gradients under a seeded cotangent (rtol 1e-3,
atol 1e-5), padding rows included; the lookup's gradient is the
embedding pack's segmented sum (K2's plain version here), which equals
autograd's ``index_select`` gradient.  IntegerFeatureEncoder and
SingleAtomEncoder copy flax ``nn.Embed`` on unclipped ids: an id past
the table gives a NaN row and no gradient, -1 the last row; Atom and
Bond clip.  K2's fixed-shape index (``segment_index_host``), run as
the kernel runs it in numpy, sums every slot once.  ``GraphBatch.edge_feat``
equals the JAX collation (zeros on padded edges, None unless every graph
of the batch has edge features), and the GNN's encoder stage (the
encoders, their masked BatchNorms, encoder_dim into pre-MP) matches the
JAX GNN's logits and gradients on a TU set with edge labels, the Bond
encoder on the edge features.  A registered encoder replaces a built-in
one of its name, and the loader builds no pack for it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.graphs.container import build_graph_batch as jax_batch
from graphgym_tpu.nn import encoders as jax_enc
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loss import LossOptions as JaxLossOptions
from graphgym_tpu.train.loss import compute_loss as jax_compute_loss
from graphgym_tpu_torch import register
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders, standins
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.graphs.packing import (EDGE_ENCODER, EMBED_TABLES,
                                               NODE_ENCODER,
                                               build_embed_pack)
from graphgym_tpu_torch.nn import encoders
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss
from graphgym_tpu_torch.weights import params_from_jax

CPU = torch.device("cpu")
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
N, E, PAD_N, PAD_E, DIM = 40, 60, 48, 64, 8


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def id_features(rng, n, dims):
    return np.stack([rng.integers(0, d, n) for d in dims],
                    axis=1).astype(np.float32)


def batches(node_feat, edge_feat):
    """The same graph in both packages' host batches, padded."""
    rng = np.random.default_rng(5)
    s, r = rng.integers(0, N, E), rng.integers(0, N, E)
    kw = dict(edge_feat=edge_feat, pad_nodes_to=PAD_N, pad_edges_to=PAD_E)
    return (jax_batch(s, r, node_feat, **kw),
            build_graph_batch(s, r, node_feat, **kw))


def with_packs(batch, node=None, edge=None):
    packs = {}
    if node:
        packs[NODE_ENCODER] = (build_embed_pack(batch.node_feat,
                                                *EMBED_TABLES[node]),)
    if edge:
        packs[EDGE_ENCODER] = (build_embed_pack(batch.edge_feat,
                                                *EMBED_TABLES[edge]),)
    return batch.replace(packs=packs).to(CPU)


CASES = {
    "Atom": (jax_enc.AtomEncoder, encoders.AtomEncoder, NODE_ENCODER),
    "Integer": (jax_enc.IntegerFeatureEncoder,
                encoders.IntegerFeatureEncoder, NODE_ENCODER),
    "SingleAtom": (jax_enc.SingleAtomEncoder, encoders.SingleAtomEncoder,
                   NODE_ENCODER),
    "Bond": (jax_enc.BondEncoder, encoders.BondEncoder, EDGE_ENCODER),
}


def port_params(jparams, name):
    """The flax tables under the port's names (weights.py's mapping,
    without the node_encoder prefix)."""
    (inner,) = jparams.values()
    if "embedding" in inner:
        return {"embedding": inner["embedding"]}
    return {col: v["embedding"] for col, v in inner.items()}


def run_both(name, node_feat, edge_feat, seed=0):
    jcls, cls, kind = CASES[name]
    jb, b = batches(node_feat, edge_feat)
    b = with_packs(b, node=name if kind == NODE_ENCODER else None,
                   edge=name if kind == EDGE_ENCODER else None)
    jmod = jcls(DIM)
    params = to_numpy(jmod.init(jax.random.PRNGKey(seed), jb))["params"]
    field = "edge_feat" if kind == EDGE_ENCODER else "node_feat"
    rows = PAD_E if kind == EDGE_ENCODER else PAD_N
    cot = np.random.default_rng(seed + 1).normal(
        size=(rows, DIM)).astype(np.float32)

    def jax_out(p):
        return getattr(jmod.apply({"params": p}, jb), field)

    want, vjp = jax.vjp(jax_out, params)
    (jgrads,) = vjp(jnp.asarray(cot))
    mod = cls(DIM, torch.Generator().manual_seed(0))
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         port_params(params, name).items()}, strict=False)
    got = getattr(mod(b), field)
    (got * torch.from_numpy(cot)).sum().backward()
    return (np.asarray(want), got.detach().numpy(),
            port_params(to_numpy(jgrads), name), mod)


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_matches_jax(name):
    rng = np.random.default_rng(3)
    node = id_features(rng, N, [119, 4, 12, 12, 10, 6, 6, 2, 2])
    edge = id_features(rng, E, [5, 6, 2])
    want, got, jgrads, mod = run_both(name, node, edge)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for key, g in jgrads.items():
        np.testing.assert_allclose(getattr(mod, key).grad.numpy(), g,
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("name", ["Atom", "Bond"])
def test_multi_column_encoders_clip_ids(name):
    """Atom / Bond clip an id into its table: past the end takes the
    last row, below 0 the first, as the JAX encoders' jnp.clip."""
    rng = np.random.default_rng(4)
    node = id_features(rng, N, [119] * 9)
    node[:5] = 400
    node[5:10] = -7
    edge = id_features(rng, E, [9, 9, 9])
    want, got, jgrads, mod = run_both(name, node, edge)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for key, g in jgrads.items():
        np.testing.assert_allclose(getattr(mod, key).grad.numpy(), g,
                                   err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("name", ["Integer", "SingleAtom"])
def test_unclipped_ids_nan_row_and_wrap(name):
    """flax nn.Embed on an unclipped id: at or past the table a NaN row
    (no gradient for it), -1 the last row, -rows the first, below
    -rows NaN; the port gives the same rows and gradients."""
    rows = EMBED_TABLES[name][0][0]
    node = np.zeros((N, 1), np.float32)
    node[:, 0] = np.arange(N) % 7
    node[1, 0], node[2, 0], node[3, 0] = rows, rows + 50, -1
    node[4, 0], node[5, 0] = -rows, -rows - 1
    want, got, jgrads, mod = run_both(name, node, None)
    bad = [1, 2, 5]
    assert np.isnan(want[bad]).all() and np.isnan(got[bad]).all()
    keep = np.setdiff1d(np.arange(PAD_N), bad)
    assert np.isfinite(got[keep]).all()
    np.testing.assert_allclose(got[keep], want[keep], **FWD_TOL)
    table = mod.embedding.detach().numpy()
    np.testing.assert_array_equal(got[3], table[-1])
    np.testing.assert_array_equal(got[4], table[0])
    np.testing.assert_allclose(mod.embedding.grad.numpy(),
                               jgrads["embedding"], **GRAD_TOL)


def assert_sums_close(got, want, scale, rel=1e-5, atol=1e-6):
    """|got - want| <= rel x (the sum of |terms|) + atol, element for
    element: an f32 sum against the float64 sum of the same terms, held
    to the rounding its terms' magnitudes allow (a sum that cancels is
    small beside its rounding error)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= rel * np.asarray(scale) + atol), \
        float(np.max(err - rel * np.asarray(scale)))


def test_table_grad_plain_equals_autograd():
    """The pack's gradient (K2's plain version over the sorted slots)
    equals autograd's gradient of the plain gathers; in f32, the lookup
    and the gradient within the rounding of their sums."""
    rng = np.random.default_rng(6)
    dims, _ = EMBED_TABLES["Atom"]
    feat = id_features(rng, 300, dims)
    pack = build_embed_pack(feat, dims, True)
    tpack = type(pack)(*(torch.from_numpy(a) for a in pack))
    gen = torch.Generator().manual_seed(6)
    table = torch.randn(sum(dims), 5, dtype=torch.float64, generator=gen,
                        requires_grad=True)
    g = torch.randn(300, 5, dtype=torch.float64, generator=gen)
    out = sum(table.index_select(0, tpack.rows[:, c].long())
              for c in range(len(dims)))
    (want,) = torch.autograd.grad(out, table, g, retain_graph=True)
    got = encoders.table_grad(tpack, g, sum(dims))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    t32 = table.detach().float().requires_grad_(True)
    fwd = encoders.EmbedSumFn.apply(t32, tpack, NODE_ENCODER)
    fwd_scale = sum(table.detach().abs().index_select(
        0, tpack.rows[:, c].long()) for c in range(len(dims)))
    assert_sums_close(fwd.detach().numpy(), out.detach().numpy(),
                      fwd_scale.numpy())
    fwd.backward(g.float())
    (grad_scale,) = torch.autograd.grad(out, table, g.abs())
    assert_sums_close(t32.grad.numpy(), want.numpy(), grad_scale.numpy())


def emulate_k2(msg, index):
    """csrc/packed_segment.cu in numpy: a row with no run summed by its
    owner in position order, a long row's runs of run_len positions
    summed into partials and the partials added in run order,
    GROUP_RUNS at a time and then the groups; each output row written
    once."""
    d = msg.shape[1]
    n_out = len(index.row_ptr) - 1
    out = np.full((n_out, d), np.nan)
    ptr = index.row_ptr
    long_rows = set(index.run_row[index.run_row >= 0].tolist())
    for r in range(n_out):
        if r not in long_rows:
            out[r] = msg[index.src[ptr[r]:ptr[r + 1]]].sum(0)
    partial = np.full((len(index.run_row), d), np.nan)
    for j, row in enumerate(index.run_row):
        if row >= 0:
            n = index.run_len[j]
            lo = ptr[row] + (j - index.run_first[j]) * n
            hi = min(lo + n, ptr[row + 1])
            partial[j] = msg[index.src[lo:hi]].sum(0)
    g = K.GROUP_RUNS
    for j, row in enumerate(index.run_row):
        if row >= 0 and index.run_first[j] == j:
            assert np.isnan(out[row]).all()
            runs = -(-(ptr[row + 1] - ptr[row]) // index.run_len[j])
            out[row] = sum(partial[g0:min(g0 + g, j + runs)].sum(0)
                           for g0 in range(j, j + runs, g))
    return out


@pytest.mark.parametrize("slots,long_rows", [(0, 0), (37, 0), (900, 2),
                                             (5000, 1)])
def test_fixed_runs_cover_every_slot(slots, long_rows):
    """segment_index_host: shapes of the slot count and n_out alone; the
    rows of more than OWNER_SLOTS slots, and only those, cut into runs
    of run_length slots in row and run order; the emulated kernel sums
    every slot once (equal to index_add_), as the plain version does."""
    rng = np.random.default_rng(slots)
    n_out = 256
    rows = np.sort(np.concatenate([
        rng.integers(0, 200, slots - 300 * long_rows),
        np.full(300 * long_rows, 7)]))
    items = rng.permutation(slots).astype(np.int32)
    index = K.segment_index_host(rows, n_out, items)
    assert [len(a) for a in index] == [n_out + 1, slots] + [
        K.segment_runs_bound(slots)] * 4
    np.testing.assert_array_equal(index.row_ptr,
                                  np.searchsorted(rows, np.arange(n_out + 1)))
    live = index.run_row >= 0
    counts = np.bincount(rows, minlength=n_out)
    long = np.flatnonzero(counts > K.OWNER_SLOTS)
    assert (7 in long) == bool(long_rows)
    np.testing.assert_array_equal(
        index.run_row[live],
        np.repeat(long, -(-counts[long] // K.run_length(
            counts[long], counts[long].sum()))))
    assert not live[live.sum():].any()
    assert not index.arrivals.any()
    msg = rng.normal(size=(slots, 3))
    want = np.zeros((n_out, 3))
    np.add.at(want, rows, msg[items])
    np.testing.assert_allclose(emulate_k2(msg, index), want,
                               rtol=1e-12, atol=1e-12)
    plain = K.segment_sum_plain(
        torch.from_numpy(msg.astype(np.float32)),
        K.SegmentIndex(*(torch.from_numpy(a) for a in index)))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def test_embed_pack_shape_depends_on_size_only():
    """Two batches of one loader share one captured program: the pack's
    shapes follow the item count and the tables, not the ids."""
    dims, clip = EMBED_TABLES["Atom"]
    rng = np.random.default_rng(8)
    a = build_embed_pack(id_features(rng, 500, dims), dims, clip)
    b = build_embed_pack(np.zeros((500, 9), np.float32), dims, clip)
    assert [x.shape for x in a] == [x.shape for x in b]
    assert [x.dtype for x in a] == [np.int32] * 7


TU_EDGES = dict(graphs=12, nodes=200, edges=300, min_nodes=5,
                max_nodes=40, large=0)


@pytest.fixture(scope="module")
def tu_dir(tmp_path_factory):
    """A TU set with integer-valued node attributes (the Integer
    encoder's ids: many distinct rows, so the encoder BatchNorm's
    gradient does not cancel to rounding noise) and three integer-valued
    edge attribute columns (the Bond encoder's ids)."""
    d = str(tmp_path_factory.mktemp("tu"))
    rng = np.random.default_rng(9)
    sizes = [int(x) for x in rng.integers(5, 25, 12)]
    edges, off = [], 0
    for n in sizes:
        e = np.stack([np.arange(n - 1), np.arange(1, n)], 1) + off
        edges.append(np.stack([e, e[:, ::-1]], 1).reshape(-1, 2))
        off += n
    edges = np.concatenate(edges)
    standins.write_tu(f"{d}/BONDS/raw", "BONDS", edges,
                      np.repeat(np.arange(12), sizes),
                      graph_labels=rng.integers(2, size=12),
                      node_attributes=rng.integers(0, 200, (off, 2)),
                      edge_attributes=rng.integers(0, 3, (len(edges), 3)))
    return d


def tu_cfgs(d, extra=()):
    opts = ["dataset.format", "TU", "dataset.name", "BONDS", "dataset.dir",
            d, "dataset.task", "graph", "dataset.transductive", "False",
            "dataset.split", "[0.5, 0.25, 0.25]", "train.batch_size", "4",
            "gnn.layer_type", "gcnconv", "gnn.dim_inner", "8",
            "gnn.layers_mp", "2", "gnn.layers_pre_mp", "1",
            "dataset.encoder_dim", "8", *extra]
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_list(opts + ["tpu.spmm_impl", "xla"])
    cfg.merge_from_list(opts + ["device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loaders, "_SEARCH_DIRS", [])
        mp.setattr(jax_native, "load", lambda: None)
        jlds = jax_loaders.create_loader(jax_loaders.create_dataset(jcfg),
                                         jcfg)
    return jcfg, cfg, jlds, loaders.create_loader(
        loaders.create_dataset(cfg), cfg)


def test_edge_feat_collation_matches_jax(tu_dir):
    _, _, jlds, lds = tu_cfgs(tu_dir)
    for jld, ld in zip(jlds, lds):
        for jb, b in zip(jld.batches(0), ld.batches(0)):
            assert b.edge_feat is not None
            np.testing.assert_array_equal(b.edge_feat,
                                          np.asarray(jb.edge_feat))
            assert b.edge_feat.shape[0] == b.num_edges
            assert not b.edge_feat[~b.edge_mask].any()
            dev = b.to(CPU)
            assert dev.edge_feat.dtype == torch.float32
    jb, b = batches(np.ones((N, 1), np.float32), None)
    assert b.edge_feat is None and jb.edge_feat is None


ENCODER_OPTS = ("dataset.node_encoder", "True", "dataset.node_encoder_name",
                "Integer", "dataset.edge_encoder", "True",
                "dataset.edge_encoder_name", "Bond")


@pytest.mark.parametrize("bn", [True, False])
def test_gnn_encoder_stage_matches_jax(tu_dir, bn):
    """The GNN with the Integer node encoder and the Bond edge encoder,
    their BatchNorms on or off: the train-mode logits and every
    gradient from carried parameters (the encoders' tables and BNs
    through params_from_jax)."""
    jcfg, cfg, jlds, lds = tu_cfgs(tu_dir, ENCODER_OPTS + (
        "dataset.node_encoder_bn", str(bn), "dataset.edge_encoder_bn",
        str(bn)))
    jb, b = jlds[0].batches(0)[0], lds[0].batches(0)[0]
    assert set(b.packs) >= {NODE_ENCODER, EDGE_ENCODER}
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(jmodel.init(jax.random.PRNGKey(0), jb, False))

    def jax_loss(p):
        (pred, label, mask), _ = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]}, jb,
            True, mutable=["batch_stats"])
        return jax_compute_loss(pred, label, mask, JaxLossOptions())[0], pred

    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(variables["params"])
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(variables, model))
    assert hasattr(model, "edge_encoder_bn") == bn
    model.train()
    pred, label, mask = model(b.to(CPU))
    loss, _ = compute_loss(pred, label, mask, LossOptions())
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = params_from_jax(to_numpy(grads), model)
    for name, p in model.named_parameters():
        if p.grad is None:      # the edge encoder feeds no gcnconv
            assert not np.any(want_grads[name].numpy()), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


class Doubled(torch.nn.Module):
    """A registered node encoder: twice feature column 0 in each of
    emb_dim columns, no table."""

    def __init__(self, emb_dim, generator):
        super().__init__()
        self.emb_dim = emb_dim

    def forward(self, graph):
        return graph.replace(node_feat=2 * graph.node_feat[:, :1].expand(
            -1, self.emb_dim))


def test_registered_encoder_replaces_the_builtin(tu_dir, monkeypatch):
    monkeypatch.setitem(register.node_encoder_dict, "Integer", Doubled)
    _, cfg, _, lds = tu_cfgs(tu_dir, ENCODER_OPTS[:4])
    b = lds[0].batches(0)[0]
    assert NODE_ENCODER not in b.packs
    model = build_model(cfg, CPU)
    assert isinstance(model.node_encoder, Doubled)
    pred, _, _ = model(b.to(CPU))
    assert torch.isfinite(pred).all()


def test_unknown_encoder_and_missing_pack_raise(tu_dir):
    _, cfg, _, lds = tu_cfgs(tu_dir, ENCODER_OPTS)
    model = build_model(cfg, CPU)
    b = lds[0].batches(0)[0].to(CPU)
    with pytest.raises(ValueError, match="'node_encoder' pack"):
        model(b.replace(packs={k: v for k, v in b.packs.items()
                               if k != NODE_ENCODER}))
    cfg.dataset.node_encoder_name = "Bond"
    with pytest.raises(ValueError, match="Unknown encoder 'Bond'"):
        build_model(cfg, CPU)
