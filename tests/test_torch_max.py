"""The segmented max of GeneralConv's 'max' aggregation and the packs
of its aggregations, against the JAX package's XLA reductions.

The max's plain version (forward, and its backward on the transpose
pack) against jax.ops.segment_max as graphgym_tpu/ops/segment.py masks
it, values and jax.grad, ties split evenly; the 'gcn_mean' and 'mean'
packs against segment_mean; the pack each aggregation takes.  Values at
rtol 1e-4 / atol 1e-5, gradients at rtol 1e-3 / atol 1e-5.  The
cuda-marked test holds the kernel (csrc/packed_max.cu) to its plain
version on the card and skips here.  This file imports no flax, so the
card's test run collects it.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.ops import segment as jax_segment
from graphgym_tpu.ops import sparse as jax_sparse
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.graphs.packing import build_packs, kinds_for_layer
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

CPU = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
N_REAL, N_PAD, E_REAL, E_PAD = 40, 48, 120, 144


@functools.lru_cache(maxsize=None)
def graph_pair(kinds=(), d_in=6, levels=0):
    """Both packages' batch of one random graph (40 real nodes padded to
    48, 120 edges padded to 144; rows 30-39 receive nothing, duplicate
    edges tie in a max), with every 5th node an ego center; the port's
    carries the packs ``kinds``.  With ``levels`` the features take that
    many values (ties in every column)."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, N_REAL, E_REAL)
    r = rng.integers(0, 30, E_REAL)
    feat = rng.normal(size=(N_REAL, d_in)).astype(np.float32)
    if levels:
        feat = rng.integers(0, levels, (N_REAL, d_in)).astype(np.float32)
    ids = np.arange(0, N_REAL, 5)
    kw = dict(node_id_index=ids, pad_nodes_to=N_PAD, pad_edges_to=E_PAD)
    jb = jax_container.build_graph_batch(s, r, feat, **kw)
    b = build_graph_batch(s, r, feat, **kw)
    if kinds:
        b = b.replace(packs=build_packs(b.senders, b.receivers,
                                        b.edge_weight, b.node_mask,
                                        b.num_nodes, kinds=kinds))
    return jb, b.to(CPU)


@functools.partial(jax.jit, static_argnums=2)
def jax_segment_max_vjp(jb, cot, normalize_adj):
    """The JAX layer's masked max of w * x[senders] (layers.py:626-642)
    and its gradient under the cotangent ``cot``, one compiled
    program."""
    if normalize_adj:
        s, r, w = jax_sparse.gcn_norm(jb.senders, jb.receivers,
                                      jb.edge_weight, N_PAD,
                                      node_mask=jb.node_mask)
        mask = jnp.concatenate([jb.edge_mask, jb.node_mask])
    else:
        s, r, w, mask = jb.senders, jb.receivers, jb.edge_weight, jb.edge_mask

    def f(x):
        msg = jnp.take(x, s, axis=0) * w[:, None]
        out = jax_segment.segment_max(msg, r, N_PAD, mask=mask)
        return jnp.sum(out * cot), out
    return jax.value_and_grad(f, has_aux=True)(jb.node_feat)


@pytest.mark.parametrize("levels", [1, 3, 0])
@pytest.mark.parametrize("normalize_adj", [False, True])
def test_packed_max_matches_segment_max(normalize_adj, levels):
    """The segmented max's plain version (forward and its backward on
    the transpose pack) against jax.ops.segment_max as the JAX layer
    masks it: values and jax.grad, on constant features (every slot of
    a row tied, levels 1), three levels (ties in most columns) and
    random ones, with weight-0 padding slots, rows with no in-edge
    (0, no gradient) and padding rows (on the 'gcn' pack a weight-0
    self-loop each).  Ties split evenly, as JAX splits them."""
    kind = "gcn" if normalize_adj else "plain"
    jb, b = graph_pair((kind,), d_in=5, levels=levels)
    fwd, bwd = b.packs[kind]
    cot = np.random.default_rng(2).normal(size=(N_PAD, 5)).astype(np.float32)
    (_, want), want_grad = jax_segment_max_vjp(jb, cot, normalize_adj)
    x = b.node_feat.clone().requires_grad_()
    out = K.packed_max_vjp(fwd, bwd, x)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               **GRAD_TOL)
    _, cnt = K.packed_max_plain(fwd, b.node_feat)
    empty = np.setdiff1d(np.arange(N_PAD), np.asarray(b.receivers[:E_REAL]))
    if normalize_adj:       # a real node's self-loop is its one slot
        empty = empty[empty >= N_REAL]
    assert (out[empty] == 0).all() and (cnt[empty] == 0).all()
    assert (x.grad[N_REAL:] == 0).all()
    if levels == 1 and not normalize_adj:   # all tied, unit weights
        deg = np.bincount(np.asarray(b.receivers[:E_REAL]),
                          minlength=N_PAD)
        np.testing.assert_array_equal(cnt[:, 0].numpy(), deg)


def test_packed_max_ties_split_like_jax():
    """Segments [1, 1] and [2, 2, 2] with upstream gradients 1 and 10:
    jax.ops.segment_max gives [0.5, 0.5, 3.33, 3.33, 3.33]."""
    x = np.array([[1.0], [1.0], [2.0], [2.0], [2.0], [0.0]], np.float32)
    s, r = np.arange(5), np.array([0, 0, 1, 1, 1])
    g = np.array([[1.0], [10.0]], np.float32)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jax.ops.segment_max(
        v[s], r, num_segments=2) * g)))(jnp.asarray(x))
    pk = build_packs(s, r, np.ones(5, np.float32), np.ones(6, bool), 6,
                     kinds=("plain",))["plain"]
    fwd, bwd = (K.PackedCSR(*(torch.from_numpy(np.asarray(a)) for a in p))
                for p in pk)
    xt = torch.from_numpy(x).requires_grad_()
    (K.packed_max_vjp(fwd, bwd, xt)[:2]
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad[:, 0].numpy(),
                               [0.5, 0.5, 10 / 3, 10 / 3, 10 / 3, 0.0],
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6)


def test_gcn_mean_pack_matches_segment_mean():
    """The 'gcn_mean' pack's K1 sum against the JAX layer's mean with
    normalize_adj: gcn_norm weights, segment_mean over the mask
    concat(edge_mask, node_mask) (layers.py:631-641); and the 'mean'
    pack against segment_mean over edge_mask."""
    jb, b = graph_pair(("gcn_mean", "mean"))

    @jax.jit
    def means(jb):
        s, r, w = jax_sparse.gcn_norm(jb.senders, jb.receivers,
                                      jb.edge_weight, N_PAD,
                                      node_mask=jb.node_mask)
        return {"gcn_mean": jax_sparse.spmm(
                    s, r, w, jb.node_feat, N_PAD, reduce="mean",
                    edge_mask=jnp.concatenate([jb.edge_mask, jb.node_mask])),
                "mean": jax_sparse.spmm(
                    jb.senders, jb.receivers, jb.edge_weight, jb.node_feat,
                    N_PAD, reduce="mean", edge_mask=jb.edge_mask)}
    for kind, want in means(jb).items():
        got = K.spmm_packed(b.packs[kind][0], b.node_feat)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=kind, **LOGIT_TOL)


def test_kinds_for_layer_by_agg():
    """The pack each aggregation takes (normalize_adj False / True)."""
    want = {"add": ("plain", "gcn"), "mean": ("mean", "gcn_mean"),
            "max": ("plain", "gcn")}
    for layer_type in ("generalconv", "idconv"):
        for agg, kinds in want.items():
            for norm, kind in zip((False, True), kinds):
                assert kinds_for_layer(layer_type, agg, norm) == (kind,)
    for layer_type in ("exampleconv1", "exampleconv2", "contrib_example"):
        assert kinds_for_layer(layer_type) == ("plain",)
    with pytest.raises(ValueError, match="agg"):
        kinds_for_layer("generalconv", "sum")


# ------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 5, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["plain", "gcn"])
def test_cuda_packed_max_matches_plain(cuda_device, kind, dtype, d):
    """The max kernel (csrc/packed_max.cu) against its plain version on
    the CPU: out and the tie counts bitwise (a max is exact), dx on the
    transpose pack at F32 tolerance (the CPU sums in slot order too);
    hub rows of 45 slots, weight-0 slots, ties; two launches bitwise
    equal; each wrapper counts its launch."""
    rng = np.random.default_rng(0)
    n, real = 96, 80
    s = np.concatenate([rng.integers(0, real, 400),
                        rng.integers(0, real, 45)])
    r = np.concatenate([rng.integers(0, real, 400), np.full(45, 3)])
    w = np.ones(len(s), np.float32)
    w[::17] = 0
    mask = np.arange(n) < real
    fwd, bwd = (K.PackedCSR(*(torch.from_numpy(np.asarray(a)) for a in p))
                for p in build_packs(s, r, w, mask, n, kinds=(kind,))[kind])
    x = torch.from_numpy(np.round(rng.normal(size=(n, d)) * 2) / 2).float()
    x[real:] = 0
    x = x.to(dtype)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(1))
    want, want_cnt = K.packed_max_plain(fwd, x)
    want_dx = K.packed_max_bwd_plain(bwd, x, g, want, want_cnt)
    dfwd, dbwd = (K.PackedCSR(*(a.to(cuda_device) for a in p))
                  for p in (fwd, bwd))
    xd, gd = x.to(cuda_device), g.to(cuda_device)
    K.packed_max_cuda.launches = K.packed_max_bwd_cuda.launches = 0
    out, cnt = K.packed_max(dfwd, xd)
    dx = K.packed_max_bwd(dbwd, xd, gd, out, cnt)
    torch.cuda.synchronize()
    assert K.packed_max_cuda.launches == K.packed_max_bwd_cuda.launches == 1
    assert torch.equal(out.cpu(), want) and torch.equal(cnt.cpu(), want_cnt)
    torch.testing.assert_close(dx.cpu(), want_dx, rtol=1e-5, atol=1e-6)
    again = K.packed_max(dfwd, xd)
    assert torch.equal(again[0], out) and torch.equal(
        K.packed_max_bwd(dbwd, xd, gd, out, cnt), dx)
