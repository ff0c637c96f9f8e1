"""The port's attention path against the JAX package's.

Packs: the 'att' packs equal the JAX numpy packer's arrays, and the
slot map sends each bwd slot to the fwd slot of the same edge.  Kernel
K3: the plain version and the autograd Function (dv through the bwd
pack and the slot map, dalpha by the SDDMM) against
packed_segment_matmul_headed / segment_matmul_headed_vjp run through
the Pallas kernel in interpret mode, on inputs its bf16 hi/lo split
represents exactly (bf16-valued alpha, v and g), so only the f32
summation order differs: rtol 1e-4 / atol 1e-5.  Segment ops, and the
packed softmax whose row sums run on K3, against
graphgym_tpu/ops/segment.py at 1e-6, and packed_attention against the
JAX one in both score branches and on the benchmark's graph.  The CUDA kernel itself runs under the
``cuda`` marker on a card; the JAX modules that need flax are imported
inside the tests that use them, so the file collects where only jax is
installed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.graphs import packing as jax_packing
from graphgym_tpu.ops import segment as JS
from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu_torch.graphs import packing
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.nn import layers
from graphgym_tpu_torch.ops import segment as S
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from test_torch_spmm import (FIELDS, jax_numpy_packer,  # noqa: F401
                             pack_tensors, random_graph)

CPU = torch.device("cpu")


def att_packs(seed, **kw):
    """(s, r, w, n, node_mask, port packs, JAX packs) of a random graph
    with weight-0 padded edges at the padding node."""
    s, r, w, n = random_graph(seed, **kw)
    mask = np.arange(n) < 300
    got = packing.build_packs(s, r, w, mask, n, kinds=("att",))["att"]
    want = jax_packing.build_packs(s, r, w, mask, n, kinds=("att",))["att"]
    return s, r, w, n, mask, got, want


def bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def random_alpha(rng, pack, heads):
    """bf16-valued coefficients, 0 on every slot of pack weight 0 (as
    the masked softmax leaves them)."""
    a = bf16_exact(rng.random(pack.senders.shape + (heads,)))
    return a * (pack.weights > 0)[..., None]


# --------------------------------------------------------------- packs


@pytest.mark.parametrize("seed", [0, 1])
def test_att_packs_match_jax(jax_numpy_packer, seed):
    *_, got, want = att_packs(seed)
    assert len(got) == 3
    for got_p, want_p in zip(got[:2], want):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got_p, f),
                                          getattr(want_p, f), f)


@pytest.mark.parametrize("seed", [0, 2])
def test_slot_map_pairs_each_edge(seed):
    s, r, w, n, mask, (fwd, bwd, slot_map), _ = att_packs(seed)
    assert slot_map.shape == bwd.senders.shape and slot_map.dtype == np.int32
    fwd_rows = K.pack_rows(pack_tensors(fwd)).numpy().reshape(-1)
    bwd_rows = K.pack_rows(pack_tensors(bwd)).numpy().reshape(-1)
    m = slot_map.reshape(-1)
    edge = m < fwd.senders.size
    # every edge of the att set (real, self-loop or padded) has one slot
    # in each pack, and the map pairs them
    n_edges = len(s) + n
    assert edge.sum() == n_edges
    assert len(np.unique(m[edge])) == n_edges
    np.testing.assert_array_equal(fwd.senders.reshape(-1)[m[edge]],
                                  bwd_rows[edge])
    np.testing.assert_array_equal(fwd_rows[m[edge]],
                                  bwd.senders.reshape(-1)[edge])
    np.testing.assert_array_equal(fwd.weights.reshape(-1)[m[edge]],
                                  bwd.weights.reshape(-1)[edge])
    # bwd padding slots point past the fwd slots (a zero coefficient)
    assert (bwd.senders.reshape(-1)[~edge] == n).all()


def test_batch_to_moves_slot_map():
    s, r, w, n = random_graph(3, e=400, hot=100)
    b = build_graph_batch(s[:400], r[:400], np.ones((300, 2), np.float32),
                          pad_nodes_to=n)
    b = b.replace(packs=packing.build_packs(
        b.senders, b.receivers, b.edge_weight, b.node_mask, b.num_nodes,
        kinds=("att",)))
    fwd, bwd, slot_map = b.to(CPU).packs["att"]
    assert isinstance(fwd, K.PackedCSR) and isinstance(bwd, K.PackedCSR)
    assert slot_map.dtype == torch.int32
    np.testing.assert_array_equal(slot_map.numpy(), b.packs["att"][2])


# ------------------------------------------------------------ kernel K3


@pytest.mark.parametrize("heads", [1, 4])
def test_headed_plain_matches_jax(heads):
    s, r, w, n, mask, (fwd, _, _), _ = att_packs(heads)
    rng = np.random.default_rng(heads)
    v = bf16_exact(rng.normal(size=(n, 8 * heads)))
    alpha = random_alpha(rng, fwd, heads)
    num_tiles = (n + K.ROWS_PER_TILE - 1) // K.ROWS_PER_TILE
    vp = np.concatenate([v, np.zeros((1, v.shape[1]), np.float32)])
    want = JK.packed_segment_matmul_headed(
        jnp.asarray(vp[fwd.senders]), jnp.asarray(alpha),
        jnp.asarray(fwd.local_rows), jnp.asarray(fwd.tiles), num_tiles,
        heads)[:n]
    got = K.packed_segment_matmul_headed_plain(
        pack_tensors(fwd), torch.from_numpy(v), torch.from_numpy(alpha))
    assert got.dtype == torch.float32 and got.shape == (n, 8 * heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("heads", [1, 4])
def test_headed_vjp_matches_jax(heads):
    s, r, w, n, mask, (fwd, bwd, slot_map), _ = att_packs(heads + 10)
    rng = np.random.default_rng(heads + 10)
    d = 8 * heads
    v = bf16_exact(rng.normal(size=(n, d)))
    alpha = random_alpha(rng, fwd, heads)
    g = bf16_exact(rng.normal(size=(n, d)))

    def jax_fn(vv, aa):
        vp = jnp.concatenate([vv, jnp.zeros((1, d), vv.dtype)])
        msg = jnp.take(vp, fwd.senders.reshape(-1), axis=0).reshape(
            fwd.senders.shape + (d,))
        return JK.segment_matmul_headed_vjp(msg, aa, fwd.local_rows,
                                            fwd.tiles, n, heads)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(v), jnp.asarray(alpha))
    want_dv, want_da = vjp(jnp.asarray(g))

    vt = torch.from_numpy(v).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    out = K.segment_matmul_headed_vjp(vt, at, pack_tensors(fwd),
                                      pack_tensors(bwd),
                                      torch.from_numpy(slot_map))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want_dv),
                               rtol=1e-4, atol=1e-5)
    # dalpha by the SDDMM: JAX's d_w on the slots of nonzero weight, 0
    # on the others (the JAX package has <g, v> on the weight-0 slots
    # whose sender is a real row; the masked softmax passes no gradient
    # back through them, ROADMAP C)
    live = fwd.weights > 0
    zero_w = ~live & (fwd.senders < n)
    assert zero_w.any() and (np.asarray(want_da)[zero_w] != 0).any()
    np.testing.assert_allclose(at.grad.numpy()[live],
                               np.asarray(want_da)[live],
                               rtol=1e-4, atol=1e-5)
    assert (at.grad.numpy()[~live] == 0).all()


def kernel_emulation(pack, v, alpha):
    """K3's reading rule in numpy: per row, its row_range in slot order,
    f32 products rounded then summed."""
    n, d = v.shape
    heads = alpha.shape[-1]
    head = np.arange(d) // (d // heads)
    s = pack.senders.reshape(-1)
    a = alpha.reshape(-1, heads)
    out = np.zeros((n, d), np.float32)
    for row, (lo, hi) in enumerate(pack.row_range):
        for k in range(lo, hi):
            if 0 <= s[k] < n:
                out[row] += a[k, head] * v[s[k]]
    return out


@pytest.mark.parametrize("heads", [1, 4])
def test_row_range_reading_matches_plain(heads):
    """Reading only each row's row_range of the att pack is exact,
    fwd pack and, with alpha carried by the slot map, bwd pack."""
    s, r, w, n, mask, (fwd, bwd, slot_map), _ = att_packs(
        20 + heads, e=1200, hot=600)
    rng = np.random.default_rng(heads)
    v = rng.normal(size=(n, 4 * heads)).astype(np.float32)
    alpha = random_alpha(rng, fwd, heads)
    alpha_bwd = K.alpha_to_bwd(torch.from_numpy(alpha),
                               torch.from_numpy(slot_map)).numpy()
    for pack, a in ((fwd, alpha), (bwd, alpha_bwd)):
        want = K.packed_segment_matmul_headed_plain(
            pack_tensors(pack), torch.from_numpy(v), torch.from_numpy(a))
        np.testing.assert_allclose(kernel_emulation(pack, v, a),
                                   want.numpy(), rtol=1e-5, atol=1e-6)


def test_headed_cpu_tensor_takes_plain_version():
    *_, (fwd, _, _), _ = att_packs(4, e=500, hot=100)
    pack = pack_tensors(fwd)
    n = fwd.row_range.shape[0]
    v = torch.randn(n, 8)
    alpha = torch.rand(fwd.senders.shape + (2,))
    before = K.packed_segment_matmul_headed_cuda.launches
    out = K.packed_segment_matmul_headed(pack, v, alpha)
    assert K.packed_segment_matmul_headed_cuda.launches == before
    torch.testing.assert_close(
        out, K.packed_segment_matmul_headed_plain(pack, v, alpha))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.packed_segment_matmul_headed_cuda(pack, v, alpha)


# ---------------------------------------------------------- segment ops


def segment_inputs(seed, masked):
    """Values, ids over 7 segments (segments 2 and 6 empty, segment 4
    fully masked when masked), and a mask."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice([0, 1, 3, 4, 5], size=40)).astype(np.int64)
    data = rng.normal(size=(40, 3)).astype(np.float32) * 4
    mask = rng.random(40) > 0.3
    mask[ids == 4] = False
    return data, ids, (mask if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["segment_mean", "segment_max",
                                  "segment_min"])
def test_masked_segment_reductions_match_jax(name, masked):
    data, ids, mask = segment_inputs(1, masked)
    want = getattr(JS, name)(jnp.asarray(data), jnp.asarray(ids), 7,
                             None if mask is None else jnp.asarray(mask))
    got = getattr(S, name)(torch.from_numpy(data), torch.from_numpy(ids),
                           7, None if mask is None
                           else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_segment_sum_and_count_match_jax():
    data, ids, mask = segment_inputs(2, True)
    np.testing.assert_allclose(
        S.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                      7).numpy(),
        np.asarray(JS.segment_sum(jnp.asarray(data), jnp.asarray(ids), 7)),
        rtol=1e-6, atol=1e-6)
    for m in (None, mask):
        np.testing.assert_array_equal(
            S.segment_count(torch.from_numpy(ids), 7, None if m is None
                            else torch.from_numpy(m)).numpy(),
            np.asarray(JS.segment_count(jnp.asarray(ids), 7, m)))


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_and_grad_match_jax(masked):
    data, ids, mask = segment_inputs(3, masked)
    mask2 = None if mask is None else np.repeat(mask[:, None], 3, 1)
    cot = np.random.default_rng(4).normal(size=data.shape).astype(
        np.float32)

    def jax_fn(x):
        return JS.segment_softmax(x, jnp.asarray(ids), 7, mask2)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(data))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(data).requires_grad_(True)
    got = S.segment_softmax(x, torch.from_numpy(ids), 7,
                            None if mask2 is None
                            else torch.from_numpy(mask2))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)
    if masked:          # segment 4 is fully masked: all-zero, no NaN
        assert (got.detach().numpy()[ids == 4] == 0).all()


@pytest.mark.parametrize("fully_masked_rows", [True, False])
@pytest.mark.parametrize("heads", [1, 4])
def test_packed_segment_softmax_matches_jax(heads, fully_masked_rows):
    """packed_segment_softmax on the 'att' fwd pack against the JAX
    segment_softmax as packed_attention calls it (rows, validity mask),
    values and gradient at 1e-6.  With node_mask < 300 the rows of nodes
    300..383 hold only weight-0 self-loops: fully masked, all-zero
    probabilities; with every node real no row is fully masked."""
    s, r, w, n = random_graph(30 + heads)
    node_mask = (np.arange(n) < 300) if fully_masked_rows \
        else np.ones(n, bool)
    fwd, _, _ = packing.build_packs(s, r, w, node_mask, n,
                                    kinds=("att",))["att"]
    valid = fwd.weights > 0
    rows = (fwd.tiles[:, None] * K.ROWS_PER_TILE
            + fwd.local_rows).reshape(-1)
    full = np.bincount(rows[valid.reshape(-1)], minlength=n) == 0
    assert full[:n - 1].any() == fully_masked_rows
    rng = np.random.default_rng(heads)
    logits = (rng.normal(size=fwd.senders.shape + (heads,)) * 3).astype(
        np.float32)
    cot = rng.normal(size=logits.shape).astype(np.float32)

    def jax_fn(x):
        flat = x.reshape(-1, heads)
        mask = valid.reshape(-1)[:, None] & jnp.ones_like(flat, bool)
        return JS.segment_softmax(flat, jnp.asarray(rows), n,
                                  mask=mask).reshape(x.shape)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(logits))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(logits).requires_grad_(True)
    before = K.packed_segment_matmul_headed_cuda.launches
    got = K.packed_segment_softmax(x, pack_tensors(fwd))
    got.backward(torch.from_numpy(cot))
    assert K.packed_segment_matmul_headed_cuda.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)
    alpha = got.detach().numpy()
    assert (alpha[~valid] == 0).all() and np.isfinite(alpha).all()
    assert (x.grad.numpy()[~valid] == 0).all()
    sums = np.zeros((n, heads))
    np.add.at(sums, rows, alpha.reshape(-1, heads))
    np.testing.assert_allclose(sums[~full], 1.0, rtol=1e-5)
    assert (sums[full] == 0).all()


def test_packed_row_sum_matches_plain_sum():
    """packed_row_sum (K3 at dv = 1; its plain version on the CPU) is the
    per-row sum over the pack's slots of values that are 0 off the
    valid slots."""
    *_, (fwd, _, _), _ = att_packs(40)
    rng = np.random.default_rng(40)
    n = fwd.row_range.shape[0]
    c = (rng.random(fwd.senders.shape + (3,))
         * (fwd.weights > 0)[..., None]).astype(np.float32)
    rows = (fwd.tiles[:, None] * K.ROWS_PER_TILE
            + fwd.local_rows).reshape(-1)
    want = np.zeros((n, 3), np.float32)
    np.add.at(want, rows, c.reshape(-1, 3))
    got = K.packed_row_sum(pack_tensors(fwd), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- activations


@pytest.mark.parametrize("name", ["relu", "selu", "elu", "lrelu_01",
                                  "lrelu_025", "lrelu_05", "prelu",
                                  "identity", "tanh", "sigmoid"])
def test_act_dict_matches_jax(name):
    from graphgym_tpu.nn.act import act_dict as jax_act_dict
    from graphgym_tpu_torch.nn.act import act_dict

    x = np.linspace(-4, 4, 33, dtype=np.float32)
    np.testing.assert_allclose(act_dict[name](torch.from_numpy(x)).numpy(),
                               np.asarray(jax_act_dict[name](x)),
                               rtol=1e-6, atol=1e-6)


def test_act_dict_falls_back_to_register(monkeypatch):
    from graphgym_tpu_torch import register
    from graphgym_tpu_torch.nn.act import act_dict

    monkeypatch.setitem(register.act_dict, "twice", lambda x: 2 * x)
    assert "twice" in act_dict and "nope" not in act_dict
    assert act_dict["twice"](3) == 6
    with pytest.raises(KeyError):
        act_dict["nope"]


# ---------------------------------------------------- packed_attention


@pytest.fixture(scope="module")
def att_graphs():
    """One random graph as a JAX GraphBatch and a port GraphBatch (CPU
    tensors), both with their 'att' packs."""
    s, r, w, n = random_graph(7, e=1500, hot=700)
    real = w != 0
    s, r = s[real], r[real]
    feat = np.zeros((299, 1), np.float32)
    jb = jax_container.build_graph_batch(s, r, feat, pad_nodes_to=n,
                                         pad_edges_to=1600)
    jb = jb.replace(packs=jax_packing.build_packs(
        jb.senders, jb.receivers, jb.edge_weight, jb.node_mask,
        jb.num_nodes, kinds=("att",)))
    b = build_graph_batch(s, r, feat, pad_nodes_to=n, pad_edges_to=1600)
    b = b.replace(packs=packing.build_packs(
        b.senders, b.receivers, b.edge_weight, b.node_mask, b.num_nodes,
        kinds=("att",)))
    return jb, b.to(CPU)


def lrelu_j(a):
    return jax.nn.leaky_relu(a, negative_slope=0.2)


def lrelu_t(a):
    return torch.nn.functional.leaky_relu(a, negative_slope=0.2)


@pytest.mark.parametrize("branch", ["score_fn", "node_scores"])
def test_packed_attention_matches_jax(att_graphs, branch):
    from graphgym_tpu.nn import layers as jax_layers

    jb, b = att_graphs
    n, heads, d = b.num_nodes, 2, 4
    rng = np.random.default_rng(8)
    arrays = {"q": rng.normal(size=(n, heads, d)),
              "k": rng.normal(size=(n, heads, d)),
              "v": rng.normal(size=(n, heads, d)),
              "s_dst": rng.normal(size=(n, heads)),
              "s_src": rng.normal(size=(n, heads))}
    arrays = {k: a.astype(np.float32) for k, a in arrays.items()}
    cot = rng.normal(size=(n, heads, d)).astype(np.float32)
    names = (["q", "k", "v"] if branch == "score_fn"
             else ["s_dst", "s_src", "v"])

    def run(mod, graph, xs, score, transform):
        a = dict(zip(names, xs))
        if branch == "score_fn":
            return mod.packed_attention(graph, a["q"], score,
                                        values=a["v"], keys=a["k"])
        return mod.packed_attention(graph, a["v"], None,
                                    node_scores=(a["s_dst"], a["s_src"]),
                                    score_transform=transform)

    def jax_score(q_i, k_j):
        return jnp.sum(q_i * k_j, axis=-1) / jnp.sqrt(jnp.float32(d))

    want, vjp = jax.vjp(
        lambda *xs: run(jax_layers, jb, xs, jax_score, lrelu_j),
        *(jnp.asarray(arrays[k]) for k in names))
    want_grads = vjp(jnp.asarray(cot))
    xs = [torch.from_numpy(arrays[k]).requires_grad_(True) for k in names]
    got = run(layers, b, xs, layers.scaled_dot(d, torch.float32), lrelu_t)
    got.backward(torch.from_numpy(cot))
    assert got.shape == (n, heads, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    for name, x, wg in zip(names, xs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_packed_attention_node_scores_on_bench_graph_matches_jax():
    """The benchmark's attention (graphgym_tpu_torch.bench at N = 2,048,
    E = 32,768: row 0 of the 'att' pack takes ~720 slots) against the
    JAX packed_attention's node_scores branch: the gradients in h, s_dst
    and s_src at rtol 1e-4 and an atol of 1e-5 of each gradient's
    largest magnitude (the TPU kernel's f32 path drops the lo*lo
    product, ~2^-16 of each alpha * v; the gradients reach ~30)."""
    from graphgym_tpu.nn import layers as jax_layers
    from graphgym_tpu_torch import bench as B

    heads, dv = 8, 2
    step, inputs = B.attention_step(2048, 32768, heads, dv, "cpu")
    batch, *arrays = B.attention_graph(2048, 32768, heads, dv)
    jb = jax_container.build_graph_batch(batch.senders, batch.receivers,
                                         batch.node_feat[:-1])
    jb = jb.replace(packs=jax_packing.build_packs(
        jb.senders, jb.receivers, jb.edge_weight, jb.node_mask,
        jb.num_nodes, kinds=("att",)))
    lengths = np.diff(batch.packs["att"][0].row_range, axis=1)
    assert lengths.max() > 600

    def loss(h, s_dst, s_src):
        out = jax_layers.packed_attention(
            jb, h, None, node_scores=(s_dst, s_src),
            score_transform=lambda a: lrelu_j(a))
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    got = step(*inputs)
    for name, g, w in zip(("h", "s_dst", "s_src"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_packed_attention_dropout_rate_and_scale(att_graphs, monkeypatch):
    """Dropped coefficients are 0, kept ones scaled by 1/(1-p), and the
    drop rate over valid slots is p (masks cannot match the JAX ones
    bit for bit, so only the rate and the scale are compared)."""
    _, b = att_graphs
    n, heads, rate = b.num_nodes, 2, 0.3
    seen = []

    def capture(v, alpha, *packs):
        seen.append(alpha.detach().clone())
        return K.segment_matmul_headed_vjp(v, alpha, *packs)

    monkeypatch.setattr(layers, "segment_matmul_headed_vjp", capture)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(n, heads, 4)).astype(np.float32))
    score = layers.scaled_dot(4, torch.float32)
    layers.packed_attention(b, x, score)
    gen = torch.Generator().manual_seed(0)
    layers.packed_attention(b, x, score, dropout_rate=rate, generator=gen)
    plain, dropped = seen
    valid = (b.packs["att"][0].weights > 0)[..., None].expand_as(plain)
    kept = dropped != 0
    assert (kept <= valid).all()
    torch.testing.assert_close(dropped[kept], plain[kept] / (1 - rate))
    frac = 1 - kept[valid].float().mean().item()
    count = int(valid.sum())
    assert abs(frac - rate) < 5 * np.sqrt(rate * (1 - rate) / count)


def test_packed_attention_rejects_missing_pack_and_scores(att_graphs):
    _, b = att_graphs
    x = torch.zeros(b.num_nodes, 1, 4)
    with pytest.raises(ValueError, match="score_fn or node_scores"):
        layers.packed_attention(b, x)
    with pytest.raises(ValueError, match="no 'att' pack"):
        layers.packed_attention(b.replace(packs={}), x,
                                layers.scaled_dot(4, torch.float32))


def test_packed_attention_multi_device_not_ported(att_graphs, monkeypatch):
    _, b = att_graphs
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        layers.packed_attention(b, torch.zeros(b.num_nodes, 1, 4),
                                layers.scaled_dot(4, torch.float32))


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["vector", "vector64", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 4])
def test_cuda_headed_kernel_matches_plain(cuda_device, dtype, heads, width):
    """K3's paths: one head or several, 16-byte vector loads with the
    lanes per row the kernel picks (D = 128: a warp in f32, a half-warp
    in bf16; D = 64: a half-warp) or the scalar path (a head's width not
    a multiple of 16 bytes).  The reference is the plain version on the
    CPU, which sums each row in slot order as the kernel does (on the
    card its index_add_ sums with atomics, in no fixed order)."""
    s, r, w, n, mask, (fwd, bwd, slot_map), _ = att_packs(5)
    rng = np.random.default_rng(heads)
    fwd_t = pack_tensors(fwd, cuda_device)
    bwd_t = pack_tensors(bwd, cuda_device)
    alpha = torch.from_numpy(random_alpha(rng, fwd, heads)).to(cuda_device)
    d = {"vector": 128, "vector64": 64,
         "scalar": 9 * heads + 2 * (heads == 1)}[width]
    v = torch.randn(n, d, device=cuda_device).to(dtype)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    before = K.packed_segment_matmul_headed_cuda.launches
    before_sddmm = K.packed_sddmm_cuda.launches
    vg = v.clone().requires_grad_(True)
    ag = alpha.clone().requires_grad_(True)
    out = K.segment_matmul_headed_vjp(vg, ag, fwd_t, bwd_t,
                                      torch.from_numpy(slot_map).to(
                                          cuda_device))
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert K.packed_segment_matmul_headed_cuda.launches == before + 2
    assert K.packed_sddmm_cuda.launches == before_sddmm + 1
    torch.testing.assert_close(
        out.cpu(), K.packed_segment_matmul_headed_plain(
            pack_tensors(fwd), v.cpu(), alpha.cpu()), **tol)
    assert torch.equal(K.packed_segment_matmul_headed(fwd_t, v, alpha),
                       K.packed_segment_matmul_headed(fwd_t, v, alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 4])
def test_cuda_softmax_and_node_scores_repeatable(cuda_device, heads):
    """On a graph with a 2,500-slot row (the narrow walk's hub branch at
    one head, the scalar walk at four): the softmax Function and the
    node-score gathers, forward and backward, give the same bits on two
    runs, and the CPU's result within rtol 1e-5 / atol 1e-6 (exp and the
    sum order differ); K3 launches 2 (softmax) and 2 (gathers' backward)
    times, and no index_add_ takes part."""
    from test_torch_spmm import hub_graph

    s, r, w, n = hub_graph(8)
    fwd, bwd, slot_map = packing.build_packs(
        s, r, w, np.arange(n) < 300, n, kinds=("att",))["att"]
    assert np.diff(fwd.row_range, axis=1).max() > 2000
    rng = np.random.default_rng(heads)
    s_dst, s_src = (rng.normal(size=(n, heads)).astype(np.float32)
                    for _ in range(2))
    cot = rng.normal(size=fwd.senders.shape + (heads,)).astype(np.float32)

    def run(device):
        packs = (pack_tensors(fwd, device), pack_tensors(bwd, device),
                 torch.from_numpy(slot_map).to(device))
        xs = [torch.from_numpy(a).to(device).requires_grad_(True)
              for a in (s_dst, s_src)]
        score = K.packed_node_scores(*xs, *packs)
        alpha = K.packed_segment_softmax(score, packs[0])
        alpha.backward(torch.from_numpy(cot).to(device))
        return [t.detach().cpu() for t in (alpha, *(x.grad for x in xs))]

    before = K.packed_segment_matmul_headed_cuda.launches
    first = run(cuda_device)
    torch.cuda.synchronize()
    assert K.packed_segment_matmul_headed_cuda.launches == before + 4
    second = run(cuda_device)
    for a, b, c in zip(first, second, run(torch.device("cpu"))):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_headed_wrapper_rejects_bad_inputs(cuda_device):
    *_, (fwd, _, _), _ = att_packs(6)
    n = fwd.row_range.shape[0]
    pack = pack_tensors(fwd, cuda_device)
    alpha = torch.rand(fwd.senders.shape + (2,), device=cuda_device)
    v = torch.randn(n, 8, device=cuda_device)
    bad = [(v.half(), alpha, "dtype"),
           (v[:-1], alpha, "row_range"),
           (v, alpha.double(), "float32"),
           (v, alpha[:, :-1], "alpha"),
           (torch.randn(n, 7, device=cuda_device), alpha, "heads"),
           (v, alpha.cpu(), "float32")]
    for vv, aa, msg in bad:
        with pytest.raises(ValueError, match=msg):
            K.packed_segment_matmul_headed_cuda(pack, vv, aa)
