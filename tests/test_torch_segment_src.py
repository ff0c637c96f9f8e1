"""K2's index of positions read in place (``SegmentIndex``) and its two
callers on the training paths, against the JAX package.

The index: positions sorted by row, a row of at most OWNER_SLOTS
positions summed by one owner, each longer row cut into runs of
``run_length`` positions listed in row and run order, every position
covered once, shapes that follow the position count and the output rows
alone (so the batches of one signature share one captured program), and
the edge sums' index holding the batch edges and no chunk padding of the
'edge' pack.

The kernel's order (csrc/packed_segment.cu) is emulated in torch: on
the rows one owner sums it adds each row's messages from 0
in position order, as the plain version's ``index_add_`` does on the
CPU, so the two are bitwise equal; a longer row's runs are added in run
order, GROUP_RUNS at a time and then the groups in order, an
association the plain version does not share, so there the two are held
by ``hold_sums``' rule (|got - want| <= 1e-5 x the row's
sum of |terms| + 1e-6, chip_smoke.py's SEG_REL / SEG_ATOL).

Against JAX: ``edge_sum`` against ``jax.ops.segment_sum`` through
graphgym_tpu/ops/segment.py:24-26 (f32 sums of the same terms, the port
by receiver then edge order: the same sum rule), its gradient against
``jax.vjp`` (a gather: exact), ``edge_count`` against ``segment_count``
with the live mask (integer counts: exact), and the encoders' table
gradient (K2 on the embedding pack, plain version and emulated kernel)
against ``jax.grad`` of the JAX encoder (the sum rule over the table
row's terms).  Inputs are seeded numpy arrays given to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphgym_tpu.graphs.container import build_graph_batch as jax_batch
from graphgym_tpu.nn import encoders as jax_enc
from graphgym_tpu.ops import segment as jax_segment
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.graphs.packing import (EDGE, EDGE_ENCODER,
                                               EMBED_TABLES, NODE_ENCODER,
                                               build_edge_pack,
                                               build_embed_pack,
                                               build_packs, edge_index,
                                               embed_index, pad_edge_pack)
from graphgym_tpu_torch.nn import encoders, layers
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

CPU = torch.device("cpu")
SEG_REL, SEG_ATOL = 1e-5, 1e-6
RUN = K.OWNER_SLOTS
GROUP = K.GROUP_RUNS


def tensors(index):
    return K.SegmentIndex(*(None if a is None else torch.from_numpy(a)
                            for a in index))


def hold_sums(got, want, scale):
    """|got - want| <= SEG_REL x scale + SEG_ATOL, element by element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) - (SEG_REL * np.asarray(scale) + SEG_ATOL)
    assert excess.max() <= 0, f"max excess {excess.max()}"


def emulate(msg: torch.Tensor, index: K.SegmentIndex) -> torch.Tensor:
    """csrc/packed_segment.cu's order in torch (f32): a row with no run
    summed from 0 in position order by its owner; a longer row's runs
    (run_len positions each) each summed from 0 into a
    partial, the partials added from 0 in run order GROUP_RUNS at a
    time, then those group sums in order.  Every row written once."""
    ptr = index.row_ptr.tolist()
    n_out, d = len(ptr) - 1, msg.shape[1]
    src = (list(range(ptr[-1])) if index.src is None
           else index.src.tolist())
    vals = msg.float()
    out = torch.full((n_out, d), float("nan"))

    def walk(lo, hi):
        acc = torch.zeros(d)
        for p in range(lo, hi):
            if 0 <= src[p] < vals.shape[0]:
                acc = acc + vals[src[p]]
        return acc

    run_row = index.run_row.tolist()
    for r in range(n_out):
        if r not in run_row:
            out[r] = walk(ptr[r], ptr[r + 1])
    run_first = index.run_first.tolist()
    run_len = index.run_len.tolist()
    partial = {}
    for j, row in enumerate(run_row):
        if row >= 0:
            lo = ptr[row] + (j - run_first[j]) * run_len[j]
            partial[j] = walk(lo, min(lo + run_len[j], ptr[row + 1]))
    for j, row in enumerate(run_row):
        if row >= 0 and run_first[j] == j:
            assert torch.isnan(out[row]).all()
            runs = list(range(j, j + -(-(ptr[row + 1] - ptr[row])
                                      // run_len[j])))
            groups = [add_in_order([partial[k] for k in runs[g:g + GROUP]])
                      for g in range(0, len(runs), GROUP)]
            out[row] = add_in_order(groups)
    assert not torch.isnan(out).any()
    return out


def add_in_order(rows):
    acc = torch.zeros_like(rows[0])
    for x in rows:
        acc = acc + x
    return acc


# ------------------------------------------------------------ the index

ROW_CASES = {
    "empty": [],
    "short": [3] * 5 + [4] * RUN + [9],
    "exactly_run": [2] * RUN + [5] * (RUN + 1),
    "long_rows": [0] * 300 + [1] * 2 + [7] * (2 * RUN) + [8] * 40,
    "hub": [1] * 3000 + [2] * 5 + [9] * 9000,
    "random": sorted(np.random.default_rng(0).integers(0, 12, 1500)),
    # row 16 (n_out): positions left out, after the rows
    "left_out": [2] * 10 + [5] * 40 + [16] * 7,
    # 39,961 positions in long rows: runs of the grain 20 (row 2), longer
    # on the rows of thousands
    "grain": [0] * 30000 + [1] * 20 + [2] * 41 + [3] * 9920,
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_index_covers_every_position_once(case):
    """Short rows (at most OWNER_SLOTS positions) have no run; each
    longer row ceil(c / run_length(c)) runs of run_length(c) positions
    (the last shorter), in row order and run order, the row's first run
    named by each; the owners' rows and the runs cover every position
    of a row once, and none left out; arrays of fixed length."""
    rows = np.asarray(ROW_CASES[case], np.int64)
    n_out = 16
    src = np.random.default_rng(1).permutation(len(rows)).astype(np.int32)
    index = K.segment_index_host(rows, n_out, src)
    bound = K.segment_runs_bound(len(rows))
    assert [len(a) for a in index] == [n_out + 1, len(rows)] + [bound] * 4
    assert all(a.dtype == np.int32 for a in index)
    np.testing.assert_array_equal(np.diff(index.row_ptr),
                                  np.bincount(rows, minlength=n_out + 1)[
                                      :n_out])
    covered = np.zeros(len(rows), int)
    counts = np.diff(index.row_ptr)
    for r in np.flatnonzero(counts <= RUN):
        covered[index.row_ptr[r]:index.row_ptr[r + 1]] += 1
    live = index.run_row >= 0
    assert not live[live.sum():].any() and not index.arrivals.any()
    long_rows = np.flatnonzero(counts > RUN)
    lengths = K.run_length(counts[long_rows], counts[long_rows].sum())
    assert (lengths >= K.MIN_RUN).all()
    pieces = -(-counts[long_rows] // lengths)
    np.testing.assert_array_equal(index.run_row[live],
                                  np.repeat(long_rows, pieces))
    np.testing.assert_array_equal(index.run_len[live],
                                  np.repeat(lengths, pieces))
    for j in np.flatnonzero(live):
        row, first, n = index.run_row[j], index.run_first[j], index.run_len[j]
        assert index.run_row[first] == row
        assert first == 0 or index.run_row[first - 1] != row
        lo = index.row_ptr[row] + (j - first) * n
        hi = min(lo + n, index.row_ptr[row + 1])
        assert 0 < hi - lo <= n
        covered[lo:hi] += 1
    summed = index.row_ptr[-1]
    assert summed == (rows < n_out).sum()
    assert (covered[:summed] == 1).all() and not covered[summed:].any()


def test_run_lengths_follow_the_long_rows():
    """Runs of MIN_RUN positions where the long rows hold few (an edge
    pack's padding row); longer, for fewer partials, where they hold
    more than MIN_RUN x RUN_TARGET (an embedding pack); one length for
    every long row of an index."""
    assert K.run_length(432, 432) == K.MIN_RUN
    assert K.run_length(32745, 294912) == 144
    assert K.run_length(41286, 41286) == 21
    assert K.run_length(5000, 5000) == K.MIN_RUN
    for c in (33, 432, 5000, 32745, 100_000):
        for p in (c, 10240, 294912):
            n = K.run_length(c, max(c, p))
            assert n == max(K.MIN_RUN, -(-max(c, p) // K.RUN_TARGET))
    np.testing.assert_array_equal(K.run_length([40, 5000], 5040),
                                  [K.MIN_RUN, K.MIN_RUN])


def test_index_rejects_unsorted_rows_and_a_short_src():
    with pytest.raises(ValueError, match="sorted"):
        K.segment_index_host(np.array([2, 1]), 4)
    with pytest.raises(ValueError, match="within"):
        K.segment_index_host(np.array([1, 5]), 4)
    with pytest.raises(ValueError, match="src"):
        K.segment_index_host(np.array([1, 2]), 4, np.array([0], np.int32))


def random_edges(seed, n=60, e=300, hot=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    r[:hot] = 5                       # a receiver of a long row
    return s, r, rng.normal(size=(n, 4)).astype(np.float32)


def test_edge_index_lists_the_edges_not_the_slots():
    """The 'edge' entry's index: every batch edge once, the real ones by
    receiver and then in edge order, the padding edges after the rows
    (left out: their messages are zeros), no slot of the pack's chunk
    padding; its shapes follow E and N, and padding the pack's chunks
    leaves it as it was."""
    s, r, feat = random_edges(0, hot=200)
    b = build_graph_batch(s, r, feat, pad_nodes_to=80, pad_edges_to=320)
    fwd, slots = build_edge_pack(b.senders, b.receivers, b.edge_weight,
                                 b.num_nodes)
    e = len(b.senders)
    assert fwd.senders.size > e       # the pack holds chunk padding
    index = edge_index(slots)
    np.testing.assert_array_equal(np.sort(index.src), np.arange(e))
    np.testing.assert_array_equal(index.src, np.concatenate(
        [np.argsort(r, kind="stable"), np.arange(len(r), e)]))
    np.testing.assert_array_equal(np.diff(index.row_ptr),
                                  np.bincount(r, minlength=b.num_nodes))
    assert index.row_ptr[-1] == len(r)
    np.testing.assert_array_equal(
        slots.edge_row, np.concatenate([r, np.full(e - len(r), 80)]))
    hot = (r == 5).sum()
    assert (index.run_row >= 0).sum() == -(-hot // K.run_length(hot, hot))
    s2, r2, feat2 = random_edges(1)
    b2 = build_graph_batch(s2, r2, feat2, pad_nodes_to=80, pad_edges_to=320)
    _, slots2 = build_edge_pack(b2.senders, b2.receivers, b2.edge_weight,
                                b2.num_nodes)
    assert [np.shape(a) for a in edge_index(slots)] == \
        [np.shape(a) for a in edge_index(slots2)]
    fwd3, slots3 = pad_edge_pack((fwd, slots), fwd.senders.shape[0] + 3)
    assert fwd3.senders.shape[0] == fwd.senders.shape[0] + 3
    for a, c in zip(edge_index(slots), edge_index(slots3)):
        np.testing.assert_array_equal(a, c)


def test_embed_index_shapes_follow_the_items():
    """An embedding pack's index: its M * C slots by row, each slot's
    item its source, shapes of M and the tables alone."""
    dims, clip = EMBED_TABLES["Atom"]
    rng = np.random.default_rng(2)
    feat = np.stack([rng.integers(0, d, 400) for d in dims], 1)
    a = build_embed_pack(feat.astype(np.float32), dims, clip)
    b = build_embed_pack(np.zeros((400, 9), np.float32), dims, clip)
    assert [np.shape(x) for x in a] == [np.shape(x) for x in b]
    index = embed_index(a)
    assert len(index.src) == 400 * 9
    assert len(index.row_ptr) == sum(dims) + 2    # the tables and the NaN row
    np.testing.assert_array_equal(np.bincount(index.src), np.full(400, 9))
    # each item's slots hold its columns' rows
    rows = K.index_rows(tensors(index), 400 * 9).numpy()
    big = sum(dims) + 1
    np.testing.assert_array_equal(
        np.sort(index.src.astype(np.int64) * big + rows),
        np.sort((np.arange(400)[:, None] * big + a.rows).reshape(-1)))
    # the all-zero batch piles 400 slots on each column's row 0: runs
    assert (embed_index(b).run_row >= 0).sum() == 9 * -(-400 // K.MIN_RUN)


# ------------------------------------------------------------ the order

def sum_case(seed, long: bool, dtype):
    """Messages [n_src, 6] and an index over them with some none
    sources; rows the owners sum, or with ``long`` rows of
    about 320 and 5,020 more (20 runs of 16: two groups of runs; about
    190 runs of 26: twelve groups and more)."""
    rng = np.random.default_rng(seed)
    rows = list(rng.integers(0, 30, 600))
    if long:
        rows += [3] * 300 + [17] * 5000
    rows = np.sort(np.asarray(rows))
    n_src = len(rows) - 5
    src = rng.permutation(len(rows)).astype(np.int32)   # 5 point past msg
    msg = torch.from_numpy(rng.normal(size=(n_src, 6)).astype(np.float32))
    return msg.to(dtype), tensors(K.segment_index_host(rows, 32, src))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernel_bitwise_on_short_rows(dtype):
    msg, index = sum_case(3, False, dtype)
    assert (index.run_row < 0).all()
    want = K.segment_sum_plain(msg, index)
    assert want.dtype == torch.float32
    assert torch.equal(emulate(msg, index), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_kernel_holds_sums_on_long_rows(dtype):
    msg, index = sum_case(4, True, dtype)
    counts = np.diff(index.row_ptr.numpy())
    long = counts[counts > RUN]
    assert (index.run_row >= 0).sum() == (
        -(-long // K.run_length(long, long.sum()))).sum()
    got = emulate(msg, index)
    want = K.segment_sum_plain(msg.double(), index)
    assert want.dtype == torch.float64
    hold_sums(got, want, K.segment_sum_plain(msg.double().abs(), index))
    short = np.diff(index.row_ptr.numpy()) <= RUN
    assert torch.equal(got[short], K.segment_sum_plain(msg, index)[short])


def test_segment_sum_without_src_reads_positions():
    rows = np.sort(np.random.default_rng(5).integers(0, 40, 400))
    msg = torch.randn(400, 3, generator=torch.Generator().manual_seed(0))
    index = tensors(K.segment_index_host(rows, 40))
    assert (index.run_row < 0).all()
    want = torch.zeros(40, 3).index_add_(0, torch.from_numpy(rows), msg)
    assert torch.equal(K.segment_sum(msg, index), want)
    assert torch.equal(emulate(msg, index), want)


# ------------------------------------------------------ against the JAX side

N_REAL, N_PAD, E_REAL, E_PAD = 50, 64, 420, 448


def edge_batches(seed):
    """Both packages' batch of one random graph (a receiver of 300 edges
    among them), the port's with its 'edge' entry, and seeded messages
    per padded edge."""
    s, r, feat = random_edges(seed, N_REAL, E_REAL, hot=300)
    kw = dict(pad_nodes_to=N_PAD, pad_edges_to=E_PAD)
    jb = jax_batch(s, r, feat, **kw)
    b = build_graph_batch(s, r, feat, **kw)
    packs = build_packs(b.senders, b.receivers, b.edge_weight, b.node_mask,
                        b.num_nodes, kinds=[EDGE])
    return jb, b.replace(packs=packs).to(CPU)


@pytest.mark.parametrize("d", [1, 8, 300])
def test_edge_sum_matches_jax_segment_sum(d):
    """edge_sum [N, d] of seeded messages (zero on the padding edges, as
    the layers give them) against S.segment_sum over the receivers,
    by the sum rule; the gradient, a gather, exactly on the real edges
    (the padding edges, left out of the port's sum, get 0: the layers
    mask them, and JAX's g of the padding node reaches no parameter)."""
    jb, b = edge_batches(6)
    rng = np.random.default_rng(d)
    msg = rng.normal(size=(E_PAD, d)).astype(np.float32)
    msg[E_REAL:] = 0
    cot = rng.normal(size=(N_PAD, d)).astype(np.float32)
    recv = jnp.asarray(jb.receivers)

    def jax_sum(m):
        return jax_segment.segment_sum(m, recv, N_PAD)

    want, vjp = jax.vjp(jax_sum, jnp.asarray(msg))
    (want_grad,) = vjp(jnp.asarray(cot))
    m = torch.from_numpy(msg).requires_grad_(True)
    got = layers.edge_sum(b, m)
    got.backward(torch.from_numpy(cot))
    assert got.shape == (N_PAD, d)
    hold_sums(got.detach().numpy(), np.asarray(want),
              np.asarray(jax_sum(jnp.abs(jnp.asarray(msg)))))
    np.testing.assert_array_equal(m.grad.numpy()[:E_REAL],
                                  np.asarray(want_grad)[:E_REAL])
    assert not m.grad[E_REAL:].any()
    # the kernel's order on the same index, through the pack's runs
    index = edge_index(b.packs[EDGE][1])
    assert (index.run_row >= 0).sum() > K.GROUP_RUNS   # two groups
    hold_sums(emulate(torch.from_numpy(msg), index).numpy(),
              np.asarray(want),
              np.asarray(jax_sum(jnp.abs(jnp.asarray(msg)))))


def test_edge_count_matches_jax_segment_count():
    jb, b = edge_batches(7)
    live = np.random.default_rng(8).random(E_PAD) < 0.6
    live[E_REAL:] = False
    want = jax_segment.segment_count(jnp.asarray(jb.receivers), N_PAD,
                                     jnp.asarray(live))
    got = layers.edge_count(b, torch.from_numpy(live))
    assert got.dtype == torch.float32 and got.shape == (N_PAD,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["Atom", "Bond"])
def test_table_grad_matches_jax_grad(name):
    """The tables' gradient of the lookup (EmbedSumFn's backward, K2's
    plain version reading the output gradient in place, and the kernel's
    order emulated) against jax.grad of the JAX encoder under a seeded
    cotangent, by the sum rule over each table row's terms; 700 items,
    most ids 0, so the rows of id 0 are cut into runs."""
    jcls = {"Atom": jax_enc.AtomEncoder, "Bond": jax_enc.BondEncoder}[name]
    cls = {"Atom": encoders.AtomEncoder, "Bond": encoders.BondEncoder}[name]
    dims, clip = EMBED_TABLES[name]
    rng = np.random.default_rng(9)
    items, d = 700, 16
    ids = np.stack([np.where(rng.random(items) < 0.7, 0,
                             rng.integers(0, k, items)) for k in dims], 1)
    ids = ids.astype(np.float32)
    kind = NODE_ENCODER if name == "Atom" else EDGE_ENCODER
    s = rng.integers(0, 40, items if name == "Bond" else 60)
    r = rng.integers(0, 40, len(s))
    node = ids if name == "Atom" else np.zeros((40, 1), np.float32)
    edge = ids if name == "Bond" else None
    jb = jax_batch(s, r, node, edge_feat=edge)
    b = build_graph_batch(s, r, node, edge_feat=edge)
    feat = b.node_feat if name == "Atom" else b.edge_feat
    pack = build_embed_pack(feat, dims, clip)
    b = b.replace(packs={kind: (pack,)}).to(CPU)
    field = "node_feat" if name == "Atom" else "edge_feat"
    rows_out = feat.shape[0]
    cot = rng.normal(size=(rows_out, d)).astype(np.float32)
    jmod = jcls(d)
    params = jmod.init(jax.random.PRNGKey(0), jb)["params"]

    def loss(p):
        out = getattr(jmod.apply({"params": p}, jb), field)
        return jnp.sum(out * cot)

    (inner,) = jax.grad(loss)(params).values()
    (tables,) = params.values()
    mod = cls(d, torch.Generator().manual_seed(0))
    mod.load_state_dict({col: torch.from_numpy(np.array(v["embedding"]))
                         for col, v in tables.items()}, strict=False)
    out = getattr(mod(b), field)
    (out * torch.from_numpy(cot)).sum().backward()
    index = tensors(embed_index(pack))
    assert (index.run_row >= 0).any()
    stacked = encoders.table_grad(b.packs[kind][0], torch.from_numpy(cot),
                                  sum(dims))
    emulated = emulate(torch.from_numpy(cot), index)[:sum(dims)]
    scale = encoders.table_grad(b.packs[kind][0],
                                torch.from_numpy(np.abs(cot)), sum(dims))
    offsets = np.concatenate([[0], np.cumsum(dims)])
    for c, key in enumerate(sorted(inner, key=lambda k: int(k[3:]))):
        want = np.asarray(inner[key]["embedding"])
        lo, hi = offsets[c], offsets[c + 1]
        hold_sums(getattr(mod, key).grad.numpy(), want, scale[lo:hi])
        hold_sums(stacked[lo:hi].numpy(), want, scale[lo:hi])
        hold_sums(emulated[lo:hi].numpy(), want, scale[lo:hi])
