"""The segmented max kernel's work split (csrc/packed_max.cu), emulated
on the CPU and held to the plain versions.

The kernel cannot run here, but how it splits the work can: which
mode a launch takes and which columns a lane owns in which slice, how a
tile's rows are cut into runs and shared out between the groups of a
block, which group stores a row and which parts are merged after the
barrier (forward), and in what order the backward's owner of a row and
slice adds its slots.  The emulation below follows the source step by step,
with its constants read from the source itself, and counts every store
and every slot it visits.  Forward: out and the tie counts equal
``packed_max_plain`` (``torch.equal``: a max is exact whatever the
split; only a zero's sign could follow a tied slot's, and +0 == -0);
each row and column stored once, each live slot visited once a slice.
Backward: dx bitwise equal to ``packed_max_bwd_plain`` (the same
products, added in slot order); x read only for rows with a live slot.
The packs: hub rows of 45, 64, 300 and 2,500 slots, the graph task's
pooling packs (``build_pool_packs``), rows whose slots are all dead,
and inputs rounded to {-1, 0, 1} (ties, and both zeros).  Last, the
plain forward and backward on a pooling pack against the JAX package's
segment_max at rtol 1e-4 / atol 1e-5 (values) and 1e-3 / 1e-5
(gradients).
"""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphgym_tpu.ops import segment as jax_segment
from graphgym_tpu_torch.graphs.packing import build_packs, build_pool_packs, \
    pool_kind
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K


@functools.lru_cache(maxsize=None)
def constants() -> dict:
    """The kernel's ``constexpr int k... = ...;`` constants, read from
    csrc/packed_max.cu and csrc/common.cuh."""
    text = ""
    for name in ("packed_max.cu", "common.cuh"):
        with open(os.path.join(K._CSRC, name)) as f:
            text += f.read()
    return {m[1]: int(m[2])
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


def test_constants_read_from_the_source():
    c = constants()
    for name in ("kVecRun", "kNarrowRun", "kGroupRuns", "kMaxTileRows",
                 "kBwdNarrowInFlight", "kFwdBlocks", "kMinBlocks",
                 "kStridedCols", "kBwdWideCols", "kMaxGridY", "kWarps"):
        assert c[name] > 0, name
    assert c["kMaxTileRows"] <= 32    # warp 0 scans a tile's rows


@dataclasses.dataclass(frozen=True)
class Layout:
    mode: str        # "vec", "strided" or "narrow"
    lanes: int       # lanes of a group
    per_lane: int    # columns a lane owns in a slice
    slices: int
    groups: int      # groups of a block
    rows: int        # forward: rows a tile; backward: 1
    run: int = 0     # forward: slots of a run

    @property
    def width(self) -> int:
        return self.lanes * self.per_lane

    def columns(self, s: int, d: int) -> np.ndarray:
        """The columns slice s holds, lane by lane (Cols::at), those
        below d."""
        lane = np.arange(self.lanes)[:, None]
        t = np.arange(self.per_lane)[None]
        at = lane * self.per_lane + t if self.mode == "vec" else t * 32 + lane
        col = (s * self.width + at).reshape(-1)
        return col[col < d]


def fwd_layout(n_rows: int, d: int, itemsize: int = 4, tile=None,
               mode=None) -> Layout:
    """fwd_vec / fwd_shape of the source (aligned arrays); ``mode``
    ("wide" or "narrow") overrides the launch's choice, so that the
    CPU's small packs can take every mode."""
    c = constants()
    kn = 16 // itemsize                    # Vec<T>::kN
    vec = d % kn == 0
    n = kn if vec else c["kStridedCols"]
    lanes = 16 if vec and d <= 16 * n else 32
    slices = -(-d // (lanes * n))
    full = min(c["kGroupRuns"] * 32 * c["kWarps"] // lanes,
               c["kMaxTileRows"])
    kind = "vec" if vec else "strided"
    if mode == "narrow" or (mode is None
                            and n_rows * slices < c["kMinBlocks"]):
        kind, lanes, n, slices = "narrow", 32, 1, -(-d // 32)
        full = min(c["kGroupRuns"] * c["kWarps"], c["kMaxTileRows"])
    if tile is None:
        tile = full
        while tile > 1 and -(-n_rows // tile) * slices < c["kMinBlocks"]:
            tile //= 2
    run = c["kNarrowRun"] if kind == "narrow" else c["kVecRun"]
    return Layout(kind, lanes, n, slices, 32 * c["kWarps"] // lanes, tile,
                  run)


def bwd_layout(n_rows: int, d: int, itemsize: int = 4,
               mode=None) -> Layout:
    """bwd_vec / bwd_shape of the source: a group a row and slice."""
    c = constants()
    vec = d % 4 == 0
    lanes = 16 if vec and d <= 64 else 32
    slices = -(-d // (lanes * 4))
    kind, n = ("vec" if vec else "strided"), 4
    blocks = -(-n_rows // (32 * c["kWarps"] // lanes))
    wide = 32 * c["kBwdWideCols"]
    if mode == "narrow" or (mode is None
                            and blocks * slices < c["kMinBlocks"]):
        kind, lanes, n, slices = "narrow", 32, 1, -(-d // 32)
    elif (vec and itemsize == 4 and lanes == 32 and d % wide == 0
          and blocks * (d // wide) >= c["kMinBlocks"]):
        n, slices = c["kBwdWideCols"], d // wide
    return Layout(kind, lanes, n, slices, 32 * c["kWarps"] // lanes, 1)


def _flat(pack: K.PackedCSR):
    return (np.asarray(pack.senders).reshape(-1).astype(np.int64),
            np.asarray(pack.weights).reshape(-1),
            np.asarray(pack.row_range).astype(np.int64))


def _take(best, count, m):
    """MaxCount::take on every column at once."""
    new = (count == 0) | (m > best)
    tie = ~new & (m == best)
    return np.where(new, m, best), np.where(new, 1, count + tie)


def _merge(best, count, b, c):
    """MaxCount::merge on every column at once."""
    new = (c != 0) & ((count == 0) | (b > best))
    tie = (c != 0) & ~new & (b == best)
    return (np.where(new, b, best),
            np.where(new, c, np.where(tie, count + c, count)))


def emulate_forward(pack: K.PackedCSR, x: np.ndarray, itemsize: int = 4,
                    tile=None, mode=None):
    """packed_max_fwd's work split and arithmetic: (out, cnt) f32, with
    every store and every visited slot counted and checked."""
    senders, weights, rr = _flat(pack)
    x = np.asarray(x, np.float32)
    n_rows, (x_rows, d) = rr.shape[0], x.shape
    lay = fwd_layout(n_rows, d, itemsize, tile, mode)
    run = lay.run
    g_n = lay.groups
    out = np.full((n_rows, d), np.nan, np.float32)
    cnt = np.full((n_rows, d), np.nan, np.float32)
    stored = np.zeros((n_rows, d), np.int64)
    visits = np.zeros((senders.size, lay.slices), np.int64)
    for r0 in range(0, n_rows, lay.rows):
        rows = min(lay.rows, n_rows - r0)
        begin = rr[r0:r0 + rows, 0]
        end = np.maximum(begin, rr[r0:r0 + rows, 1])
        run0 = np.concatenate(
            [[0], np.cumsum(np.maximum(1, -(-(end - begin) // run)))])
        total = int(run0[-1])

        def first(g):
            return g * total // g_n
        for sl in range(lay.slices):
            cols = lay.columns(sl, d)
            zero = np.zeros(len(cols), np.float32)
            heads, tails = {}, []

            def store(r, best, count):
                out[r0 + r, cols], cnt[r0 + r, cols] = best, count
                stored[r0 + r, cols] += 1
            for g in range(g_n):
                j0, j1 = first(g), first(g + 1)
                if j0 >= j1:
                    continue
                r = int(np.searchsorted(run0, j0, side="right")) - 1
                best, count = zero, zero
                for j in range(j0, j1):
                    k0 = begin[r] + (j - run0[r]) * run
                    ks = k0 + np.arange(max(0, min(run, end[r] - k0)))
                    s, w = senders[ks], weights[ks]
                    live = (w != 0) & (s >= 0) & (s < x_rows)
                    visits[ks[live], sl] += 1
                    # every live slot's x row loaded, then the compares
                    # in slot order
                    m = (w[live, None] * x[s[live]][:, cols]).astype(
                        np.float32)
                    for mi in m:
                        best, count = _take(best, count, mi)
                    row_ends = j + 1 == run0[r + 1]
                    if row_ends or j + 1 == j1:
                        own = run0[r] >= j0
                        if row_ends and own:
                            store(r, best, count)
                        elif not own:
                            assert g not in heads
                            heads[g] = (best, count)
                        else:
                            tails.append((g, r, best, count))
                        if row_ends:
                            best, count = zero, zero
                            r += 1
            for g, r, best, count in tails:   # after the barrier
                for g2 in range(g + 1, g_n):
                    if first(g2) >= run0[r + 1]:
                        break
                    if first(g2) == first(g2 + 1):
                        continue
                    best, count = _merge(best, count, *heads.pop(g2))
                store(r, best, count)
            assert not heads, "a part no group merged"
    assert (stored == 1).all(), "a row's column stored twice or never"
    in_range = np.zeros(senders.size, bool)
    for b, e in rr:
        in_range[b:max(b, e)] = True
    live = in_range & (weights != 0) & (senders >= 0) & (senders < x_rows)
    np.testing.assert_array_equal(visits, live[:, None].astype(np.int64)
                                  .repeat(lay.slices, 1))
    return torch.from_numpy(out), torch.from_numpy(cnt)


def emulate_backward(pack: K.PackedCSR, x: np.ndarray, g: np.ndarray,
                     out: np.ndarray, cnt: np.ndarray, mode=None):
    """packed_max_bwd's order and arithmetic: f32 dx, and the rows whose
    x it read."""
    receivers, weights, rr = _flat(pack)
    x, g, out, cnt = (np.asarray(a, np.float32) for a in (x, g, out, cnt))
    n_rows, d = x.shape
    g_rows = out.shape[0]
    lay = bwd_layout(n_rows, d, mode=mode)
    dx = np.full((n_rows, d), np.nan, np.float32)
    stored = np.zeros((n_rows, d), np.int64)
    x_read = np.zeros(n_rows, bool)
    one = np.float32(1)
    for row in range(n_rows):   # an owner a row and slice
        for sl in range(lay.slices):
            cols = lay.columns(sl, d)
            begin, end = rr[row, 0], max(rr[row, 0], rr[row, 1])
            acc = np.zeros(len(cols), np.float32)
            xs = None
            for k0 in range(begin, end, lay.lanes):
                ks = np.arange(k0, min(k0 + lay.lanes, end))
                r, w = receivers[ks], weights[ks]
                live = (w != 0) & (r >= 0) & (r < g_rows)
                if xs is None:   # x once a batch holds a live slot
                    if not live.any():
                        continue
                    xs, x_read[row] = x[row, cols], True
                for j in np.flatnonzero(live):   # in slot order
                    o, cc, gr = (a[r[j], cols] for a in (out, cnt, g))
                    hit = ((w[j] * xs).astype(np.float32) == o) & (cc > 0)
                    with np.errstate(divide="ignore"):
                        term = (gr * (one / cc)).astype(np.float32) * w[j]
                    acc = np.where(hit, (acc + term).astype(np.float32), acc)
            dx[row, cols] = acc
            stored[row, cols] += 1
    assert (stored == 1).all(), "a dx entry stored twice or never"
    return torch.from_numpy(dx), x_read


# ------------------------------------------------------------ the packs


def to_torch(packs) -> tuple:
    return tuple(K.PackedCSR(*(torch.from_numpy(np.asarray(a)) for a in p))
                 for p in packs)


@functools.lru_cache(maxsize=None)
def hub_packs(hub: int, seed: int = 0):
    """'plain' fwd and bwd packs over 384 rows (300 real): 1,500 edges
    into rows 0-127, 1,500 more anywhere, ``hub`` more into row 0 (a
    row of ~12 + hub slots), every 17th edge of weight 0 (dead slots
    inside the rows' ranges), the edges into rows 20-23 all of weight 0
    (empty ranges), and the padding rows 300-383 with none."""
    rng = np.random.default_rng(seed)
    n, real = 384, 300
    s = np.concatenate([rng.integers(0, real, 3000),
                        rng.integers(0, real, hub)])
    r = np.concatenate([rng.integers(0, 128, 1500),
                        rng.integers(0, real, 1500), np.zeros(hub, int)])
    w = rng.random(len(s)).astype(np.float32) + 0.1
    w[::17] = 0
    w[(r >= 20) & (r < 24)] = 0
    return to_torch(build_packs(s, r, w, np.arange(n) < real, n,
                                kinds=("plain",))["plain"])


@functools.lru_cache(maxsize=None)
def pool_packs(kind: str, sizes: tuple, centers=None):
    """A graph task's pooling packs (``build_pool_packs``) over graphs
    of ``sizes`` nodes padded to a multiple of 128 nodes with one
    padding graph slot; under ego (``centers`` a graph) the first
    centers of each graph and 4 padding centers at the padding node:
    (fwd, bwd, graph slots, nodes)."""
    g = len(sizes) + 1
    real = sum(sizes)
    n = -(-(real + 1) // 128) * 128
    gids = np.full(n, g - 1)
    gids[:real] = np.repeat(np.arange(g - 1), sizes)
    id_index = id_mask = None
    if centers is not None:
        starts = np.cumsum(sizes) - np.asarray(sizes)
        ids = np.concatenate([st + np.arange(min(centers, sz))
                              for st, sz in zip(starts, sizes)])
        id_index = np.concatenate([ids, np.full(4, n - 1)])
        id_mask = np.arange(len(id_index)) < len(ids)
    packs = build_pool_packs(gids, np.arange(n) < real, g, kind, id_index,
                             id_mask)[pool_kind(kind, centers is not None)]
    return (*to_torch(packs), g, n)


MIXED = tuple(np.random.default_rng(3).integers(40, 71, 12).tolist())
POOLED = {"17x64": (64,) * 17, "mixed": MIXED}


def inputs(rows: int, d: int, seed: int, tied: bool) -> np.ndarray:
    """Seeded normal x, or x rounded to {-1, 0, 1} (ties in most columns
    and both zeros: round(-0.3) is -0.0)."""
    x = np.random.default_rng(seed).normal(size=(rows, d)).astype(np.float32)
    return np.clip(np.round(x), -1, 1) if tied else x


def forward_case(fwd, x, **kw):
    want, want_cnt = K.packed_max_plain(fwd, torch.from_numpy(x))
    out, cnt = emulate_forward(fwd, x, **kw)
    assert torch.equal(out, want) and torch.equal(cnt, want_cnt)
    return want, want_cnt


def backward_case(bwd, x, g, out, cnt, **kw):
    want = K.packed_max_bwd_plain(bwd, torch.from_numpy(x),
                                  torch.from_numpy(g), out, cnt)
    dx, x_read = emulate_backward(bwd, x, g, out.numpy(), cnt.numpy(), **kw)
    assert torch.equal(dx.view(torch.int32), want.view(torch.int32))
    # x is read for exactly the rows with a live slot
    receivers, weights, rr = _flat(bwd)
    live = (weights != 0) & (receivers >= 0) & (receivers < out.shape[0])
    has_live = np.array([live[b:max(b, e)].any() for b, e in rr])
    np.testing.assert_array_equal(x_read, has_live)
    return x_read


# ---------------------------------------------------------- the forward


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("tile", [None, 4, 16, 32])
@pytest.mark.parametrize("hub", [45, 64, 300, 2500])
def test_forward_split_matches_plain(hub, tile, mode):
    """Hub rows of 45-2,500 slots split over the groups of a block, on
    the launch's own tile (one row at this pack's size) and on tiles of
    4, 16 and 32 rows (design_sf_max's, and the ws and ba packs'),
    D = 128: one slice of 32 vector lanes (runs of kVecRun slots), or
    four of one column a lane (runs of kNarrowRun)."""
    fwd, _ = hub_packs(hub)
    x = inputs(384, 128, hub, tied=False)
    forward_case(fwd, x, tile=tile, mode=mode)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [1, 3, 8, 130, 256])
def test_forward_columns_match_plain(d, itemsize, mode):
    """The column layouts on tied inputs, tiles of 16 rows: strided
    lanes (D = 1, 3, 130; bf16 also 8), one vector a lane on a half-warp
    (8) or a warp (256: two slices of f32, one of bf16), one column a
    lane (narrow); bf16 values (x rounded to {-1, 0, 1} is exact in
    bf16) with bf16's layout.  Every column in exactly one slice."""
    fwd, _ = hub_packs(64)
    x = inputs(384, d, d, tied=True)
    lay = fwd_layout(384, d, itemsize, tile=16, mode=mode)
    want = ("narrow" if mode == "narrow"
            else "vec" if d % (16 // itemsize) == 0 else "strided")
    assert lay.mode == want
    cols = np.concatenate([lay.columns(s, d) for s in range(lay.slices)])
    np.testing.assert_array_equal(np.sort(cols), np.arange(d))
    forward_case(fwd, x, itemsize=itemsize, tile=16, mode=mode)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("graphs,d,centers", [
    ("17x64", 768, None), ("17x64", 128, 64), ("mixed", 128, None),
    ("mixed", 768, 30)])
def test_forward_pool_packs_match_plain(graphs, d, centers, tied):
    """Max pooling's rectangular fwd packs as the launch takes them: 17
    rows of 64 slots at D = 768 (design_graph_sf's shape: one column a
    lane, 24 slices, a row a block, one run a group), 64 ego centers at
    128 (idgraph_ba's), mixed graph sizes; padding nodes, padding
    centers and the padding slot dead."""
    fwd, _, g, n = pool_packs("max", POOLED[graphs], centers)
    x = inputs(n, d, d, tied)
    out, _ = forward_case(fwd, x)
    lay = fwd_layout(g, d)
    assert (lay.mode, lay.rows) == ("narrow", 1)
    assert not out[g - 1].any()


def test_forward_dead_senders_match_plain():
    """Slots of nonzero weight whose sender is not a row of x (the
    padding sender: x has one row fewer than the pack reads) are dead:
    rows reached only by them come out 0 with count 0."""
    rng = np.random.default_rng(9)
    n = 256
    s = np.concatenate([rng.integers(0, n - 1, 900), np.full(60, n - 1)])
    r = np.concatenate([rng.integers(0, n, 900), rng.integers(0, 6, 60)])
    fwd = to_torch([K.pack_csr(s, r, np.ones(len(s), np.float32), n,
                              num_senders=n - 1)])[0]
    x = inputs(n - 1, 128, 9, tied=False)
    only_dead = np.setdiff1d(np.arange(6), r[:900])
    for tile, mode in ((None, None), (16, "wide")):
        out, cnt = forward_case(fwd, x, tile=tile, mode=mode)
        assert not out[only_dead].any() and not cnt[only_dead].any()


# --------------------------------------------------------- the backward


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("mode", ["wide", "narrow"])
@pytest.mark.parametrize("hub", [45, 300, 2500])
def test_backward_order_matches_plain(hub, mode, tied):
    """The backward on the transpose pack (row 0's 45-2,500 in-edges are
    spread over the bwd rows; the bwd pack's own long rows hold up to
    ~25 slots), with 4 vector columns a lane or one: bitwise to the
    plain version."""
    fwd, bwd = hub_packs(hub)
    x = inputs(384, 128, hub, tied)
    g = np.random.default_rng(1).normal(size=(384, 128)).astype(np.float32)
    out, cnt = K.packed_max_plain(fwd, torch.from_numpy(x))
    backward_case(bwd, x, g, out, cnt, mode=mode)


def test_backward_two_vectors_a_lane_match_plain():
    """f32 rows of 256 columns on enough rows take 8 columns a lane (one
    slice a row): 20,000 rows, tied inputs, bitwise to the plain
    version."""
    rng = np.random.default_rng(12)
    n = 20_000
    s, r = rng.integers(0, n, 60_000), rng.integers(0, n, 60_000)
    bwd, fwd = to_torch([K.pack_csr(r, s, None, n), K.pack_csr(s, r, None, n)])
    assert bwd_layout(n, 256).per_lane == constants()["kBwdWideCols"]
    x = inputs(n, 256, 12, tied=True)
    g = np.random.default_rng(13).normal(size=(n, 256)).astype(np.float32)
    out, cnt = K.packed_max_plain(fwd, torch.from_numpy(x))
    backward_case(bwd, x, g, out, cnt)


@pytest.mark.parametrize("mode", ["wide", "narrow"])
def test_backward_dead_receivers_match_plain(mode):
    """Rows of the transpose pack whose slots have nonzero weight but a
    receiver that is not a row of g (the padding receiver: g, out and
    cnt have one row fewer than the pack names) are dead: their dx is 0
    and their x is never read."""
    rng = np.random.default_rng(10)
    n = 256
    # rows n - 6 .. n - 1: only slots of the padding receiver
    s = np.concatenate([rng.integers(0, n - 6, 900),
                        rng.integers(n - 6, n, 60)])
    r = np.concatenate([rng.integers(0, n - 1, 900), np.full(60, n - 1)])
    bwd = to_torch([K.pack_csr(r, s, np.ones(len(s), np.float32), n,
                              num_senders=n - 1)])[0]
    x = inputs(n, 128, 10, tied=True)
    g, out = (np.random.default_rng(k).normal(size=(n - 1, 128))
              .astype(np.float32) for k in (11, 12))
    cnt = np.ones((n - 1, 128), np.float32)
    out[:, :64] = np.clip(np.round(out[:, :64]), -1, 1)   # some hits
    x_read = backward_case(bwd, x, g, torch.from_numpy(out),
                           torch.from_numpy(cnt), mode=mode)
    assert not x_read[n - 6:].any() and x_read[:n - 6].any()


@pytest.mark.parametrize("graphs,d,centers", [
    ("17x64", 768, None), ("mixed", 128, 30), ("mixed", 128, 2),
    ("17x64", 3, 2)])
def test_backward_pool_packs_match_plain(graphs, d, centers):
    """Max pooling's backward on the transpose pack (a node row, at most
    one slot), as the launch takes it: with 2 centers a graph most rows
    have no live slot, write zeros and read no x; on tied inputs."""
    fwd, bwd, g, n = pool_packs("max", POOLED[graphs], centers)
    x = inputs(n, d, 5, tied=True)
    cot = np.random.default_rng(2).normal(size=(g, d)).astype(np.float32)
    out, cnt = K.packed_max_plain(fwd, torch.from_numpy(x))
    x_read = backward_case(bwd, x, cot, out, cnt)
    if centers == 2:
        assert x_read.sum() == 2 * len(POOLED[graphs])


# ---------------------------------------------- the launch's own sizes


@pytest.mark.parametrize("shape,want", [
    # (n_rows, d, itemsize) -> (mode, lanes, slices, tile rows): the
    # chip's probes (PERF.md section 6)
    ((49_152, 128, 4), ("vec", 32, 1, 32)),     # ws ego 'plain'
    ((196_608, 256, 4), ("vec", 32, 2, 32)),    # ba ego 'plain'
    ((1_280, 256, 4), ("vec", 32, 2, 4)),       # design_sf_max
    ((17, 768, 4), ("narrow", 32, 24, 1)),      # design_graph_sf pool_max
    ((93, 128, 4), ("narrow", 32, 4, 1)),       # idgraph_ba pool_max_ego
    ((93, 128, 2), ("narrow", 32, 4, 1)),       # the same in bf16
    ((131_072, 128, 4), ("vec", 32, 1, 32)),    # make_graph
    ((20_000, 130, 4), ("strided", 32, 2, 32)),
])
def test_forward_grid_of_the_paths(shape, want):
    lay = fwd_layout(*shape)
    assert (lay.mode, lay.lanes, lay.slices, lay.rows) == want


@pytest.mark.parametrize("shape,want", [
    # (n_rows, d, itemsize) -> (mode, lanes, columns a lane, slices)
    ((49_152, 128, 4), ("vec", 32, 4, 1)),      # ws ego 'plain'
    ((49_152, 256, 4), ("vec", 32, 8, 1)),      # the same at 256
    ((196_608, 256, 4), ("vec", 32, 8, 1)),     # ba ego 'plain'
    ((196_608, 256, 2), ("vec", 32, 4, 2)),     # the same in bf16
    ((327_680, 128, 4), ("vec", 32, 4, 1)),     # idgraph_ba pool_max_ego
    ((1_280, 256, 4), ("narrow", 32, 1, 8)),    # design_sf_max
    ((1_280, 768, 4), ("vec", 32, 4, 6)),       # design_graph_sf pool_max
    ((1_280, 64, 4), ("narrow", 32, 1, 2)),
    ((20_000, 130, 4), ("strided", 32, 4, 2)),
])
def test_backward_grid_of_the_paths(shape, want):
    lay = bwd_layout(*shape)
    assert (lay.mode, lay.lanes, lay.per_lane, lay.slices) == want


# ------------------------------------------------ against the JAX package


@pytest.mark.parametrize("centers", [None, 30])
def test_pool_max_plain_matches_segment_max(centers):
    """``packed_max_plain`` on a pooling pack and its backward on the
    transpose, through PackedMaxFn, against jax.ops.segment_max over the
    same nodes (or ego centers) and graph ids, masked as
    graphgym_tpu/ops/segment.py masks it: values and jax.grad under a
    seeded cotangent, on tied inputs (ties split evenly)."""
    sizes = MIXED
    fwd, bwd, g, n = pool_packs("max", sizes, centers)
    x = inputs(n, 8, 4, tied=True)
    cot = np.random.default_rng(6).normal(size=(g, 8)).astype(np.float32)
    real = sum(sizes)
    gids = np.full(n, g - 1)
    gids[:real] = np.repeat(np.arange(g - 1), sizes)
    if centers is None:
        take, mask = np.arange(n), np.arange(n) < real
    else:
        starts = np.cumsum(sizes) - np.asarray(sizes)
        ids = np.concatenate([st + np.arange(centers) for st in starts])
        take = np.concatenate([ids, np.full(4, n - 1)])
        mask = np.arange(len(take)) < len(ids)

    def f(v):
        pooled = jax_segment.segment_max(
            v[take], jnp.asarray(gids[take]), g, mask=jnp.asarray(mask))
        return jnp.sum(pooled * cot), pooled
    (_, want), want_grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = K.packed_max_vjp(fwd, bwd, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-3, atol=1e-5)
