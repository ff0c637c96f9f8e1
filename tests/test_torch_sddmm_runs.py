"""The SDDMM kernel's work split (csrc/packed_sddmm.cu), emulated on the
CPU and held to the plain version.

The kernel cannot run here, but how it splits the work can: the layout
is cut into runs of kRun consecutive slots of one chunk, each run's
slots take their rows from the pack's ``tiles`` and ``local_rows``, a
run with no slot of nonzero weight only streams its zeros, the owner
walks the run kFlight slots at a time and loads a[row] only where a
live slot's row differs from the live slot before it, each lane sums
its columns in order, the lanes of a head add four slots at once in
reduce4's tree, and each batch of min(LANES / heads, kRun) slots is
stored by the lanes that took their slot and head.  The emulation follows the source
step by step, with its constants read from the source itself, and counts
every store and every row it loads.

Held to ``packed_sddmm_plain``: bitwise at f32 on integer-valued inputs
(every sum exact, so any order gives the same float: a wrong row, sender
or slot shows), and within 1e-5 of each slot's sum of |a * b| (+ 1e-6)
on random inputs, where only the sum order differs.  The run length and
depth change no output bit (the per-slot arithmetic is the same
whichever slots share a run).  The packs: a hub row of 2,500 slots
crossing many runs, runs that start mid-row, weight-0 slots inside rows,
and bucket-padding chunks that are all padding; H = 1, 4 and 8, on the
vector path and (bf16 widths) on the scalar path.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

from graphgym_tpu_torch.ops.cuda import spmm_kernel as K


@functools.lru_cache(maxsize=None)
def constants() -> dict:
    """The kernel's ``constexpr int k... = ...;`` constants, read from
    csrc/packed_sddmm.cu and csrc/common.cuh."""
    text = ""
    for name in ("packed_sddmm.cu", "common.cuh"):
        with open(os.path.join(K._CSRC, name)) as f:
            text += f.read()
    return {m[1]: int(m[2])
            for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


def test_constants_read_from_the_source():
    c = constants()
    assert c["kChunk"] == K.EDGES_PER_CHUNK
    assert c["kTileRows"] == K.ROWS_PER_TILE
    assert c["kChunk"] % c["kRun"] == 0
    assert c["kFlight"] % 4 == 0 and c["kRun"] % c["kFlight"] == 0
    assert c["kWarps"] > 0


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def vector_lanes(d: int, heads: int, itemsize: int) -> int:
    """vector_lanes of the source: lanes of an owner, 0 for the scalar
    path (a and b 16-byte aligned, as torch allocates them)."""
    vw = 16 // itemsize
    dv = d // heads
    group = dv // vw
    vec = (dv % vw == 0 and group >= 4 and _pow2(group) and _pow2(heads)
           and d <= 32 * vw)
    return (16 if d <= 16 * vw else 32) if vec else 0


def reduce4(x: np.ndarray, group: int) -> np.ndarray:
    """reduce4 of the source on x [runs, LANES, 4] f32: each lane's
    value after the two transposing steps and the butterfly."""
    lanes = np.arange(x.shape[1])
    off = group // 2
    hi = (lanes & off) != 0
    y0 = np.where(hi, x[..., 2], x[..., 0]) \
        + np.where(hi, x[..., 0], x[..., 2])[:, lanes ^ off]
    y1 = np.where(hi, x[..., 3], x[..., 1]) \
        + np.where(hi, x[..., 1], x[..., 3])[:, lanes ^ off]
    off //= 2
    lo = (lanes & off) != 0
    z = np.where(lo, y1, y0) + np.where(lo, y0, y1)[:, lanes ^ off]
    off //= 2
    while off > 0:
        z = z + z[:, lanes ^ off]
        off //= 2
    return z


def run_slots(pack, n: int, run: int):
    """The Run struct of every run: senders and rows [runs, run], -1
    where the slot takes no product."""
    s = np.asarray(pack.senders).reshape(-1, run).astype(np.int64)
    w = np.asarray(pack.weights).reshape(-1, run)
    chunk = constants()["kChunk"]
    tile = np.asarray(pack.tiles).astype(np.int64)[
        np.arange(s.shape[0]) * run // chunk]
    rows = (tile[:, None] * constants()["kTileRows"]
            + np.asarray(pack.local_rows).reshape(-1, run))
    live = (w != 0) & (s >= 0) & (s < n) & (rows < n)
    return np.where(live, s, -1), np.where(live, rows, -1)


def a_row_loads(sender: np.ndarray, rows: np.ndarray) -> list:
    """The (run, row) of every load of a[row]: a live slot whose row
    differs from the live slot before it in its run (cur_row starts at
    -1 in each run)."""
    loads = []
    for k, (s_run, r_run) in enumerate(zip(sender, rows)):
        r = r_run[s_run >= 0]
        changed = r != np.concatenate([[-1], r[:-1]])
        loads += [(k, int(v)) for v in r[changed]]
    return loads


def emulate(pack, a: np.ndarray, b: np.ndarray, itemsize: int = 4,
            run: int = None, flight: int = None) -> dict:
    """The kernel on the CPU: f32 out [NC, C, H], and what it counted
    (``writes`` per output, ``a_loads``, ``b_loads``, ``zero_runs``).
    a and b f32 [n, H, dh] (bf16-valued for a bf16 launch, itemsize 2,
    which only picks the path)."""
    c = constants()
    run = run or c["kRun"]
    flight = flight or c["kFlight"]
    n, heads, dh = a.shape
    d = heads * dh
    a2 = np.ascontiguousarray(a.reshape(n, d), np.float32)
    b2 = np.ascontiguousarray(b.reshape(n, d), np.float32)
    sender, rows = run_slots(pack, n, run)
    n_runs = sender.shape[0]
    out = np.zeros((n_runs, run * heads), np.float32)
    writes = np.zeros((n_runs, run * heads), np.int64)
    lanes = vector_lanes(d, heads, itemsize)
    busy = (sender >= 0).any(1)
    # a run of no live slot: zero_run's streaming stores, lane-strided
    writes[~busy] += 1
    sender, rows, idx = sender[busy], rows[busy], np.flatnonzero(busy)
    live = sender >= 0
    srow = np.where(live, sender, 0)
    arow = np.where(live, rows, 0)

    def products(i, width):   # [runs, width] f32 of slot i, +0 if dead
        p = np.zeros((len(idx), width), np.float32)
        p[:, :d] = np.where(live[:, i, None],
                            a2[arow[:, i]] * b2[srow[:, i]], np.float32(0))
        return p

    got = np.zeros((len(idx), run * heads), np.float32)
    wrote = np.zeros((len(idx), run * heads), np.int64)
    if lanes:
        vw = 16 // itemsize
        group = dh // vw
        per_batch = min(lanes // heads, run)
        lane = np.arange(lanes)
        my_slot, my_head = lane // heads, lane % heads
        mine = np.zeros((len(idx), lanes), np.float32)
        for i0 in range(0, run, flight):
            for q in range(0, flight, 4):
                x = np.zeros((len(idx), lanes, 4), np.float32)
                for j in range(4):
                    # lane l: columns [l*vw, (l+1)*vw), in column order
                    p = products(i0 + q + j, lanes * vw).reshape(
                        len(idx), lanes, vw)
                    for t in range(vw):
                        x[:, :, j] = x[:, :, j] + p[:, :, t]
                z = reduce4(x, group)
                i = i0 + q
                j = my_slot - i % per_batch
                src = (my_head * group + (j >> 1) * (group // 2)
                       + (j & 1) * (group // 4)) % lanes
                take = (j >= 0) & (j < 4)
                mine[:, take] = z[:, src[take]]
                if (i + 4) % per_batch == 0:
                    k0 = i + 4 - per_batch
                    st = lane < per_batch * heads
                    got[:, k0 * heads + lane[st]] = mine[:, st]
                    wrote[:, k0 * heads + lane[st]] += 1
    else:
        steps = -(-dh // 32)
        for i in range(run):
            p = products(i, d)
            for h in range(heads):
                # lane l: columns h*dh + l, + 32, ... in order (+0 past
                # the head's width adds nothing: no sum here is -0)
                cols = np.zeros((len(idx), steps * 32), np.float32)
                cols[:, :dh] = p[:, h * dh:(h + 1) * dh]
                cols = cols.reshape(len(idx), steps, 32)
                part = np.zeros((len(idx), 32), np.float32)
                for t in range(steps):
                    part = part + cols[:, t]
                off = 16
                while off > 0:
                    part = part + part[:, np.arange(32) ^ off]
                    off //= 2
                got[:, i * heads + h] = part[:, 0]   # lane 0 stores
                wrote[:, i * heads + h] += 1
    out[idx] = got
    writes[idx] += wrote
    return dict(out=out.reshape(pack.senders.shape + (heads,)),
                writes=writes, lanes=lanes,
                a_loads=len(a_row_loads(sender, rows)),
                b_loads=int(live.sum()), zero_runs=int((~busy).sum()))


def hub_pack(seed: int, n: int = 700, hub: int = 2500, e: int = 3000,
             extra_chunks: int = 3, zero_share: float = 0.1):
    """A pack of n rows: row 0 a hub of ``hub`` in-edges, row 5 one of
    300, the rest random; a share of weight-0 edges inside rows, and
    ``extra_chunks`` bucket-padding chunks (all padding)."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([np.zeros(hub, np.int64), np.full(300, 5),
                        rng.integers(0, n, e)])
    s = rng.integers(0, n, len(r))
    w = rng.random(len(r)).astype(np.float32) + 0.5
    w[rng.random(len(r)) < zero_share] = 0
    pack = K.pack_csr(s, r, w, n)
    return K.pack_csr(s, r, w, n,
                      pad_chunks_to=pack.senders.shape[0] + extra_chunks)


def plain(pack, a, b) -> np.ndarray:
    return K.packed_sddmm_plain(K.PackedCSR(*map(torch.from_numpy, pack)),
                                torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()


def integer_inputs(rng, n, heads, dh):
    """Values in +-{1..4}: every product and sum exact in f32."""
    def draw():
        v = rng.integers(1, 5, (n, heads, dh)).astype(np.float32)
        return v * rng.choice(np.float32([-1, 1]), (n, heads, dh))
    return draw(), draw()


CASES = [(1, 128, 4), (4, 32, 4), (8, 16, 4),   # vector path, f32
         (1, 128, 2), (8, 16, 2), (4, 9, 4)]    # bf16 widths; scalar


@pytest.mark.parametrize("heads,dh,itemsize", CASES)
def test_emulation_bitwise_to_plain_on_exact_sums(heads, dh, itemsize):
    pack = hub_pack(heads + dh)
    n = pack.row_range.shape[0]
    a, b = integer_inputs(np.random.default_rng(heads * dh), n, heads, dh)
    emu = emulate(pack, a, b, itemsize)
    assert emu["lanes"] == vector_lanes(heads * dh, heads, itemsize)
    assert (emu["lanes"] == 0) == ((heads, dh, itemsize) in
                                   ((8, 16, 2), (4, 9, 4)))
    np.testing.assert_array_equal(emu["out"], plain(pack, a, b))
    assert (emu["writes"] == 1).all()     # each output stored once


@pytest.mark.parametrize("heads,dh,itemsize", CASES)
def test_emulation_within_sum_order_of_plain(heads, dh, itemsize):
    pack = hub_pack(10 + heads)
    n = pack.row_range.shape[0]
    rng = np.random.default_rng(heads)
    a, b = (rng.normal(size=(n, heads, dh)).astype(np.float32)
            for _ in range(2))
    got = emulate(pack, a, b, itemsize)["out"]
    want = plain(pack, a, b)
    scale = plain(pack, np.abs(a), np.abs(b))
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all()
    assert (got[np.asarray(pack.weights) == 0] == 0).all()


@pytest.mark.parametrize("heads,dh", [(1, 128), (8, 16)])
def test_run_length_and_depth_change_no_bit(heads, dh):
    """The per-slot arithmetic is the same whichever slots share a run
    (the row-owner walk's), so every run length and depth gives the same
    floats."""
    pack = hub_pack(3, e=1200, hub=2100)
    n = pack.row_range.shape[0]
    rng = np.random.default_rng(7)
    a, b = (rng.normal(size=(n, heads, dh)).astype(np.float32)
            for _ in range(2))
    want = emulate(pack, a, b, run=32, flight=8)["out"]
    for run, flight in ((16, 4), (16, 8), (32, 4), (64, 8), (64, 16)):
        np.testing.assert_array_equal(
            emulate(pack, a, b, run=run, flight=flight)["out"], want)


def test_runs_split_the_hub_and_start_mid_row():
    pack = hub_pack(1)
    run = constants()["kRun"]
    n = pack.row_range.shape[0]
    lo, hi = (int(v) for v in pack.row_range[0])
    assert hi - lo >= 2000
    sender, rows = run_slots(pack, n, run)
    # the hub's slots are dealt out over the runs they span, and each of
    # those runs loads the hub's a-row once
    hub_runs = {k for k in range(sender.shape[0])
                if ((rows[k] == 0) & (sender[k] >= 0)).any()}
    assert len(hub_runs) >= 2000 // run
    assert sorted(k for k, r in a_row_loads(sender, rows) if r == 0) \
        == sorted(hub_runs)
    # runs that start inside a row: their first live slot's row is the
    # row of the last live slot of the run before
    first = [r[s >= 0][0] if (s >= 0).any() else -1
             for s, r in zip(sender, rows)]
    last = [r[s >= 0][-1] if (s >= 0).any() else -2
            for s, r in zip(sender, rows)]
    assert sum(f == p for f, p in zip(first[1:], last[:-1])) > 10


def test_counts_of_loads_and_zero_runs():
    pack = hub_pack(2, extra_chunks=3)
    n = pack.row_range.shape[0]
    c = constants()
    heads, dh = 4, 32
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(n, heads, dh)).astype(np.float32)
            for _ in range(2))
    emu = emulate(pack, a, b)
    w = np.asarray(pack.weights).reshape(-1)
    s = np.asarray(pack.senders).reshape(-1)
    live = (w != 0) & (s < n)
    assert emu["b_loads"] == live.sum()      # no b row for weight 0
    # a[row] once per (run, row) with a live slot
    runs = np.arange(len(w)) // c["kRun"]
    rows = K.pack_rows(K.PackedCSR(*map(torch.from_numpy, pack))) \
        .numpy().reshape(-1)
    assert emu["a_loads"] == len(set(zip(runs[live], rows[live])))
    # the three bucket-padding chunks, and the last tile's padding tail,
    # only stream zeros
    chunk_runs = c["kChunk"] // c["kRun"]
    empty = ~live.reshape(-1, c["kRun"]).any(1)
    assert empty[-3 * chunk_runs:].all()
    assert emu["zero_runs"] == empty.sum() > 3 * chunk_runs
    assert (emu["out"].reshape(-1, heads)[~live] == 0).all()


def test_att_pack_of_the_layer_matches_plain():
    """On a layer's 'att' pack (group padding, weight-0 padded edges at
    the padding node)."""
    from test_torch_attention import att_packs
    *_, n, _, (fwd, _, _), _ = att_packs(9, e=1500, hot=700)
    rng = np.random.default_rng(1)
    for heads, dh in ((1, 128), (4, 16)):
        a, b = integer_inputs(rng, n, heads, dh)
        emu = emulate(fwd, a, b)
        np.testing.assert_array_equal(emu["out"], plain(fwd, a, b))
        assert (emu["writes"] == 1).all()
