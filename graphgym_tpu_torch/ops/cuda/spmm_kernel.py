"""Packed segmented SpMM: host packing, the Hopper kernels, their plain
versions and the autograd wrappers.

The port of graphgym_tpu/ops/pallas/spmm_kernel.py, all three kernels,
and the SDDMM that K3's backward and the dot-product attention score
ran as XLA gathers:

  K1  the weighted sum (``_kernel_weighted``) -> ``csrc/packed_spmm.cu``;
  K2  the unweighted sum of given messages (``_kernel``)
      -> ``csrc/packed_segment.cu``;
  K3  the per-head weighted sum of attention (``_kernel_headed``)
      -> ``csrc/packed_attention.cu`` (K1 is its one-head case: both
      run the row walk of ``csrc/row_walk.cuh``);
  the per-slot, per-head dot products (``_segmm_headed_bwd``'s d_w,
      graphgym_tpu/nn/layers.py's score) -> ``csrc/packed_sddmm.cu``;
  the segmented max of the 'max' aggregation (XLA's segment_max in the
      JAX package, graphgym_tpu/ops/segment.py:50-60), forward and
      backward -> ``csrc/packed_max.cu``.

Host side, ``pack_csr`` sorts edges by receiver and cuts them into
chunks of C slots, each owned by one R-row output tile; the layout is
the JAX package's, array for array.  Device side, K1, K3 and the SDDMM
fuse the ``x[senders]`` gather that the TPU version ran outside its
kernel; K2 sums messages it is given, read in place through a
host-built index of positions sorted by row (``SegmentIndex``): every
slot of a pack, or a batch's edges, or an embedding pack's slots.

On a CUDA tensor the entry points (``spmm_packed``,
``packed_segment_matmul``, ``packed_segment_matmul_headed``,
``packed_sddmm``, ``packed_max``, ``packed_max_bwd``) launch the kernel
or raise; on a CPU tensor they take the plain version, the same
arithmetic in plain PyTorch.

Around them: the autograd Functions of the layers (SpMM, attention
aggregation, score, the attention softmax and the node-score gathers,
whose sums all run on K3 or K1, the segmented max, the edge convs' K2
sum on a host-built index and the permutation of the softmax's
per-edge rows into slot order and back, so no float atomics), and the
COO
entries ``pack_bidir`` / ``spmm_bidir`` / ``spmm_pallas`` of the
benchmark.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

ROWS_PER_TILE = 128     # R: output rows per tile
EDGES_PER_CHUNK = 1024  # C: edge slots per chunk

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
# one shared library per source, csrc/<name>.cu
SOURCES = ("packed_spmm", "packed_segment", "packed_attention",
           "packed_sddmm", "packed_max")
BUILD_DIR = os.path.join(_CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class PackedCSR(NamedTuple):
    """Chunked, receiver-sorted edge layout (host-built, numpy; tensors
    after ``GraphBatch.to``).

    senders    [NC, C] int32 — gather rows (padding -> num_nodes)
    weights    [NC, C] f32   — edge weights (0 on padding)
    local_rows [NC, C] int32 — receiver row within the chunk's tile
    tiles      [NC]    int32 — output tile of each chunk (ascending)
    row_range  [N, 2]  int32 — flat slots [start, end) of row r's edges

    The first four fields are the JAX package's PackedCSR.  row_range
    is built with them, once per pack: a row's edges are contiguous in
    slot order, and its range stops after the last edge of nonzero
    weight, so the kernel never reads padding slots, bucket-padding
    chunks or trailing zero-weight edges (each would add 0).
    """
    senders: Any
    weights: Any
    local_rows: Any
    tiles: Any
    row_range: Any


def pack_csr(senders: np.ndarray, receivers: np.ndarray,
             weights: Optional[np.ndarray], num_nodes: int,
             pad_chunks_to: Optional[int] = None,
             group: int = 1,
             num_senders: Optional[int] = None) -> PackedCSR:
    """Host-side packing (the numpy path of the JAX package's
    ``pack_csr``, spmm_kernel.py:74-179).

    Edges are sorted by (receiver, sender), so partial sums accumulate
    in a fixed order.  Each row's span is padded to a multiple of
    ``group`` (G) slots, which keep the row's local index and weight 0,
    so aligned groups of G slots belong to one row.  Every tile gets at
    least one chunk; the other padding slots carry sender
    ``num_senders``, weight 0 and local row 0.  The pack has
    ``num_nodes`` rows and reads ``num_senders`` rows (by default as
    many: a square pack; a graph-pooling pack maps node rows to graph
    slots), so its padding sender is the zero row after the input's."""
    pack, _ = pack_csr_with_slots(senders, receivers, weights, num_nodes,
                                  group, num_senders)
    if pad_chunks_to is not None:
        pack = pad_pack(pack, pad_chunks_to, num_nodes, num_senders)
    return pack


def pack_csr_with_slots(senders: np.ndarray, receivers: np.ndarray,
                        weights: Optional[np.ndarray], num_nodes: int,
                        group: int = 1, num_senders: Optional[int] = None
                        ) -> Tuple[PackedCSR, np.ndarray]:
    """``pack_csr`` without chunk padding, and the flat slot [E] that
    each input edge landed in (the attention path maps its fwd slots to
    its bwd slots with it)."""
    R, C, G = ROWS_PER_TILE, EDGES_PER_CHUNK, group
    if G < 1 or C % G:
        raise ValueError(f"group {G} must divide the chunk of {C} slots")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    e = len(senders)
    if weights is None:
        weights = np.ones(e, np.float32)
    weights = np.asarray(weights, np.float32)

    order = np.lexsort((senders, receivers))
    s_s, r_s, w_s = senders[order], receivers[order], weights[order]
    num_tiles = (num_nodes + R - 1) // R

    deg = np.bincount(r_s, minlength=num_nodes).astype(np.int64)
    padded = (deg + G - 1) // G * G
    tile_of_row = np.arange(num_nodes) // R
    tile_slots = np.bincount(tile_of_row, weights=padded,
                             minlength=num_tiles).astype(np.int64)
    chunks_per_tile = np.maximum((tile_slots + C - 1) // C, 1)
    nc = int(chunks_per_tile.sum())
    chunk_start = np.concatenate([[0], np.cumsum(chunks_per_tile)])

    # slot offset of each row within its tile = running padded sizes
    # minus the tile's base
    cum = np.concatenate([[0], np.cumsum(padded)])[:-1]
    tile_base_cum = cum[::R][:num_tiles]
    rows_in_tile = np.minimum(R, num_nodes - np.arange(num_tiles) * R)
    row_off_in_tile = cum - np.repeat(tile_base_cum, rows_in_tile)
    # global slot of edge k: tile's first chunk * C + row offset + rank
    # within the row
    first_pos = np.concatenate([[0], np.cumsum(deg)])[:-1]
    rank = np.arange(e) - first_pos[r_s]
    slot = (chunk_start[tile_of_row[r_s]] * C
            + row_off_in_tile[r_s] + rank)

    out_s = np.full(nc * C, num_nodes if num_senders is None
                    else num_senders, np.int32)
    out_w = np.zeros(nc * C, np.float32)
    out_l = np.zeros(nc * C, np.int32)
    out_s[slot] = s_s
    out_w[slot] = w_s
    out_l[slot] = (r_s - tile_of_row[r_s] * R).astype(np.int32)
    # the group padding slots after a row's edges keep its local index
    pad_amt = padded - deg
    pr = np.repeat(np.arange(num_nodes), pad_amt)
    pad_rank = np.arange(len(pr)) - np.repeat(
        np.concatenate([[0], np.cumsum(pad_amt)])[:-1], pad_amt)
    out_l[chunk_start[tile_of_row[pr]] * C + row_off_in_tile[pr]
          + deg[pr] + pad_rank] = (pr - tile_of_row[pr] * R)
    out_t = np.repeat(np.arange(num_tiles, dtype=np.int32),
                      chunks_per_tile)
    if nc * C >= 2 ** 31:
        raise ValueError(f"{nc} chunks overflow int32 slot indices")
    # row r's range ends after its last nonzero-weight slot: the
    # zero-weight edges after it (the padding node's padded edges) add
    # 0 to a finite sum, so the kernel skips them
    start = chunk_start[tile_of_row] * C + row_off_in_tile
    nz = w_s != 0
    last = np.full(num_nodes, -1, np.int64)
    np.maximum.at(last, r_s[nz], slot[nz])
    end = np.where(last >= 0, last + 1, start)
    row_range = np.stack([start, end], 1).astype(np.int32)
    pack = PackedCSR(out_s.reshape(nc, C), out_w.reshape(nc, C),
                     out_l.reshape(nc, C), out_t, row_range)
    edge_slot = np.empty(e, np.int64)
    edge_slot[order] = slot
    return pack, edge_slot


def pad_pack(pack: PackedCSR, pad_chunks_to: int, num_nodes: int,
             num_senders: Optional[int] = None) -> PackedCSR:
    """Pad a pack of ``num_nodes`` rows with no-op chunks (zero weight,
    last tile, the padding sender ``num_senders``, by default
    ``num_nodes``) up to ``pad_chunks_to`` chunks
    (spmm_kernel.py:182-201)."""
    nc, c = pack.senders.shape
    if pad_chunks_to <= nc:
        return pack
    extra = pad_chunks_to - nc
    num_tiles = (num_nodes + ROWS_PER_TILE - 1) // ROWS_PER_TILE
    pad_sender = num_nodes if num_senders is None else num_senders
    cat = np.concatenate
    return PackedCSR(
        cat([pack.senders, np.full((extra, c), pad_sender, np.int32)]),
        cat([pack.weights, np.zeros((extra, c), np.float32)]),
        cat([pack.local_rows, np.zeros((extra, c), np.int32)]),
        cat([pack.tiles, np.full((extra,), num_tiles - 1, np.int32)]),
        pack.row_range)


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def slot_rows(local_rows: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """Output row of every packed slot, [NC, C] int64: tiles*R + local
    (spmm_kernel.py:675-678)."""
    return tiles.long()[:, None] * ROWS_PER_TILE + local_rows.long()


def pack_rows(pack: PackedCSR) -> torch.Tensor:
    """Receiver row of every slot of ``pack``, [NC, C] int64."""
    return slot_rows(pack.local_rows, pack.tiles)


def num_tiles_of(n: int) -> int:
    return (n + ROWS_PER_TILE - 1) // ROWS_PER_TILE


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' sums: f32, or float64 for float64 input."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _tiles(n: int, d: int, dtype, device) -> torch.Tensor:
    return torch.zeros(num_tiles_of(n) * ROWS_PER_TILE, d, dtype=dtype,
                       device=device)


def weight_as(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Slot weights as the kernels take them against a message x: as
    they are, rounded to bf16 for a bf16 x (the TPU kernels cast the
    weighted one-hot to the message's dtype, spmm_kernel.py:362-364,
    567-568; csrc/common.cuh ``as_weight``)."""
    return w.to(torch.bfloat16) if x.dtype == torch.bfloat16 else w


def spmm_packed_plain(pack: PackedCSR, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x from the packed layout: gather, weight (rounded to
    bf16 for a bf16 x, ``weight_as``), index_add_ into f32 tiles
    (float64 for float64 x), cast to x.dtype.  out has the pack's rows
    (x's on a square pack); the padding sender, x's row count, reads an
    appended zero row."""
    d = x.shape[1]
    rows = pack.row_range.shape[0]
    acc = _sum_dtype(x)
    xp = torch.cat([x, x.new_zeros(1, d)]).to(acc)
    msg = xp.index_select(0, pack.senders.reshape(-1).long())
    msg = msg * weight_as(pack.weights, x).reshape(-1, 1).to(acc)
    out = _tiles(rows, d, acc, x.device)
    out.index_add_(0, pack_rows(pack).reshape(-1), msg)
    return out[:rows].to(x.dtype)


def packed_segment_matmul_headed_plain(pack: PackedCSR, v: torch.Tensor,
                                       alpha: torch.Tensor) -> torch.Tensor:
    """out[row(s), h*dv + k] += alpha[s, h] * v[senders[s], h*dv + k]
    over the pack's slots: gather, per-head multiply (alpha rounded to
    bf16 for a bf16 v, ``weight_as``), index_add_ into f32 tiles.  v
    [num_nodes, H*dv] f32 or bf16, alpha [NC, C, H]; out [num_nodes,
    H*dv] f32 (float64 for float64 v and alpha).  The padding sender
    num_nodes reads an appended zero row."""
    n, d = v.shape
    heads = alpha.shape[-1]
    acc = _sum_dtype(v)
    vp = torch.cat([v, v.new_zeros(1, d)]).to(acc)
    msg = vp.index_select(0, pack.senders.reshape(-1).long())
    msg = msg.view(-1, heads, d // heads) * weight_as(
        alpha, v).reshape(-1, heads, 1).to(acc)
    out = _tiles(n, d, msg.dtype, v.device)
    out.index_add_(0, pack_rows(pack).reshape(-1), msg.view(-1, d))
    return out[:n]


def packed_sddmm_plain(pack: PackedCSR, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """out[s, h] = <a[row(s), h, :], b[senders[s], h, :]> where the pack
    weight of slot s is nonzero, else 0: gather, multiply in f32 (float64
    for float64 a), sum per head, mask.  a and b [num_nodes, H, dh]; f32
    out [NC, C, H].  The padding sender num_nodes reads an appended zero
    row."""
    n, heads, dh = a.shape
    acc = _sum_dtype(a)
    rows = pack_rows(pack).reshape(-1).clamp_max(n - 1)
    bp = torch.cat([b.reshape(n, -1), b.new_zeros(1, heads * dh)])
    prod = (a.reshape(n, -1).to(acc).index_select(0, rows)
            * bp.to(acc).index_select(0, pack.senders.reshape(-1).long()))
    out = prod.view(-1, heads, dh).sum(-1).view(pack.senders.shape
                                                + (heads,))
    return torch.where(pack.weights[..., None] != 0, out, 0.0)


def packed_segment_matmul_plain(msg: torch.Tensor, local_rows: torch.Tensor,
                                tiles: torch.Tensor,
                                num_tiles: int) -> torch.Tensor:
    """out[tiles[i]*R + local_rows[i, c]] += msg[i, c] over every slot,
    padding slots included: index_add_ into f32 tiles.  msg [NC, C, D]
    f32 or bf16; out [num_tiles*R, D] f32 (float64 for float64 msg)."""
    d = msg.shape[-1]
    acc = _sum_dtype(msg)
    out = torch.zeros(num_tiles * ROWS_PER_TILE, d, dtype=acc,
                      device=msg.device)
    out.index_add_(0, slot_rows(local_rows, tiles).reshape(-1),
                   msg.reshape(-1, d).to(acc))
    return out


def _live(pack: PackedCSR, n: int) -> torch.Tensor:
    """[NC * C] bool: the slots a max takes, those of nonzero weight
    whose sender is a row of x (not the padding sender n)."""
    senders = pack.senders.reshape(-1)
    return (pack.weights.reshape(-1) != 0) & (senders >= 0) & (senders < n)


def packed_max_plain(pack: PackedCSR, x: torch.Tensor):
    """f32 (out, cnt) [rows, D], the pack's rows (x's on a square pack):
    out[r, c] = the max of w * x[s, c] over the slots of row r
    with weight w != 0 and a live sender s (a row of x), cnt how many
    slots reach it; 0 and 0 for a row with none.  Gather, multiply in
    f32, -inf on every other slot, scatter_reduce(amax) into f32 tiles
    and -inf -> 0 (the JAX -inf mask and isfinite -> 0), then the ties
    counted by index_add_ (exact small integers).  No data-dependent
    shape, so nothing waits for the card."""
    n, d = x.shape
    rows_out = pack.row_range.shape[0]
    live = _live(pack, n)[:, None]
    xp = torch.cat([x, x.new_zeros(1, d)]).float()
    msg = torch.where(live, xp.index_select(
        0, pack.senders.reshape(-1).long()) * pack.weights.reshape(-1, 1),
        float("-inf"))
    rows = pack_rows(pack).reshape(-1)
    out = torch.full((num_tiles_of(rows_out) * ROWS_PER_TILE, d),
                     float("-inf"), device=x.device)
    out.scatter_reduce_(0, rows[:, None].expand(-1, d), msg, "amax")
    out = torch.where(torch.isfinite(out), out, 0.0)
    cnt = torch.zeros_like(out)
    cnt.index_add_(0, rows, (live & (msg == out.index_select(0, rows)))
                   .float())
    return out[:rows_out], cnt[:rows_out]


def packed_max_bwd_plain(bwd_pack: PackedCSR, x: torch.Tensor,
                         g: torch.Tensor, out: torch.Tensor,
                         cnt: torch.Tensor) -> torch.Tensor:
    """f32 dx [num_nodes, D], x's rows, of packed_max_plain's out on the
    transpose pack (its rows are the senders s, its senders the
    receivers r, rows of g, out and cnt):
    dx[s, c] = the sum over row s's slots of weight w != 0, in slot
    order, of [w * x[s, c] == out[r, c]] * (g[r, c] * (1 / cnt[r, c]))
    * w, a tie split evenly between the slots that reach the max, as
    jax.ops.segment_max's gradient splits it.  Gathers and index_add_
    into f32 tiles over every slot (0 on the others; sequential, so in
    slot order, on the CPU)."""
    n, d = x.shape
    live = _live(bwd_pack, out.shape[0])[:, None]
    rows = pack_rows(bwd_pack).reshape(-1)
    receivers = bwd_pack.senders.reshape(-1).long()
    w = bwd_pack.weights.reshape(-1, 1)

    def take(a):   # a[receivers], the padding sender (a's rows) reading
        # an appended zero row
        return torch.cat([a.float(), a.new_zeros(1, d).float()]) \
            .index_select(0, receivers)
    xs = x.float().index_select(0, rows.clamp_max(n - 1))
    hit = live & (xs * w == take(out))
    term = torch.where(hit, take(g) * (1.0 / take(cnt)) * w, 0.0)
    dx = torch.zeros(num_tiles_of(n) * ROWS_PER_TILE, d, device=x.device)
    dx.index_add_(0, rows, term)
    return dx[:n]


# --------------------------------------------------------------------------
# K2's index: positions sorted by row, and the runs of the long rows
# (host-built, with the batch or once per pack)
# --------------------------------------------------------------------------

OWNER_SLOTS = 32   # the longest row one owner sums (kOwnerSlots)
MIN_RUN = 16       # the shortest run a longer row is cut into
RUN_TARGET = 2048  # about the warps the card holds: long rows of more
                   # positions than MIN_RUN x RUN_TARGET take longer runs
GROUP_RUNS = 16    # a long row's partials are added GROUP_RUNS at a time
                   # (kGroupRuns), then the group sums


class SegmentIndex(NamedTuple):
    """Where K2 reads and writes: P positions sorted by output row.

    row_ptr    [n_out + 1] int32 — the positions of row r are
               row_ptr[r] up to row_ptr[r + 1]; those past row_ptr[n_out]
               are left out
    src        [P] int32 — the message row of each position (a value at
               or beyond the messages' rows: none, skipped); None: the
               position's own row
    run_row    [L] int32 — the output row of each run of a row of more
               than OWNER_SLOTS positions (run k of a row covers its
               positions k * len on, at most len of them), in row order
               and run order; -1 past the last run
    run_first  [L] int32 — the first run of that row (its partials are
               run_first up to run_first + the row's run count)
    run_len    [L] int32 — the row's run length (``run_length``: one
               for the whole index)
    arrivals   [L] int32 — zeros: the kernel's counts of runs done (at a
               group's first run) and of groups done (at a row's second
               run), each set back to 0 by the arrival that completes it
               (so launches on one index run one at a time:
               ``segment_sum_cuda``)
    L = ``segment_runs_bound(P)`` whatever the rows, so the shapes follow
    P and n_out alone.
    """
    row_ptr: Any
    src: Any
    run_row: Any
    run_first: Any
    run_len: Any
    arrivals: Any


def run_length(counts, long_positions: int):
    """The run length of rows of ``counts`` > OWNER_SLOTS positions, of
    an index whose long rows hold ``long_positions`` positions: MIN_RUN,
    or as many positions as make RUN_TARGET runs where that is more (a
    launch whose runs would outnumber the card's warps is bound by its
    bytes, and longer runs keep its partials few)."""
    grain = max(MIN_RUN, -(-long_positions // RUN_TARGET))
    return np.full(np.shape(counts), grain, np.int64)


def segment_runs_bound(positions: int) -> int:
    """The most runs ``positions`` sorted positions can cut into: a row
    of c > OWNER_SLOTS positions takes ceil(c / len) <= c / MIN_RUN + 1
    < c / MIN_RUN + c / (OWNER_SLOTS + 1) runs."""
    return -(-positions // MIN_RUN) + -(-positions // (OWNER_SLOTS + 1))


def segment_index_host(rows: np.ndarray, n_out: int,
                       src: Optional[np.ndarray] = None) -> SegmentIndex:
    """K2's index (numpy) of positions whose output rows ``rows`` [P]
    are sorted, within n_out rows, each reading message row ``src[p]``
    (its own row p where src is None).  A position of row n_out is left
    out: no row covers it (the positions past row_ptr[n_out])."""
    rows = np.asarray(rows, np.int64)
    if rows.size and (np.any(rows[1:] < rows[:-1]) or rows[0] < 0
                      or rows[-1] > n_out):
        raise ValueError(f"rows must be sorted and within {n_out} rows")
    if src is not None and len(src) != rows.size:
        raise ValueError(f"src holds {len(src)} positions, rows "
                         f"{rows.size}")
    counts = np.bincount(rows, minlength=n_out + 1)[:n_out]
    long_rows = np.flatnonzero(counts > OWNER_SLOTS)
    lengths = run_length(counts[long_rows], int(counts[long_rows].sum()))
    pieces = -(-counts[long_rows] // lengths)
    first = np.cumsum(pieces) - pieces
    total = segment_runs_bound(rows.size)
    run_row = np.full(total, -1, np.int32)
    run_first = np.zeros(total, np.int32)
    run_len = np.zeros(total, np.int32)
    runs = int(pieces.sum())
    run_row[:runs] = np.repeat(long_rows, pieces)
    run_first[:runs] = np.repeat(first, pieces)
    run_len[:runs] = np.repeat(lengths, pieces)
    return SegmentIndex(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        None if src is None else np.asarray(src, np.int32),
        run_row, run_first, run_len, np.zeros(total, np.int32))


def pack_segment_index_host(local_rows: np.ndarray, tiles: np.ndarray,
                            num_tiles: int) -> SegmentIndex:
    """K2's index of a pack's slots (the TPU contract: every slot, padding
    slots included, to row tiles*R + local_rows of num_tiles tiles): the
    slots stably sorted by row as src, so each row sums its slots in slot
    order (None where the slots are sorted already)."""
    local_rows = np.asarray(local_rows, np.int64)
    rows = (np.asarray(tiles, np.int64)[:, None] * ROWS_PER_TILE
            + local_rows).reshape(-1)
    n_out = num_tiles * ROWS_PER_TILE
    if rows.size and (rows.min() < 0 or rows.max() >= n_out):
        raise ValueError(f"pack rows outside the {n_out} rows of "
                         f"{num_tiles} tiles")
    order = np.argsort(rows, kind="stable")
    sorted_already = np.array_equal(order, np.arange(rows.size))
    return segment_index_host(rows[order], n_out,
                              None if sorted_already else order)


def index_rows(index: SegmentIndex, positions: int) -> torch.Tensor:
    """[positions] int64: the output row of each position, n_out for the
    positions left out (past row_ptr[n_out])."""
    ptr = index.row_ptr.long()
    counts = torch.cat([ptr[1:] - ptr[:-1], positions - ptr[-1:]])
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts,
        output_size=positions)


def segment_sum_plain(msg: torch.Tensor,
                      index: SegmentIndex) -> torch.Tensor:
    """K2's function: f32 out [n_out, D], out[row(p)] += msg[src[p]]
    over the positions of the rows in order (index_add_ of the
    src-gathered rows; a none source adds the zero row, a left-out
    position a row past out; float64 for float64 msg)."""
    n_out = index.row_ptr.numel() - 1
    if index.src is None:
        vals = msg
    else:
        vals = take_padded(msg, index.src.clamp(0, msg.shape[0]))
    out = torch.zeros(n_out + 1, msg.shape[-1], dtype=_sum_dtype(msg),
                      device=msg.device)
    return out.index_add_(0, index_rows(index, vals.shape[0]),
                          vals.to(out.dtype))[:n_out]


_INDEX_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_INDEX_CACHE_SIZE = 8


def segment_index(local_rows: torch.Tensor, tiles: torch.Tensor,
                  num_tiles: int) -> SegmentIndex:
    """``pack_segment_index_host`` of a pack, on local_rows' device,
    built once per pack.  The cache holds the pack's own tensors, so a
    hit names the same memory, unchanged since (equal version
    counters)."""
    key = (local_rows.data_ptr(), tiles.data_ptr(), local_rows.device,
           tuple(local_rows.shape), tuple(tiles.shape),
           local_rows._version, tiles._version, num_tiles)
    hit = _INDEX_CACHE.get(key)
    if hit is None:
        host = pack_segment_index_host(local_rows.cpu().numpy(),
                                       tiles.cpu().numpy(), num_tiles)
        index = SegmentIndex(*(None if a is None else
                               torch.from_numpy(a).to(local_rows.device)
                               for a in host))
        hit = _INDEX_CACHE[key] = (local_rows, tiles, index)
        while len(_INDEX_CACHE) > _INDEX_CACHE_SIZE:
            _INDEX_CACHE.popitem(last=False)
    return hit[2]


# --------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str        # the shared library
    seconds: float   # wall time of the nvcc run that built it, all
                     # sources side by side (0.0 when already built)
    log: str         # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels need the CUDA toolkit")
    return found


def _digest(source: str) -> str:
    """Hash of the flags, the source and every header in csrc/, so that
    an edit to any file the library is built from rebuilds it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build() -> Dict[str, BuildInfo]:
    """Compile each csrc/<name>.cu of SOURCES for sm_90a into its own
    shared library in BUILD_DIR, once per version of its files (the
    library's name carries their hash).  The nvcc processes run side
    by side; every one is waited for before any failure is raised."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        source = os.path.join(_CSRC, f"{name}.cu")
        path = os.path.join(BUILD_DIR, f"lib{name}_{_digest(source)}.so")
        if os.path.exists(path):
            out[name] = BuildInfo(path, 0.0, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        running[name] = (path, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: proc.communicate()[0]
            for name, (_, _, proc) in running.items()}
    seconds = time.perf_counter() - t0
    for name, (path, tmp, proc) in running.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{logs[name]}")
        os.replace(tmp, path)
        out[name] = BuildInfo(path, seconds, logs[name])
    return out


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # x, x_rows, d, senders, weights, row_range, n_rows, out, stream
    "packed_spmm": [_P, _LL, _I, _P, _P, _P, _LL, _P, _P],
    # msg, n_src, d, src, row_ptr, n_out, run_row, run_first, run_len,
    # n_runs, arrivals, partial, out, stream
    "packed_segment": [_P, _LL, _I, _P, _P, _LL, _P, _P, _P, _LL, _P, _P,
                       _P, _P],
    # v, n_rows, d, heads, senders, alpha, row_range, out, stream
    "packed_attention": [_P, _LL, _I, _I, _P, _P, _P, _P, _P],
    # a, b, n_rows, d, heads, senders, weights, local_rows, tiles, n_slots,
    # out, stream
    "packed_sddmm": [_P, _P, _LL, _I, _I, _P, _P, _P, _P, _LL, _P, _P],
    # x, x_rows, d, senders, weights, row_range, n_rows, out, cnt, stream
    "packed_max": [_P, _LL, _I, _P, _P, _P, _LL, _P, _P, _P],
    # x, g, out, cnt, n_rows, d, senders, weights, row_range, g_rows, dx,
    # stream
    "packed_max_bwd": [_P, _P, _P, _P, _LL, _I, _P, _P, _P, _LL, _P, _P],
}
# the entry points of each library beyond csrc/<name>.cu's own <name>
_ENTRIES = {"packed_max": ("packed_max", "packed_max_bwd")}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, with the f32 and bf16
    versions of each of its entry points bound."""
    lib = ctypes.CDLL(build()[name].path)
    for entry in _ENTRIES.get(name, (name,)):
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{entry}_{suffix}")
            fn.argtypes = _ARGTYPES[entry]
            fn.restype = ctypes.c_int
    return lib


def _check(name: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_inputs(name: str, pack: PackedCSR, x: torch.Tensor,
                  square: bool = True) -> None:
    """What the kernels take: a 2-D f32 or bf16 CUDA x, a pack of x's
    rows (of any rows where not ``square``: K1 and the max on a pooling
    pack), and the pack's int32 / f32 arrays contiguous on x's device."""
    _check(name, x.is_cuda and x.dim() == 2, "x must be a 2-D CUDA tensor")
    _check(name, x.dtype in (torch.float32, torch.bfloat16),
           f"x dtype {x.dtype} not supported (float32, bfloat16)")
    n = x.shape[0] if square else pack.row_range.shape[0]
    _check(name, tuple(pack.row_range.shape) == (n, 2),
           f"row_range {tuple(pack.row_range.shape)} for {n} rows")
    for field, a, dtype in (("senders", pack.senders, torch.int32),
                            ("weights", pack.weights, torch.float32),
                            ("row_range", pack.row_range, torch.int32)):
        _check(name, a.device == x.device and a.dtype == dtype
               and a.is_contiguous(),
               f"{field} must be a contiguous {dtype} tensor on {x.device}")
    _check(name, pack.senders.shape == pack.weights.shape,
           "pack arrays disagree in shape")


def _launch(name: str, x: torch.Tensor, *args, entry: str = "") -> None:
    """Launch entry point ``entry`` (default ``name``) of csrc/<name>.cu
    in x's dtype on the current stream; raise on a refused launch."""
    entry = entry or name
    lib = library(name)
    fn = getattr(lib, f"{entry}_f32" if x.dtype == torch.float32
                 else f"{entry}_bf16")
    err = fn(x.data_ptr(), *args,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def packed_spmm_cuda(pack: PackedCSR, x: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K1: f32 out [rows, D] = A @ x, with x
    [x_rows, D] f32 or bf16 on a CUDA device; rows are the pack's, x's
    on a square pack (a pooling pack maps node rows to graph slots, its
    transpose back).  Adds one to ``packed_spmm_cuda.launches`` per
    launch, and to its D's entry of ``packed_spmm_cuda.launches_by_width``
    (the kernel picks its walk by width) and, where rows differ from
    x_rows, of ``packed_spmm_cuda.launches_rectangular``."""
    _check_inputs("packed_spmm_cuda", pack, x, square=False)
    x = x.contiguous()
    x_rows, d = x.shape
    n = pack.row_range.shape[0]
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out
    _launch("packed_spmm", x, x_rows, d, pack.senders.data_ptr(),
            pack.weights.data_ptr(), pack.row_range.data_ptr(), n,
            out.data_ptr())
    packed_spmm_cuda.launches += 1
    packed_spmm_cuda.launches_by_width[d] += 1
    packed_spmm_cuda.launches_by_dtype[str(x.dtype)] += 1
    if n != x_rows:
        packed_spmm_cuda.launches_rectangular[d] += 1
    return out


packed_spmm_cuda.launches = 0
packed_spmm_cuda.launches_by_width = collections.Counter()
packed_spmm_cuda.launches_rectangular = collections.Counter()
packed_spmm_cuda.launches_by_dtype = collections.Counter()


def packed_segment_matmul_headed_cuda(pack: PackedCSR, v: torch.Tensor,
                                      alpha: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel K3: f32 out [num_nodes, H*dv], out[row,
    h*dv + k] = sum over the row's slots of alpha[s, h] * v[senders[s],
    h*dv + k], with v [num_nodes, H*dv] f32 or bf16 and alpha [NC, C, H]
    f32 on a CUDA device.  Adds one to
    ``packed_segment_matmul_headed_cuda.launches`` per launch, and to
    the H*dv entry of its ``launches_by_width`` (the softmax's row sums
    run it at dv = 1)."""
    name = "packed_segment_matmul_headed_cuda"
    _check_inputs(name, pack, v)
    _check(name, alpha.dim() == 3
           and alpha.shape[:2] == pack.senders.shape,
           f"alpha {tuple(alpha.shape)} for a pack of "
           f"{tuple(pack.senders.shape)} slots")
    _check(name, alpha.dtype == torch.float32 and alpha.device == v.device,
           f"alpha must be a float32 tensor on {v.device}")
    heads = alpha.shape[-1]
    _check(name, heads > 0 and v.shape[1] % heads == 0,
           f"{heads} heads do not divide the width {v.shape[1]}")
    v, alpha = v.contiguous(), alpha.contiguous()
    n, d = v.shape
    out = torch.empty(n, d, dtype=torch.float32, device=v.device)
    if n == 0 or d == 0:
        return out
    _launch("packed_attention", v, n, d, heads,
            pack.senders.data_ptr(), alpha.data_ptr(),
            pack.row_range.data_ptr(), out.data_ptr())
    packed_segment_matmul_headed_cuda.launches += 1
    packed_segment_matmul_headed_cuda.launches_by_width[d] += 1
    packed_segment_matmul_headed_cuda.launches_by_dtype[str(v.dtype)] += 1
    return out


packed_segment_matmul_headed_cuda.launches = 0
packed_segment_matmul_headed_cuda.launches_by_width = collections.Counter()
packed_segment_matmul_headed_cuda.launches_by_dtype = collections.Counter()


def packed_sddmm_cuda(pack: PackedCSR, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper SDDMM kernel: f32 out [NC, C, H], out[s, h] =
    <a[row(s), h, :], b[senders[s], h, :]> on the slots of nonzero pack
    weight, 0 on every other slot, with a and b [num_nodes, H, dh] f32
    or bf16 (one dtype) on a CUDA device.  The kernel deals out runs of
    slots and reads each slot's row from the pack's ``tiles`` and
    ``local_rows`` (chunks of EDGES_PER_CHUNK slots).  Adds one to
    ``packed_sddmm_cuda.launches`` per launch."""
    name = "packed_sddmm_cuda"
    _check(name, a.dim() == 3 and b.shape == a.shape,
           f"a {tuple(a.shape)} and b {tuple(b.shape)} must both be "
           "[num_nodes, heads, dh]")
    _check(name, b.dtype == a.dtype and b.device == a.device,
           f"b ({b.dtype} on {b.device}) must match a ({a.dtype} on "
           f"{a.device})")
    n, heads, dh = a.shape
    a, b = (t.reshape(n, heads * dh).contiguous() for t in (a, b))
    _check_inputs(name, pack, a)
    _check(name, pack.senders.dim() == 2
           and pack.senders.shape[1] == EDGES_PER_CHUNK
           and pack.local_rows.shape == pack.senders.shape
           and pack.tiles.shape == pack.senders.shape[:1],
           f"local_rows {tuple(pack.local_rows.shape)} and tiles "
           f"{tuple(pack.tiles.shape)} for a pack of "
           f"{tuple(pack.senders.shape)} slots of {EDGES_PER_CHUNK}-slot "
           "chunks")
    for field, t in (("local_rows", pack.local_rows), ("tiles", pack.tiles)):
        _check(name, t.device == a.device and t.dtype == torch.int32
               and t.is_contiguous(),
               f"{field} must be a contiguous int32 tensor on {a.device}")
    out = torch.empty(pack.senders.shape + (heads,), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0 or n == 0 or dh == 0:
        return out.zero_()
    _launch("packed_sddmm", a, b.data_ptr(), n, heads * dh, heads,
            pack.senders.data_ptr(), pack.weights.data_ptr(),
            pack.local_rows.data_ptr(), pack.tiles.data_ptr(),
            pack.senders.numel(), out.data_ptr())
    packed_sddmm_cuda.launches += 1
    packed_sddmm_cuda.launches_by_dtype[str(a.dtype)] += 1
    return out


packed_sddmm_cuda.launches = 0
packed_sddmm_cuda.launches_by_dtype = collections.Counter()


def packed_segment_matmul_cuda(msg: torch.Tensor, local_rows: torch.Tensor,
                               tiles: torch.Tensor,
                               num_tiles: int) -> torch.Tensor:
    """Launch the Hopper kernel K2 on a pack's slots (the TPU contract):
    f32 out [num_tiles*R, D], out[tiles[i]*R + local_rows[i, c]] +=
    msg[i, c] over every slot, with msg [NC, C, D] f32 or bf16 and the
    pack's int32 local_rows [NC, C] and tiles [NC] on a CUDA device, on
    the pack's index (``segment_index``, built once per pack).  Adds one
    to ``packed_segment_matmul_cuda.launches`` per launch."""
    name = "packed_segment_matmul_cuda"
    _check(name, msg.is_cuda and msg.dim() == 3,
           "msg must be a 3-D CUDA tensor")
    _check(name, tuple(local_rows.shape) == tuple(msg.shape[:2])
           and tuple(tiles.shape) == tuple(msg.shape[:1]),
           f"local_rows {tuple(local_rows.shape)} and tiles "
           f"{tuple(tiles.shape)} for msg {tuple(msg.shape)}")
    for field, a in (("local_rows", local_rows), ("tiles", tiles)):
        _check(name, a.device == msg.device and a.dtype == torch.int32,
               f"{field} must be an int32 tensor on {msg.device}")
    return segment_sum_cuda(msg.reshape(-1, msg.shape[-1]),
                            segment_index(local_rows, tiles, num_tiles))


packed_segment_matmul_cuda.launches = 0
packed_segment_matmul_cuda.launches_by_pack = collections.Counter()
packed_segment_matmul_cuda.launches_by_dtype = collections.Counter()


def segment_sum_cuda(msg: torch.Tensor, index: SegmentIndex,
                     pack: str = "") -> torch.Tensor:
    """Launch K2 (csrc/packed_segment.cu) on an index built on the host
    (no copy to the host, so a captured step may launch it): f32 out
    [n_out, D], each row the sum of its positions' messages msg[src[p]]
    [n_src, D] (f32 or bf16; msg[p] where src is None) in position
    order, the index's int32 arrays on msg's device.  Adds one to
    ``packed_segment_matmul_cuda.launches`` (K2's count) per launch, and
    to the entry of ``pack`` (the kind of the batch pack the index came
    from; '' for a pack's own slots) in its ``launches_by_pack``.

    Not reentrant per index: the launch counts its long rows' runs in
    the index's ``arrivals`` and leaves them at 0 when it ends, so two
    launches on one index must not overlap (two streams, or two
    branches of a captured graph).  Every caller in the port launches
    on the current stream, one after another."""
    name = "segment_sum_cuda"
    _check(name, msg.is_cuda and msg.dim() == 2,
           "msg must be a 2-D CUDA tensor")
    _check(name, msg.dtype in (torch.float32, torch.bfloat16),
           f"msg dtype {msg.dtype} not supported (float32, bfloat16)")
    for field, a in zip(index._fields, index):
        _check(name, (a is None and field == "src")
               or (a is not None and a.device == msg.device
                   and a.dtype == torch.int32 and a.is_contiguous()
                   and a.dim() == 1),
               f"{field} must be a contiguous 1-D int32 tensor on "
               f"{msg.device}")
    n_runs = index.run_row.numel()
    _check(name, all(a.numel() == n_runs for a in index[3:]),
           "run_row, run_first, run_len and arrivals must hold one entry "
           "a run")
    msg = msg.contiguous()
    n_src, d = msg.shape
    n_out = index.row_ptr.numel() - 1
    out = torch.empty(n_out, d, dtype=torch.float32, device=msg.device)
    if out.numel() == 0:
        return out
    partial = torch.empty(n_runs, d, dtype=torch.float32,
                          device=msg.device)
    _launch("packed_segment", msg, n_src, d,
            None if index.src is None else index.src.data_ptr(),
            index.row_ptr.data_ptr(), n_out, index.run_row.data_ptr(),
            index.run_first.data_ptr(), index.run_len.data_ptr(), n_runs,
            index.arrivals.data_ptr(), partial.data_ptr(), out.data_ptr())
    packed_segment_matmul_cuda.launches += 1
    packed_segment_matmul_cuda.launches_by_pack[pack] += 1
    packed_segment_matmul_cuda.launches_by_dtype[str(msg.dtype)] += 1
    return out


def packed_max_cuda(pack: PackedCSR, x: torch.Tensor):
    """Launch the Hopper segmented max (csrc/packed_max.cu, forward): f32
    (out, cnt) [rows, D] as ``packed_max_plain``, the pack's rows, x
    [x_rows, D] f32 or bf16 on a CUDA device.  Adds one to
    ``packed_max_cuda.launches`` per launch."""
    _check_inputs("packed_max_cuda", pack, x, square=False)
    x = x.contiguous()
    x_rows, d = x.shape
    n = pack.row_range.shape[0]
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    cnt = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out, cnt
    _launch("packed_max", x, x_rows, d, pack.senders.data_ptr(),
            pack.weights.data_ptr(), pack.row_range.data_ptr(), n,
            out.data_ptr(), cnt.data_ptr())
    packed_max_cuda.launches += 1
    packed_max_cuda.launches_by_dtype[str(x.dtype)] += 1
    return out, cnt


packed_max_cuda.launches = 0
packed_max_cuda.launches_by_dtype = collections.Counter()


def packed_max_bwd_cuda(bwd_pack: PackedCSR, x: torch.Tensor,
                        g: torch.Tensor, out: torch.Tensor,
                        cnt: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper segmented max's backward (csrc/packed_max.cu) on
    the transpose pack: f32 dx [num_nodes, D], x's rows, as
    ``packed_max_bwd_plain``, from x (f32 or bf16) and the f32 g, out
    and cnt [out rows, D] (the forward's rows: x's on a square pack) on
    a CUDA device.  Adds one to ``packed_max_bwd_cuda.launches`` per
    launch."""
    name = "packed_max_bwd_cuda"
    _check_inputs(name, bwd_pack, x)
    for field, a in (("g", g), ("out", out), ("cnt", cnt)):
        _check(name, a.dim() == 2 and a.shape == out.shape
               and a.shape[1] == x.shape[1] and a.dtype == torch.float32
               and a.device == x.device,
               f"{field} must be a float32 [rows, {x.shape[1]}] tensor "
               f"of out's shape {tuple(out.shape)} on {x.device}")
    x, g, out, cnt = (a.contiguous() for a in (x, g, out, cnt))
    n, d = x.shape
    dx = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return dx
    _launch("packed_max", x, g.data_ptr(), out.data_ptr(), cnt.data_ptr(),
            n, d, bwd_pack.senders.data_ptr(), bwd_pack.weights.data_ptr(),
            bwd_pack.row_range.data_ptr(), out.shape[0], dx.data_ptr(),
            entry="packed_max_bwd")
    packed_max_bwd_cuda.launches += 1
    packed_max_bwd_cuda.launches_by_dtype[str(x.dtype)] += 1
    return dx


packed_max_bwd_cuda.launches = 0
packed_max_bwd_cuda.launches_by_dtype = collections.Counter()

# every kernel wrapper; each counts its launches, and by the dtype of
# the input it reads (x, v, a, msg: 'torch.float32' or
# 'torch.bfloat16'), K1 and K3 also by width, K1 also its rectangular
# launches by width, K2 also by the batch pack its index came from (''
# for a pack's own local rows)
KERNELS = (packed_spmm_cuda, packed_segment_matmul_cuda,
           packed_segment_matmul_headed_cuda, packed_sddmm_cuda,
           packed_max_cuda, packed_max_bwd_cuda)
_KEYED = ("launches_by_width", "launches_rectangular", "launches_by_pack",
          "launches_by_dtype")
# per wrapper: launches, then a Counter per _KEYED name (empty where the
# wrapper has no such counter; a snapshot given fewer reads them empty)
LaunchCounts = Dict[str, Tuple[Any, ...]]


def launch_counts() -> LaunchCounts:
    """A snapshot of every wrapper's launches and keyed counters."""
    return {k.__name__: (k.launches, *(collections.Counter(
        getattr(k, a, {})) for a in _KEYED)) for k in KERNELS}


def _keyed(counts: Tuple[Any, ...]) -> list:
    return list(counts[1:]) + [{}] * (1 + len(_KEYED) - len(counts))


def set_launch_counts(counts: LaunchCounts) -> None:
    for k in KERNELS:
        k.launches = counts[k.__name__][0]
        for a, c in zip(_KEYED, _keyed(counts[k.__name__])):
            if hasattr(k, a):
                getattr(k, a).clear()
                getattr(k, a).update(c)


def add_launch_counts(delta: LaunchCounts) -> None:
    """Add ``delta`` (launches_between's) to the counters: a replayed
    CUDA graph launches again the kernels counted at its capture."""
    for k in KERNELS:
        k.launches += delta[k.__name__][0]
        for a, c in zip(_KEYED, _keyed(delta[k.__name__])):
            if hasattr(k, a):
                getattr(k, a).update(c)


def launches_between(before: LaunchCounts,
                     after: LaunchCounts) -> LaunchCounts:
    return {name: (after[name][0] - b[0],
                   *(a - collections.Counter(c) for a, c in
                     zip(_keyed(after[name]), _keyed(b))))
            for name, b in before.items()}


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def spmm_packed(pack: PackedCSR, x: torch.Tensor) -> torch.Tensor:
    """Forward SpMM from a packed layout (spmm_kernel.py:441-459):
    the kernel for a CUDA tensor, the plain version for a CPU one; out
    has the pack's rows."""
    if x.is_cuda:
        return packed_spmm_cuda(pack, x).to(x.dtype)
    return spmm_packed_plain(pack, x)


def packed_segment_matmul(msg: torch.Tensor, local_rows: torch.Tensor,
                          tiles: torch.Tensor, num_tiles: int,
                          group: int = 1) -> torch.Tensor:
    """out[t*R + j] = the sum of msg over the slots of tile t's chunks
    whose local row is j (spmm_kernel.py:376-438 with weights=None),
    every slot, padding slots included: the kernel for a CUDA tensor,
    the plain version for a CPU one.  msg [NC, C, D] f32 or bf16; f32
    out [num_tiles*R, D].  ``group`` is the G the pack was built with;
    both versions sum in f32 in slot order whatever G is (the TPU kernel
    pre-sums aligned groups, and rounds them to bf16 for bf16 msg)."""
    if group < 1 or msg.shape[1] % group:
        raise ValueError(f"group {group} must divide the chunk of "
                         f"{msg.shape[1]} slots")
    if msg.is_cuda:
        return packed_segment_matmul_cuda(msg, local_rows, tiles, num_tiles)
    return packed_segment_matmul_plain(msg, local_rows, tiles, num_tiles)


def segment_sum(msg: torch.Tensor, index: SegmentIndex,
                pack: str = "") -> torch.Tensor:
    """out[row(p)] += msg[src[p]] into f32 [n_out, D] over the positions
    of a host-built ``index`` of the batch's ``pack``: K2 for a CUDA
    tensor, the plain version for a CPU one."""
    if msg.is_cuda:
        return segment_sum_cuda(msg, index, pack)
    return segment_sum_plain(msg, index)


class SegmentMatmulFn(torch.autograd.Function):
    """Differentiable packed segmented sum (the port of
    ``segment_matmul_vjp``, spmm_kernel.py:505-534): out[rows] += msg,
    rows = tiles*R + local_rows, sliced to num_nodes rows.  The gradient
    is the gather d_msg[i, c] = g[rows[i, c]], with rows clamped to the
    last row of g as the JAX rule does (:526): a slot whose row lies past
    num_nodes reads g[num_nodes - 1].  local_rows and tiles get no
    gradient."""

    @staticmethod
    def forward(ctx, msg: torch.Tensor, local_rows: torch.Tensor,
                tiles: torch.Tensor, num_nodes: int) -> torch.Tensor:
        ctx.save_for_backward(local_rows, tiles)
        ctx.msg_dtype = msg.dtype
        return packed_segment_matmul(msg, local_rows, tiles,
                                     num_tiles_of(num_nodes))[:num_nodes]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        local_rows, tiles = ctx.saved_tensors
        rows = slot_rows(local_rows, tiles).clamp_max(g.shape[0] - 1)
        d_msg = g.index_select(0, rows.reshape(-1)).view(
            rows.shape + g.shape[1:])
        return d_msg.to(ctx.msg_dtype), None, None, None


def segment_matmul_vjp(msg: torch.Tensor, local_rows: torch.Tensor,
                       tiles: torch.Tensor, num_nodes: int) -> torch.Tensor:
    return SegmentMatmulFn.apply(msg, local_rows, tiles, num_nodes)


class SegmentSumFn(torch.autograd.Function):
    """Differentiable segmented sum on a host-built index (the edge
    convs' S.segment_sum over receivers, graphgym_tpu/nn/layers.py:706):
    out[row(p)] += msg[src[p]], K2 for a CUDA msg (``segment_sum``,
    counted under ``pack``), sliced to ``num_rows`` rows.  Every message
    row is the source of at most one position, and ``grad_rows``
    [n_src] is that position's row (g's row count where it has none, or
    is left out): the gradient is the gather d_msg[i] = g[grad_rows[i]],
    0 past g's rows, no scatter.  The index and grad_rows get no
    gradient."""

    @staticmethod
    def forward(ctx, msg: torch.Tensor, index: SegmentIndex,
                grad_rows: torch.Tensor, num_rows: int,
                pack: str) -> torch.Tensor:
        ctx.save_for_backward(grad_rows)
        return segment_sum(msg, index, pack)[:num_rows].to(msg.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (grad_rows,) = ctx.saved_tensors
        return take_padded(g, grad_rows), None, None, None, None


def segment_sum_vjp(msg: torch.Tensor, index: SegmentIndex,
                    grad_rows: torch.Tensor, num_rows: int,
                    pack: str = "") -> torch.Tensor:
    return SegmentSumFn.apply(msg, index, grad_rows, num_rows, pack)


class PermuteRowsFn(torch.autograd.Function):
    """out[s] = a[index[s]] with ``index`` a bijection between some of
    a's rows and some of out's, every other out row reading an appended
    zero row (index = a's row count): the edge softmax's per-edge logits
    in the 'edge' pack's slot order, and its weights back in edge order.
    The gradient is the gather of the inverse map, da[e] = g[inverse[e]]
    (0 where inverse[e] is g's row count), no scatter and no atomics.
    The maps get no gradient."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, index: torch.Tensor,
                inverse: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(inverse)
        return take_padded(a, index.reshape(-1))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (inverse,) = ctx.saved_tensors
        return take_padded(g, inverse), None, None


def permute_rows(a: torch.Tensor, index: torch.Tensor,
                 inverse: torch.Tensor) -> torch.Tensor:
    return PermuteRowsFn.apply(a, index, inverse)


class SpmmPackFn(torch.autograd.Function):
    """Differentiable SpMM over batch-carried packs (the port of
    ``spmm_pack_vjp``, spmm_kernel.py:681-710): out = A x on the fwd
    pack, dx = A^T g on the bwd pack.  On a rectangular pack (graph
    pooling) out has the fwd pack's rows and dx the bwd pack's, x's.
    The packs get no gradient."""

    @staticmethod
    def forward(ctx, fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                x: torch.Tensor) -> torch.Tensor:
        ctx.bwd_pack = bwd_pack
        return spmm_packed(fwd_pack, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, None, spmm_packed(ctx.bwd_pack, g.contiguous())


def spmm_pack_vjp(fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                  x: torch.Tensor) -> torch.Tensor:
    return SpmmPackFn.apply(fwd_pack, bwd_pack, x)


def packed_max(pack: PackedCSR, x: torch.Tensor):
    """Segmented max from a packed layout, f32 (out, cnt) of the pack's
    rows: the kernel for a CUDA tensor, the plain version for a CPU
    one."""
    if x.is_cuda:
        return packed_max_cuda(pack, x)
    return packed_max_plain(pack, x)


def packed_max_bwd(bwd_pack: PackedCSR, x: torch.Tensor, g: torch.Tensor,
                   out: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """The segmented max's f32 dx on the transpose pack: the kernel for a
    CUDA tensor, the plain version for a CPU one."""
    if x.is_cuda:
        return packed_max_bwd_cuda(bwd_pack, x, g, out, cnt)
    return packed_max_bwd_plain(bwd_pack, x, g, out, cnt)


class PackedMaxFn(torch.autograd.Function):
    """Differentiable segmented max over batch-carried packs (the
    'max' aggregation: graphgym_tpu/ops/sparse.py:25-57 with reduce
    'max', segment_max masked to the slots of nonzero pack weight): out
    = the max of w * x[sender] over each row's slots on the fwd pack;
    dx by ``packed_max_bwd`` on the bwd pack from the forward's out and
    tie counts, no scatter, no atomics.  On a rectangular pack (graph
    max pooling) out has the fwd pack's rows and dx x's.  The packs get
    no gradient."""

    @staticmethod
    def forward(ctx, fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                x: torch.Tensor) -> torch.Tensor:
        out, cnt = packed_max(fwd_pack, x)
        ctx.save_for_backward(x, out, cnt)
        ctx.bwd_pack = bwd_pack
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, out, cnt = ctx.saved_tensors
        dx = packed_max_bwd(ctx.bwd_pack, x, g.float(), out, cnt)
        return None, None, dx.to(x.dtype)


def packed_max_vjp(fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                   x: torch.Tensor) -> torch.Tensor:
    return PackedMaxFn.apply(fwd_pack, bwd_pack, x)


class BidirPack(NamedTuple):
    """Forward (A) and transpose (A^T) packs of one COO graph, with its
    int32 senders and receivers (spmm_kernel.py:466-472)."""
    fwd: PackedCSR
    bwd: PackedCSR
    senders: Any
    receivers: Any

    def to(self, device) -> "BidirPack":
        """A copy with every array as a tensor on ``device``."""
        def move(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return BidirPack(PackedCSR(*map(move, self.fwd)),
                         PackedCSR(*map(move, self.bwd)),
                         move(self.senders), move(self.receivers))


def pack_bidir(senders: np.ndarray, receivers: np.ndarray,
               weights: Optional[np.ndarray], num_nodes: int) -> BidirPack:
    """Both packs of an edge list, no chunk bucketing (spmm_kernel.py:
    475-481): the fwd pack sums into receivers, the bwd pack into
    senders, with the same weights."""
    return BidirPack(pack_csr(senders, receivers, weights, num_nodes),
                     pack_csr(receivers, senders, weights, num_nodes),
                     np.asarray(senders, np.int32),
                     np.asarray(receivers, np.int32))


def spmm_bidir(pack: BidirPack, x: torch.Tensor,
               num_nodes: int) -> torch.Tensor:
    """out = A x, differentiable in x (spmm_kernel.py:484-502): K1 on the
    fwd pack forward, K1 on the bwd pack for dx = A^T g.  x has
    num_nodes rows: the pack's padding sender num_nodes reads as a zero
    row in both the kernel and the plain version.  The weights are
    constants."""
    if x.shape[0] != num_nodes:
        raise ValueError(f"spmm_bidir: x has {x.shape[0]} rows, the packs "
                         f"{num_nodes}")
    return SpmmPackFn.apply(pack.fwd, pack.bwd, x)


def sddmm_edge_grad(pack: BidirPack, x: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """dL/dw[e] = <g[receivers[e]], x[senders[e]]>, the edge-weight
    gradient of ``spmm_bidir`` (spmm_kernel.py:713-717, XLA gathers
    there, so plain PyTorch here)."""
    return (g.index_select(0, pack.receivers.long())
            * x.index_select(0, pack.senders.long())).sum(-1)


def spmm_pallas(senders, receivers, edge_weight, x: torch.Tensor,
                num_nodes: int) -> torch.Tensor:
    """The COO entry of the packed SpMM (spmm_kernel.py:721-728): packs
    the edges on the host, then K1 (the plain version for a CPU x).  x
    has num_nodes rows, or one more, the padding row, which only slots
    of weight 0 read; out has num_nodes rows.  Forward only, as in the
    JAX package."""
    if x.shape[0] not in (num_nodes, num_nodes + 1):
        raise ValueError(f"spmm_pallas: x has {x.shape[0]} rows for "
                         f"{num_nodes} nodes")

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)
    pack = pack_csr(host(senders), host(receivers),
                    None if edge_weight is None else host(edge_weight),
                    num_nodes)
    pack = PackedCSR(*(torch.from_numpy(a).to(x.device) for a in pack))
    return spmm_packed(pack, x[:num_nodes])


def packed_segment_matmul_headed(pack: PackedCSR, v: torch.Tensor,
                                 alpha: torch.Tensor) -> torch.Tensor:
    """Per-head weighted aggregation from a packed layout
    (spmm_kernel.py:584-625, with the v[senders] gather fused): the
    kernel for a CUDA tensor, the plain version for a CPU one.  f32
    out [num_nodes, H*dv] whatever v's dtype, as the TPU kernel's
    (:621).  A bf16 alpha (a mixed-precision softmax's) goes in as f32;
    against a bf16 v both versions round it to bf16 anyway."""
    if alpha.dtype == torch.bfloat16:
        alpha = alpha.float()
    if v.is_cuda:
        return packed_segment_matmul_headed_cuda(pack, v, alpha)
    return packed_segment_matmul_headed_plain(pack, v, alpha)


def alpha_to_bwd(alpha: torch.Tensor, slot_map: torch.Tensor
                 ) -> torch.Tensor:
    """Per-slot coefficients [NC, C, H] of the fwd 'att' pack carried
    into bwd slot order [NC_bwd, C, H]; bwd padding slots, which the map
    points one past the fwd slots, get 0."""
    heads = alpha.shape[-1]
    flat = torch.cat([alpha.reshape(-1, heads), alpha.new_zeros(1, heads)])
    return flat.index_select(0, slot_map.reshape(-1)).view(
        slot_map.shape + (heads,))


def packed_sddmm(pack: PackedCSR, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Per-slot, per-head dot products on a packed layout (the SDDMM
    half of ``_segmm_headed_bwd``, spmm_kernel.py:655-669, and the
    score of graphgym_tpu/nn/layers.py:152-156, both XLA gathers there):
    out[s, h] = <a[row(s), h, :], b[senders[s], h, :]> on the slots of
    nonzero pack weight and 0 on the others, a and b [num_nodes, H, dh];
    f32 out [NC, C, H].  The kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if a.is_cuda:
        return packed_sddmm_cuda(pack, a, b)
    return packed_sddmm_plain(pack, a, b)


class SegmentMatmulHeadedFn(torch.autograd.Function):
    """Differentiable per-head weighted aggregation over the 'att' packs
    (the port of ``segment_matmul_headed_vjp``, spmm_kernel.py:628-672):

        out[row(s), h, :] += alpha[s, h] * v[sender(s), h, :]

    Gradients: dv = A_alpha^T g is the same kernel on the bwd pack, with
    alpha carried into bwd slot order by ``slot_map`` (deterministic, no
    atomics, no [E, H*dv] message gradient; the JAX package gathers,
    multiplies and scatters instead, with the same result);
    dalpha[s, h] = <g[row(s), h, :], v[sender(s), h, :]> is the SDDMM
    kernel, and 0 on every slot of pack weight 0, where the JAX package
    has <g, v> (ROADMAP C: the masked softmax gives those slots alpha 0
    and passes no gradient back through them).  The packs and the map
    get no gradient."""

    @staticmethod
    def forward(ctx, v: torch.Tensor, alpha: torch.Tensor,
                fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                slot_map: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(v, alpha)
        ctx.packs = (fwd_pack, bwd_pack, slot_map)
        return packed_segment_matmul_headed(fwd_pack, v, alpha)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        v, alpha = ctx.saved_tensors
        fwd_pack, bwd_pack, slot_map = ctx.packs
        g = g.contiguous()
        n, d = v.shape
        heads = alpha.shape[-1]
        dv = dalpha = None
        if ctx.needs_input_grad[0]:
            dv = packed_segment_matmul_headed(
                bwd_pack, g, alpha_to_bwd(alpha, slot_map)).to(v.dtype)
        if ctx.needs_input_grad[1]:
            dalpha = packed_sddmm(
                fwd_pack, g.view(n, heads, d // heads),
                v.to(g.dtype).view(n, heads, d // heads)).to(alpha.dtype)
        return dv, dalpha, None, None, None


def segment_matmul_headed_vjp(v: torch.Tensor, alpha: torch.Tensor,
                              fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                              slot_map: torch.Tensor) -> torch.Tensor:
    return SegmentMatmulHeadedFn.apply(v, alpha, fwd_pack, bwd_pack,
                                       slot_map)


class PackedScoreFn(torch.autograd.Function):
    """Differentiable scaled dot-product score on the 'att' packs:

        score[s, h] = <q[row(s), h, :], k[sender(s), h, :]> / scale

    on the slots of nonzero pack weight, 0 on the others (the JAX
    package's score, graphgym_tpu/nn/layers.py:152-156 and :454-457, on
    gathered [E, H, dh] q and k; there every slot gets the dot product,
    and the softmax masks the weight-0 ones).  Forward is the SDDMM
    kernel.  With c = dscore / scale, 0 on the weight-0 slots, the
    gradients are K3: dq = A_c k on the fwd pack, dk = A_c^T q on the bwd
    pack with c carried by ``slot_map``.  No [E, H*dh] tensor, no
    atomics.  The packs and the map get no gradient."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, fwd_pack: PackedCSR,
                bwd_pack: PackedCSR, slot_map: torch.Tensor,
                scale: float) -> torch.Tensor:
        ctx.save_for_backward(q, k)
        ctx.packs = (fwd_pack, bwd_pack, slot_map)
        ctx.scale = scale
        return (packed_sddmm(fwd_pack, q, k) / scale).to(q.dtype)

    @staticmethod
    def backward(ctx, dscore: torch.Tensor):
        q, k = ctx.saved_tensors
        fwd_pack, bwd_pack, slot_map = ctx.packs
        n = q.shape[0]
        c = torch.where(fwd_pack.weights[..., None] != 0,
                        dscore.float() / ctx.scale, 0.0).contiguous()
        dq = dk = None
        if ctx.needs_input_grad[0]:
            dq = packed_segment_matmul_headed(
                fwd_pack, k.reshape(n, -1), c).view(q.shape).to(q.dtype)
        if ctx.needs_input_grad[1]:
            dk = packed_segment_matmul_headed(
                bwd_pack, q.reshape(n, -1),
                alpha_to_bwd(c, slot_map)).view(k.shape).to(k.dtype)
        return dq, dk, None, None, None, None


def packed_scaled_dot(q: torch.Tensor, k: torch.Tensor, fwd_pack: PackedCSR,
                      bwd_pack: PackedCSR, slot_map: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """[NC, C, H] scores of the fwd pack's slots from q, k [N, H, dh]."""
    return PackedScoreFn.apply(q, k, fwd_pack, bwd_pack, slot_map, scale)


def take_padded(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[idx] with idx of any shape, where index num_nodes (the pack's
    padding sender) reads an appended zero row."""
    padded = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
    return padded.index_select(0, idx.reshape(-1).long()).view(
        idx.shape + arr.shape[1:])


def packed_row_sum(pack: PackedCSR, c: torch.Tensor) -> torch.Tensor:
    """f32 [num_nodes, H] row sums of per-slot values c [NC, C, H] f32
    over the slots of each row's row_range, in slot order: K3 with v =
    ones [num_nodes, H] (dv = 1) for a CUDA tensor, its plain version for
    a CPU one.  The slots outside the ranges are those of pack weight 0
    after a row's last nonzero one; callers give them c = 0."""
    n, heads = pack.row_range.shape[0], c.shape[-1]
    ones = torch.ones(n, heads, dtype=torch.float32, device=c.device)
    return packed_segment_matmul_headed(pack, ones, c)


class PackedSoftmaxFn(torch.autograd.Function):
    """The attention softmax over each row's slots of the 'att' fwd pack,
    no float atomics forward or backward (the JAX package's
    segment_softmax, graphgym_tpu/ops/segment.py:73-100, as
    graphgym_tpu/nn/layers.py:157-160 calls it with the pack's rows and
    validity mask).

    In f32 (float64 for float64 logits).

    Forward: logits of slots of pack weight 0 are masked to -1e30; the
    row max by scatter_reduce (amax, order-free; no gradient: the
    softmax does not depend on the shift); exp, 0 on masked slots; the
    denominators denom[row, h] = sum of the row's exp by K3 (one owner
    per row, slot order), clamped to 1e-16, so a fully masked row gives
    all-zero probabilities; alpha = exp / denom[rows], a gather.

    Backward: with s[row, h] = sum of the row's alpha * g (K3 again),
    dlogit = alpha * (g - s[rows]), 0 on masked slots.  No [E, H]
    scatter, no index_add.  The pack gets no gradient."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, pack: PackedCSR) -> torch.Tensor:
        rows = pack_rows(pack).reshape(-1)
        valid = (pack.weights > 0)[..., None]
        x = torch.where(valid, logits.to(_sum_dtype(logits)), -1e30)
        flat = x.reshape(-1, x.shape[-1])
        n = pack.row_range.shape[0]
        seg_max = flat.new_full((n, flat.shape[1]), float("-inf"))
        seg_max = seg_max.scatter_reduce(
            0, rows[:, None].expand_as(flat), flat, "amax")
        seg_max = torch.where(torch.isfinite(seg_max) & (seg_max > -5e29),
                              seg_max, 0.0)
        exp = torch.where(valid, torch.exp(
            x - seg_max.index_select(0, rows).view(x.shape)), 0.0)
        denom = packed_row_sum(pack, exp.contiguous()).clamp_min(1e-16)
        alpha = exp / denom.index_select(0, rows).view(x.shape)
        ctx.save_for_backward(alpha)
        ctx.pack, ctx.in_dtype = pack, logits.dtype
        return alpha.to(logits.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (alpha,) = ctx.saved_tensors
        pack = ctx.pack
        g = g.to(alpha.dtype)
        s = packed_row_sum(pack, (alpha * g).contiguous())
        rows = pack_rows(pack).reshape(-1)
        dlogit = alpha * (g - s.index_select(0, rows).view(g.shape))
        return dlogit.to(ctx.in_dtype), None


def packed_segment_softmax(logits: torch.Tensor,
                           pack: PackedCSR) -> torch.Tensor:
    """[NC, C, H] softmax of per-slot logits over each row of the 'att'
    fwd pack, masked to the slots of nonzero pack weight."""
    return PackedSoftmaxFn.apply(logits, pack)


class PackedNodeScoresFn(torch.autograd.Function):
    """Per-slot scores from per-node ones (GAT's additive attention,
    graphgym_tpu/nn/layers.py:146-149): score[s, h] = s_dst[row(s), h] +
    s_src[sender(s), h] on the 'att' fwd pack, the padding sender
    reading a zero row.

    Forward is two gathers.  Their gradients are row sums on the row
    walk (K3, dv = 1) instead of index_add: ds_dst over the fwd pack,
    ds_src over the bwd pack with the slot gradient carried into bwd
    order by ``slot_map``.  The sums read only the slots of the row
    ranges, so the gradient is the gathers' own only where the slots of
    pack weight 0 get a gradient of 0, as they do downstream of
    ``packed_segment_softmax`` (masked there) in ``packed_attention``,
    the one caller.  The packs and the map get no gradient."""

    @staticmethod
    def forward(ctx, s_dst: torch.Tensor, s_src: torch.Tensor,
                fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                slot_map: torch.Tensor) -> torch.Tensor:
        ctx.packs = (fwd_pack, bwd_pack, slot_map)
        ctx.dtypes = (s_dst.dtype, s_src.dtype)
        return (take_padded(s_dst, pack_rows(fwd_pack))
                + take_padded(s_src, fwd_pack.senders))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        fwd_pack, bwd_pack, slot_map = ctx.packs
        c = g.float().contiguous()
        ds_dst = ds_src = None
        if ctx.needs_input_grad[0]:
            ds_dst = packed_row_sum(fwd_pack, c).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            ds_src = packed_row_sum(bwd_pack, alpha_to_bwd(
                c, slot_map)).to(ctx.dtypes[1])
        return ds_dst, ds_src, None, None, None


def packed_node_scores(s_dst: torch.Tensor, s_src: torch.Tensor,
                       fwd_pack: PackedCSR, bwd_pack: PackedCSR,
                       slot_map: torch.Tensor) -> torch.Tensor:
    """[NC, C, H] per-slot s_dst[row] + s_src[sender] from [N, H]."""
    return PackedNodeScoresFn.apply(s_dst, s_src, fwd_pack, bwd_pack,
                                    slot_map)
