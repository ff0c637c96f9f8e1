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
kernel; K2 sums messages it is given, every slot of the pack.

On a CUDA tensor the entry points (``spmm_packed``,
``packed_segment_matmul``, ``packed_segment_matmul_headed``,
``packed_sddmm``, ``packed_max``, ``packed_max_bwd``) launch the kernel
or raise; on a CPU tensor they take the plain version, the same
arithmetic in plain PyTorch.

Around them: the autograd Functions of the layers (SpMM, attention
aggregation, score, the attention softmax and the node-score gathers,
whose sums all run on K3 or K1, and the segmented max, so no float
atomics), and the COO
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
             group: int = 1) -> PackedCSR:
    """Host-side packing (the numpy path of the JAX package's
    ``pack_csr``, spmm_kernel.py:74-179).

    Edges are sorted by (receiver, sender), so partial sums accumulate
    in a fixed order.  Each row's span is padded to a multiple of
    ``group`` (G) slots, which keep the row's local index and weight 0,
    so aligned groups of G slots belong to one row.  Every tile gets at
    least one chunk; the other padding slots carry sender ``num_nodes``,
    weight 0 and local row 0."""
    pack, _ = pack_csr_with_slots(senders, receivers, weights, num_nodes,
                                  group)
    if pad_chunks_to is not None:
        pack = pad_pack(pack, pad_chunks_to, num_nodes)
    return pack


def pack_csr_with_slots(senders: np.ndarray, receivers: np.ndarray,
                        weights: Optional[np.ndarray], num_nodes: int,
                        group: int = 1) -> Tuple[PackedCSR, np.ndarray]:
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

    out_s = np.full(nc * C, num_nodes, np.int32)
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


def pad_pack(pack: PackedCSR, pad_chunks_to: int,
             num_nodes: int) -> PackedCSR:
    """Pad a pack with no-op chunks (zero weight, last tile) up to
    ``pad_chunks_to`` chunks (spmm_kernel.py:182-201)."""
    nc, c = pack.senders.shape
    if pad_chunks_to <= nc:
        return pack
    extra = pad_chunks_to - nc
    num_tiles = (num_nodes + ROWS_PER_TILE - 1) // ROWS_PER_TILE
    cat = np.concatenate
    return PackedCSR(
        cat([pack.senders, np.full((extra, c), num_nodes, np.int32)]),
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


def _f32_tiles(n: int, d: int, device) -> torch.Tensor:
    return torch.zeros(num_tiles_of(n) * ROWS_PER_TILE, d,
                       dtype=torch.float32, device=device)


def spmm_packed_plain(pack: PackedCSR, x: torch.Tensor) -> torch.Tensor:
    """out = A @ x from the packed layout: gather, weight, index_add_
    into f32 tiles, cast to x.dtype.  x has num_nodes rows; the padding
    sender num_nodes reads an appended zero row."""
    n, d = x.shape
    xp = torch.cat([x, x.new_zeros(1, d)]).float()
    msg = xp.index_select(0, pack.senders.reshape(-1).long())
    msg = msg * pack.weights.reshape(-1, 1)
    out = _f32_tiles(n, d, x.device)
    out.index_add_(0, pack_rows(pack).reshape(-1), msg)
    return out[:n].to(x.dtype)


def packed_segment_matmul_headed_plain(pack: PackedCSR, v: torch.Tensor,
                                       alpha: torch.Tensor) -> torch.Tensor:
    """out[row(s), h*dv + k] += alpha[s, h] * v[senders[s], h*dv + k]
    over the pack's slots: gather, per-head multiply, index_add_ into
    f32 tiles.  v [num_nodes, H*dv] f32 or bf16, alpha [NC, C, H];
    out [num_nodes, H*dv] f32.  The padding sender num_nodes reads an
    appended zero row."""
    n, d = v.shape
    heads = alpha.shape[-1]
    vp = torch.cat([v, v.new_zeros(1, d)]).float()
    msg = vp.index_select(0, pack.senders.reshape(-1).long())
    msg = msg.view(-1, heads, d // heads) * alpha.reshape(-1, heads, 1)
    out = _f32_tiles(n, d, v.device)
    out.index_add_(0, pack_rows(pack).reshape(-1), msg.view(-1, d))
    return out[:n]


def packed_sddmm_plain(pack: PackedCSR, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """out[s, h] = <a[row(s), h, :], b[senders[s], h, :]> where the pack
    weight of slot s is nonzero, else 0: gather, multiply in f32, sum
    per head, mask.  a and b [num_nodes, H, dh]; f32 out [NC, C, H].
    The padding sender num_nodes reads an appended zero row."""
    n, heads, dh = a.shape
    rows = pack_rows(pack).reshape(-1).clamp_max(n - 1)
    bp = torch.cat([b.reshape(n, -1), b.new_zeros(1, heads * dh)])
    prod = (a.reshape(n, -1).float().index_select(0, rows)
            * bp.float().index_select(0, pack.senders.reshape(-1).long()))
    out = prod.view(-1, heads, dh).sum(-1).view(pack.senders.shape
                                                + (heads,))
    return torch.where(pack.weights[..., None] != 0, out, 0.0)


def packed_segment_matmul_plain(msg: torch.Tensor, local_rows: torch.Tensor,
                                tiles: torch.Tensor,
                                num_tiles: int) -> torch.Tensor:
    """out[tiles[i]*R + local_rows[i, c]] += msg[i, c] over every slot,
    padding slots included: index_add_ into f32 tiles.  msg [NC, C, D]
    f32 or bf16; out [num_tiles*R, D] f32."""
    d = msg.shape[-1]
    out = torch.zeros(num_tiles * ROWS_PER_TILE, d, dtype=torch.float32,
                      device=msg.device)
    out.index_add_(0, slot_rows(local_rows, tiles).reshape(-1),
                   msg.reshape(-1, d).float())
    return out


def _live(pack: PackedCSR, n: int) -> torch.Tensor:
    """[NC * C] bool: the slots a max takes, those of nonzero weight
    whose sender is a row of x (not the padding sender n)."""
    senders = pack.senders.reshape(-1)
    return (pack.weights.reshape(-1) != 0) & (senders >= 0) & (senders < n)


def packed_max_plain(pack: PackedCSR, x: torch.Tensor):
    """f32 (out, cnt) [num_nodes, D]: out[r, c] = the max of w * x[s, c]
    over the slots of row r with weight w != 0 and a live sender s, cnt
    how many slots reach it; 0 and 0 for a row with none.  Gather,
    multiply in f32, -inf on every other slot, scatter_reduce(amax) into
    f32 tiles and -inf -> 0 (the JAX -inf mask and isfinite -> 0), then
    the ties counted by index_add_ (exact small integers).  No
    data-dependent shape, so nothing waits for the card."""
    n, d = x.shape
    live = _live(pack, n)[:, None]
    xp = torch.cat([x, x.new_zeros(1, d)]).float()
    msg = torch.where(live, xp.index_select(
        0, pack.senders.reshape(-1).long()) * pack.weights.reshape(-1, 1),
        float("-inf"))
    rows = pack_rows(pack).reshape(-1)
    out = torch.full((num_tiles_of(n) * ROWS_PER_TILE, d), float("-inf"),
                     device=x.device)
    out.scatter_reduce_(0, rows[:, None].expand(-1, d), msg, "amax")
    out = torch.where(torch.isfinite(out), out, 0.0)
    cnt = torch.zeros_like(out)
    cnt.index_add_(0, rows, (live & (msg == out.index_select(0, rows)))
                   .float())
    return out[:n], cnt[:n]


def packed_max_bwd_plain(bwd_pack: PackedCSR, x: torch.Tensor,
                         g: torch.Tensor, out: torch.Tensor,
                         cnt: torch.Tensor) -> torch.Tensor:
    """f32 dx [num_nodes, D] of packed_max_plain's out on the transpose
    pack (its rows are the senders s, its senders the receivers r):
    dx[s, c] = the sum over row s's slots of weight w != 0, in slot
    order, of [w * x[s, c] == out[r, c]] * (g[r, c] * (1 / cnt[r, c]))
    * w, a tie split evenly between the slots that reach the max, as
    jax.ops.segment_max's gradient splits it.  Gathers and index_add_
    into f32 tiles over every slot (0 on the others; sequential, so in
    slot order, on the CPU)."""
    n, d = x.shape
    live = _live(bwd_pack, n)[:, None]
    rows = pack_rows(bwd_pack).reshape(-1)
    receivers = bwd_pack.senders.reshape(-1).long()
    w = bwd_pack.weights.reshape(-1, 1)

    def take(a):   # a[receivers], the padding sender n reading row n
        return torch.cat([a.float(), a.new_zeros(1, d).float()]) \
            .index_select(0, receivers)
    xs = x.float().index_select(0, rows.clamp_max(n - 1))
    hit = live & (xs * w == take(out))
    term = torch.where(hit, take(g) * (1.0 / take(cnt)) * w, 0.0)
    dx = torch.zeros(num_tiles_of(n) * ROWS_PER_TILE, d, device=x.device)
    dx.index_add_(0, rows, term)
    return dx[:n]


# --------------------------------------------------------------------------
# K2's row -> slots index (host-built, once per pack)
# --------------------------------------------------------------------------

RUN_SLOTS = 128   # most slots of one row that one warp of K2 sums


class SegmentRuns(NamedTuple):
    """Where K2 reads and writes, for one pack.

    run_start    [runs + 1] int32 — first flat slot of each run, then
                 the slot count.  A run is at most RUN_SLOTS consecutive
                 slots of one output row within one chunk; runs are in
                 slot order and cover every slot.
    run_out      [runs] int32 — where a run's sum goes: its output row
                 when it is the row's only run, else partial p as -(p+1)
    comb_rows    [M] int32 — the output rows with no run or several
    comb_ptr     [M + 1] int32 — their partials, comb_ptr[m] up to
                 comb_ptr[m + 1], numbered in slot order
    num_partials int
    """
    run_start: Any
    run_out: Any
    comb_rows: Any
    comb_ptr: Any
    num_partials: int


def segment_runs_host(local_rows: np.ndarray, tiles: np.ndarray,
                      num_tiles: int) -> SegmentRuns:
    """K2's index of a pack (numpy): the slots cut into runs, and for
    each output row either its single run or its partials."""
    local_rows = np.asarray(local_rows, np.int64)
    nc, c = local_rows.shape
    rows = (np.asarray(tiles, np.int64)[:, None] * ROWS_PER_TILE
            + local_rows).reshape(-1)
    n_out = num_tiles * ROWS_PER_TILE
    if rows.size and (rows.min() < 0 or rows.max() >= n_out):
        raise ValueError(f"pack rows outside the {n_out} rows of "
                         f"{num_tiles} tiles")
    # a run starts at each chunk, at each change of row, and every
    # RUN_SLOTS slots after that
    new = np.ones(rows.size, bool)
    new[1:] = rows[1:] != rows[:-1]
    new[::c] = True
    starts = np.flatnonzero(new)
    pieces = -(-np.diff(np.append(starts, rows.size)) // RUN_SLOTS)
    first = np.cumsum(pieces) - pieces
    k = np.arange(int(pieces.sum()))
    run_start = (np.repeat(starts, pieces)
                 + (k - np.repeat(first, pieces)) * RUN_SLOTS)
    run_row = rows[run_start]
    count = np.bincount(run_row, minlength=n_out)
    # partials of rows with several runs: by row, then in slot order
    multi = np.flatnonzero(count[run_row] > 1)
    multi = multi[np.argsort(run_row[multi], kind="stable")]
    run_out = run_row.copy()
    run_out[multi] = -1 - np.arange(len(multi))
    comb_rows = np.flatnonzero(count != 1)
    sizes = np.where(count[comb_rows] > 1, count[comb_rows], 0)
    return SegmentRuns(
        np.append(run_start, rows.size).astype(np.int32),
        run_out.astype(np.int32), comb_rows.astype(np.int32),
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
        len(multi))


_RUNS_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_RUNS_CACHE_SIZE = 8


def segment_runs(local_rows: torch.Tensor, tiles: torch.Tensor,
                 num_tiles: int) -> SegmentRuns:
    """``segment_runs_host`` of a pack, on local_rows' device, built
    once per pack.  The cache holds the pack's own tensors, so a hit
    names the same memory, unchanged since (equal version counters)."""
    key = (local_rows.data_ptr(), tiles.data_ptr(), local_rows.device,
           tuple(local_rows.shape), tuple(tiles.shape),
           local_rows._version, tiles._version, num_tiles)
    hit = _RUNS_CACHE.get(key)
    if hit is None:
        host = segment_runs_host(local_rows.cpu().numpy(),
                                 tiles.cpu().numpy(), num_tiles)
        runs = SegmentRuns(*(torch.from_numpy(a).to(local_rows.device)
                             for a in host[:4]), host.num_partials)
        hit = _RUNS_CACHE[key] = (local_rows, tiles, runs)
        while len(_RUNS_CACHE) > _RUNS_CACHE_SIZE:
            _RUNS_CACHE.popitem(last=False)
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
    # x, n_rows, d, senders, weights, row_range, out, stream
    "packed_spmm": [_P, _LL, _I, _P, _P, _P, _P, _P],
    # msg, d, n_runs, run_start, run_out, n_comb, comb_rows, comb_ptr,
    # partial, out, stream
    "packed_segment": [_P, _I, _LL, _P, _P, _LL, _P, _P, _P, _P, _P],
    # v, n_rows, d, heads, senders, alpha, row_range, out, stream
    "packed_attention": [_P, _LL, _I, _I, _P, _P, _P, _P, _P],
    # a, b, n_rows, d, heads, senders, weights, row_range, n_slots, out,
    # stream
    "packed_sddmm": [_P, _P, _LL, _I, _I, _P, _P, _P, _LL, _P, _P],
    # x, n_rows, d, senders, weights, row_range, out, cnt, stream
    "packed_max": [_P, _LL, _I, _P, _P, _P, _P, _P, _P],
    # x, g, out, cnt, n_rows, d, senders, weights, row_range, dx, stream
    "packed_max_bwd": [_P, _P, _P, _P, _LL, _I, _P, _P, _P, _P, _P],
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


def _check_inputs(name: str, pack: PackedCSR, x: torch.Tensor) -> None:
    """What both kernels take: a 2-D f32 or bf16 CUDA x of num_nodes
    rows, and the pack's int32 / f32 arrays contiguous on x's device."""
    _check(name, x.is_cuda and x.dim() == 2, "x must be a 2-D CUDA tensor")
    _check(name, x.dtype in (torch.float32, torch.bfloat16),
           f"x dtype {x.dtype} not supported (float32, bfloat16)")
    n = x.shape[0]
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
    """Launch the Hopper kernel K1: f32 out [num_nodes, D] = A @ x, with
    x [num_nodes, D] f32 or bf16 on a CUDA device.  Adds one to
    ``packed_spmm_cuda.launches`` per launch, and to its D's entry of
    ``packed_spmm_cuda.launches_by_width`` (the kernel picks its walk by
    width)."""
    _check_inputs("packed_spmm_cuda", pack, x)
    x = x.contiguous()
    n, d = x.shape
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out
    _launch("packed_spmm", x, n, d, pack.senders.data_ptr(),
            pack.weights.data_ptr(), pack.row_range.data_ptr(),
            out.data_ptr())
    packed_spmm_cuda.launches += 1
    packed_spmm_cuda.launches_by_width[d] += 1
    return out


packed_spmm_cuda.launches = 0
packed_spmm_cuda.launches_by_width = collections.Counter()


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
    return out


packed_segment_matmul_headed_cuda.launches = 0
packed_segment_matmul_headed_cuda.launches_by_width = collections.Counter()


def packed_sddmm_cuda(pack: PackedCSR, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper SDDMM kernel: f32 out [NC, C, H], out[s, h] =
    <a[row(s), h, :], b[senders[s], h, :]> on the slots of nonzero pack
    weight, 0 on every other slot, with a and b [num_nodes, H, dh] f32
    or bf16 (one dtype) on a CUDA device.  Adds one to
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
    out = torch.empty(pack.senders.shape + (heads,), dtype=torch.float32,
                      device=a.device)
    if out.numel() == 0 or n == 0 or dh == 0:
        return out.zero_()
    _launch("packed_sddmm", a, b.data_ptr(), n, heads * dh, heads,
            pack.senders.data_ptr(), pack.weights.data_ptr(),
            pack.row_range.data_ptr(), pack.senders.numel(), out.data_ptr())
    packed_sddmm_cuda.launches += 1
    return out


packed_sddmm_cuda.launches = 0


def packed_segment_matmul_cuda(msg: torch.Tensor, local_rows: torch.Tensor,
                               tiles: torch.Tensor,
                               num_tiles: int) -> torch.Tensor:
    """Launch the Hopper kernel K2: f32 out [num_tiles*R, D],
    out[tiles[i]*R + local_rows[i, c]] += msg[i, c] over every slot, with
    msg [NC, C, D] f32 or bf16 and the pack's int32 local_rows [NC, C]
    and tiles [NC] on a CUDA device.  Adds one to
    ``packed_segment_matmul_cuda.launches`` per launch."""
    name = "packed_segment_matmul_cuda"
    _check(name, msg.is_cuda and msg.dim() == 3,
           "msg must be a 3-D CUDA tensor")
    _check(name, msg.dtype in (torch.float32, torch.bfloat16),
           f"msg dtype {msg.dtype} not supported (float32, bfloat16)")
    _check(name, tuple(local_rows.shape) == tuple(msg.shape[:2])
           and tuple(tiles.shape) == tuple(msg.shape[:1]),
           f"local_rows {tuple(local_rows.shape)} and tiles "
           f"{tuple(tiles.shape)} for msg {tuple(msg.shape)}")
    for field, a in (("local_rows", local_rows), ("tiles", tiles)):
        _check(name, a.device == msg.device and a.dtype == torch.int32,
               f"{field} must be an int32 tensor on {msg.device}")
    runs = segment_runs(local_rows, tiles, num_tiles)
    msg = msg.contiguous()
    d = msg.shape[-1]
    out = torch.empty(num_tiles * ROWS_PER_TILE, d, dtype=torch.float32,
                      device=msg.device)
    if out.numel() == 0:
        return out
    partial = torch.empty(runs.num_partials, d, dtype=torch.float32,
                          device=msg.device)
    _launch("packed_segment", msg, d, runs.run_out.numel(),
            runs.run_start.data_ptr(), runs.run_out.data_ptr(),
            runs.comb_rows.numel(), runs.comb_rows.data_ptr(),
            runs.comb_ptr.data_ptr(), partial.data_ptr(), out.data_ptr())
    packed_segment_matmul_cuda.launches += 1
    return out


packed_segment_matmul_cuda.launches = 0


def packed_max_cuda(pack: PackedCSR, x: torch.Tensor):
    """Launch the Hopper segmented max (csrc/packed_max.cu, forward): f32
    (out, cnt) [num_nodes, D] as ``packed_max_plain``, x [num_nodes, D]
    f32 or bf16 on a CUDA device.  Adds one to
    ``packed_max_cuda.launches`` per launch."""
    _check_inputs("packed_max_cuda", pack, x)
    x = x.contiguous()
    n, d = x.shape
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    cnt = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return out, cnt
    _launch("packed_max", x, n, d, pack.senders.data_ptr(),
            pack.weights.data_ptr(), pack.row_range.data_ptr(),
            out.data_ptr(), cnt.data_ptr())
    packed_max_cuda.launches += 1
    return out, cnt


packed_max_cuda.launches = 0


def packed_max_bwd_cuda(bwd_pack: PackedCSR, x: torch.Tensor,
                        g: torch.Tensor, out: torch.Tensor,
                        cnt: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper segmented max's backward (csrc/packed_max.cu) on
    the transpose pack: f32 dx [num_nodes, D] as
    ``packed_max_bwd_plain``, from x (f32 or bf16) and the f32 g, out
    and cnt [num_nodes, D] on a CUDA device.  Adds one to
    ``packed_max_bwd_cuda.launches`` per launch."""
    name = "packed_max_bwd_cuda"
    _check_inputs(name, bwd_pack, x)
    for field, a in (("g", g), ("out", out), ("cnt", cnt)):
        _check(name, a.shape == x.shape and a.dtype == torch.float32
               and a.device == x.device,
               f"{field} must be a float32 {tuple(x.shape)} tensor on "
               f"{x.device}")
    x, g, out, cnt = (a.contiguous() for a in (x, g, out, cnt))
    n, d = x.shape
    dx = torch.empty(n, d, dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return dx
    _launch("packed_max", x, g.data_ptr(), out.data_ptr(), cnt.data_ptr(),
            n, d, bwd_pack.senders.data_ptr(), bwd_pack.weights.data_ptr(),
            bwd_pack.row_range.data_ptr(), dx.data_ptr(),
            entry="packed_max_bwd")
    packed_max_bwd_cuda.launches += 1
    return dx


packed_max_bwd_cuda.launches = 0

# every kernel wrapper; each counts its launches, K1 and K3 also by width
KERNELS = (packed_spmm_cuda, packed_segment_matmul_cuda,
           packed_segment_matmul_headed_cuda, packed_sddmm_cuda,
           packed_max_cuda, packed_max_bwd_cuda)
LaunchCounts = Dict[str, Tuple[int, collections.Counter]]


def launch_counts() -> LaunchCounts:
    """A snapshot of every wrapper's launches and launches by width."""
    return {k.__name__: (k.launches, collections.Counter(
        getattr(k, "launches_by_width", {}))) for k in KERNELS}


def set_launch_counts(counts: LaunchCounts) -> None:
    for k in KERNELS:
        k.launches, by_width = counts[k.__name__]
        if hasattr(k, "launches_by_width"):
            k.launches_by_width.clear()
            k.launches_by_width.update(by_width)


def add_launch_counts(delta: LaunchCounts) -> None:
    """Add ``delta`` (launches_between's) to the counters: a replayed
    CUDA graph launches again the kernels counted at its capture."""
    for k in KERNELS:
        n, by_width = delta[k.__name__]
        k.launches += n
        if hasattr(k, "launches_by_width"):
            k.launches_by_width.update(by_width)


def launches_between(before: LaunchCounts,
                     after: LaunchCounts) -> LaunchCounts:
    return {name: (after[name][0] - n, after[name][1] - by_width)
            for name, (n, by_width) in before.items()}


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def spmm_packed(pack: PackedCSR, x: torch.Tensor) -> torch.Tensor:
    """Forward SpMM from a packed layout (spmm_kernel.py:441-459):
    the kernel for a CUDA tensor, the plain version for a CPU one."""
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


class SpmmPackFn(torch.autograd.Function):
    """Differentiable SpMM over batch-carried packs (the port of
    ``spmm_pack_vjp``, spmm_kernel.py:681-710): out = A x on the fwd
    pack, dx = A^T g on the bwd pack.  The packs get no gradient."""

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
    """Segmented max from a packed layout, f32 (out, cnt): the kernel for
    a CUDA tensor, the plain version for a CPU one."""
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
    tie counts, no scatter, no atomics.  The packs get no gradient."""

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
    out [num_nodes, H*dv]."""
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
        x = torch.where(valid, logits.float(), -1e30)
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
        g = g.float()
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
