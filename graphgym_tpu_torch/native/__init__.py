"""The loader's host pack builder and the data pipeline's graph
statistics and ego-net union: ``graph_native.cpp`` through ctypes.

The port's own copy of the chunk packer of graphgym_tpu/native (the JAX
package's build is never loaded), and of its BFS and triangle count
(``bfs_distances``, ``triangle_counts``: integers only, which
data/structure.py turns into path lengths and clustering coefficients
in the numpy plain versions' float order), its ego-net union
(``ego_union``, data/transforms.py's numpy ``ego_nets_plain`` array
for array) and Brandes' betweenness (``betweenness``, the sums of
data/structure.py's Python loop in its order, on threads).  ``g++ -O3`` compiles the
source at first use into ``csrc/build/``, beside the kernels, under a
name that
carries the hash of the source and the flags; each process compiles to
a file of its own and renames it into place, so processes that build at
once all end with the same library.  A failed build raises with the
compiler's message: the loader has no other packer and the pipeline
no other BFS or union.  The numpy ``pack_csr_with_slots``
(ops/cuda/spmm_kernel.py), data/structure.py's
``bfs_from_sources_plain``, ``triangle_counts_plain`` and
``betweenness_centrality_plain`` and data/transforms.py's
``ego_nets_plain`` are the plain versions the tests hold these to.

ctypes releases the GIL during a call, so a pack built on the trainer's
prefetch thread leaves the main thread free.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, Optional, Tuple, Union

import numpy as np

from graphgym_tpu_torch.ops.cuda.spmm_kernel import (BUILD_DIR,
                                                     EDGES_PER_CHUNK,
                                                     ROWS_PER_TILE,
                                                     PackedCSR)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "graph_native.cpp")
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-ffp-contract=off"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """The shared library of ``source`` in ``build_dir``, compiled with
    g++ unless a library of this source and these flags is there;
    raises RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"{CXX} not found: the loader's pack builder "
                           f"compiles {source} at first use") from exc
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{CXX} failed on {source} ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The built library with its entry points bound (built once per
    process; the prefetch thread and the main thread share it)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i64, ptr = ctypes.c_int64, ctypes.c_void_p
            lib.pack_count.argtypes = [i64, i64, ptr, i64, i64, i64]
            lib.pack_count.restype = i64
            lib.pack_fill.argtypes = [i64, i64, i64, ptr, ptr, ptr, i64,
                                      i64, i64, i64, ptr, ptr, ptr, ptr,
                                      ptr, ptr]
            lib.pack_fill.restype = ctypes.c_int
            lib.scatter_i32.argtypes = [i64, ctypes.c_int32, i64, ptr,
                                        ptr, ptr]
            lib.scatter_i32.restype = ctypes.c_int
            lib.multi_bfs.argtypes = [i64, ptr, ptr, i64, ptr, i64, ptr]
            lib.multi_bfs.restype = ctypes.c_int
            lib.triangle_counts.argtypes = [i64, ptr, ptr, ptr]
            lib.triangle_counts.restype = ctypes.c_int
            lib.ego_sizes.argtypes = [i64, i64, ptr, ptr, i64, ptr, ptr]
            lib.ego_sizes.restype = ctypes.c_int
            lib.ego_fill.argtypes = [i64, i64, ptr, ptr, i64, ptr, ptr,
                                     ptr]
            lib.ego_fill.restype = ctypes.c_int
            lib.betweenness.argtypes = [i64, ptr, ptr, i64, ptr]
            lib.betweenness.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data


def _int32(a: np.ndarray, what: str) -> np.ndarray:
    """``a`` as a contiguous int32 array (node and slot indices of a
    batch stay below 2^31); raises where a value would not fit."""
    a = np.asarray(a)
    if a.dtype != np.int32 and a.size and (a.min() < -2 ** 31
                                           or a.max() >= 2 ** 31):
        raise ValueError(f"{what} outside int32")
    return np.ascontiguousarray(a, np.int32)


def pack_csr_with_slots(
        senders: np.ndarray, receivers: np.ndarray,
        weights: Optional[np.ndarray], num_nodes: int, group: int = 1,
        num_senders: Optional[int] = None,
        pad_chunks_to: Union[None, int, Callable[[int], int]] = None,
        slots: bool = True) -> Tuple[PackedCSR, Optional[np.ndarray]]:
    """The numpy ``pack_csr_with_slots`` followed by ``pad_pack`` in one
    native pass: a pack of ``num_nodes`` rows reading ``num_senders``
    rows (default as many), its row spans padded to multiples of
    ``group``, and the flat slot of each edge, int32 (None unless
    ``slots``).  ``pad_chunks_to`` is the chunk count to pad to, or a
    function of the pack's own count giving it; a count below the
    pack's pads nothing."""
    R, C, G = ROWS_PER_TILE, EDGES_PER_CHUNK, group
    if G < 1 or C % G:
        raise ValueError(f"group {G} must divide the chunk of {C} slots")
    senders = _int32(senders, "a sender")
    receivers = _int32(receivers, "a receiver")
    e = len(senders)
    weights = (np.ones(e, np.float32) if weights is None
               else np.ascontiguousarray(weights, np.float32))
    if len(receivers) != e or len(weights) != e:
        raise ValueError(f"{e} senders, {len(receivers)} receivers, "
                         f"{len(weights)} weights")
    lib = library()
    nc = int(lib.pack_count(num_nodes, e, _ptr(receivers), R, C, G))
    if nc < 0:
        raise ValueError(f"a receiver outside [0, {num_nodes})")
    want = pad_chunks_to(nc) if callable(pad_chunks_to) else pad_chunks_to
    nc_out = max(nc, want or 0)
    if nc_out * C >= 2 ** 31:
        raise ValueError(f"{nc_out} chunks overflow int32 slot indices")
    out_s = np.empty((nc_out, C), np.int32)
    out_w = np.empty((nc_out, C), np.float32)
    out_l = np.empty((nc_out, C), np.int32)
    out_t = np.empty(nc_out, np.int32)
    row_range = np.empty((num_nodes, 2), np.int32)
    edge_slot = np.empty(e, np.int32) if slots else None
    err = lib.pack_fill(
        num_nodes, num_nodes if num_senders is None else num_senders, e,
        _ptr(senders), _ptr(receivers), _ptr(weights), R, C, G, nc_out,
        _ptr(out_s), _ptr(out_w), _ptr(out_l), _ptr(out_t), _ptr(row_range),
        _ptr(edge_slot))
    if err:
        raise ValueError(f"pack_fill refused its inputs (code {err}: "
                         "1 a negative sender, 2 a receiver out of range, "
                         "3 too few chunks)")
    return PackedCSR(out_s, out_w, out_l, out_t, row_range), edge_slot


def scatter(size: int, fill: int, index: np.ndarray,
            values: np.ndarray) -> np.ndarray:
    """An int32 array of ``size`` entries, ``fill`` but at ``index``,
    which holds ``values`` (the attention packs' slot map: at each bwd
    slot of an edge its fwd slot)."""
    index, values = _int32(index, "an index"), _int32(values, "a value")
    if len(index) != len(values):
        raise ValueError(f"{len(index)} indices, {len(values)} values")
    out = np.empty(size, np.int32)
    if library().scatter_i32(size, fill, len(index), _ptr(index),
                             _ptr(values), _ptr(out)):
        raise ValueError(f"an index outside [0, {size})")
    return out


def _csr(indptr: np.ndarray, indices: np.ndarray):
    """A CSR's int64 indptr and int32 indices, contiguous, and its row
    count; raises where they do not fit each other."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = _int32(indices, "a neighbour")
    if indptr.ndim != 1 or len(indptr) < 1 or indptr[0] != 0 \
            or indptr[-1] != len(indices) or np.any(np.diff(indptr) < 0):
        raise ValueError(f"indptr of {len(indptr)} entries does not span "
                         f"{len(indices)} neighbours")
    return indptr, indices, len(indptr) - 1


def bfs_distances(indptr: np.ndarray, indices: np.ndarray,
                  sources: np.ndarray, max_dist: int = -1) -> np.ndarray:
    """Hop distances [S, N] int32 from each source over the CSR (row u:
    u's out-neighbours), -1 where unreached; nodes beyond ``max_dist``
    hops stay -1 (no cap where it is negative)."""
    indptr, indices, n = _csr(indptr, indices)
    sources = np.ascontiguousarray(sources, np.int64).reshape(-1)
    out = np.empty((len(sources), n), np.int32)
    err = library().multi_bfs(n, _ptr(indptr), _ptr(indices), len(sources),
                              _ptr(sources), int(max_dist), _ptr(out))
    if err:
        raise ValueError(f"multi_bfs refused its inputs (code {err}: 1 a "
                         f"source, 2 a neighbour outside [0, {n}))")
    return out


def triangle_counts(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per node j, int64: the closed wedges i - j - k counted from both
    ends (twice the triangles through j on a simple graph; repeated
    edges and self loops counted as data/structure.py's plain version
    counts them)."""
    indptr, indices, n = _csr(indptr, indices)
    tri = np.empty(n, np.int64)
    if library().triangle_counts(n, _ptr(indptr), _ptr(indices), _ptr(tri)):
        raise ValueError(f"a neighbour outside [0, {n})")
    return tri


def ego_union(senders: np.ndarray, receivers: np.ndarray, n: int,
              radius: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The disjoint union of every node's ``radius``-hop ego net over
    the out-edges (reference transform.py:11-39), as the numpy
    ``ego_nets_plain`` lays it out: (union senders, union receivers,
    int32; the original node of each union node, int64).  Center c
    keeps id c; ego c's other members follow ego c-1's, in ascending
    original id; ego c's edges are the input edges with both ends in
    it, in input order.  Sized in one native pass, filled in a second."""
    senders, receivers = _int32(senders, "a sender"), _int32(receivers,
                                                             "a receiver")
    e = len(senders)
    if len(receivers) != e:
        raise ValueError(f"{e} senders, {len(receivers)} receivers")
    lib = library()
    node_counts = np.empty(n, np.int64)
    edge_counts = np.empty(n, np.int64)
    if lib.ego_sizes(n, e, _ptr(senders), _ptr(receivers), int(radius),
                     _ptr(node_counts), _ptr(edge_counts)):
        raise ValueError(f"an edge endpoint outside [0, {n})")
    # each center counts itself: the union has sum(node_counts) nodes
    total_nodes, total_edges = int(node_counts.sum()), int(edge_counts.sum())
    if max(total_nodes, total_edges) >= 2 ** 31:
        raise ValueError("the ego-net union overflows int32 node or edge "
                         "indices")
    us = np.empty(total_edges, np.int32)
    ur = np.empty(total_edges, np.int32)
    orig_of = np.empty(total_nodes, np.int64)
    lib.ego_fill(n, e, _ptr(senders), _ptr(receivers), int(radius),
                 _ptr(us), _ptr(ur), _ptr(orig_of))
    return us, ur, orig_of


def betweenness(indptr: np.ndarray, indices: np.ndarray,
                threads: Optional[int] = None) -> np.ndarray:
    """Per node, float64: the sum over sources s of s's dependency on it
    (Brandes, unweighted, over the CSR's out-edges; unnormalized, each
    unordered pair of an undirected graph counted twice), the sums of
    data/structure.py's Python loop to the bit, on ``threads`` threads
    (default the CPUs, at most 8) with the same result at any count."""
    indptr, indices, n = _csr(indptr, indices)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    bc = np.empty(n, np.float64)
    if library().betweenness(n, _ptr(indptr), _ptr(indices), int(threads),
                             _ptr(bc)):
        raise ValueError(f"a neighbour outside [0, {n})")
    return bc
