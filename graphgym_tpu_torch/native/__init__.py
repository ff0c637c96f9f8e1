"""The loader's host pack builder: ``graph_native.cpp`` through ctypes.

The port's own copy of the chunk packer of graphgym_tpu/native (the JAX
package's build is never loaded).  ``g++ -O3`` compiles the source at
first use into ``csrc/build/``, beside the kernels, under a name that
carries the hash of the source and the flags; each process compiles to
a file of its own and renames it into place, so processes that build at
once all end with the same library.  A failed build raises with the
compiler's message: the loader has no other packer.  The numpy
``pack_csr_with_slots`` (ops/cuda/spmm_kernel.py) is the plain version
the tests hold this one to, array for array.

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
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

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
