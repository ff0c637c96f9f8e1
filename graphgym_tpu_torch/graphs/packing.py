"""Host-side pack construction for the packed SpMM path.

The port of graphgym_tpu/graphs/packing.py.  Per collated GraphBatch it
precomputes the normalized edge weights (pure functions of the static
graph structure) and the packed chunk layouts of A and A^T:

  'gcn'   — D^-1/2 (A + I) D^-1/2 with the reference's inf guard
            (TfgIDLayer.py:528-566); self-loops only on real nodes.
  'plain' — raw A (GIN sum aggregation).
  'mean'  — D^-1 A (SAGE mean aggregation; GeneralConv's agg 'mean'),
            the degree counting edges of nonzero weight.
  'gcn_mean' — the 'gcn' weights over each receiver's count of slots of
            nonzero weight, its real in-edges and its self-loop
            (GeneralConv's agg 'mean' with normalize_adj: segment_mean
            over the mask concat(edge_mask, node_mask),
            graphgym_tpu/nn/layers.py:631-641).
  'att'   — A + self-loops on real nodes, weights a validity indicator
            (1 real, 0 padding); the attention coefficients are computed
            in the layer (packing.py:71-79 of the JAX package).

The bwd layout packs the transpose with the same weights, giving
dx = A^T g.  The 'att' entry carries a third array, the slot map: for
each bwd slot the fwd slot of the same edge, so the backward carries
the per-slot coefficients into bwd order.

A graph task adds the pooling pack of its head (``pool_kind``): the
graph head's global add / mean / max pooling (graphgym_tpu/nn/heads.py:
23-46, XLA segment reductions in the JAX package) as a rectangular
pack, rows the graph slots and senders the nodes (the ego centers
under the ego transform), weights the node mask (over each graph's
count for mean).  Its bwd pack maps the graph slots back to the node
rows, one slot a node.  A graph's nodes, and under ego its centers,
are contiguous in a batch, so a row's slots are one graph's.

The heads' gathers of node rows at an index with repeats run on gather
packs (``build_gather_packs``): 'pairs', the edge head's rows of both
nodes of each supervised pair, and 'labels', the node head's supervised
nodes where a node is supervised more than once (the edge task's
path-length pairs are drawn with replacement).  The fwd pack has a row
per index entry holding one slot, its node, weight 1 (0 on padding
entries: an empty row); the bwd pack a row per node holding the entries
that read it, in index order.  So the gather's gradient sums a node's
entries on K1 in a fixed order: the gradient of ``index_select`` is
an ``index_add_`` whose float atomics sum a repeated node's entries in
no fixed order.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from graphgym_tpu_torch import native
from graphgym_tpu_torch.graphs.container import bucket_size
from graphgym_tpu_torch.ops.cuda.spmm_kernel import PackedCSR, pad_pack

Chunks = Dict[str, Tuple[int, int]]


def _gcn_weights(senders: np.ndarray, receivers: np.ndarray,
                 edge_weight: np.ndarray, node_mask: np.ndarray,
                 num_nodes: int):
    """Append weight-1 self loops on real nodes and sym-normalize."""
    loop = np.arange(num_nodes, dtype=senders.dtype)
    s = np.concatenate([senders, loop])
    r = np.concatenate([receivers, loop])
    w = np.concatenate([edge_weight,
                        node_mask.astype(np.float32)])
    deg = np.bincount(r, weights=w, minlength=num_nodes)
    with np.errstate(divide="ignore"):
        dis = deg ** -0.5
    dis[~np.isfinite(dis)] = 0
    return s, r, (dis[r] * w * dis[s]).astype(np.float32)


def _mean_weights(senders: np.ndarray, receivers: np.ndarray,
                  edge_weight: np.ndarray, num_nodes: int):
    """Each edge's weight over its receiver's count of nonzero-weight
    in-edges (0 where the count is 0)."""
    deg = np.bincount(receivers, weights=(edge_weight != 0).astype(
        np.float64), minlength=num_nodes)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    return senders, receivers, (edge_weight * inv[receivers]).astype(
        np.float32)


def _gcn_mean_weights(senders: np.ndarray, receivers: np.ndarray,
                      edge_weight: np.ndarray, node_mask: np.ndarray,
                      num_nodes: int):
    """The 'gcn' edges and weights, each weight over its receiver's count
    of nonzero-weight slots (real in-edges plus the real node's
    self-loop; padding nodes have none and keep weight 0)."""
    s, r, w = _gcn_weights(senders, receivers, edge_weight, node_mask,
                           num_nodes)
    count = np.bincount(r, weights=(w != 0).astype(np.float64),
                        minlength=num_nodes)
    return s, r, (w / np.maximum(count, 1)[r]).astype(np.float32)


def _att_edges(senders: np.ndarray, receivers: np.ndarray,
               edge_weight: np.ndarray, node_mask: np.ndarray,
               num_nodes: int):
    """A plus self-loops on real nodes, weight 1 real / 0 padding."""
    loop = np.arange(num_nodes, dtype=senders.dtype)
    s = np.concatenate([senders, loop])
    r = np.concatenate([receivers, loop])
    w = np.concatenate([(edge_weight != 0).astype(np.float32),
                        node_mask.astype(np.float32)])
    return s, r, w


def build_packs(senders: np.ndarray, receivers: np.ndarray,
                edge_weight: np.ndarray, node_mask: np.ndarray,
                num_nodes: int, kinds: Sequence[str] = ("gcn",),
                chunks: Optional[Chunks] = None) -> Dict[str, tuple]:
    """kind -> (fwd, bwd) packs, and for 'att' also the slot map
    [NC_bwd, C] int32.  num_nodes here is the PADDED node count (packs
    target padded rows; the padding row receives only weight-0
    contributions).  Each pack's chunk count is bucketed and at least
    ``chunks[kind]``'s (``_pack``)."""
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    edge_weight = np.asarray(edge_weight, np.float32)
    node_mask = np.asarray(node_mask, bool)
    out = {}
    for kind in kinds:
        if kind == "gcn":
            s, r, w = _gcn_weights(senders, receivers, edge_weight,
                                   node_mask, num_nodes)
        elif kind == "plain":
            s, r, w = senders, receivers, edge_weight
        elif kind == "mean":
            s, r, w = _mean_weights(senders, receivers, edge_weight,
                                    num_nodes)
        elif kind == "gcn_mean":
            s, r, w = _gcn_mean_weights(senders, receivers, edge_weight,
                                        node_mask, num_nodes)
        elif kind == "att":
            s, r, w = _att_edges(senders, receivers, edge_weight,
                                 node_mask, num_nodes)
        else:
            raise ValueError(f"unknown pack kind {kind!r}")
        (fwd, fwd_slot), (bwd, bwd_slot) = _pack_pair(
            s, r, w, num_nodes, num_nodes, (chunks or {}).get(kind, (0, 0)),
            slots=kind == "att")
        out[kind] = (fwd, bwd)
        if kind == "att":
            out[kind] += (_slot_map(fwd, bwd, fwd_slot, bwd_slot),)
    return out


def pack_chunks(packs: Dict[str, tuple]) -> Dict[str, Tuple[int, int]]:
    """kind -> (fwd chunks, bwd chunks) of a batch's packs."""
    return {kind: (entry[0].senders.shape[0], entry[1].senders.shape[0])
            for kind, entry in packs.items()}


def pad_packs(packs: Dict[str, tuple], chunks: Dict[str, Tuple[int, int]]
              ) -> Dict[str, tuple]:
    """``packs`` with each kind's fwd and bwd pack padded with no-op
    chunks (``pad_pack``) to ``chunks[kind]``, each pack's rows its
    row_range's and its padding sender the other pack's row count (the
    node count, or a pooling pack's graph slots); the 'att' slot map
    grows with the bwd pack, and its padding slots point one past the
    padded fwd slots."""
    out = {}
    for kind, entry in packs.items():
        fwd_rows, bwd_rows = (p.row_range.shape[0] for p in entry[:2])
        fwd = pad_pack(entry[0], chunks[kind][0], fwd_rows, bwd_rows)
        bwd = pad_pack(entry[1], chunks[kind][1], bwd_rows, fwd_rows)
        out[kind] = (fwd, bwd)
        if kind == "att":
            past = fwd.senders.size
            slot_map = np.full(bwd.senders.shape, past, np.int32)
            old = entry[2]
            slot_map[:old.shape[0]] = np.where(
                old == entry[0].senders.size, past, old)
            out[kind] += (slot_map,)
    return out


def _slot_map(fwd: PackedCSR, bwd: PackedCSR, fwd_slot: np.ndarray,
              bwd_slot: np.ndarray) -> np.ndarray:
    """For each bwd slot, the fwd slot of the same edge.  Bwd padding
    slots point one past the last fwd slot, where the backward appends
    a zero coefficient."""
    return native.scatter(bwd.senders.size, fwd.senders.size, bwd_slot,
                          fwd_slot).reshape(bwd.senders.shape)


def _pack(senders: np.ndarray, receivers: np.ndarray, w: np.ndarray,
          num_rows: int, num_senders: int, least: int = 0,
          slots: bool = False) -> Tuple[PackedCSR, Optional[np.ndarray]]:
    """A pack of ``num_rows`` rows reading ``num_senders`` rows, built
    natively (graphgym_tpu_torch/native), and the slot of each edge where
    ``slots``.  Its chunk count is bucketed, so the batches of a
    multi-batch loader land on few shapes, and at least ``least``: the
    loader's running count for the pack (``GraphLoader._chunks``), so a
    batch is built at the shape the loader shares and is not copied
    into it later."""
    return native.pack_csr_with_slots(
        senders, receivers, w, num_rows, num_senders=num_senders,
        pad_chunks_to=lambda nc: max(bucket_size(nc), least), slots=slots)


_POOLS: Dict[str, ThreadPoolExecutor] = {}
_POOLS_LOCK = threading.Lock()
HOST_THREADS = 4    # threads a pool: an epoch of ba at batch 48 is 2


def host_pool(name: str) -> ThreadPoolExecutor:
    """The process's pool of host threads called ``name`` (made at
    first use).  The loader collates an epoch's batches on one and
    builds each transpose pack on another; the native packer and most
    numpy work release the GIL, so they run side by side.  Nothing the
    threads compute depends on their timing."""
    with _POOLS_LOCK:
        if name not in _POOLS:
            _POOLS[name] = ThreadPoolExecutor(
                HOST_THREADS, thread_name_prefix=f"graphgym-{name}")
        return _POOLS[name]


def _pack_pair(senders: np.ndarray, receivers: np.ndarray, w: np.ndarray,
               num_rows: int, num_senders: int,
               least: Tuple[int, int] = (0, 0), slots: bool = False):
    """((fwd, slots), (bwd, slots)): ``_pack`` of A (``num_rows`` rows
    reading ``num_senders``) and of its transpose, the transpose built
    on a ``host_pool`` thread while this one builds A."""
    bwd = host_pool("pack").submit(_pack, receivers, senders, w,
                                   num_senders, num_rows, least[1], slots)
    fwd = _pack(senders, receivers, w, num_rows, num_senders, least[0],
                slots)
    return fwd, bwd.result()


POOLINGS = ("add", "mean", "max")


def pool_kind(pooling: str, ego: bool = False) -> str:
    """The pack kind of a graph head's pooling: 'pool_add', 'pool_mean'
    or 'pool_max', with '_ego' where it pools the ego centers."""
    if pooling not in POOLINGS:
        raise ValueError(f"Unknown pooling {pooling}")
    return f"pool_{pooling}" + ("_ego" if ego else "")


def build_pool_packs(graph_ids: np.ndarray, node_mask: np.ndarray,
                     num_graphs: int, pooling: str,
                     id_index: Optional[np.ndarray] = None,
                     id_mask: Optional[np.ndarray] = None,
                     chunks: Optional[Chunks] = None) -> Dict[str, tuple]:
    """{pool_kind: (fwd, bwd)}: the pooling of ``global_pool``
    (graphgym_tpu/nn/heads.py:23-46) as packs.  The fwd pack has a row
    per graph slot and reads the node rows: a slot per node, or per
    entry of ``id_index`` (the ego centers) under the ego transform,
    weighted by ``node_mask`` (``id_mask``), so padding nodes and
    padding centers have weight 0; for 'mean' each weight is over its
    graph's count of real slots (segment_mean's division, taken on the
    host as the 'gcn_mean' pack takes it).  The padding graph slot's row
    holds only weight-0 slots: an empty row, 0 in the sum and in the
    max.  The bwd pack has a row per node and reads the graph slots.
    graph_ids and node_mask are the padded batch's (num_nodes long);
    ``chunks`` as ``build_packs``'."""
    graph_ids = np.asarray(graph_ids, np.int32)
    num_nodes = len(graph_ids)
    if id_index is None:
        senders, mask = np.arange(num_nodes, dtype=np.int32), node_mask
    else:
        senders, mask = np.asarray(id_index, np.int32), id_mask
    w = np.asarray(mask, np.float32)
    receivers = graph_ids[senders]
    if pooling == "mean":
        count = np.bincount(receivers, weights=w, minlength=num_graphs)
        w = (w / np.maximum(count, 1)[receivers]).astype(np.float32)
    kind = pool_kind(pooling, id_index is not None)
    (fwd, _), (bwd, _) = _pack_pair(senders, receivers, w, num_graphs,
                                    num_nodes, (chunks or {}).get(kind,
                                                                  (0, 0)))
    return {kind: (fwd, bwd)}


def agg_kind(agg: str, normalize_adj: bool) -> str:
    """The pack of GeneralConv's / GeneralIDConv's aggregation: 'add' and
    'max' take A ('plain') or D^-1/2 (A + I) D^-1/2 ('gcn'), 'mean' the
    same weights over each receiver's count of real slots ('mean',
    'gcn_mean'); 'max' takes the max of its weighted messages."""
    if agg not in ("add", "mean", "max"):
        raise ValueError(f"Unknown agg: {agg}")
    if agg == "mean":
        return "gcn_mean" if normalize_adj else "mean"
    return "gcn" if normalize_adj else "plain"


def kinds_for_layer(layer_type: str, agg: str = "add",
                    normalize_adj: bool = False) -> Tuple[str, ...]:
    """Which precomputed packs a layer type consumes (``agg`` and
    ``normalize_adj``: cfg.gnn's, read by generalconv and idconv)."""
    lt = layer_type.replace("Tfg-", "")
    if lt in ("generalconv", "idconv"):
        return (agg_kind(agg, normalize_adj),)
    if lt in ("gcnconv", "gcnidconv", "idgcn"):
        return ("gcn",)
    if lt in ("ginconv", "ginidconv", "idgin", "exampleconv1",
              "exampleconv2", "contrib_example"):
        return ("plain",)
    if lt in ("sageconv", "idsage", "sageidconv", "sageinitconv"):
        return ("mean",)
    if lt in ("gatconv", "idgat", "gatidconv", "gaddconv", "gmulconv"):
        return ("att",)
    return ()


PAIRS, LABELS = "pairs", "labels"


def build_gather_packs(index: np.ndarray, mask: np.ndarray,
                       num_nodes: int, least: Tuple[int, int] = (0, 0)
                       ) -> tuple:
    """(fwd, bwd): the gather x[index] of ``num_nodes`` node rows as a
    rectangular pack pair (module docstring).  The fwd pack has
    len(index) rows, each the one slot of its entry, weight ``mask``;
    the bwd pack has num_nodes rows, a node's slots the entries that
    read it, in index order, with the same weights.  ``least``: the
    chunk counts to pad to at least (``_pack``)."""
    index = np.asarray(index, np.int32)
    rows = np.arange(len(index), dtype=np.int32)
    w = np.asarray(mask, np.float32)
    (fwd, _), (bwd, _) = _pack_pair(index, rows, w, len(index), num_nodes,
                                    least)
    return fwd, bwd
