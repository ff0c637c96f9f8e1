"""Host-side pack construction for the packed SpMM path.

The port of graphgym_tpu/graphs/packing.py.  Per collated GraphBatch it
precomputes the normalized edge weights (pure functions of the static
graph structure) and the packed chunk layouts of A and A^T:

  'gcn'   — D^-1/2 (A + I) D^-1/2 with the reference's inf guard
            (TfgIDLayer.py:528-566); self-loops only on real nodes.
  'gcn_improved' — the same with self-loops of weight 2 (GCNConv's
            ``improved``, graphgym_tpu/ops/sparse.py:110).
  'gcn_noself' — D^-1/2 A D^-1/2, no self-loops, the degree the
            weighted in-degree (``gcn_norm(add_self_loops=False)``:
            GINConv's gin_agg 'gcn_noself').
  'plain' — raw A (GIN sum aggregation).
  'mean'  — D^-1 A (SAGE mean aggregation; GeneralConv's agg 'mean'),
            the degree counting edges of nonzero weight.
  'wmean' — each weight over max(its receiver's weighted in-degree, 1)
            (GINConv's gin_agg 'mean', graphgym_tpu/nn/layers.py:
            537-540); 'mean' where every weight is 0 or 1.
  'gcn_mean' — the 'gcn' weights over each receiver's count of slots of
            nonzero weight, its real in-edges and its self-loop
            (GeneralConv's agg 'mean' with normalize_adj: segment_mean
            over the mask concat(edge_mask, node_mask),
            graphgym_tpu/nn/layers.py:631-641).
  'att'   — A + self-loops on real nodes, weights a validity indicator
            (1 real, 0 padding); the attention coefficients are computed
            in the layer (packing.py:71-79 of the JAX package).
  'dir'   — generalconv_v2's directed norm: each weight over its
            receiver's weighted in-degree, no self-loops
            (graphgym_tpu/nn/att_layers.py:205-208).
  'dir_mean' — the 'dir' weights over each receiver's count of
            nonzero-weight in-edges (generalconv_v2's agg 'mean' with
            normalize_adj: segment_mean of the normed messages).
  'rev_<kind>' — <kind> of the reversed edges (generalconv_v2's flow
            'target_to_source': senders and receivers swapped before
            the weights), so its fwd pack is <kind>'s transpose.

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

A model with a node or edge encoder adds the embedding pack of its
table lookup (``build_embed_pack``, kinds 'node_encoder' and
'edge_encoder'): the stacked tables' row of each item's id columns for
the forward gather, and for the tables' gradient the (item, column)
slots sorted by row as K2's index (``segment_index_host``, each slot's
item its source), so the gradient of the lookup is a segmented sum in a
fixed order that reads the output gradient in place (the gradient of
``index_select`` is an ``index_add_``, float atomics).

The edge-feature convs (``EDGE_CONVS``) sum, soften or take the max of a
message per edge over its receiver (graphgym_tpu/nn/layers.py:655-730,
att_layers.py:118-183 and :253-312, XLA segment reductions there), on
the 'edge' pack: the raw edges, no self-loops, each weight the edge's
validity (1 real, 0 padding), beside ``EdgeSlots``, the batch edge of
each of its slots and K2's host-built index of the batch edges by
receiver, so the sum runs on K2 over the per-edge messages in place in
a captured step.  Their per-edge gathers of node rows
x[senders] and x[receivers] run on the gather packs 'edge_src' and
'edge_dst' (``build_gather_packs`` of the senders and receivers); the
segmented max reads the messages through the 'edge' pack's layout with
the slots' edges as senders, and its backward the 'edge_dst' fwd pack.
generalogbconv's bond tables' lookup reads the embedding pack
'edge_bond' of the edge features (``build_embed_pack``).

On the COO route (cfg.tpu.spmm_impl 'xla', nn/coo.py) the MP layers
take no pack: the batch carries instead, for each edge list they read,
the entry ``build_coo_edges`` makes, 'coo' (the batch's E edges) or
'coo_loops' (E + N, a self-loop on every node slot): its senders and
receivers and K2's indexes of the positions by receiver (the sum) and
by sender (the gather's gradient), shapes of E and N alone
(``coo_kinds`` names them for a config; GeneralConv's max adds the
'edge' pack and 'edge_dst', the edge convs' max).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from graphgym_tpu_torch import native
from graphgym_tpu_torch.graphs.container import bucket_size
from graphgym_tpu_torch.ops.cuda.spmm_kernel import (PackedCSR, SegmentIndex,
                                                     pad_pack,
                                                     segment_index_host)

Chunks = Dict[str, Tuple[int, int]]
FLOWS = ("source_to_target", "target_to_source")   # cfg.gnn.flow
REV = "rev_"        # the prefix of a kind of the reversed edges


def _gcn_weights(senders: np.ndarray, receivers: np.ndarray,
                 edge_weight: np.ndarray, node_mask: np.ndarray,
                 num_nodes: int, fill: Optional[float] = 1.0):
    """Append self loops of weight ``fill`` on real nodes (none where
    ``fill`` is None) and sym-normalize by the weighted in-degree."""
    s, r, w = senders, receivers, edge_weight
    if fill is not None:
        loop = np.arange(num_nodes, dtype=senders.dtype)
        s = np.concatenate([senders, loop])
        r = np.concatenate([receivers, loop])
        w = np.concatenate([edge_weight,
                            np.where(node_mask, fill, 0).astype(np.float32)])
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


def _wmean_weights(senders: np.ndarray, receivers: np.ndarray,
                   edge_weight: np.ndarray, num_nodes: int):
    """Each edge's weight over max(its receiver's weighted in-degree,
    1)."""
    deg = np.bincount(receivers, weights=edge_weight, minlength=num_nodes)
    return senders, receivers, (edge_weight / np.maximum(deg, 1.0)[
        receivers]).astype(np.float32)


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


def _dir_weights(senders: np.ndarray, receivers: np.ndarray,
                 edge_weight: np.ndarray, num_nodes: int):
    """Each edge's weight over its receiver's weighted in-degree (0
    where the degree is 0)."""
    deg = np.bincount(receivers, weights=edge_weight, minlength=num_nodes)
    inv = np.where(deg > 0, 1.0 / np.where(deg > 0, deg, 1.0), 0.0)
    return senders, receivers, (edge_weight * inv[receivers]).astype(
        np.float32)


def _dir_mean_weights(senders: np.ndarray, receivers: np.ndarray,
                      edge_weight: np.ndarray, num_nodes: int):
    """The 'dir' weights over each receiver's count of nonzero-weight
    in-edges."""
    _, _, w = _dir_weights(senders, receivers, edge_weight, num_nodes)
    count = np.bincount(receivers, weights=(edge_weight != 0).astype(
        np.float64), minlength=num_nodes)
    return senders, receivers, (w / np.maximum(count, 1)[receivers]).astype(
        np.float32)


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


# the COO route's edge lists (nn/coo.py), and the list of each MP
# layer kind it runs
COO, COO_LOOPS = "coo", "coo_loops"
COO_KINDS = {"plain": COO, "mean": COO, "wmean": COO, "gcn_noself": COO,
             "gcn": COO_LOOPS, "gcn_improved": COO_LOOPS,
             "gcn_mean": COO_LOOPS}

# the sym-normalized kinds: the weight of their self-loops (None: none)
GCN_FILL = {"gcn": 1.0, "gcn_improved": 2.0, "gcn_noself": None}
# GINConv's neighbour aggregation (cfg.gnn.gin_agg) -> its pack
GIN_KINDS = {"sum": "plain", "gcn": "gcn", "gcn_noself": "gcn_noself",
             "mean": "wmean"}


def gin_kind(gin_agg: str) -> str:
    """The pack of GINConv's aggregation ``gin_agg``."""
    if gin_agg not in GIN_KINDS:
        raise ValueError(f"gin_agg {gin_agg!r} not in {sorted(GIN_KINDS)}")
    return GIN_KINDS[gin_agg]


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
        base = kind[len(REV):] if kind.startswith(REV) else kind
        s, r = ((receivers, senders) if base != kind
                else (senders, receivers))
        if base in GCN_FILL:
            s, r, w = _gcn_weights(s, r, edge_weight, node_mask, num_nodes,
                                   GCN_FILL[base])
        elif base == "plain":
            w = edge_weight
        elif base == "mean":
            s, r, w = _mean_weights(s, r, edge_weight, num_nodes)
        elif base == "wmean":
            s, r, w = _wmean_weights(s, r, edge_weight, num_nodes)
        elif base == "gcn_mean":
            s, r, w = _gcn_mean_weights(s, r, edge_weight, node_mask,
                                        num_nodes)
        elif base == "att":
            s, r, w = _att_edges(s, r, edge_weight, node_mask, num_nodes)
        elif base == "dir":
            s, r, w = _dir_weights(s, r, edge_weight, num_nodes)
        elif base == "dir_mean":
            s, r, w = _dir_mean_weights(s, r, edge_weight, num_nodes)
        elif kind in (COO, COO_LOOPS):
            out[kind] = (build_coo_edges(senders, receivers, num_nodes,
                                         kind == COO_LOOPS),)
            continue
        elif kind == EDGE:
            out[kind] = build_edge_pack(senders, receivers, edge_weight,
                                        num_nodes, (chunks or {}).get(
                                            kind, (0, 0))[0])
            continue
        elif kind in (EDGE_SRC, EDGE_DST):
            out[kind] = build_gather_packs(
                senders if kind == EDGE_SRC else receivers,
                edge_weight != 0, num_nodes,
                (chunks or {}).get(kind, (0, 0)))
            continue
        else:
            raise ValueError(f"unknown pack kind {kind!r}")
        (fwd, fwd_slot), (bwd, bwd_slot) = _pack_pair(
            s, r, w, num_nodes, num_nodes, (chunks or {}).get(kind, (0, 0)),
            slots=base == "att")
        out[kind] = (fwd, bwd)
        if base == "att":
            out[kind] += (_slot_map(fwd, bwd, fwd_slot, bwd_slot),)
    return out


def pack_chunks(packs: Dict[str, tuple]) -> Dict[str, Tuple[int, int]]:
    """kind -> (fwd chunks, bwd chunks) of a batch's packed-CSR packs
    (the embedding packs have their loader's shape by construction)."""
    return {kind: (entry[0].senders.shape[0], 0 if kind == EDGE
                   else entry[1].senders.shape[0])
            for kind, entry in packs.items()
            if kind not in EMBED_KINDS + (COO, COO_LOOPS)}


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
        if kind in EMBED_KINDS + (COO, COO_LOOPS):
            out[kind] = entry
            continue
        if kind == EDGE:
            out[kind] = pad_edge_pack(entry, chunks[kind][0])
            continue
        fwd_rows, bwd_rows = (p.row_range.shape[0] for p in entry[:2])
        fwd = pad_pack(entry[0], chunks[kind][0], fwd_rows, bwd_rows)
        bwd = pad_pack(entry[1], chunks[kind][1], bwd_rows, fwd_rows)
        out[kind] = (fwd, bwd)
        if len(entry) == 3:             # an 'att' pack's slot map
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


def v2_kind(agg: str, normalize_adj: bool, flow: str) -> str:
    """The pack of GeneralConvV2's aggregation (graphgym_tpu/nn/
    att_layers.py:184-226, spmm of ops/sparse.py:25-57 with reduce
    'sum', 'mean' or 'max'): 'add' and 'max' take A ('plain') or its
    directed norm ('dir'), 'mean' the same weights over each receiver's
    count of real in-edges ('mean', 'dir_mean'); 'max' takes the max of
    its weighted messages.  Flow 'target_to_source' takes the kind of
    the reversed edges ('rev_<kind>')."""
    if agg not in ("add", "mean", "max"):
        raise ValueError(f"Unknown agg: {agg}")
    if flow not in FLOWS:
        raise ValueError(f"Unknown flow: {flow}")
    kind = {(False, False): "plain", (False, True): "dir",
            (True, False): "mean", (True, True): "dir_mean"}[
        (agg == "mean", bool(normalize_adj))]
    return REV + kind if flow == "target_to_source" else kind


def kinds_for_layer(layer_type: str, agg: str = "add",
                    normalize_adj: bool = False,
                    flow: str = "source_to_target",
                    msg_direction: str = "single",
                    gin_agg: str = "sum") -> Tuple[str, ...]:
    """Which precomputed packs a layer type consumes (``agg``,
    ``normalize_adj`` and ``flow``: cfg.gnn's, read by generalconv,
    idconv and generalconv_v2; ``msg_direction`` and ``agg``, read by
    the edge-feature convs, ``edge_kinds``; ``gin_agg``, read by
    ginconv, ``gin_kind``)."""
    if layer_type in EDGE_CONVS:
        return edge_kinds(layer_type, agg, msg_direction)
    lt = layer_type.replace("Tfg-", "")
    if lt in ("generalconv", "idconv"):
        return (agg_kind(agg, normalize_adj),)
    if lt == "generalconv_v2":
        return (v2_kind(agg, normalize_adj, flow),)
    if lt in ("gcnconv", "gcnidconv", "idgcn", "appnp"):
        return ("gcn",)
    if lt == "ginconv":
        return (gin_kind(gin_agg),)
    if lt in ("ginidconv", "idgin", "exampleconv1", "exampleconv2",
              "contrib_example"):
        return ("plain",)
    if lt in ("sageconv", "idsage", "sageidconv", "sageinitconv"):
        return ("mean",)
    if lt in ("gatconv", "idgat", "gatidconv", "gaddconv", "gmulconv"):
        return ("att",)
    return ()


def kinds_for_cfg(gnn) -> Tuple[str, ...]:
    """``kinds_for_layer`` of a config's gnn group."""
    return kinds_for_layer(gnn.layer_type, gnn.agg, gnn.normalize_adj,
                           gnn.flow, gnn.msg_direction, gnn.gin_agg)


def coo_kinds(gnn) -> Tuple[str, ...]:
    """The entries a batch carries on the COO route (cfg.tpu.spmm_impl
    'xla') for a config's gnn group: each MP layer kind's edge list
    (``COO_KINDS``), and for GeneralConv's / GeneralIDConv's max the
    edge convs' 'edge' and 'edge_dst' packs; the edge convs' own packs
    as they are.  A kind the route does not run raises
    NotImplementedError naming ROADMAP A0: the attention layers'
    'att', generalconv_v2's directed norms, the max over self-loops."""
    out = []
    lt = gnn.layer_type.replace("Tfg-", "")
    for kind in kinds_for_cfg(gnn):
        if kind in (EDGE, EDGE_SRC, EDGE_DST, EDGE_BOND):
            out.append(kind)
            continue
        agg = gnn.agg if lt in ("generalconv", "idconv") else None
        if kind not in COO_KINDS or (agg == "max"
                                     and COO_KINDS[kind] != COO):
            what = ("the max over self-loops (gnn.agg max with "
                    "normalize_adj)" if kind in COO_KINDS
                    else f"pack kind {kind!r}")
            raise NotImplementedError(
                f"the COO route (tpu.spmm_impl xla) of {what} is not "
                "ported yet (ROADMAP A0)")
        out.append(COO_KINDS[kind])
        if agg == "max":
            out += [EDGE, EDGE_DST]
    return tuple(dict.fromkeys(out))


PAIRS, LABELS = "pairs", "labels"

# ------------------------------------------------------- edge-feature convs

EDGE, EDGE_SRC, EDGE_DST = "edge", "edge_src", "edge_dst"
EDGE_BOND = "edge_bond"
EDGE_CONVS = ("generaledgeconv", "generalsampleedgeconv", "splineconv",
              "generaledgeattconvv1", "generaledgeattconvv2",
              "generalogbconv")


def edge_kinds(layer_type: str, agg: str = "add",
               msg_direction: str = "single") -> Tuple[str, ...]:
    """The packs of an edge-feature conv: 'edge' (the sum, the softmax,
    the max's forward) and 'edge_src' (x[senders]) always; 'edge_dst'
    where it gathers x[receivers] (``msg_direction`` 'both', read by
    generaledgeconv, generalsampleedgeconv and the attention convs) or
    takes the max (``agg`` 'max', read by generaledgeconv,
    generalsampleedgeconv and generalogbconv: the max's backward);
    'edge_bond' for generalogbconv's bond tables (built where the batch
    has edge features)."""
    if agg not in ("add", "mean", "max"):
        raise ValueError(f"Unknown agg: {agg}")
    if msg_direction not in ("single", "both"):
        raise ValueError(f"Unknown msg_direction: {msg_direction}")
    kinds = [EDGE, EDGE_SRC]
    reads_agg = layer_type in ("generaledgeconv", "generalsampleedgeconv",
                               "generalogbconv")
    reads_dir = layer_type not in ("splineconv", "generalogbconv")
    if (reads_dir and msg_direction == "both") or (reads_agg
                                                   and agg == "max"):
        kinds.append(EDGE_DST)
    if layer_type == "generalogbconv":
        kinds.append(EDGE_BOND)
    return tuple(kinds)


class EdgeSlots(NamedTuple):
    """The 'edge' fwd pack's slots and K2's index of the batch edges
    (S = NC * C slots of the pack, E batch edges, N nodes).

    slot_edge   [NC, C] int32 — the batch edge of each slot, E on the
                slots of no edge (chunk padding)
    edge_slot   [E] int32 — the slot of each batch edge (slot_edge's
                inverse)
    edge_row    [E] int32 — the row K2 sums each edge into: its receiver,
                N for a padding edge (weight 0), which the sum leaves out
    row_ptr, edge_order, run_row, run_first, run_len, arrivals — K2's
                index (``segment_index_host``) of the E edges, the real
                ones by receiver, then in edge order, over the N rows,
                the padding edges after them, left out; its src
                ``edge_order``: the per-edge messages [E, D] are read in
                place, and no chunk padding is listed; shapes of E and N
                alone, one captured program
    """
    slot_edge: Any
    edge_slot: Any
    edge_row: Any
    row_ptr: Any
    edge_order: Any
    run_row: Any
    run_first: Any
    run_len: Any
    arrivals: Any


def edge_index(slots: EdgeSlots) -> SegmentIndex:
    """K2's index of the batch edges in an 'edge' entry's slots."""
    return SegmentIndex(slots.row_ptr, slots.edge_order, slots.run_row,
                        slots.run_first, slots.run_len, slots.arrivals)


def build_edge_pack(senders: np.ndarray, receivers: np.ndarray,
                    edge_weight: np.ndarray, num_nodes: int,
                    least: int = 0) -> Tuple[PackedCSR, EdgeSlots]:
    """(fwd, EdgeSlots): the 'edge' pack of a padded batch's E edges
    (module docstring), its chunk count bucketed and at least ``least``
    (``_pack``)."""
    w = (np.asarray(edge_weight) != 0).astype(np.float32)
    fwd, edge_slot = _pack(senders, receivers, w, num_nodes, num_nodes,
                           least, slots=True)
    e = len(edge_slot)
    edge_slot = np.asarray(edge_slot)
    slot_edge = native.scatter(fwd.senders.size, e, edge_slot,
                               np.arange(e, dtype=np.int32))
    # the real edges by receiver, then in edge order; the padding edges
    # (weight 0, zero messages) left out past the last row
    edge_row = np.where(w != 0, receivers, num_nodes).astype(np.int32)
    order = np.argsort(edge_row, kind="stable").astype(np.int32)
    index = segment_index_host(edge_row[order], num_nodes, order)
    return fwd, EdgeSlots(slot_edge.reshape(fwd.senders.shape),
                          edge_slot.astype(np.int32), edge_row, *index)


def pad_edge_pack(entry: Tuple[PackedCSR, EdgeSlots],
                  chunks: int) -> Tuple[PackedCSR, EdgeSlots]:
    """An 'edge' entry padded to ``chunks`` chunks (``pad_pack``), the
    new slots holding no edge; K2's index of the edges is unchanged."""
    fwd, slots = entry
    if chunks <= fwd.senders.shape[0]:
        return entry
    n = fwd.row_range.shape[0]
    fwd = pad_pack(fwd, chunks, n, n)
    slot_edge = np.full(fwd.senders.shape, len(slots.edge_slot), np.int32)
    slot_edge[:slots.slot_edge.shape[0]] = slots.slot_edge
    return fwd, slots._replace(slot_edge=slot_edge)


class CooEdges(NamedTuple):
    """A COO route entry (module docstring): P positions, the batch's E
    edges in batch order, then with loops the N node slots.

    senders, receivers   [P] int32
    recv_ptr, recv_src, recv_run_row, recv_run_first, recv_run_len,
        recv_arrivals — K2's index (``segment_index_host``) of the
        positions by receiver (stable), its src the position: the sum
        reads the per-position messages in place
    send_ptr, send_src, send_run_row, send_run_first, send_run_len,
        send_arrivals — the same by sender: the gather's gradient
    """
    senders: Any
    receivers: Any
    recv_ptr: Any
    recv_src: Any
    recv_run_row: Any
    recv_run_first: Any
    recv_run_len: Any
    recv_arrivals: Any
    send_ptr: Any
    send_src: Any
    send_run_row: Any
    send_run_first: Any
    send_run_len: Any
    send_arrivals: Any


def coo_recv_index(edges: CooEdges) -> SegmentIndex:
    """K2's index of a COO entry's positions by receiver."""
    return SegmentIndex(*edges[2:8])


def coo_send_index(edges: CooEdges) -> SegmentIndex:
    """K2's index of a COO entry's positions by sender."""
    return SegmentIndex(*edges[8:14])


def _sorted_index(rows: np.ndarray, num_nodes: int) -> SegmentIndex:
    order = np.argsort(rows, kind="stable").astype(np.int32)
    return segment_index_host(rows[order], num_nodes, order)


def build_coo_edges(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int, loops: bool) -> CooEdges:
    """The COO route's entry of a padded batch's edges (and with
    ``loops`` a self-loop on each of the ``num_nodes`` slots, appended
    as ``gcn_norm`` appends them)."""
    s = np.asarray(senders, np.int32)
    r = np.asarray(receivers, np.int32)
    if loops:
        loop = np.arange(num_nodes, dtype=np.int32)
        s, r = np.concatenate([s, loop]), np.concatenate([r, loop])
    return CooEdges(s, r, *_sorted_index(r, num_nodes),
                    *_sorted_index(s, num_nodes))


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


# ---------------------------------------------------------------- encoders

NODE_ENCODER, EDGE_ENCODER = "node_encoder", "edge_encoder"
EMBED_KINDS = (NODE_ENCODER, EDGE_ENCODER, EDGE_BOND)
# ogb.utils.features get_atom_feature_dims() / get_bond_feature_dims()
ATOM_FEATURE_DIMS = [119, 4, 12, 12, 10, 6, 6, 2, 2]
BOND_FEATURE_DIMS = [5, 6, 2]
# the built-in encoders' tables (graphgym_tpu/nn/encoders.py): encoder
# name -> (rows of each column's table, ids clipped to the table)
EMBED_TABLES = {
    "Integer": ([256], False),
    "SingleAtom": ([ATOM_FEATURE_DIMS[0]], False),
    "Atom": (ATOM_FEATURE_DIMS, True),
    "Bond": (BOND_FEATURE_DIMS, True),
}


class EmbedPack(NamedTuple):
    """An encoder's table lookup over M items (nodes or edges, padding
    included) of C id columns, the columns' tables stacked into R rows.

    rows        [M, C] int32 — the stacked row of item m's column c; R
                 (one past the tables: a NaN row in the forward, no
                 gradient) where the id lies outside its table
    row_ptr, slot_items, run_row, run_first, run_len, arrivals — K2's
                 index (``segment_index_host``) of the M * C (item,
                 column) slots sorted by row (stable) over the R + 1
                 rows, its src ``slot_items`` the item of each slot: the
                 tables' gradient reads the output gradient's item rows
                 in place
    """
    rows: Any
    row_ptr: Any
    slot_items: Any
    run_row: Any
    run_first: Any
    run_len: Any
    arrivals: Any


def embed_index(pack: EmbedPack) -> SegmentIndex:
    """K2's index of an embedding pack's slots."""
    return SegmentIndex(pack.row_ptr, pack.slot_items, pack.run_row,
                        pack.run_first, pack.run_len, pack.arrivals)


def build_embed_pack(feat: np.ndarray, dims: Sequence[int],
                     clip: bool) -> EmbedPack:
    """The embedding pack of ``feat`` [M, F]: the first min(len(dims),
    F) columns as integer ids (truncated toward zero, as the JAX
    encoders' ``astype(int32)``), looked up in tables of ``dims`` rows.
    With ``clip`` an id is clipped into its table (_MultiColumnEmbed);
    else a negative id counts from the table's end and an id outside
    [-rows, rows) gets the NaN row (flax ``nn.Embed``'s ``jnp.take``,
    IntegerFeatureEncoder and SingleAtomEncoder).  Its shapes depend on
    M, F and ``dims`` alone."""
    dims = np.asarray(dims[:min(len(dims), feat.shape[1])], np.int64)
    ncol = len(dims)
    offsets = np.concatenate([[0], np.cumsum(dims)[:-1]])
    total = int(dims.sum())
    ids = np.asarray(feat[:, :ncol], np.float32).astype(np.int64)
    if clip:
        rows = np.clip(ids, 0, dims - 1) + offsets
    else:
        ids = np.where(ids < 0, ids + dims, ids)
        rows = np.where((ids >= 0) & (ids < dims), ids + offsets, total)
    flat = rows.reshape(-1)
    # a stable sort of small ints: numpy's radix sort on int16
    order = np.argsort(flat.astype(np.int16 if total < 2 ** 15
                                   else np.int64), kind="stable")
    index = segment_index_host(flat[order], total + 1,
                               (order // ncol).astype(np.int32))
    return EmbedPack(rows.astype(np.int32), *index)
