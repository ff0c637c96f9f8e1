"""Host-side pack construction for the packed SpMM path.

The port of graphgym_tpu/graphs/packing.py.  Per collated GraphBatch it
precomputes the normalized edge weights (pure functions of the static
graph structure) and the packed chunk layouts of A and A^T:

  'gcn'   — D^-1/2 (A + I) D^-1/2 with the reference's inf guard
            (TfgIDLayer.py:528-566); self-loops only on real nodes.
  'plain' — raw A (GIN sum aggregation).
  'mean'  — D^-1 A (SAGE mean aggregation), the degree counting edges
            of nonzero weight.
  'att'   — A + self-loops on real nodes, weights a validity indicator
            (1 real, 0 padding); the attention coefficients are computed
            in the layer (packing.py:71-79 of the JAX package).

The bwd layout packs the transpose with the same weights, giving
dx = A^T g.  The 'att' entry carries a third array, the slot map: for
each bwd slot the fwd slot of the same edge, so the backward carries
the per-slot coefficients into bwd order.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from graphgym_tpu_torch.graphs.container import bucket_size
from graphgym_tpu_torch.ops.cuda.spmm_kernel import (PackedCSR,
                                                     pack_csr_with_slots,
                                                     pad_pack)


def _gcn_weights(senders: np.ndarray, receivers: np.ndarray,
                 edge_weight: np.ndarray, node_mask: np.ndarray,
                 num_nodes: int):
    """Append weight-1 self loops on real nodes and sym-normalize."""
    loop = np.arange(num_nodes, dtype=senders.dtype)
    s = np.concatenate([senders, loop])
    r = np.concatenate([receivers, loop])
    w = np.concatenate([edge_weight,
                        node_mask.astype(np.float32)])
    deg = np.zeros(num_nodes, np.float64)
    np.add.at(deg, r, w)
    with np.errstate(divide="ignore"):
        dis = deg ** -0.5
    dis[~np.isfinite(dis)] = 0
    return s, r, (dis[r] * w * dis[s]).astype(np.float32)


def _mean_weights(senders: np.ndarray, receivers: np.ndarray,
                  edge_weight: np.ndarray, num_nodes: int):
    """Each edge's weight over its receiver's count of nonzero-weight
    in-edges (0 where the count is 0)."""
    deg = np.zeros(num_nodes, np.float64)
    np.add.at(deg, receivers, (edge_weight != 0).astype(np.float64))
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    return senders, receivers, (edge_weight * inv[receivers]).astype(
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


def build_packs(senders: np.ndarray, receivers: np.ndarray,
                edge_weight: np.ndarray, node_mask: np.ndarray,
                num_nodes: int, kinds: Sequence[str] = ("gcn",)
                ) -> Dict[str, tuple]:
    """kind -> (fwd, bwd) packs, and for 'att' also the slot map
    [NC_bwd, C] int32.  num_nodes here is the PADDED node count (packs
    target padded rows; the padding row receives only weight-0
    contributions)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
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
        elif kind == "att":
            s, r, w = _att_edges(senders, receivers, edge_weight,
                                 node_mask, num_nodes)
        else:
            raise ValueError(f"unknown pack kind {kind!r}")
        fwd, fwd_slot = pack_csr_with_slots(s, r, w, num_nodes)
        bwd, bwd_slot = pack_csr_with_slots(r, s, w, num_nodes)
        # bucket chunk counts so multi-batch loaders share shapes
        fwd = _pad_to_bucket(fwd, num_nodes)
        bwd = _pad_to_bucket(bwd, num_nodes)
        out[kind] = (fwd, bwd)
        if kind == "att":
            out[kind] += (_slot_map(fwd, bwd, fwd_slot, bwd_slot),)
    return out


def _slot_map(fwd: PackedCSR, bwd: PackedCSR, fwd_slot: np.ndarray,
              bwd_slot: np.ndarray) -> np.ndarray:
    """For each bwd slot, the fwd slot of the same edge.  Bwd padding
    slots point one past the last fwd slot, where the backward appends
    a zero coefficient."""
    slot_map = np.full(bwd.senders.size, fwd.senders.size, np.int32)
    slot_map[bwd_slot] = fwd_slot
    return slot_map.reshape(bwd.senders.shape)


def _pad_to_bucket(pack: PackedCSR, num_nodes: int) -> PackedCSR:
    return pad_pack(pack, bucket_size(pack.senders.shape[0]), num_nodes)


def kinds_for_layer(layer_type: str) -> Tuple[str, ...]:
    """Which precomputed packs a layer type consumes."""
    lt = layer_type.replace("Tfg-", "")
    if lt in ("gcnconv", "gcnidconv", "idgcn"):
        return ("gcn",)
    if lt in ("ginconv", "ginidconv", "idgin"):
        return ("plain",)
    if lt in ("sageconv", "idsage", "sageidconv", "sageinitconv"):
        return ("mean",)
    if lt in ("gatconv", "idgat", "gatidconv", "gaddconv", "gmulconv"):
        return ("att",)
    return ()
