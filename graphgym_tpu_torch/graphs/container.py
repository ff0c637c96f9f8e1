"""Static-shape graph batches for the torch port.

The port of graphgym_tpu/graphs/container.py for node, graph, edge
and link tasks.  A loader
builds a ``GraphBatch`` on the host with numpy leaves and moves it to
the device in one call, ``batch.to(device)``.

Padding conventions (the same as graphgym_tpu/graphs/container.py:10-15):
  * nodes are padded to ``num_nodes`` slots and edges to ``num_edges``
    slots;
  * every padded edge has ``senders == receivers == num_nodes - 1`` (the
    padding-node slot) and ``edge_weight == 0``, so aggregation lands in
    a row nobody reads and the SpMM path needs no mask;
  * padded nodes carry zero features and ``node_mask == False``; only
    losses and metrics consult the masks;
  * messages flow ``senders -> receivers``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A disjoint-union batch of graphs with static shapes.

    Attributes:
      senders:    [E] source node of each edge.
      receivers:  [E] destination node of each edge.
      edge_weight:[E] f32, 0.0 on padded edges.
      node_feat:  [N, D] node features (zeros on padded rows).
      edge_feat:  [E, De] edge features, zeros on padded edges (None
                  where a graph of the batch has none).
      node_mask:  [N] bool, True for real nodes.
      edge_mask:  [E] bool, True for real edges.
      graph_ids:  [N] graph slot of each node; padded nodes point at the
                  padding graph slot ``num_graphs - 1``.
      num_graphs: number of graph slots (incl. the padding slot).
      node_label: [N] labels aligned with node slots.
      node_label_index: [L] padded index list of supervised nodes.
      label_mask: [L] bool mask over node_label_index slots.
      edge_label: [P] labels of the supervised node pairs (edge and
                  link tasks), 0 on padding pairs.
      edge_label_index: [2, P] the supervised node pairs; padding pairs
                  at the padding node.
      edge_label_mask: [P] bool, True for the real pairs.
      graph_label: [G] labels of the graph slots (graph tasks), 0 on the
                  padding graph slot.
      graph_mask: [G] bool, True for the real graph slots.
      node_id_index: [K] ego-net center slots (ID-GNN Full).
      id_mask:    [K] bool mask over node_id_index slots.
      packs:      dict kind -> (fwd PackedCSR, bwd PackedCSR), the packed
                  SpMM layouts of A and A^T, and for 'att' also the
                  fwd->bwd slot map; a graph task's pooling pack maps
                  node rows to graph slots and back, and the gather
                  packs map node rows to supervised pairs or nodes and
                  back (graphs/packing.py).

    Host batches hold numpy arrays.  ``to(device)`` gives torch tensors;
    index arrays become int64 there, except the packs, whose int32
    arrays are what the SpMM kernel reads.
    """

    senders: Any
    receivers: Any
    edge_weight: Any
    node_feat: Any
    node_mask: Any
    edge_mask: Any
    graph_ids: Any = None
    num_graphs: int = 1
    node_label: Any = None
    node_label_index: Any = None
    label_mask: Any = None
    edge_label: Any = None
    edge_label_index: Any = None
    edge_label_mask: Any = None
    graph_label: Any = None
    graph_mask: Any = None
    node_id_index: Any = None
    id_mask: Any = None
    packs: Optional[dict] = None
    edge_feat: Any = None

    @property
    def num_nodes(self) -> int:
        return int(self.node_feat.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    def count_real_edges(self) -> int:
        return int(self.edge_mask.sum())

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def leaves(self):
        """Every array of the batch (numpy on the host, tensors after
        ``to``), its packs' included, in field order."""
        for value in vars(self).values():
            parts = value.values() if isinstance(value, dict) else [value]
            for part in parts:
                for p in (part if isinstance(part, tuple) else [part]):
                    for a in (p if isinstance(p, tuple) else [p]):
                        if isinstance(a, (np.ndarray, torch.Tensor)):
                            yield a

    def staging_bytes(self) -> int:
        """The pinned staging buffer ``to`` needs for this host batch."""
        return sum(_staged(a.nbytes) for a in self.leaves())

    def to(self, device: torch.device,
           staging: Optional[torch.Tensor] = None) -> "GraphBatch":
        """A copy with every array as a tensor on ``device``.  With
        ``staging``, a pinned uint8 host tensor of at least
        ``staging_bytes()``, each array is copied into it and moved from
        there without blocking the host, on the current stream, and index
        arrays widen to int64 on the device; the caller synchronises that
        stream before it writes ``staging`` again."""
        offset = 0

        def move(a, index=False):
            nonlocal offset
            if a is None:
                return None
            a = np.ascontiguousarray(a)
            if staging is None:
                t = torch.from_numpy(a)
                if index:
                    t = t.long()
                return t.to(device)
            dst = staging[offset:offset + a.nbytes].view(
                torch.from_numpy(a).dtype).view(a.shape)
            offset += _staged(a.nbytes)
            # numpy's copy: one thread, the GIL released; torch's copy_
            # would fork its intra-op threads, which stall behind the
            # loader's threads while the prefetch worker collates
            np.copyto(dst.numpy(), a)
            t = dst.to(device, non_blocking=True)
            return t.long() if index else t

        def move_pack(p):
            if isinstance(p, tuple):        # a PackedCSR
                return type(p)(*(move(a) for a in p))
            return move(p)                  # the 'att' slot map

        packs = None
        if self.packs is not None:
            packs = {kind: tuple(move_pack(p) for p in entry)
                     for kind, entry in self.packs.items()}
        return GraphBatch(
            senders=move(self.senders, True),
            receivers=move(self.receivers, True),
            edge_weight=move(self.edge_weight),
            node_feat=move(self.node_feat),
            node_mask=move(self.node_mask),
            edge_mask=move(self.edge_mask),
            graph_ids=move(self.graph_ids, True),
            num_graphs=self.num_graphs,
            node_label=move(self.node_label, True),
            node_label_index=move(self.node_label_index, True),
            label_mask=move(self.label_mask),
            edge_label=move(self.edge_label, True),
            edge_label_index=move(self.edge_label_index, True),
            edge_label_mask=move(self.edge_label_mask),
            graph_label=move(self.graph_label, True),
            graph_mask=move(self.graph_mask),
            node_id_index=move(self.node_id_index, True),
            id_mask=move(self.id_mask),
            packs=packs,
            edge_feat=move(self.edge_feat))


def _staged(nbytes: int) -> int:
    """An array's share of a staging buffer: its bytes rounded up to 64,
    so every array starts aligned."""
    return (nbytes + 63) // 64 * 64


def pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``x`` to length ``n`` with ``fill``."""
    if x.shape[0] > n:
        raise ValueError(f"cannot pad length {x.shape[0]} down to {n}")
    if x.shape[0] == n:
        return x
    pad_shape = (n - x.shape[0],) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)])


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def bucket_size(n: int, multiple: int = 8, min_size: int = 8) -> int:
    """Quarter-step bucketing: the smallest value >= n of the form
    m * 2^k with m in {4, 5, 6, 7} (graphs/container.py of the JAX
    package).  Worst-case padding is 25%."""
    n = max(n, min_size)
    size = min_size
    while size < n:
        size *= 2
    # refine: walk back down in quarter steps of the bracket
    for m in (4, 5, 6, 7):
        cand = size // 8 * m
        if cand >= n:
            return round_up(max(cand, min_size), multiple)
    return round_up(size, multiple)


def build_graph_batch(
    senders: np.ndarray,
    receivers: np.ndarray,
    node_feat: np.ndarray,
    *,
    edge_weight: Optional[np.ndarray] = None,
    graph_ids: Optional[np.ndarray] = None,
    num_graphs: int = 1,
    node_label: Optional[np.ndarray] = None,
    node_label_index: Optional[np.ndarray] = None,
    edge_label: Optional[np.ndarray] = None,
    edge_label_index: Optional[np.ndarray] = None,
    edge_label_mask: Optional[np.ndarray] = None,
    graph_label: Optional[np.ndarray] = None,
    node_id_index: Optional[np.ndarray] = None,
    edge_feat: Optional[np.ndarray] = None,
    pad_nodes_to: Optional[int] = None,
    pad_edges_to: Optional[int] = None,
) -> GraphBatch:
    """Host-side constructor: pads numpy arrays into a GraphBatch.

    One extra padding node slot is always reserved (the scatter target for
    padded edges), so ``pad_nodes_to`` must exceed the real node count.
    The edge supervision arrays are kept as given (the loader pads them);
    ``edge_feat`` is padded with zero rows to the edge slots.
    """
    n_real = int(node_feat.shape[0])
    e_real = int(senders.shape[0])

    pad_nodes_to = max(pad_nodes_to or 0, n_real + 1)
    pad_edges_to = max(pad_edges_to or 0, e_real, 1)

    pad_node = pad_nodes_to - 1

    senders = pad_to(np.asarray(senders, np.int32), pad_edges_to, pad_node)
    receivers = pad_to(np.asarray(receivers, np.int32), pad_edges_to,
                       pad_node)
    if edge_weight is None:
        edge_weight = np.ones((e_real,), np.float32)
    edge_weight = pad_to(np.asarray(edge_weight, np.float32), pad_edges_to,
                         0.0)
    node_feat = pad_to(np.asarray(node_feat, np.float32), pad_nodes_to, 0.0)

    node_mask = pad_to(np.ones((n_real,), bool), pad_nodes_to, False)
    edge_mask = pad_to(np.ones((e_real,), bool), pad_edges_to, False)

    if graph_ids is None:
        graph_ids = np.zeros((n_real,), np.int32)
    graph_ids = pad_to(np.asarray(graph_ids, np.int32), pad_nodes_to,
                       max(num_graphs - 1, 0))

    kw: dict[str, Any] = {}
    if edge_feat is not None:
        kw["edge_feat"] = pad_to(np.asarray(edge_feat, np.float32),
                                 pad_edges_to, 0.0)
    if node_label is not None:
        kw["node_label"] = pad_to(np.asarray(node_label), pad_nodes_to, 0)
    if node_label_index is not None:
        li = np.asarray(node_label_index, np.int32)
        l_pad = max(pad_nodes_to, len(li))
        kw["node_label_index"] = pad_to(li, l_pad, pad_node)
        kw["label_mask"] = pad_to(np.ones((len(li),), bool), l_pad, False)
    if edge_label is not None:
        kw["edge_label"] = np.asarray(edge_label)
    if edge_label_index is not None:
        kw["edge_label_index"] = np.asarray(edge_label_index, np.int32)
    if edge_label_mask is not None:
        kw["edge_label_mask"] = np.asarray(edge_label_mask, bool)
    if graph_label is not None:
        g_real = int(np.asarray(graph_label).shape[0])
        kw["graph_label"] = pad_to(np.asarray(graph_label), num_graphs, 0)
        kw["graph_mask"] = pad_to(np.ones((g_real,), bool), num_graphs,
                                  False)
    if node_id_index is not None:
        ii = np.asarray(node_id_index, np.int32)
        i_pad = max(len(ii), 1)
        kw["node_id_index"] = pad_to(ii, i_pad, pad_node)
        kw["id_mask"] = pad_to(np.ones((len(ii),), bool), i_pad, False)

    return GraphBatch(
        senders=senders,
        receivers=receivers,
        edge_weight=edge_weight,
        node_feat=node_feat,
        node_mask=node_mask,
        edge_mask=edge_mask,
        graph_ids=graph_ids,
        num_graphs=num_graphs,
        **kw,
    )
