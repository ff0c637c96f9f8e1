"""The MP layers' COO route (cfg.tpu.spmm_impl 'xla'; ROADMAP A0).

Where the JAX package's batch carries no pack, each MP layer aggregates
per-edge messages: it gathers x by sender, scales by the edge weights,
and segment-reduces by receiver (graphgym_tpu/ops/sparse.py:25-57,
as graphgym_tpu/nn/layers.py:282-290, 320-322, 526-540, 626-641 and
nn/id_layers.py:60-69, 92-101, 132, 165-168, 355-358 call it), with the
GCN weights from ``gcn_norm`` on the device.  The port does the same on
the entries ``graphs/packing.build_coo_edges`` builds with the batch
(the loader's ``coo`` and ``coo_loops``: the batch's E edges, and E + N
with a self-loop on every node slot):

  * the per-edge weights as the JAX function computes them: the GCN
    sym-norm with its self-loops (weight ``fill`` on real nodes, 0 on
    padding ones), the weighted in-degree summed by K2 at width 1; the
    edge weights for 'plain' and GeneralConv's mean; none for SAGE's;
  * the gather x[senders], its gradient a sum by sender on K2
    (``GatherFn``, the entry's second index), not ``index_select``'s
    backward, an ``index_add`` with float atomics;
  * the sum by receiver on K2 over the messages in place
    (``segment_sum_vjp``), its gradient the gather g[receiver];
  * the mean as that sum over the count of live edges (K2 at width 1);
  * the max the edge convs' ``edge_max`` (the segmented max on the
    'edge' pack's layout).

So neither direction adds floats with atomics, and a step repeats
bitwise.  K2 counts each of the three roles under its own label in
``launches_by_pack``: ``COO_SUM`` (the sums by receiver), ``COO_DEGREE``
(the degrees and counts at width 1) and ``COO_GRAD`` (the gather's
gradient).  The dtypes flow as in the JAX package: a bf16 message times
an f32 weight is an f32 message, so under mixed precision the layer
after a weighted aggregation runs in f32.
"""

from __future__ import annotations

import torch

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import (COO_KINDS, COO_LOOPS,
                                               GCN_FILL, CooEdges,
                                               coo_recv_index,
                                               coo_send_index)
from graphgym_tpu_torch.ops.cuda.spmm_kernel import (segment_sum,
                                                     segment_sum_vjp)
from graphgym_tpu_torch.ops.sparse import inv_sqrt_degree

COO_SUM, COO_DEGREE, COO_GRAD = "coo_sum", "coo_degree", "coo_grad"


def on_coo(graph: GraphBatch, kind: str) -> bool:
    """Whether a layer of pack ``kind`` takes the COO route: the batch
    carries the COO entry of its edges and not the kind's pack."""
    return (graph.packs is not None and kind not in graph.packs
            and COO_KINDS.get(kind) in graph.packs)


def _edges(graph: GraphBatch, kind: str) -> CooEdges:
    return graph.packs[COO_KINDS[kind]][0]


class GatherFn(torch.autograd.Function):
    """x[senders] of a COO entry's positions; the gradient the sum by
    sender, K2 on the entry's sender index reading g in place (a
    deterministic index_add)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, edges: CooEdges) -> torch.Tensor:
        ctx.edges = edges
        return x.index_select(0, edges.senders)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dx = segment_sum(g.contiguous(), coo_send_index(ctx.edges),
                         COO_GRAD)
        return dx.to(g.dtype), None


def _row_sum(graph: GraphBatch, edges: CooEdges, msg: torch.Tensor,
             label: str = COO_SUM) -> torch.Tensor:
    """[N, D] sum by receiver of msg [P, D] (one row a position)."""
    return segment_sum_vjp(msg, coo_recv_index(edges), edges.receivers,
                           graph.num_nodes, label)


def _count(graph: GraphBatch, edges: CooEdges,
           weight: torch.Tensor) -> torch.Tensor:
    """[N] f32 sum by receiver of a per-position weight, no gradient."""
    with torch.no_grad():
        return _row_sum(graph, edges, weight.float()[:, None],
                        COO_DEGREE)[:, 0]


def _loop_weights(graph: GraphBatch, fill: float) -> torch.Tensor:
    return torch.cat([graph.edge_weight,
                      torch.where(graph.node_mask, fill, 0.0).float()])


def gcn_weights(graph: GraphBatch, kind: str) -> torch.Tensor:
    """The per-position weights of a sym-normalized kind ('gcn',
    'gcn_improved', 'gcn_mean', 'gcn_noself'): graphgym_tpu/ops/
    sparse.py ``gcn_norm``, dis[r] * w * dis[s] with dis the inverse
    square root of the weighted in-degree."""
    edges = _edges(graph, kind)
    fill = GCN_FILL.get(kind, 1.0)
    w = graph.edge_weight if fill is None else _loop_weights(graph, fill)
    dis = inv_sqrt_degree(_count(graph, edges, w))
    return (dis.index_select(0, edges.receivers) * w
            * dis.index_select(0, edges.senders))


def _live(graph: GraphBatch, kind: str) -> torch.Tensor:
    """The mask of a mean's positions: the real edges, and with the
    loops the real nodes (segment_mean's mask)."""
    if COO_KINDS[kind] == COO_LOOPS:
        return torch.cat([graph.edge_mask, graph.node_mask])
    return graph.edge_mask


def coo_spmm(graph: GraphBatch, kind: str, h: torch.Tensor,
             weighted: bool = True) -> torch.Tensor:
    """The aggregation of pack ``kind`` on the COO route: 'plain' the
    sum of w * h[s] (GIN's and GeneralConv's add), 'gcn' /
    'gcn_improved' / 'gcn_noself' the sym-normed sum, 'mean' the mean
    over the real in-edges (of h[s] for SAGE, of w * h[s] with
    ``weighted``, GeneralConv's), 'gcn_mean' the sym-normed messages'
    mean over the real slots, 'wmean' the sum over max(the weighted
    in-degree, 1) (GINConv's gin_agg 'mean')."""
    edges = _edges(graph, kind)
    msg = GatherFn.apply(h, edges)
    if kind in GCN_FILL or kind == "gcn_mean":
        msg = msg * gcn_weights(graph, kind)[:, None]
    elif weighted or kind != "mean":
        msg = msg * graph.edge_weight[:, None]
    if kind in ("mean", "gcn_mean"):
        live = _live(graph, kind)
        msg = torch.where(live[:, None], msg, msg.new_zeros(()))
        total = _row_sum(graph, edges, msg)
        return total / _count(graph, edges, live).clamp_min(1.0)[:, None]
    out = _row_sum(graph, edges, msg)
    if kind == "wmean":
        deg = _count(graph, edges, graph.edge_weight)
        out = out / deg.clamp_min(1.0)[:, None]
    return out


def weighted_messages(graph: GraphBatch, h: torch.Tensor) -> torch.Tensor:
    """[E, D] w * h[s] over the batch's edges: GeneralConv's 'max'
    takes their max over each receiver's real edges (segment_max with
    the edge mask) on the 'edge' pack (nn/layers.py ``edge_max``)."""
    return (GatherFn.apply(h, _edges(graph, "plain"))
            * graph.edge_weight[:, None])

