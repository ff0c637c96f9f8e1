"""Layer building blocks of the port (graphgym_tpu/nn/layers.py subset):
the glorot initializer with its gain, the packed SpMM, aggregation and
attention dispatch (the MP layers' COO route under tpu.spmm_impl 'xla':
nn/coo.py), ``Linear``, ``MLP`` and the ``GeneralLayer``
wrapper (conv, BatchNorm, dropout, activation), the packed-branch GCN,
SAGE and GIN convs with the GIN MLP, GraphGym's ``GeneralConv``, the
additive ``GATConv`` and the Tfg dot-product GAT, and the edge-feature
convs ``SplineConv`` and ``GeneralEdgeConv`` with the per-edge message
helpers they share with nn/att_layers.py.  Modules take and return a
GraphBatch whose arrays are tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import (EDGE, EDGE_DST, EDGE_SRC,
                                               agg_kind, edge_index,
                                               edge_kinds, gin_kind)
from graphgym_tpu_torch.nn import coo, remat
from graphgym_tpu_torch.nn.act import PReLU, act_dict
from graphgym_tpu_torch.nn.norm import MaskedBatchNorm
from graphgym_tpu_torch.ops.cuda.spmm_kernel import (
    pack_rows, packed_max_vjp, packed_node_scores, packed_scaled_dot,
    packed_segment_softmax, permute_rows, segment_matmul_headed_vjp,
    segment_sum_vjp, spmm_pack_vjp, take_padded)
from graphgym_tpu_torch.ops.sparse import inv_sqrt_degree, mm


# xavier gain of the torch path's nn.Linear equivalents (Linear, MLP,
# ginconv's MLP; reference init.py:6-16)
LINEAR_GAIN = math.sqrt(2)


def glorot(shape, generator: torch.Generator,
           gain: float = 1.0) -> nn.Parameter:
    """xavier_uniform with a gain: uniform in +-gain * sqrt(6 / (fan_in
    + fan_out)), the fans of flax's ``variance_scaling(gain^2, fan_avg,
    uniform)`` (graphgym_tpu/nn/layers.py:48-61): fan_in = shape[-2] and
    fan_out = shape[-1], each times the product of the leading axes.
    gain 1 is TF/flax glorot; the torch path's nn.Linear equivalents
    take LINEAR_GAIN."""
    w = torch.empty(shape)
    if len(shape) == 2:
        nn.init.xavier_uniform_(w, gain=gain, generator=generator)
    else:
        field = math.prod(shape[:-2])
        bound = gain * math.sqrt(6.0 / ((shape[-2] + shape[-1]) * field))
        w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


def zeros(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _packs(graph: GraphBatch, kind: str) -> tuple:
    """The batch-carried packs of ``kind``.  The port always builds the
    packs a layer consumes (or, on the COO route, the entry of its
    edges), so a missing pack is an error."""
    if graph.packs is None or kind not in graph.packs:
        raise ValueError(f"batch carries no {kind!r} pack")
    return graph.packs[kind]


def as_coo_message(h: torch.Tensor) -> torch.Tensor:
    """h as the JAX package's COO ``spmm`` aggregates it, where its layer
    takes that route whatever the batch carries: the message h[s] times
    an f32 weight (or, unweighted, a mean over an f32 count) is f32, so
    a bf16 h aggregates in f32 and its result is f32; f32 and float64
    as they are."""
    return h.to(torch.promote_types(h.dtype, torch.float32))


def packed_spmm(graph: GraphBatch, kind: str, h: torch.Tensor,
                coo_dtype: bool = False) -> torch.Tensor:
    """SpMM over the batch-carried packs of ``kind`` (layers.py:63-84,
    single-device branch); on the COO route (tpu.spmm_impl 'xla', a
    batch with the entry of the kind's edges in place of its packs) the
    per-edge messages' sum on K2 (nn/coo.py; 'mean' unweighted, SAGE's
    ``spmm(None)``).  ``coo_dtype``: the JAX layer takes the COO spmm
    even with packs (GCN's ``improved``, GINConv's gin_agg other than
    sum, SAGEIDConv, sageinitconv, APPNP, the example conv), so its
    result's dtype is the COO route's (``as_coo_message``), not K1's
    cast back to h's."""
    if coo.on_coo(graph, kind):
        return coo.coo_spmm(graph, kind, h, weighted=False)
    fwd, bwd = _packs(graph, kind)
    return spmm_pack_vjp(fwd, bwd, as_coo_message(h) if coo_dtype else h)


def packed_aggregate(graph: GraphBatch, h: torch.Tensor, agg: str,
                     kind: str) -> torch.Tensor:
    """GeneralConv's aggregation of the messages h over the receivers
    (graphgym_tpu/ops/sparse.py:25-57 as layers.py:626-642 calls it):
    'add' and 'mean' are K1 on the packs of ``kind`` (``agg_kind``'s or
    ``v2_kind``'s; the mean's division is in its weights), 'max' the
    segmented max on them, each with its backward on the transpose
    pack: no float atomics.  The JAX layers aggregate on the COO
    ``spmm`` whatever the batch carries, so the result's dtype is that
    route's (``as_coo_message``).  On the COO route the per-edge
    messages w * h[s] reduce on K2 ('add', 'mean') or on the edge convs'
    max (nn/coo.py)."""
    if coo.on_coo(graph, kind):
        if agg == "max":
            return edge_max(graph, coo.weighted_messages(graph, h),
                            graph.edge_mask)
        return coo.coo_spmm(graph, kind, h)
    fwd, bwd = _packs(graph, kind)
    h = as_coo_message(h)
    if agg == "max":
        return packed_max_vjp(fwd, bwd, h)
    return spmm_pack_vjp(fwd, bwd, h)


def packed_attention(graph: GraphBatch, h_heads: torch.Tensor,
                     score_fn: Optional[Callable] = None,
                     values: Optional[torch.Tensor] = None,
                     keys: Optional[torch.Tensor] = None,
                     node_scores: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                     score_transform: Optional[Callable] = None,
                     score_bias: Optional[torch.Tensor] = None,
                     dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Multi-head attention over the 'att' pack (layers.py:92-176):
    per-edge scores and the softmax run on scalars in packed slot
    order, and the value aggregation runs through the per-head kernel
    K3 (``segment_matmul_headed_vjp``), which gathers v[senders]
    itself.  The softmax's row sums (``packed_segment_softmax``) and
    the node scores' gradients (``packed_node_scores``) are K3 row sums
    too: no float atomics forward or backward.

    h_heads: [N, H, d] receiver-side (query) features; keys and values
    default to h_heads.  score_fn(h_i, h_j) -> [NC, C, H] raw scores of
    the gathered [NC, C, H, d] features; a ``ScaledDot`` score_fn is
    computed on the packs instead (``packed_scaled_dot``: the SDDMM
    kernel, and K3 for its gradients), with no [NC, C, H, d] tensor.
    node_scores: optional (s_dst [N, H], s_src [N, H]) for scores that
    decompose per node (GAT's additive attention); only those scalars
    are gathered per edge, and alpha = score_transform(s_dst[i] +
    s_src[j]).  score_bias: optional [H] added to a ``ScaledDot``
    score as score_bias / scale, broadcast over the slots (GeneralMulAttConv's
    (h_i . h_j + b) / sqrt(d), up to rounding); its gradient is the
    per-head sum of the slots' (the masked slots' are 0 after the
    softmax).  dropout_rate > 0 drops coefficients with a mask drawn
    from ``generator``.  Returns [N, H, dv]."""
    if score_fn is None and node_scores is None:
        raise ValueError("packed_attention needs score_fn or node_scores")
    if score_bias is not None and not isinstance(score_fn, ScaledDot):
        raise ValueError("score_bias is added to a ScaledDot score only")
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-device attention is not ported yet (ROADMAP A16)")
    fwd, bwd, slot_map = _packs(graph, "att")
    n = graph.num_nodes
    heads = h_heads.shape[1]
    v = values if values is not None else h_heads
    dv = v.shape[-1]
    if node_scores is not None:
        alpha = packed_node_scores(*node_scores, fwd, bwd, slot_map)
        if score_transform is not None:
            alpha = score_transform(alpha)
    else:
        k = keys if keys is not None else h_heads
        if isinstance(score_fn, ScaledDot):
            alpha = packed_scaled_dot(h_heads, k, fwd, bwd, slot_map,
                                      score_fn.scale)    # [NC, C, H]
            if score_bias is not None:
                alpha = alpha + score_bias / score_fn.scale
        else:
            alpha = score_fn(take_padded(h_heads, pack_rows(fwd)),
                             take_padded(k, fwd.senders))
    # masked to the slots of nonzero pack weight: padding slots have
    # local row 0, so their rows name a real row
    alpha = packed_segment_softmax(alpha.reshape(
        fwd.senders.shape + (heads,)), fwd)
    if dropout_rate > 0.0 and generator is not None:
        keep = remat.keep_draw(alpha.shape, 1.0 - dropout_rate, generator,
                         alpha.device)
        alpha = torch.where(keep, alpha / (1.0 - dropout_rate), 0.0)
    out = segment_matmul_headed_vjp(v.reshape(n, heads * dv), alpha, fwd,
                                    bwd, slot_map)
    return out.view(n, heads, dv)


class ScaledDot:
    """The score sum(q_i * k_j) / scale over the last axis.
    ``packed_attention`` recognises it and computes it on the packs."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, q_i: torch.Tensor, k_j: torch.Tensor) -> torch.Tensor:
        return (q_i * k_j).sum(-1) / self.scale


def check_heads(layer: str, dim_out: int, heads: int) -> None:
    """The JAX attention layers assert dim_out % heads == 0
    (layers.py:361,440; id_layers.py:203,276; att_layers.py:55,94):
    their non-packed branches run only without an 'att' pack or with
    split_value_heads False, which no config sets."""
    if heads < 1 or dim_out % heads != 0:
        raise ValueError(f"{layer}: {heads} attention heads do not divide "
                         f"the width {dim_out}")


def scaled_dot(dh: int, dtype: torch.dtype) -> ScaledDot:
    """score(q_i, k_j) = sum(q_i * k_j) / sqrt(dh), the scale rounded
    to the input dtype as in the JAX package (layers.py:454)."""
    return ScaledDot(torch.sqrt(torch.tensor(float(dh), dtype=dtype)).item())


class TfgGATConv(nn.Module):
    """tf_geometric-style multi-head dot-product attention GAT
    (layers.py:415-499; reference TfgIDLayer.py:269-388 ``gat_id``
    without the identity kernel):

      Q = relu(x Wq + bq),  K = relu(x Wk + bk),  V = x Wv
      score = sum_h(Q_h[i] * K_h[j]) / sqrt(d_h);  alpha = edge softmax
      h = per-head alpha-weighted sum of V_h[j], heads concatenated

    The packed branch, as in the JAX package: value heads split (dim_out
    divisible by heads, else ValueError as the JAX layer asserts),
    attention width dim_out, relu on Q and K (the JAX layer's defaults,
    which no model overrides)."""

    has_id_kernel = False

    def __init__(self, dim_in: int, dim_out: int, heads: int = 1,
                 use_bias: bool = True, att_dropout: float = 0.0, *,
                 generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_heads(type(self).__name__, dim_out, heads)
        if att_dropout > 0 and dropout_generator is None:
            raise ValueError("att_dropout > 0 needs a dropout_generator")
        self.heads = heads
        self.att_dropout = att_dropout
        self.dropout_generator = dropout_generator
        self.query_kernel = glorot((dim_in, dim_out), generator)
        self.query_bias = zeros((dim_out,))
        self.key_kernel = glorot((dim_in, dim_out), generator)
        self.key_bias = zeros((dim_out,))
        self.kernel = glorot((dim_in, dim_out), generator)
        if self.has_id_kernel:
            self.id_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def values(self, graph: GraphBatch) -> torch.Tensor:
        return mm(graph.node_feat, self.kernel)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        n, dim_out = x.shape[0], self.kernel.shape[1]
        dh = dim_out // self.heads
        q = torch.relu(mm(x, self.query_kernel) + self.query_bias)
        k = torch.relu(mm(x, self.key_kernel) + self.key_bias)
        v = self.values(graph)
        out = packed_attention(
            graph, q.view(n, self.heads, dh), scaled_dot(dh, x.dtype),
            values=v.view(n, self.heads, dh),
            keys=k.view(n, self.heads, dh),
            dropout_rate=self.att_dropout if self.training else 0.0,
            generator=self.dropout_generator).reshape(n, dim_out)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GATConv(nn.Module):
    """PyG-style additive-attention GAT (layers.py:336-412; reference
    layer.py:155-162):

      h = x W (heads of dim_out / H columns)
      e_ij = leakyrelu(a_l . h_i + a_r . h_j), alpha = edge softmax
      out_i = sum_j alpha_ij h_j, heads concatenated; + b

    The score decomposes per endpoint, so only the [N, H] node scores
    are gathered per slot (``packed_attention``'s node_scores branch,
    the JAX layer's packed branch): self-loops are those of the 'att'
    pack, one per real node.  Heads that do not divide dim_out raise
    ValueError, as the JAX layer asserts.  The layer type 'gaddconv'
    (GeneralAddAttConv, graphgym_tpu/nn/att_layers.py:41-79: the same
    parameters, score and 'att' edges) is this class without attention
    dropout."""

    has_id_kernel = False

    def __init__(self, dim_in: int, dim_out: int, heads: int = 1,
                 use_bias: bool = False, negative_slope: float = 0.2,
                 att_dropout: float = 0.0, *, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_heads(type(self).__name__, dim_out, heads)
        if att_dropout > 0 and dropout_generator is None:
            raise ValueError("att_dropout > 0 needs a dropout_generator")
        self.heads = heads
        self.negative_slope = negative_slope
        self.att_dropout = att_dropout
        self.dropout_generator = dropout_generator
        per_head = dim_out // heads
        self.kernel = glorot((dim_in, dim_out), generator)
        if self.has_id_kernel:
            self.id_kernel = glorot((dim_in, dim_out), generator)
        self.att = glorot((1, heads, 2 * per_head), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def project(self, graph: GraphBatch) -> torch.Tensor:
        return mm(graph.node_feat, self.kernel)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = self.project(graph)
        n, dim_out = h.shape
        per_head = dim_out // self.heads
        h = h.view(n, self.heads, per_head)
        s_dst = (h * self.att[:, :, :per_head]).sum(-1)     # [N, H]
        s_src = (h * self.att[:, :, per_head:]).sum(-1)
        out = packed_attention(
            graph, h, node_scores=(s_dst, s_src),
            score_transform=functools.partial(
                F.leaky_relu, negative_slope=self.negative_slope),
            dropout_rate=self.att_dropout if self.training else 0.0,
            generator=self.dropout_generator).reshape(n, dim_out)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GCNConv(nn.Module):
    """GCN with the renormalization trick: h = D^-1/2 (A+I) D^-1/2 (x W)
    + b (layers.py:266-293; reference layer.py:135-142,
    TfgIDLayer.py:478-525 without the id kernel), on the 'gcn' pack;
    ``improved`` (self-loops of weight 2, set by no config) on the
    'gcn_improved' pack."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 improved: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.kind = "gcn_improved" if improved else "gcn"
        self.kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = packed_spmm(graph, self.kind, mm(graph.node_feat, self.kernel),
                        coo_dtype=self.kind != "gcn")
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation over the 'mean' pack
    (layers.py:296-333).  combine='concat' is tfg MeanGraphSage
    (TfgIDLayer.py:86-120): h = [x W_self || mean_nb(x) W_nb];
    combine='sum' is pyg SAGEConv (reference layer.py:145-152):
    h = x W_self + mean_nb(x) W_nb."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 combine: str = "sum", *, generator: torch.Generator):
        super().__init__()
        if combine not in ("sum", "concat"):
            raise ValueError(f"SAGEConv combine {combine!r}")
        if combine == "concat" and dim_out % 2:
            raise ValueError("SAGEConv concat needs an even dim_out (tfg: "
                             "'units must be an even number if concat is "
                             "True')")
        self.combine = combine
        d = dim_out // 2 if combine == "concat" else dim_out
        self.self_kernel = glorot((dim_in, d), generator)
        self.neighbor_kernel = glorot((dim_in, d), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h_nb = mm(packed_spmm(graph, "mean", x), self.neighbor_kernel)
        h_self = mm(x, self.self_kernel)
        h = (torch.cat([h_self, h_nb], -1) if self.combine == "concat"
             else h_self + h_nb)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class GeneralConv(nn.Module):
    """GraphGym's configurable conv (layers.py:606-652; reference
    contrib/layer/generalconv.py:12-114), the default gnn.layer_type:

      h = x W;  h_msg = agg over receivers of w * h[senders] (+ b)
      self_msg 'none': h_msg;  'add': h_msg + h;  'concat': h_msg + x W_self

    w is the edge weight, or the GCN sym-norm weight with self-loops if
    normalize_adj; agg is 'add', 'mean' or 'max' (``packed_aggregate``),
    taken after the projection, at dim_out.  The JAX layer's
    ``improved`` is set by no config (as in ``gcn_norm``)."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 agg: str = "add", self_msg: str = "concat",
                 normalize_adj: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        if self_msg not in ("none", "add", "concat"):
            raise ValueError(f"self_msg {self_msg} not defined")
        self.kind = agg_kind(agg, normalize_adj)
        self.agg, self.self_msg = agg, self_msg
        self.normalize_adj = normalize_adj
        self.kernel = glorot((dim_in, dim_out), generator)
        if self_msg == "concat":
            self.self_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h = mm(x, self.kernel)
        out = packed_aggregate(graph, h, self.agg, self.kind)
        if self.bias is not None:
            out = out + self.bias
        if self.self_msg == "add":
            out = out + h
        elif self.self_msg == "concat":
            out = out + mm(x, self.self_kernel)
        return graph.replace(node_feat=out)


# ------------------------------------------------------- per-edge messages
#
# The edge-feature convs build a message per batch edge [E, D] (edge
# order: the edge features need no gather) from per-edge node rows,
# gathered by K1 on the 'edge_src' / 'edge_dst' gather packs, and reduce
# it over the receivers on the 'edge' pack (graphs/packing.py): K2 sums
# the messages [E, D] in place, in the order of the pack's index of the
# edges (by receiver, then edge order), the softmax runs on the pack's
# rows (``permute_rows`` moves the logits into its slot order and the
# weights back), and the segmented max reads the messages through the
# pack's layout.  K2 leaves the padding edges out, and every message is
# masked by its edge's validity first.


def edge_feat_of(graph: GraphBatch, layer: str) -> torch.Tensor:
    if graph.edge_feat is None:
        raise ValueError(f"{layer} needs edge features, and the batch has "
                         "none")
    return graph.edge_feat


def edge_valid(graph: GraphBatch) -> torch.Tensor:
    """[E] bool: the real edges (edge weight != 0, the 'edge' pack's
    weights)."""
    return graph.edge_weight != 0


def gather_nodes(graph: GraphBatch, kind: str,
                 x: torch.Tensor) -> torch.Tensor:
    """x[senders] ('edge_src') or x[receivers] ('edge_dst') per edge,
    0 on padding edges: K1 on the gather pack, its gradient K1 on the
    transpose (a node's edges in edge order)."""
    fwd, bwd = _packs(graph, kind)
    return spmm_pack_vjp(fwd, bwd, x)


def edge_sum(graph: GraphBatch, msg: torch.Tensor) -> torch.Tensor:
    """[N, D]: the sum over each receiver's real edges of msg [E, D]
    (masked by the caller: the padding edges' messages are zeros, which
    the sum leaves out), K2 on the 'edge' entry's index of the edges,
    reading msg in place; its gradient the gather d_msg[e] =
    g[receiver(e)], 0 on a padding edge."""
    _, slots = _packs(graph, EDGE)
    return segment_sum_vjp(msg, edge_index(slots), slots.edge_row,
                           graph.num_nodes, EDGE)


def edge_count(graph: GraphBatch, weight: torch.Tensor) -> torch.Tensor:
    """[N] f32: the sum of the per-edge ``weight`` [E] over each
    receiver's real edges (the live in-edge count for a 0/1 weight), K2
    at width 1; no gradient."""
    _, slots = _packs(graph, EDGE)
    with torch.no_grad():
        return segment_sum_vjp(weight.float()[:, None], edge_index(slots),
                               slots.edge_row, graph.num_nodes, EDGE)[:, 0]


def edge_max(graph: GraphBatch, msg: torch.Tensor,
             live: torch.Tensor) -> torch.Tensor:
    """[N, D]: the max over each receiver's edges of msg [E, D] among
    the ``live`` [E] ones, 0 where none (segment_max with a mask,
    graphgym_tpu/ops/segment.py:50-60): the segmented max on the 'edge'
    pack's layout with each slot's edge as its sender and the slot's
    liveness as its weight, its backward on the 'edge_dst' fwd pack
    (each edge's one slot reading its receiver; the caller's mask zeroes
    what a dead edge's message gets there)."""
    return packed_max_vjp(*edge_max_packs(graph, live), msg)


def edge_max_packs(graph: GraphBatch, live: torch.Tensor) -> tuple:
    """``edge_max``'s (fwd, bwd) packs for the ``live`` [E] edges."""
    fwd, slots = _packs(graph, EDGE)
    weights = take_padded(live.float(), slots.slot_edge)
    return (fwd._replace(senders=slots.slot_edge, weights=weights),
            _packs(graph, EDGE_DST)[0])


def edge_softmax(graph: GraphBatch, logits: torch.Tensor) -> torch.Tensor:
    """[E, H]: the softmax of per-edge logits [E, H] over each
    receiver's real edges, in edge order: the logits moved into the
    'edge' pack's slot order (``permute_rows``), ``packed_segment_softmax``
    on the pack (K3 row sums, no atomics), the weights moved back."""
    fwd, slots = _packs(graph, EDGE)
    in_slots = permute_rows(logits, slots.slot_edge, slots.edge_slot)
    alpha = packed_segment_softmax(in_slots.reshape(
        fwd.senders.shape + logits.shape[1:]), fwd)
    return permute_rows(alpha.reshape(-1, logits.shape[1]),
                        slots.edge_slot, slots.slot_edge.reshape(-1))


def edge_aggregate(graph: GraphBatch, msg: torch.Tensor, agg: str,
                   live: torch.Tensor,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 'add', 'mean' or 'max' of the masked per-edge msg over the
    receivers: mean is the sum over the live edges' count (at least 1,
    segment_mean's), ``count`` where the caller has it."""
    if agg == "max":
        return edge_max(graph, msg, live)
    out = edge_sum(graph, msg)
    if agg == "mean":
        if count is None:
            count = edge_count(graph, live)
        out = out / count.clamp_min(1.0)[:, None]
    return out


def check_self_msg(self_msg: str) -> None:
    if self_msg not in ("none", "add", "concat"):
        raise ValueError(f"self_msg {self_msg} not defined")


class SplineConv(nn.Module):
    """Linear B-spline conv over 1-D edge pseudo-coordinates, kernel size
    2 (layers.py:573-604; reference layer.py:177-186): u = clip(e[:, 0],
    0, 1), msg_e = (1 - u) (x W_0)[s] + u (x W_1)[s], out_i = sum of
    msg_e over i's edges + x W_root (+ b).  The two projections are
    gathered as one [N, 2 D] row on 'edge_src'; the sum is K2.  Where an
    edge encoder feeds edge_feat, u carries its gradient to the
    tables."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel0 = glorot((dim_in, dim_out), generator)
        self.kernel1 = glorot((dim_in, dim_out), generator)
        self.root_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        u = edge_feat_of(graph, "splineconv")[:, 0].clamp(0.0, 1.0)
        d = self.kernel0.shape[1]
        h = gather_nodes(graph, EDGE_SRC, torch.cat(
            [mm(x, self.kernel0), mm(x, self.kernel1)], -1))
        msg = h[:, :d] * (1 - u)[:, None] + h[:, d:] * u[:, None]
        msg = torch.where(edge_valid(graph)[:, None], msg, 0.0)
        out = edge_sum(graph, msg) + mm(x, self.root_kernel)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GeneralEdgeConv(nn.Module):
    """GeneralConv with edge features in the message (layers.py:655-730;
    reference contrib/layer/generalconv.py:117-218):

      msg_e = [x_j, e] W_msg, or [x_i, x_j, e] W_msg with msg_direction
      'both'; with normalize_adj times dis[i] dis[j], dis the inverse
      square root of the live in-degree (no self-loops);
      h = agg over receivers ('add', 'mean', 'max') (+ b);
      self_msg 'none': h; 'add': x + h (where the widths agree); 'concat':
      x W_self + h.

    ``sample_rate`` < 1 is generalsampleedgeconv (reference layer.py:
    210-221): in train mode each call keeps each edge with that
    probability, a draw of ``generator``, and the degree, the mean's
    count and the max follow the kept edges; eval mode keeps every edge.
    x_j and x_i are K1 on the gather packs, the sum K2, the count and
    degree K2 at width 1, the max the segmented max (``edge_kinds``)."""

    def __init__(self, dim_in: int, dim_out: int, dim_edge: int,
                 use_bias: bool = False, agg: str = "add",
                 self_msg: str = "concat", normalize_adj: bool = False,
                 msg_direction: str = "single", sample_rate: float = 1.0,
                 *, generator: torch.Generator,
                 sample_generator: Optional[torch.Generator] = None):
        super().__init__()
        check_self_msg(self_msg)
        edge_kinds("generaledgeconv", agg, msg_direction)
        if sample_rate < 1.0 and sample_generator is None:
            raise ValueError("sample_rate < 1 needs a sample_generator")
        self.agg, self.self_msg = agg, self_msg
        self.normalize_adj, self.msg_direction = normalize_adj, msg_direction
        self.sample_rate = sample_rate
        self.sample_generator = sample_generator
        feat = dim_in * (2 if msg_direction == "both" else 1) + dim_edge
        self.msg_kernel = glorot((feat, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None
        if self_msg == "concat":
            self.self_kernel = glorot((dim_in, dim_out), generator)

    def live_edges(self, graph: GraphBatch) -> torch.Tensor:
        live = edge_valid(graph)
        if self.sample_rate < 1.0 and self.training:
            keep = remat.keep_draw(live.shape, self.sample_rate,
                             self.sample_generator, live.device)
            live = live & keep
        return live

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        e = edge_feat_of(graph, "GeneralEdgeConv")
        live = self.live_edges(graph)
        x_j = gather_nodes(graph, EDGE_SRC, x)
        if self.msg_direction == "both":
            feat = torch.cat([gather_nodes(graph, EDGE_DST, x), x_j, e], -1)
        else:
            feat = torch.cat([x_j, e], -1)
        msg = mm(feat, self.msg_kernel)
        count = None
        if self.normalize_adj or self.agg == "mean":
            count = edge_count(graph, live)
        if self.normalize_adj:
            dis = inv_sqrt_degree(count)
            msg = msg * (dis.index_select(0, graph.receivers)
                         * dis.index_select(0, graph.senders))[:, None]
        msg = torch.where(live[:, None], msg, 0.0)
        out = edge_aggregate(graph, msg, self.agg, live, count)
        if self.bias is not None:
            out = out + self.bias
        if self.self_msg == "add" and x.shape[-1] == out.shape[-1]:
            out = x + out
        elif self.self_msg == "concat":
            out = mm(x, self.self_kernel) + out
        return graph.replace(node_feat=out)


def gin_mlp_init(mod: nn.Module, prefix: str, dim_in: int, dim_out: int,
                 with_bn: bool, generator: torch.Generator,
                 gain: float = 1.0) -> None:
    """Register the GIN MLP's parameters on ``mod`` under the flax
    names: <prefix>_kernel1/_bias1/_kernel2/_bias2 (kernels drawn at
    ``gain``: LINEAR_GAIN for the torch path's ginconv, whose MLP is
    nn.Linear, layers.py:551-562) and, with BN, the submodule
    <prefix>_bn (its eps and momentum are the JAX layer's defaults, not
    cfg.bn's, as at layers.py:568)."""
    setattr(mod, f"{prefix}_kernel1",
            glorot((dim_in, dim_out), generator, gain))
    setattr(mod, f"{prefix}_bias1", zeros((dim_out,)))
    setattr(mod, f"{prefix}_kernel2",
            glorot((dim_out, dim_out), generator, gain))
    setattr(mod, f"{prefix}_bias2", zeros((dim_out,)))
    if with_bn:
        setattr(mod, f"{prefix}_bn", MaskedBatchNorm(dim_out))


def _gin_mlp(mod: nn.Module, prefix: str, h: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The 2-layer GIN MLP (layers.py:551-570): Dense -> ReLU -> Dense,
    then BN over the ``mask`` rows -> ReLU when <prefix>_bn exists (the
    Tfg variant, reference main_zd.py:181-186).  Its weight names
    contain 'kernel', so the Tfg L2 term covers them."""
    def p(name):
        return getattr(mod, f"{prefix}_{name}")
    h = torch.relu(mm(h, p("kernel1")) + p("bias1"))
    h = mm(h, p("kernel2")) + p("bias2")
    bn = getattr(mod, f"{prefix}_bn", None)
    if bn is not None:
        h = torch.relu(bn(h, mask))
    return h


class GINConv(nn.Module):
    """GIN: h = MLP((1 + eps) x + agg_neighbors x) (layers.py:502-548;
    reference layer.py:165-174, TfgIDLayer.py:123-167), with eps = 0
    (the JAX layer's default, which no model changes).  ``agg`` is
    cfg.gnn.gin_agg, the JAX layer's ablation switch, each on K1 over
    the pack ``gin_kind`` names: 'sum' the 'plain' pack, 'gcn' the
    'gcn' pack (D^-1/2 (A + I) D^-1/2), 'gcn_noself' the 'gcn_noself'
    pack, 'mean' the 'wmean' pack (the sum over max(the weighted
    in-degree, 1), the JAX layer's COO SpMM and division)."""

    def __init__(self, dim_in: int, dim_out: int, mlp_bn: bool = False,
                 agg: str = "sum", mlp_gain: float = 1.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.kind = gin_kind(agg)
        gin_mlp_init(self, "mlp", dim_in, dim_out, mlp_bn, generator,
                     mlp_gain)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h = x + packed_spmm(graph, self.kind, x,
                            coo_dtype=self.kind != "plain")
        return graph.replace(node_feat=_gin_mlp(self, "mlp", h,
                                                graph.node_mask))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout in train mode: each entry kept with probability
    1 - rate, from a uniform draw of ``generator``, and scaled by 1 /
    (1 - rate); dropped entries are 0."""
    keep = remat.keep_draw(x.shape, 1.0 - rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


class GeneralLayer(nn.Module):
    """conv + BatchNorm + dropout + act wrapper
    (graphgym_tpu/nn/layers.py:204-234; reference layer.py:16-47):
    ``layer``, then ``bn`` (MaskedBatchNorm over the real nodes), then
    dropout (train mode only, masks from ``dropout_generator``), then
    the activation (act ``prelu`` is the learnable ``PReLU`` module
    ``act``).  The JAX wrapper's own L2 norm is set by no caller: the
    stages apply theirs.  The Tfg path's wrapper is a conv and its
    activation.  ``remat`` (cfg.tpu.remat on the MP stage's layers)
    recomputes the layer's activations in the backward of a train-mode
    step (nn/remat.py), the same function to the bit."""

    def __init__(self, layer: nn.Module, dim_out: Optional[int] = None,
                 has_act: bool = True, has_bn: bool = False,
                 dropout: float = 0.0, act: str = "relu",
                 bn_eps: float = 1e-5, bn_mom: float = 0.1,
                 dropout_generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if dropout > 0 and dropout_generator is None:
            raise ValueError("dropout > 0 needs a dropout_generator")
        self.remat = remat
        self.layer = layer
        self.bn = (MaskedBatchNorm(dim_out, eps=bn_eps, momentum=bn_mom)
                   if has_bn else None)
        self.dropout = dropout
        self.dropout_generator = dropout_generator
        if has_act and act == "prelu":
            self.act = PReLU()
        else:
            self.act = act_dict[act] if has_act else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        if self.remat and self.training and torch.is_grad_enabled():
            return remat.checkpoint(self, self._forward, graph)
        return self._forward(graph)

    def _forward(self, graph: GraphBatch) -> GraphBatch:
        graph = self.layer(graph)
        x = graph.node_feat
        if self.bn is not None:
            x = self.bn(x, graph.node_mask)
        if self.dropout > 0 and self.training:
            x = dropout(x, self.dropout, self.dropout_generator)
        if self.act is not None:
            x = self.act(x)
        return graph.replace(node_feat=x)


class Linear(nn.Module):
    """Linear layer on node features (graphgym_tpu/nn/layers.py:183-201;
    reference layer.py:72-82), its kernel drawn at LINEAR_GAIN."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel = glorot((dim_in, dim_out), generator, LINEAR_GAIN)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = mm(graph.node_feat, self.kernel)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class MLP(nn.Module):
    """MLP on node features (graphgym_tpu/nn/layers.py:237-259;
    reference layer.py:109-132): num_layers - 1 hidden Linear + BN +
    act blocks (width ``dim_inner``, else the input's), then a plain
    Linear; no dropout, as no caller of the JAX MLP sets it.
    ``layers`` holds them all, each a GeneralLayer around its Linear
    (the last with no BN or act), as flax names them: ``Linear_<j>``
    and ``GeneralLayer_<j>``."""

    def __init__(self, dim_in: int, dim_out: int, num_layers: int = 2,
                 dim_inner: Optional[int] = None, use_bias: bool = True,
                 act: str = "relu", *, generator: torch.Generator):
        super().__init__()
        layers = []
        for _ in range(num_layers - 1):
            d = dim_inner if dim_inner is not None else dim_in
            layers.append(GeneralLayer(
                Linear(dim_in, d, generator=generator), d, has_act=True,
                has_bn=True, act=act))
            dim_in = d
        layers.append(GeneralLayer(
            Linear(dim_in, dim_out, use_bias=use_bias, generator=generator),
            has_act=False))
        self.layers = nn.ModuleList(layers)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        for layer in self.layers:
            graph = layer(graph)
        return graph
