"""Layers of graphgym_tpu/nn/att_layers.py on the port's packed path.

  * ``GeneralMulAttConv`` (att_layers.py:82-115, layer type 'gmulconv'):
    dot-product attention with a per-head score bias, on the 'att' pack
    (the SDDMM for the score, K3 for the aggregation);
  * ``GeneralConvV2`` (att_layers.py:184-226, 'generalconv_v2'):
    GeneralConv with the message flow and the directed norm, on the
    ``v2_kind`` packs;
  * ``SAGEInitConv`` (att_layers.py:228-251, 'sageinitconv'): [x ||
    mean_nb(x)] W + b on the 'mean' pack;
  * ``ExampleConv`` (att_layers.py:313-330), the layer class of the
    contrib example ('contrib_example') and of 'exampleconv1' /
    'exampleconv2';
  * ``APPNP`` (att_layers.py:333-363), the block of the Tfg APPNP model
    ('Tfg-appnp'), on the 'gcn' pack.

  * ``GeneralEdgeAttConv`` (att_layers.py:118-183, 'generaledgeattconvv1'
    / 'generaledgeattconvv2'): attention over each receiver's edges of
    a message from [x_j (, x_i), e], on the 'edge' pack;
  * ``GeneralOGBConv`` (att_layers.py:253-312, 'generalogbconv'): the
    bond tables' embeddings of the integer edge features added to the
    gathered x_j W, on the 'edge' and 'edge_bond' packs.

The additive attention 'gaddconv' (GeneralAddAttConv, att_layers.py:
41-79) is layers.GATConv without attention dropout.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import (BOND_FEATURE_DIMS, EDGE_BOND,
                                               EDGE_DST, EDGE_SRC,
                                               edge_kinds, v2_kind)
from graphgym_tpu_torch.nn.encoders import EmbedSumFn, embed_pack
from graphgym_tpu_torch.nn.layers import (GeneralConv, check_heads,
                                          check_self_msg, edge_aggregate,
                                          edge_count, edge_feat_of,
                                          edge_softmax, edge_sum,
                                          edge_valid, gather_nodes, glorot,
                                          packed_attention, packed_spmm,
                                          scaled_dot, zeros)
from graphgym_tpu_torch.nn.norm import MaskedBatchNorm, l2_normalize
from graphgym_tpu_torch.ops.sparse import inv_sqrt_degree, mm


class GeneralMulAttConv(nn.Module):
    """Dot-product attention (reference attconv.py:115-214):

      h = x W (heads of dim_out / H columns)
      alpha = edge softmax of (h_i . h_j + att_bias) / sqrt(dim_out / H)
      out_i = sum_j alpha_ij h_j, heads concatenated; + b

    over the 'att' pack (A plus a self-loop on each real node).  The
    score is ``packed_attention``'s ScaledDot on the packs with the bias
    added as att_bias / sqrt(d), which differs from the JAX layer's
    (dot + att_bias) / sqrt(d) by rounding only.  No attention dropout:
    the JAX make_conv sets none for this layer type."""

    def __init__(self, dim_in: int, dim_out: int, heads: int = 1,
                 use_bias: bool = False, *, generator: torch.Generator):
        super().__init__()
        check_heads(type(self).__name__, dim_out, heads)
        self.heads = heads
        self.kernel = glorot((dim_in, dim_out), generator)
        self.att_bias = zeros((1, heads))
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = mm(graph.node_feat, self.kernel)
        n, dim_out = h.shape
        per_head = dim_out // self.heads
        out = packed_attention(
            graph, h.view(n, self.heads, per_head),
            scaled_dot(per_head, h.dtype),
            score_bias=self.att_bias[0]).reshape(n, dim_out)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GeneralConvV2(GeneralConv):
    """GeneralConv with the message flow and the directed norm
    (reference contrib/layer/generalconv_v2.py:12-242): flow
    'target_to_source' swaps senders and receivers; normalize_adj
    divides each edge weight by its receiver's weighted in-degree, no
    self-loops (D^-1 A, where v1 takes the symmetric GCN norm).  The
    aggregation runs on the pack ``v2_kind`` names for agg,
    normalize_adj and flow; the rest is GeneralConv's."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 agg: str = "add", self_msg: str = "concat",
                 normalize_adj: bool = False,
                 flow: str = "source_to_target", *,
                 generator: torch.Generator):
        super().__init__(dim_in, dim_out, use_bias=use_bias, agg=agg,
                         self_msg=self_msg, normalize_adj=normalize_adj,
                         generator=generator)
        self.flow = flow
        self.kind = v2_kind(agg, normalize_adj, flow)


class SAGEInitConv(nn.Module):
    """SAGE with glorot init and the concatenated self update (reference
    sageinitconv.py:12-115): h = [x || mean_nb(x)] W + b, then with
    ``normalize`` the L2 norm of each row (``l2_normalize``, its sum of
    squares clamped: ROADMAP C5).  The mean over the real in-edges is
    K1 on the 'mean' pack at the input width.  The JAX make_conv builds
    it with its defaults (a bias, no normalize)."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = True,
                 normalize: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.normalize = normalize
        self.kernel = glorot((2 * dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h = mm(torch.cat([x, packed_spmm(graph, "mean", x, coo_dtype=True)],
                         -1), self.kernel)
        if self.bias is not None:
            h = h + self.bias
        if self.normalize:
            h = l2_normalize(h)
        return graph.replace(node_feat=h)


class ExampleConv(nn.Module):
    """Contrib extension example (reference contrib/layer/example.py:
    16-122): h = x W, out = h + sum over in-edges of w * h[sender] (+
    b), the sum K1 on the 'plain' pack."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = mm(graph.node_feat, self.kernel)
        out = h + packed_spmm(graph, "plain", h, coo_dtype=True)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class APPNP(nn.Module):
    """APPNP propagation (reference Tfg zoo, main_zd.py:245-257 via
    tfg.layers.APPNP): h0 = MLP(x), Dense layers of widths ``dims``
    (``kernel<i>``, ``bias<i>``, ReLU between them); then
    ``num_iterations`` times h <- (1 - alpha) Anorm h + alpha h0, Anorm
    = D^-1/2 (A + I) D^-1/2 with self-loops on the real nodes: K1 on the
    'gcn' pack at the last width, and its backward on the transpose."""

    def __init__(self, dim_in: int, dims: Sequence[int], alpha: float = 0.1,
                 num_iterations: int = 10, *, generator: torch.Generator):
        super().__init__()
        self.alpha, self.num_iterations = alpha, num_iterations
        self.depth = len(dims)
        for i, d in enumerate(dims):
            setattr(self, f"kernel{i}", glorot((dim_in, d), generator))
            setattr(self, f"bias{i}", zeros((d,)))
            dim_in = d

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = graph.node_feat
        for i in range(self.depth):
            h = mm(h, getattr(self, f"kernel{i}")) + getattr(self, f"bias{i}")
            if i < self.depth - 1:
                h = torch.relu(h)
        h0 = h
        for _ in range(self.num_iterations):
            h = ((1 - self.alpha) * packed_spmm(graph, "gcn", h,
                                                coo_dtype=True)
                 + self.alpha * h0)
        return graph.replace(node_feat=h)


class GeneralEdgeAttConv(nn.Module):
    """Edge-feature attention conv (att_layers.py:118-183; reference
    attconv.py:243-375 v1 and :378+ v2):

      feat_e = [x_j, e], or [x_i, x_j, e] with msg_direction 'both'
      msg_e = feat_e W_msg, heads of dim_out / H columns
      score: v1 sum(msg_e * w_att) per head, v2 feat_e W_key;
      alpha = softmax of leakyrelu(score, 0.2) over each receiver's real
      edges (no self-loops: a receiver with none gets a zero row)
      out_i = sum_e alpha_e msg_e, heads concatenated; then with
      final_linear out W_final, with final_linear_bn the masked BN
      ``final_bn``; + b.

    x_j and x_i are K1 on the gather packs, the softmax's row sums K3
    on the 'edge' pack, the sum K2.  No attention dropout: the JAX
    make_conv sets none for these layer types."""

    def __init__(self, dim_in: int, dim_out: int, dim_edge: int,
                 heads: int = 1, use_bias: bool = False,
                 msg_direction: str = "single", final_linear: bool = False,
                 final_linear_bn: bool = False, version: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        check_heads(type(self).__name__, dim_out, heads)
        edge_kinds("generaledgeattconvv1", "add", msg_direction)
        if version not in (1, 2):
            raise ValueError(f"GeneralEdgeAttConv version {version}")
        self.heads, self.version = heads, version
        self.msg_direction = msg_direction
        feat = dim_in * (2 if msg_direction == "both" else 1) + dim_edge
        self.msg_kernel = glorot((feat, dim_out), generator)
        if version == 1:
            self.att_kernel = glorot((1, heads, dim_out // heads), generator)
        else:
            self.key_kernel = glorot((feat, heads), generator)
        if final_linear:
            self.final_kernel = glorot((dim_out, dim_out), generator)
        if final_linear_bn:
            self.final_bn = MaskedBatchNorm(dim_out)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        e = edge_feat_of(graph, "edge attention conv")
        dim_out = self.msg_kernel.shape[1]
        x_j = gather_nodes(graph, EDGE_SRC, x)
        if self.msg_direction == "both":
            feat = torch.cat([gather_nodes(graph, EDGE_DST, x), x_j, e], -1)
        else:
            feat = torch.cat([x_j, e], -1)
        msg = mm(feat, self.msg_kernel).view(-1, self.heads,
                                            dim_out // self.heads)
        if self.version == 1:
            score = (msg * self.att_kernel).sum(-1)
        else:
            score = mm(feat, self.key_kernel)
        alpha = edge_softmax(graph, F.leaky_relu(score, 0.2))   # [E, H]
        msg = torch.where(edge_valid(graph)[:, None, None], msg, 0.0)
        out = edge_sum(graph, (msg * alpha[..., None]).view(-1, dim_out))
        if hasattr(self, "final_kernel"):
            out = mm(out, self.final_kernel)
        if hasattr(self, "final_bn"):
            out = self.final_bn(out, graph.node_mask)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GeneralOGBConv(nn.Module):
    """OGB bond-encoder conv (att_layers.py:253-312; reference contrib/
    layer/generalconv_ogb.py:38-127):

      emb_e = sum over the first min(3, columns) edge feature columns c
      of bond_emb<c>[e[:, c]] (``BOND_FEATURE_DIMS`` rows; an id outside
      its table gives a NaN row, as jnp.take does)
      msg_e = w_e ((x W)[s] + emb_e), w the edge weight, or with
      normalize_adj the GCN weight of the edge (degrees with a self-loop
      on each real node; the loops' messages are dropped)
      h = agg over receivers (+ b); self_msg as GeneralConv's.

    (x W)[s] is K1 on 'edge_src'; the lookup reads the 'edge_bond'
    embedding pack, the tables' gradient K2 on it; the sum and the
    degrees K2 on the 'edge' pack.  The ids are the raw edge features'
    (the pack is built from them), so no edge encoder may run ahead of
    this layer."""

    def __init__(self, dim_in: int, dim_out: int, dim_edge: int,
                 use_bias: bool = False, agg: str = "add",
                 self_msg: str = "concat", normalize_adj: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        check_self_msg(self_msg)
        edge_kinds("generalogbconv", agg)
        self.agg, self.self_msg = agg, self_msg
        self.normalize_adj = normalize_adj
        self.kernel = glorot((dim_in, dim_out), generator)
        self.num_tables = min(len(BOND_FEATURE_DIMS), dim_edge)
        for i in range(self.num_tables):
            setattr(self, f"bond_emb{i}",
                    glorot((BOND_FEATURE_DIMS[i], dim_out), generator))
        if self_msg == "concat":
            self.self_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        if graph.edge_feat is None:
            raise ValueError("generalogbconv needs integer edge features, "
                             "and the batch has none")
        pack = embed_pack(graph, EDGE_BOND)
        if pack.rows.shape[1] != self.num_tables:
            raise ValueError(f"generalogbconv: {self.num_tables} bond "
                             f"tables, the batch's pack {pack.rows.shape[1]}"
                             " columns")
        table = torch.cat([getattr(self, f"bond_emb{i}")
                           for i in range(self.num_tables)])
        emb = EmbedSumFn.apply(table, pack, EDGE_BOND)
        h = mm(x, self.kernel)
        w = graph.edge_weight
        if self.normalize_adj:
            deg = edge_count(graph, w) + graph.node_mask.float()
            dis = inv_sqrt_degree(deg)
            w = (dis.index_select(0, graph.receivers) * w
                 * dis.index_select(0, graph.senders))
        msg = (gather_nodes(graph, EDGE_SRC, h) + emb) * w[:, None]
        live = edge_valid(graph)
        msg = torch.where(live[:, None], msg, 0.0)
        out = edge_aggregate(graph, msg, self.agg, live)
        if self.bias is not None:
            out = out + self.bias
        if self.self_msg == "add":
            out = out + h
        elif self.self_msg == "concat":
            out = out + mm(x, self.self_kernel)
        return graph.replace(node_feat=out)
