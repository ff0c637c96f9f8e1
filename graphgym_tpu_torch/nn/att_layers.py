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

The additive attention 'gaddconv' (GeneralAddAttConv, att_layers.py:
41-79) is layers.GATConv without attention dropout.  The edge-feature
convs (GeneralEdgeAttConv, GeneralOGBConv) wait for the loaders that
give edge features (ROADMAP A10b, A13c).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import v2_kind
from graphgym_tpu_torch.nn.layers import (GeneralConv, check_heads, glorot,
                                          packed_attention, packed_spmm,
                                          scaled_dot, zeros)
from graphgym_tpu_torch.nn.norm import l2_normalize


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
        h = graph.node_feat @ self.kernel
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
        h = torch.cat([x, packed_spmm(graph, "mean", x)], -1) @ self.kernel
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
        h = graph.node_feat @ self.kernel
        out = h + packed_spmm(graph, "plain", h)
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
            h = h @ getattr(self, f"kernel{i}") + getattr(self, f"bias{i}")
            if i < self.depth - 1:
                h = torch.relu(h)
        h0 = h
        for _ in range(self.num_iterations):
            h = ((1 - self.alpha) * packed_spmm(graph, "gcn", h)
                 + self.alpha * h0)
        return graph.replace(node_feat=h)
