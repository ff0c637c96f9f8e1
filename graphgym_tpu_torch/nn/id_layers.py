"""ID-GNN Full layers: identity-colored message passing.

Each layer carries ``kernel``, applied to all nodes, and ``id_kernel``,
applied additionally to the ego-net center rows in
``graph.node_id_index`` (reference contrib/layer/idconv.py:62-67).
The port of graphgym_tpu/nn/id_layers.py on the packed path:
GeneralIDConv, GCNIDConv, SAGEIDConv, GATIDConv and GINIDConv (the torch
path's idconv, gcnidconv, sageidconv, gatidconv and ginidconv; GCNIDConv
and GINIDConv also serve Tfg-idgcn and Tfg-idgin), TfgIDSAGE and
TfgIDGAT.
"""

from __future__ import annotations

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import agg_kind
from graphgym_tpu_torch.nn.layers import (GATConv, TfgGATConv, _gin_mlp,
                                          gin_mlp_init, glorot,
                                          packed_aggregate, packed_spmm,
                                          zeros)
from graphgym_tpu_torch.ops import sparse as sp


def _id_index(graph: GraphBatch):
    if graph.node_id_index is None:
        raise ValueError(
            "ID layers need graph.node_id_index (run the 'ego' "
            "transform; reference models/transform.py:38)")
    return graph.node_id_index, graph.id_mask


class GCNIDConv(nn.Module):
    """ID-GCN: id-colored projection then the renormalized SpMM.

    h = x @ W; h[id] += x[id] @ W_id; h = D^-1/2(A+I)D^-1/2 h + b
    (reference idconv.py:104-189 == TfgIDLayer.py:478-525 gcn_id)."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel = glorot((dim_in, dim_out), generator)
        self.id_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        idx, id_mask = _id_index(graph)
        h = sp.apply_id_weights(graph.node_feat, idx, self.kernel,
                                self.id_kernel, id_mask)
        h = packed_spmm(graph, "gcn", h)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class GeneralIDConv(nn.Module):
    """ID version of GeneralConv (id_layers.py:75-105; reference
    idconv.py:16-101), the fifth ID-GNN Full variant: the id-colored
    projection h = x W, h[id] += x[id] W_id, then GeneralConv's
    aggregation (agg 'add', 'mean' or 'max', on A or, with
    normalize_adj, the GCN sym-norm; ``packed_aggregate``), then + b.
    No self message."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 agg: str = "add", normalize_adj: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        agg_kind(agg, normalize_adj)
        self.agg, self.normalize_adj = agg, normalize_adj
        self.kernel = glorot((dim_in, dim_out), generator)
        self.id_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        idx, id_mask = _id_index(graph)
        h = sp.apply_id_weights(graph.node_feat, idx, self.kernel,
                                self.id_kernel, id_mask)
        h = packed_aggregate(graph, h, self.agg, self.normalize_adj)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class SAGEIDConv(nn.Module):
    """torch-style ID-SAGE (id_layers.py:108-142; reference
    idconv.py:192-263): the neighbour mean concatenated with self, then
    the id-colored projection of the concatenation:

      a = [x || mean_nb(x)];  h = a W;  h[id] += a[id] W_id;  + b

    (the JAX layer's concat_self=True, normalize=False, as make_conv
    builds it).  The JAX layer takes the mean through the COO ``spmm``;
    here it is K1 on the 'mean' pack, the same function (TfgIDSAGE's
    packed mean, whose fallback is that COO mean), so the card adds no
    float atomics.  A batch without the pack raises."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel = glorot((2 * dim_in, dim_out), generator)
        self.id_kernel = glorot((2 * dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        idx, id_mask = _id_index(graph)
        a = torch.cat([x, packed_spmm(graph, "mean", x)], -1)
        h = sp.apply_id_weights(a, idx, self.kernel, self.id_kernel,
                                id_mask)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class GATIDConv(GATConv):
    """torch-style ID-GAT (id_layers.py:184-255; reference
    idconv.py:266-347): GATConv's additive attention over id-colored
    features, h = x W with h[id] += x[id] W_id."""

    has_id_kernel = True

    def project(self, graph: GraphBatch) -> torch.Tensor:
        idx, id_mask = _id_index(graph)
        return sp.apply_id_weights(graph.node_feat, idx, self.kernel,
                                   self.id_kernel, id_mask)


class TfgIDSAGE(nn.Module):
    """tfg-style ID-SAGE (id_layers.py:145-181; reference
    TfgIDLayer.py:15-120), three kernels, self, id and neighbor:

      h = x W_self;  h[id] += x[id] W_id
      out = [h || mean_nb(x) W_nb] + b

    the neighbor mean on the 'mean' pack (the JAX layer's concat=True,
    normalize=False, which no model changes)."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = True,
                 *, generator: torch.Generator):
        super().__init__()
        d = dim_out // 2
        self.self_kernel = glorot((dim_in, d), generator)
        self.id_kernel = glorot((dim_in, d), generator)
        self.neighbor_kernel = glorot((dim_in, d), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        idx, id_mask = _id_index(graph)
        h_nb = packed_spmm(graph, "mean", x) @ self.neighbor_kernel
        h = sp.apply_id_weights(x, idx, self.self_kernel, self.id_kernel,
                                id_mask)
        h = torch.cat([h, h_nb], -1)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class TfgIDGAT(TfgGATConv):
    """tfg-style ID-GAT (id_layers.py:258-337; reference
    TfgIDLayer.py:269-388 ``gat_id``): TfgGATConv's dot-product
    attention with the identity coloring applied to V only,
    V = x Wv with V[id] += x[id] Wv_id."""

    has_id_kernel = True

    def values(self, graph: GraphBatch) -> torch.Tensor:
        idx, id_mask = _id_index(graph)
        return sp.apply_id_weights(graph.node_feat, idx, self.kernel,
                                   self.id_kernel, id_mask)


class GINIDConv(nn.Module):
    """ID-GIN (id_layers.py:340-369; reference idconv.py:350-382 ==
    TfgIDLayer.py:123-167):

      h = (1 + eps) x + sum_nb x          (the 'plain' pack)
      out = MLP(h);  out[id] += MLP_id(h[id])

    with eps = 0 (the JAX layer's default, which no model changes).
    With ``mlp_bn`` (Tfg-idgin) each MLP ends in BN + ReLU: MLP's BN
    over the real nodes (node_mask), MLP_id's over the real ego centers
    (id_mask).  The torch path's ginidconv has no BN and keeps gain 1
    (graphgym_tpu/nn/model.py:79), unlike ginconv's sqrt(2)."""

    def __init__(self, dim_in: int, dim_out: int, mlp_bn: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        gin_mlp_init(self, "mlp", dim_in, dim_out, mlp_bn, generator)
        gin_mlp_init(self, "mlp_id", dim_in, dim_out, mlp_bn, generator)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        idx, id_mask = _id_index(graph)
        h = x + packed_spmm(graph, "plain", x)
        out = _gin_mlp(self, "mlp", h, graph.node_mask)
        out_id = _gin_mlp(self, "mlp_id", h.index_select(0, idx), id_mask)
        return graph.replace(node_feat=sp.scatter_add_rows(
            out, idx, out_id, mask=id_mask))
