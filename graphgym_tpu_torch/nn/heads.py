"""Task heads and global pooling (the port of graphgym_tpu/nn/heads.py;
reference graphgym/models/head.py:19-119 and models/pooling.py:12-42).

A head maps a GraphBatch to ``(pred, label, mask)``, the mask marking
the real prediction slots: the node head's supervised nodes, the edge
head's supervised node pairs, the graph head's graph slots.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from graphgym_tpu_torch import register
from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import LABELS, PAIRS, pool_kind
from graphgym_tpu_torch.nn.layers import MLP
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

HeadOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gather_supervised(graph: GraphBatch, h: torch.Tensor) -> HeadOut:
    """Predictions and labels at the supervised node slots.  Where the
    index repeats a node, the loader gives the batch the 'labels' gather
    pack and the rows are gathered on it (``gather_rows``); else by
    ``index_select``, whose gradient adds one row to each node."""
    idx = graph.node_label_index
    pred = (gather_rows(graph, LABELS, h)
            if graph.packs and LABELS in graph.packs
            else h.index_select(0, idx))
    return pred, graph.node_label.index_select(0, idx), graph.label_mask


def gather_rows(graph: GraphBatch, kind: str, h: torch.Tensor
                ) -> torch.Tensor:
    """h's rows at a head's index, on the batch's gather pack ``kind``
    (graphs/packing.build_gather_packs): K1 on the pack, its gradient K1
    on the transpose, which sums each node's entries in index order.  A
    padding entry gives a zero row."""
    if not graph.packs or kind not in graph.packs:
        raise ValueError(f"the batch carries no {kind!r} gather pack")
    fwd, bwd = graph.packs[kind]
    return K.SpmmPackFn.apply(fwd, bwd, h)


def global_pool(graph: GraphBatch, x: torch.Tensor, kind: str = "add",
                ego: bool = False) -> torch.Tensor:
    """Global add / mean / max pooling of x [num_nodes, D] into the
    graph slots [num_graphs, D] (heads.py:23-46), of the real nodes, or
    with ``ego`` of the real ego-net centers only (the reference's 'ego'
    branch); an empty graph slot (the padding one) gives 0.  It runs on
    the batch's pooling pack (``graphs/packing.build_pool_packs``): add
    and mean are K1 on it and its transpose (``SpmmPackFn``; mean's
    division is in the pack's weights), max the segmented max
    (``PackedMaxFn``: ties split evenly in the backward), so no float
    atomics.  A pooling in register.pooling_dict is called as the JAX
    package calls it, with the node arrays and the graph slots' count,
    read from graph_mask's shape (which a captured step's signature
    holds)."""
    if kind in register.pooling_dict:
        return register.pooling_dict[kind](
            x, graph.graph_ids, graph.graph_mask.shape[0],
            node_mask=graph.node_mask,
            id_index=graph.node_id_index if ego else None,
            id_mask=graph.id_mask if ego else None)
    name = pool_kind(kind, ego)
    if not graph.packs or name not in graph.packs:
        raise ValueError(f"the batch carries no {name!r} pack (the loader "
                         "builds the pack of cfg.model.graph_pooling)")
    fwd, bwd = graph.packs[name]
    fn = K.PackedMaxFn if kind == "max" else K.SpmmPackFn
    return fn.apply(fwd, bwd, x)


class GNNNodeHead(nn.Module):
    """Node prediction head (heads.py:49-66): the post-MP MLP of
    ``layers_post_mp`` layers, then the gather of the supervised node
    slots."""

    def __init__(self, dim_in: int, dim_out: int, layers_post_mp: int = 1,
                 dim_inner: Optional[int] = None, act: str = "relu", *,
                 generator: torch.Generator):
        super().__init__()
        self.mlp = MLP(dim_in, dim_out, num_layers=layers_post_mp,
                       dim_inner=dim_inner, use_bias=True, act=act,
                       generator=generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        return gather_supervised(graph, self.mlp(graph).node_feat)


class GNNEdgeHead(nn.Module):
    """Edge / link prediction head (heads.py:71-117; reference
    head.py:40-90): the node rows of each supervised pair, gathered on
    the batch's 'pairs' pack (both ends at once), decoded by
    ``decoding``:

    - 'dot' / 'cosine_similarity': the post-MP MLP (as wide as its
      input) over the nodes, then each pair's dot product, or its
      cosine with the norms' product clamped at 1e-8;
    - 'concat': the two rows concatenated, then the MLP over the pair
      slots, its BatchNorm masked by edge_label_mask.

    Returns the predictions, labels and mask of every pair slot."""

    def __init__(self, dim_in: int, dim_out: int, decoding: str = "dot",
                 layers_post_mp: int = 1, dim_inner: Optional[int] = None,
                 act: str = "relu", *, generator: torch.Generator):
        super().__init__()
        if decoding not in ("dot", "cosine_similarity", "concat"):
            raise ValueError(f"Unknown edge decoding {decoding}")
        self.decoding = decoding
        concat = decoding == "concat"
        self.mlp = MLP(2 * dim_in if concat else dim_in,
                       dim_out if concat else dim_in,
                       num_layers=layers_post_mp, dim_inner=dim_inner,
                       use_bias=True, act=act, generator=generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        mask = graph.edge_label_mask
        if self.decoding == "concat":
            v1, v2 = gather_rows(graph, PAIRS, graph.node_feat).chunk(2)
            pair = graph.replace(node_feat=torch.cat([v1, v2], -1),
                                 node_mask=mask)
            pred = self.mlp(pair).node_feat
        else:
            h = self.mlp(graph).node_feat
            v1, v2 = gather_rows(graph, PAIRS, h).chunk(2)
            pred = (v1 * v2).sum(-1)
            if self.decoding == "cosine_similarity":
                pred = pred / (v1.norm(dim=-1)
                               * v2.norm(dim=-1)).clamp_min(1e-8)
        return pred, graph.edge_label, mask


class GNNGraphHead(nn.Module):
    """Graph prediction head (heads.py:120-147): ``global_pool`` (the ego
    centers only with ``ego``), then the post-MP MLP over the graph
    slots, its BatchNorm masked by graph_mask (the padding graph slot
    out); the predictions, labels and mask of every graph slot."""

    def __init__(self, dim_in: int, dim_out: int, pooling: str = "add",
                 ego: bool = False, layers_post_mp: int = 1,
                 dim_inner: Optional[int] = None, act: str = "relu", *,
                 generator: torch.Generator):
        super().__init__()
        self.pooling = pooling
        self.ego = ego
        self.mlp = MLP(dim_in, dim_out, num_layers=layers_post_mp,
                       dim_inner=dim_inner, use_bias=True, act=act,
                       generator=generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        emb = global_pool(graph, graph.node_feat, self.pooling, self.ego)
        pooled = graph.replace(node_feat=emb, node_mask=graph.graph_mask)
        return (self.mlp(pooled).node_feat, graph.graph_label,
                graph.graph_mask)
