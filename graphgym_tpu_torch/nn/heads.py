"""Task heads and global pooling (the port of graphgym_tpu/nn/heads.py;
reference graphgym/models/head.py:19-37, 93-119 and
models/pooling.py:12-42).

A head maps a GraphBatch to ``(pred, label, mask)``, the mask marking
the real prediction slots.  The node and graph heads are ported; the
edge head is ROADMAP A13b.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from graphgym_tpu_torch import register
from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import pool_kind
from graphgym_tpu_torch.nn.layers import MLP
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

HeadOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gather_supervised(graph: GraphBatch, h: torch.Tensor) -> HeadOut:
    """Predictions and labels at the supervised node slots."""
    idx = graph.node_label_index
    return (h.index_select(0, idx), graph.node_label.index_select(0, idx),
            graph.label_mask)


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
