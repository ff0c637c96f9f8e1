"""Task heads (the port of graphgym_tpu/nn/heads.py; reference
graphgym/models/head.py:19-37).

A head maps a GraphBatch to ``(pred, label, mask)``, the mask marking
the real prediction slots.  The node head is ported; the edge and graph
heads and ``global_pool`` are ROADMAP A13b.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.nn.layers import MLP

HeadOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def gather_supervised(graph: GraphBatch, h: torch.Tensor) -> HeadOut:
    """Predictions and labels at the supervised node slots."""
    idx = graph.node_label_index
    return (h.index_select(0, idx), graph.node_label.index_select(0, idx),
            graph.label_mask)


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
