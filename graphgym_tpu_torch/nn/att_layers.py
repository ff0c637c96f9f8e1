"""Layers of graphgym_tpu/nn/att_layers.py on the port's packed path.

Only ``ExampleConv`` (att_layers.py:313-330), the layer class of the
contrib example ('contrib_example') and of the layer types
'exampleconv1' / 'exampleconv2'.  The rest of that module (add and mul
attention, edge attention, generalconv_v2, the OGB conv, sageinitconv)
is ROADMAP A10b.
"""

from __future__ import annotations

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.nn.layers import glorot, packed_spmm, zeros


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
