"""Model composition: stage, Tfg head and the GNN, built from the config.

The port of graphgym_tpu/nn/model.py for the Tfg model family
(reference main_zd.py:28-257): plain conv + relu stacks with a
Dense(256) -> Dense(C) head, no pre-MP, no BatchNorm wrapper and no
post-stage L2 norm (the GIN layers keep the BatchNorm inside their MLP).
The layer table holds the Tfg layer types of nn/model.py:101-113 of the
JAX package; other layer types are ROADMAP A9-A11.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.nn import id_layers as idl
from graphgym_tpu_torch.nn.layers import (GCNConv, GeneralLayer, GINConv,
                                          SAGEConv, TfgGATConv, glorot, zeros)

HeadOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# layer type -> conv(dim_in, dim_out, opts, init generator, dropout
# generator) (nn/model.py:101-113 of the JAX package)
LAYERS = {
    "Tfg-gcnconv": lambda dim_in, dim_out, opts, gen, _: GCNConv(
        dim_in, dim_out, use_bias=True, generator=gen),
    "Tfg-sageconv": lambda dim_in, dim_out, opts, gen, _: SAGEConv(
        dim_in, dim_out, use_bias=True, combine="concat", generator=gen),
    "Tfg-ginconv": lambda dim_in, dim_out, opts, gen, _: GINConv(
        dim_in, dim_out, mlp_bn=True, agg=opts.gin_agg, generator=gen),
    "Tfg-idgcn": lambda dim_in, dim_out, opts, gen, _: idl.GCNIDConv(
        dim_in, dim_out, use_bias=True, generator=gen),
    "Tfg-idsage": lambda dim_in, dim_out, opts, gen, _: idl.TfgIDSAGE(
        dim_in, dim_out, use_bias=True, generator=gen),
    "Tfg-idgin": lambda dim_in, dim_out, opts, gen, _: idl.GINIDConv(
        dim_in, dim_out, mlp_bn=True, generator=gen),
    "Tfg-gatconv": lambda dim_in, dim_out, opts, gen, drop_gen: TfgGATConv(
        dim_in, dim_out, heads=opts.att_heads, att_dropout=opts.att_dropout,
        generator=gen, dropout_generator=drop_gen),
    "Tfg-idgat": lambda dim_in, dim_out, opts, gen, drop_gen: idl.TfgIDGAT(
        dim_in, dim_out, heads=opts.att_heads, att_dropout=opts.att_dropout,
        generator=gen, dropout_generator=drop_gen),
}


@dataclasses.dataclass(frozen=True)
class GNNOptions:
    """Static snapshot of the cfg groups the model needs."""
    layer_type: str
    dim_in: int
    dim_out: int
    layers_mp: int = 2
    dim_inner: int = 16
    act: str = "relu"
    att_heads: int = 1
    att_dropout: float = 0.0
    gin_agg: str = "sum"
    bn_eps: float = 1e-5      # the BN wrapper's (A11); the Tfg GIN MLP's
    bn_mom: float = 0.1       # BN keeps the defaults, as in the JAX layer


def options_from_cfg(cfg) -> GNNOptions:
    """Snapshot cfg into GNNOptions (the Tfg branch of
    nn/model.py:347-371, which overrides pre-MP, BatchNorm, dropout and
    L2-norm flags regardless of their cfg values)."""
    if cfg.gnn.layer_type not in LAYERS:
        raise NotImplementedError(
            f"layer type {cfg.gnn.layer_type!r} is not ported yet "
            "(ROADMAP A9-A11)")
    if cfg.dataset.task != "node":
        raise NotImplementedError(
            f"task {cfg.dataset.task!r} is not ported yet (ROADMAP A13b)")
    return GNNOptions(layer_type=cfg.gnn.layer_type,
                      dim_in=cfg.share.dim_in, dim_out=cfg.share.dim_out,
                      layers_mp=cfg.gnn.layers_mp,
                      dim_inner=cfg.gnn.dim_inner, act=cfg.gnn.act,
                      att_heads=cfg.gnn.att_heads,
                      att_dropout=cfg.gnn.att_dropout,
                      gin_agg=cfg.gnn.gin_agg, bn_eps=cfg.bn.eps,
                      bn_mom=cfg.bn.mom)


class GNNStackStage(nn.Module):
    """Plain stack of MP layers (gnn.py:65-81); Tfg has no L2 norm."""

    def __init__(self, opts: GNNOptions, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [opts.dim_in] + [opts.dim_inner] * opts.layers_mp
        self.layers = nn.ModuleList(
            GeneralLayer(LAYERS[opts.layer_type](dims[i], dims[i + 1], opts,
                                                 generator,
                                                 dropout_generator),
                         act=opts.act)
            for i in range(opts.layers_mp))

    def forward(self, graph: GraphBatch) -> GraphBatch:
        for layer in self.layers:
            graph = layer(graph)
        return graph


class TfgMLPHead(nn.Module):
    """The Tfg models' head: Dense(256, relu) -> Dense(C) (reference
    main_zd.py:37-39), then the gather at the supervised nodes."""

    def __init__(self, dim_in: int, dim_out: int,
                 generator: torch.Generator):
        super().__init__()
        self.head_kernel1 = glorot((dim_in, 256), generator)
        self.head_bias1 = zeros((256,))
        self.head_kernel2 = glorot((256, dim_out), generator)
        self.head_bias2 = zeros((dim_out,))

    def forward(self, graph: GraphBatch) -> HeadOut:
        h = torch.relu(graph.node_feat @ self.head_kernel1
                       + self.head_bias1)
        h = h @ self.head_kernel2 + self.head_bias2
        idx = graph.node_label_index
        return (h.index_select(0, idx), graph.node_label.index_select(0, idx),
                graph.label_mask)


class GNN(nn.Module):
    """Full Tfg model (gnn.py:123-168): MP stage -> Tfg head.
    ``forward`` returns (pred, label, mask) at the supervised slots."""

    def __init__(self, opts: GNNOptions, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.opts = opts
        self.mp = GNNStackStage(opts, generator, dropout_generator)
        dim = opts.dim_inner if opts.layers_mp > 0 else opts.dim_in
        self.post_mp = TfgMLPHead(dim, opts.dim_out, generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        return self.post_mp(self.mp(graph))


def build_model(cfg, device: torch.device) -> GNN:
    """create_model equivalent (reference model_builder.py:15): glorot
    kernels drawn from a torch.Generator seeded with cfg.seed, zero
    biases, on ``device``.  With att_dropout > 0 the attention layers
    draw their dropout masks from a second Generator on ``device``,
    seeded with cfg.seed (dropout acts in train mode only)."""
    opts = options_from_cfg(cfg)
    generator = torch.Generator().manual_seed(int(cfg.seed))
    dropout_generator = None
    if opts.att_dropout > 0:
        dropout_generator = torch.Generator(device=device).manual_seed(
            int(cfg.seed))
    return GNN(opts, generator, dropout_generator).to(device)
