"""Model composition: stages, heads and the GNN, built from the config
(the port of graphgym_tpu/nn/model.py).

Two model families, as in the JAX package:
  * the torch path (GraphGym's, reference gnn.py:123-168): pre-MP
    Linear + BN + dropout + act layers, a stack or skip stage of
    GeneralLayer(conv) with BN, dropout and act, the L2 norm after the
    stage, and the node head's MLP; its linear kernels at LINEAR_GAIN;
  * the Tfg path (main_zd.py:28-257, layer types 'Tfg-*'): plain conv +
    act stacks with a Dense(256) -> Dense(C) head, no pre-MP, no
    BatchNorm wrapper and no L2 norm (the GIN layers keep the BatchNorm
    inside their MLP).
The layer table holds the layer types of the packed paths, and a
layer registered in register.layer_dict (the contrib 'contrib_example')
takes precedence, as in the JAX make_conv; the others raise naming
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from graphgym_tpu_torch import register
from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.nn import id_layers as idl
from graphgym_tpu_torch.nn.act import act_dict
from graphgym_tpu_torch.nn.att_layers import ExampleConv
from graphgym_tpu_torch.nn.heads import GNNNodeHead, HeadOut, gather_supervised
from graphgym_tpu_torch.nn.layers import (LINEAR_GAIN, MLP, GATConv, GCNConv,
                                          GeneralConv, GeneralLayer, GINConv,
                                          Linear, SAGEConv, TfgGATConv,
                                          glorot, zeros)
from graphgym_tpu_torch.nn.norm import l2_normalize

# layer type -> conv(dim_in, dim_out, opts, init generator, dropout
# generator) (make_conv, nn/model.py:36-120 of the JAX package).  The
# torch path's convs take a bias only without the BatchNorm wrapper.
LAYERS = {
    "linear": lambda dim_in, dim_out, opts, gen, _: Linear(
        dim_in, dim_out, use_bias=not opts.batchnorm, generator=gen),
    "mlp": lambda dim_in, dim_out, opts, gen, _: MLP(
        dim_in, dim_out, use_bias=not opts.batchnorm, act=opts.act,
        generator=gen),
    "gcnconv": lambda dim_in, dim_out, opts, gen, _: GCNConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, generator=gen),
    "sageconv": lambda dim_in, dim_out, opts, gen, _: SAGEConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, combine="sum",
        generator=gen),
    "gatconv": lambda dim_in, dim_out, opts, gen, drop_gen: GATConv(
        dim_in, dim_out, heads=opts.att_heads,
        use_bias=not opts.batchnorm, att_dropout=opts.att_dropout,
        generator=gen, dropout_generator=drop_gen),
    "ginconv": lambda dim_in, dim_out, opts, gen, _: GINConv(
        dim_in, dim_out, agg=opts.gin_agg, mlp_gain=LINEAR_GAIN,
        generator=gen),
    "generalconv": lambda dim_in, dim_out, opts, gen, _: GeneralConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, agg=opts.agg,
        self_msg=opts.self_msg, normalize_adj=opts.normalize_adj,
        generator=gen),
    "idconv": lambda dim_in, dim_out, opts, gen, _: idl.GeneralIDConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, agg=opts.agg,
        normalize_adj=opts.normalize_adj, generator=gen),
    "gcnidconv": lambda dim_in, dim_out, opts, gen, _: idl.GCNIDConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, generator=gen),
    "sageidconv": lambda dim_in, dim_out, opts, gen, _: idl.SAGEIDConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, generator=gen),
    "gatidconv": lambda dim_in, dim_out, opts, gen, drop_gen: idl.GATIDConv(
        dim_in, dim_out, heads=opts.att_heads,
        use_bias=not opts.batchnorm, att_dropout=opts.att_dropout,
        generator=gen, dropout_generator=drop_gen),
    # no BN in its MLP and gain 1 (nn/model.py:79)
    "ginidconv": lambda dim_in, dim_out, opts, gen, _: idl.GINIDConv(
        dim_in, dim_out, generator=gen),
    # a bias whatever the BatchNorm, and none (nn/model.py:98-99)
    "exampleconv1": lambda dim_in, dim_out, opts, gen, _: ExampleConv(
        dim_in, dim_out, generator=gen),
    "exampleconv2": lambda dim_in, dim_out, opts, gen, _: ExampleConv(
        dim_in, dim_out, use_bias=False, generator=gen),
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

# layer types of the JAX package not ported yet, by ROADMAP item (the
# edge-feature convs wait for the loaders that give edge features)
NOT_PORTED = {
    **dict.fromkeys(("generaledgeconv", "generalsampleedgeconv",
                     "splineconv"), "A9b, with the edge features of A13b"),
    **dict.fromkeys(("gaddconv", "gmulconv", "generaledgeattconvv1",
                     "generaledgeattconvv2", "generalconv_v2",
                     "sageinitconv", "generalogbconv", "Tfg-appnp"),
                    "A10b"),
}


@dataclasses.dataclass(frozen=True)
class GNNOptions:
    """Static snapshot of the cfg groups the model needs."""
    layer_type: str
    dim_in: int
    dim_out: int
    stage_type: str = "stack"
    layers_pre_mp: int = 0
    layers_mp: int = 2
    layers_post_mp: int = 1
    dim_inner: int = 16
    skip_every: int = 1
    batchnorm: bool = True
    act: str = "relu"
    dropout: float = 0.0
    att_heads: int = 1
    att_dropout: float = 0.0
    gin_agg: str = "sum"
    agg: str = "add"           # GeneralConv / GeneralIDConv
    self_msg: str = "concat"   # GeneralConv
    normalize_adj: bool = False
    l2norm: bool = True
    bn_eps: float = 1e-5       # the BN wrapper's; the Tfg GIN MLP's BN
    bn_mom: float = 0.1        # keeps the defaults, as in the JAX layer
    tfg_head: bool = False


def options_from_cfg(cfg) -> GNNOptions:
    """Snapshot cfg into GNNOptions (nn/model.py:338-416).  The Tfg
    branch overrides pre-MP, BatchNorm, dropout and L2-norm flags
    regardless of their cfg values; the torch branch reads them (its
    linear kernels are drawn at layers.LINEAR_GAIN)."""
    name = cfg.gnn.layer_type
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"layer type {name!r} is not ported yet (ROADMAP "
            f"{NOT_PORTED[name]})")
    if name not in LAYERS and name not in register.layer_dict:
        raise ValueError(f"Unknown layer type: {name}")
    if cfg.dataset.task != "node":
        raise NotImplementedError(
            f"task {cfg.dataset.task!r} is not ported yet (ROADMAP A13b)")
    common = dict(layer_type=name, dim_in=cfg.share.dim_in,
                  dim_out=cfg.share.dim_out, layers_mp=cfg.gnn.layers_mp,
                  dim_inner=cfg.gnn.dim_inner, act=cfg.gnn.act,
                  att_heads=cfg.gnn.att_heads,
                  att_dropout=cfg.gnn.att_dropout, gin_agg=cfg.gnn.gin_agg,
                  agg=cfg.gnn.agg, self_msg=cfg.gnn.self_msg,
                  normalize_adj=cfg.gnn.normalize_adj,
                  bn_eps=cfg.bn.eps, bn_mom=cfg.bn.mom)
    if name.startswith("Tfg-"):
        return GNNOptions(**common, batchnorm=False, l2norm=False,
                          tfg_head=True)
    if cfg.tpu.remat:
        raise NotImplementedError(
            "tpu.remat (rematerialized MP layers) is not ported yet "
            "(ROADMAP A0)")
    if cfg.dataset.node_encoder or cfg.dataset.edge_encoder:
        raise NotImplementedError(
            "node and edge encoders are not ported yet (ROADMAP A13b)")
    return GNNOptions(**common, stage_type=cfg.gnn.stage_type,
                      layers_pre_mp=cfg.gnn.layers_pre_mp,
                      layers_post_mp=max(cfg.gnn.layers_post_mp, 1),
                      skip_every=cfg.gnn.skip_every,
                      batchnorm=cfg.gnn.batchnorm, dropout=cfg.gnn.dropout,
                      l2norm=cfg.gnn.l2norm)


def _gnn_layer(opts: GNNOptions, dim_in: int, gen: torch.Generator,
               drop_gen: Optional[torch.Generator],
               has_act: bool = True) -> GeneralLayer:
    """GeneralLayer(conv) of the MP stage (nn/model.py:165-176); a
    registered layer is called as the JAX make_conv calls it, with the
    port's input width and init generator."""
    if opts.layer_type in register.layer_dict:
        conv = register.layer_dict[opts.layer_type](
            dim_in, opts.dim_inner, use_bias=not opts.batchnorm, opts=opts,
            generator=gen)
    else:
        conv = LAYERS[opts.layer_type](dim_in, opts.dim_inner, opts, gen,
                                       drop_gen)
    return GeneralLayer(conv, opts.dim_inner, has_act=has_act,
                        has_bn=opts.batchnorm, dropout=opts.dropout,
                        act=opts.act, bn_eps=opts.bn_eps,
                        bn_mom=opts.bn_mom, dropout_generator=drop_gen)


class GNNStackStage(nn.Module):
    """Plain stack of MP layers, then the optional L2 norm
    (nn/model.py:179-190; reference gnn.py:65-81)."""

    def __init__(self, opts: GNNOptions, dim_in: int,
                 generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l2norm = opts.l2norm
        dims = [dim_in] + [opts.dim_inner] * opts.layers_mp
        self.layers = nn.ModuleList(
            _gnn_layer(opts, dims[i], generator, dropout_generator)
            for i in range(opts.layers_mp))
        self.dim_out = dims[-1]

    def forward(self, graph: GraphBatch) -> GraphBatch:
        for layer in self.layers:
            graph = layer(graph)
        if self.l2norm:
            graph = graph.replace(node_feat=l2_normalize(graph.node_feat))
        return graph


class GNNSkipStage(nn.Module):
    """skipsum / skipconcat stage (nn/model.py:193-224; reference
    gnn.py:30-109): blocks of ``skip_every`` layers, the last of each
    without its activation, the block's input summed or concatenated
    with its output, then ``act_dict[act]`` (for 'prelu' the fixed 0.25
    leaky ReLU, as in the JAX stage), then the optional L2 norm."""

    def __init__(self, opts: GNNOptions, dim_in: int,
                 generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if opts.stage_type not in ("skipsum", "skipconcat"):
            raise ValueError(opts.stage_type)
        if opts.layers_mp % opts.skip_every:
            raise ValueError("gnn.layers_mp must be a multiple of "
                             "gnn.skip_every")
        self.opts = opts
        self.act = act_dict[opts.act]
        layers = []
        for _ in range(opts.layers_mp // opts.skip_every):
            if opts.stage_type == "skipsum" and dim_in != opts.dim_inner:
                raise ValueError("Sum skip needs matching dims; set "
                                 "dim_inner == dim_in")
            d = dim_in
            for i in range(opts.skip_every):
                layers.append(_gnn_layer(
                    opts, d, generator, dropout_generator,
                    has_act=i < opts.skip_every - 1))
                d = opts.dim_inner
            if opts.stage_type == "skipconcat":
                dim_in = dim_in + opts.dim_inner
        self.layers = nn.ModuleList(layers)
        self.dim_out = dim_in if opts.stage_type == "skipconcat" \
            else opts.dim_inner

    def forward(self, graph: GraphBatch) -> GraphBatch:
        every = self.opts.skip_every
        for b in range(len(self.layers) // every):
            x_in = graph.node_feat
            for layer in self.layers[b * every:(b + 1) * every]:
                graph = layer(graph)
            merged = (x_in + graph.node_feat
                      if self.opts.stage_type == "skipsum"
                      else torch.cat([x_in, graph.node_feat], -1))
            graph = graph.replace(node_feat=self.act(merged))
        if self.opts.l2norm:
            graph = graph.replace(node_feat=l2_normalize(graph.node_feat))
        return graph


STAGES = {"stack": GNNStackStage, "skipsum": GNNSkipStage,
          "skipconcat": GNNSkipStage}


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
        return gather_supervised(graph, h @ self.head_kernel2
                                 + self.head_bias2)


class GNN(nn.Module):
    """Full model (nn/model.py:227-336; reference gnn.py:123-168):
    pre-MP layers -> MP stage -> head.  ``forward`` returns (pred,
    label, mask) at the supervised slots.  ``pre_mp`` holds
    GeneralLayer(Linear) blocks, each Linear + BN + dropout + act
    (GNNPreMP, nn/model.py:291-308)."""

    def __init__(self, opts: GNNOptions, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.opts = opts
        dim = opts.dim_in
        pre = []
        for _ in range(opts.layers_pre_mp):
            pre.append(GeneralLayer(
                Linear(dim, opts.dim_inner, use_bias=not opts.batchnorm,
                       generator=generator),
                opts.dim_inner, has_act=True, has_bn=opts.batchnorm,
                dropout=opts.dropout, act=opts.act, bn_eps=opts.bn_eps,
                bn_mom=opts.bn_mom, dropout_generator=dropout_generator))
            dim = opts.dim_inner
        self.pre_mp = nn.ModuleList(pre)
        self.mp = None
        if opts.layers_mp > 0:
            self.mp = STAGES[opts.stage_type](opts, dim, generator,
                                              dropout_generator)
            dim = self.mp.dim_out
        if opts.tfg_head:
            self.post_mp = TfgMLPHead(dim, opts.dim_out, generator)
        else:
            self.post_mp = GNNNodeHead(
                dim, opts.dim_out, layers_post_mp=opts.layers_post_mp,
                dim_inner=opts.dim_inner, act=opts.act,
                generator=generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        for layer in self.pre_mp:
            graph = layer(graph)
        if self.mp is not None:
            graph = self.mp(graph)
        return self.post_mp(graph)


def build_model(cfg, device: torch.device) -> GNN:
    """create_model equivalent (reference model_builder.py:15): kernels
    drawn from a torch.Generator seeded with cfg.seed, zero biases, on
    ``device``; the Tfg or the torch model by layer type.  With dropout
    or att_dropout > 0 the layers draw their masks from a second
    Generator on ``device``, seeded with cfg.seed (train mode only)."""
    opts = options_from_cfg(cfg)
    generator = torch.Generator().manual_seed(int(cfg.seed))
    dropout_generator = None
    if opts.dropout > 0 or opts.att_dropout > 0:
        dropout_generator = torch.Generator(device=device).manual_seed(
            int(cfg.seed))
    return GNN(opts, generator, dropout_generator).to(device)
