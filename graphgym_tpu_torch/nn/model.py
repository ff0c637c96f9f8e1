"""Model composition: stages, heads and the GNN, built from the config
(the port of graphgym_tpu/nn/model.py).

Two model families, as in the JAX package:
  * the torch path (GraphGym's, reference gnn.py:123-168): pre-MP
    Linear + BN + dropout + act layers, a stack or skip stage of
    GeneralLayer(conv) with BN, dropout and act, the L2 norm after the
    stage, and the head of the task (a head registered for the task in
    register.head_dict first): the node head's MLP, the edge head's
    pair decoding, or the graph head's global pooling and MLP; its
    linear kernels at LINEAR_GAIN;
  * the Tfg path (main_zd.py:28-257, layer types 'Tfg-*'): plain conv +
    act stacks with a Dense(256) -> Dense(C) head, no pre-MP, no
    BatchNorm wrapper and no L2 norm (the GIN layers keep the BatchNorm
    inside their MLP), or for 'Tfg-appnp' the APPNP model
    (``TfgAPPNPNet``); node tasks only, as in the JAX package, whose Tfg
    head gathers node slots whatever the task.
The layer table holds the layer types of the packed paths, and a
layer registered in register.layer_dict (the contrib 'contrib_example')
takes precedence, as in the JAX make_conv.  The edge-feature convs take
the width of the edge features they read (``GNNOptions.dim_edge``).
Node and edge encoders (nn/encoders.py, or registered ones) run ahead
of the torch path's pre-MP layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from graphgym_tpu_torch import register
from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.nn import encoders
from graphgym_tpu_torch.nn import id_layers as idl
from graphgym_tpu_torch.nn.act import act_dict
from graphgym_tpu_torch.nn.att_layers import (APPNP, ExampleConv,
                                              GeneralConvV2,
                                              GeneralEdgeAttConv,
                                              GeneralMulAttConv,
                                              GeneralOGBConv, SAGEInitConv)
from graphgym_tpu_torch.nn.heads import (GNNEdgeHead, GNNGraphHead,
                                         GNNNodeHead, HeadOut,
                                         gather_supervised)
from graphgym_tpu_torch.nn.layers import (LINEAR_GAIN, MLP, GATConv, GCNConv,
                                          GeneralConv, GeneralEdgeConv,
                                          GeneralLayer, GINConv, Linear,
                                          SAGEConv, SplineConv, TfgGATConv,
                                          glorot, zeros)
from graphgym_tpu_torch.nn.norm import MaskedBatchNorm, l2_normalize
from graphgym_tpu_torch.ops.sparse import mm

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
    "generalconv_v2": lambda dim_in, dim_out, opts, gen, _: GeneralConvV2(
        dim_in, dim_out, use_bias=not opts.batchnorm, agg=opts.agg,
        self_msg=opts.self_msg, normalize_adj=opts.normalize_adj,
        flow=opts.flow, generator=gen),
    # GeneralAddAttConv: GATConv's parameters, score and edges, with no
    # attention dropout (nn/model.py:81)
    "gaddconv": lambda dim_in, dim_out, opts, gen, _: GATConv(
        dim_in, dim_out, heads=opts.att_heads,
        use_bias=not opts.batchnorm, generator=gen),
    "gmulconv": lambda dim_in, dim_out, opts, gen, _: GeneralMulAttConv(
        dim_in, dim_out, heads=opts.att_heads,
        use_bias=not opts.batchnorm, generator=gen),
    # the edge-feature convs (nn/model.py:58-66, 85-97), at the width of
    # the edge features they read
    "splineconv": lambda dim_in, dim_out, opts, gen, _: SplineConv(
        dim_in, dim_out, use_bias=not opts.batchnorm, generator=gen),
    "generaledgeconv": lambda dim_in, dim_out, opts, gen, _: GeneralEdgeConv(
        dim_in, dim_out, opts.dim_edge, use_bias=not opts.batchnorm,
        agg=opts.agg, self_msg=opts.self_msg,
        normalize_adj=opts.normalize_adj, msg_direction=opts.msg_direction,
        generator=gen),
    "generalsampleedgeconv": lambda dim_in, dim_out, opts, gen, drop_gen:
        GeneralEdgeConv(
            dim_in, dim_out, opts.dim_edge, use_bias=not opts.batchnorm,
            agg=opts.agg, self_msg=opts.self_msg,
            normalize_adj=opts.normalize_adj,
            msg_direction=opts.msg_direction, sample_rate=opts.keep_edge,
            generator=gen, sample_generator=drop_gen),
    "generaledgeattconvv1": lambda dim_in, dim_out, opts, gen, _:
        GeneralEdgeAttConv(
            dim_in, dim_out, opts.dim_edge, heads=opts.att_heads,
            use_bias=not opts.batchnorm, msg_direction=opts.msg_direction,
            final_linear=opts.att_final_linear,
            final_linear_bn=opts.att_final_linear_bn, version=1,
            generator=gen),
    "generaledgeattconvv2": lambda dim_in, dim_out, opts, gen, _:
        GeneralEdgeAttConv(
            dim_in, dim_out, opts.dim_edge, heads=opts.att_heads,
            use_bias=not opts.batchnorm, msg_direction=opts.msg_direction,
            final_linear=opts.att_final_linear,
            final_linear_bn=opts.att_final_linear_bn, version=2,
            generator=gen),
    "generalogbconv": lambda dim_in, dim_out, opts, gen, _: GeneralOGBConv(
        dim_in, dim_out, opts.dim_edge, use_bias=not opts.batchnorm,
        agg=opts.agg, self_msg=opts.self_msg,
        normalize_adj=opts.normalize_adj, generator=gen),
    # a bias whatever the BatchNorm, no normalize (nn/model.py:94)
    "sageinitconv": lambda dim_in, dim_out, opts, gen, _: SAGEInitConv(
        dim_in, dim_out, generator=gen),
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

# the Tfg APPNP model's layer type (build_model picks TfgAPPNPNet by it)
APPNP_TYPE = "Tfg-appnp"



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
    flow: str = "source_to_target"   # GeneralConvV2
    msg_direction: str = "single"    # the edge-feature convs: their
    keep_edge: float = 0.5           # messages, generalsampleedgeconv's
    att_final_linear: bool = False   # rate, the attention convs' final
    att_final_linear_bn: bool = False   # linear and BN, and the width of
    dim_edge: int = 0                # the edge features they read
    l2norm: bool = True
    bn_eps: float = 1e-5       # the BN wrapper's; the Tfg GIN MLP's BN
    bn_mom: float = 0.1        # keeps the defaults, as in the JAX layer
    task: str = "node"         # node | graph | edge | link_pred
    graph_pooling: str = "add"  # the graph head's: add | mean | max
    edge_decoding: str = "dot"  # the edge head's: dot | cosine_similarity
    #                             | concat
    ego: bool = False          # the graph head pools the ego centers
    tfg_head: bool = False
    node_encoder: str = ""     # encoder names ('' for none) and their
    node_encoder_bn: bool = True   # BatchNorms (torch path only)
    edge_encoder: str = ""
    edge_encoder_bn: bool = True
    encoder_dim: int = 128
    remat: bool = False        # recompute the MP layers in the backward


def options_from_cfg(cfg) -> GNNOptions:
    """Snapshot cfg into GNNOptions (nn/model.py:338-416).  The Tfg
    branch overrides pre-MP, BatchNorm, dropout and L2-norm flags
    regardless of their cfg values; the torch branch reads them (its
    linear kernels are drawn at layers.LINEAR_GAIN)."""
    name = cfg.gnn.layer_type
    if name not in LAYERS and name not in register.layer_dict \
            and name != APPNP_TYPE:
        raise ValueError(f"Unknown layer type: {name}")
    task = cfg.dataset.task
    if task not in ("node", "graph", "edge", "link_pred"):
        raise ValueError(f"Unknown task {task}")
    if task != "node" and name.startswith("Tfg-"):
        raise NotImplementedError(
            f"task {task!r} with {name!r}: the Tfg models are node "
            "models, as in the JAX package, whose Tfg head gathers node "
            "slots")
    common = dict(layer_type=name, dim_in=cfg.share.dim_in,
                  dim_out=cfg.share.dim_out, layers_mp=cfg.gnn.layers_mp,
                  dim_inner=cfg.gnn.dim_inner, act=cfg.gnn.act,
                  att_heads=cfg.gnn.att_heads,
                  att_dropout=cfg.gnn.att_dropout, gin_agg=cfg.gnn.gin_agg,
                  agg=cfg.gnn.agg, self_msg=cfg.gnn.self_msg,
                  normalize_adj=cfg.gnn.normalize_adj, flow=cfg.gnn.flow,
                  msg_direction=cfg.gnn.msg_direction,
                  keep_edge=cfg.gnn.keep_edge,
                  att_final_linear=cfg.gnn.att_final_linear,
                  att_final_linear_bn=cfg.gnn.att_final_linear_bn,
                  dim_edge=(cfg.dataset.encoder_dim
                            if cfg.dataset.edge_encoder
                            and not name.startswith("Tfg-")
                            else cfg.dataset.edge_dim),
                  bn_eps=cfg.bn.eps, bn_mom=cfg.bn.mom, task=task,
                  graph_pooling=cfg.model.graph_pooling,
                  edge_decoding=cfg.model.edge_decoding,
                  ego=cfg.dataset.transform == "ego")
    if name.startswith("Tfg-"):
        return GNNOptions(**common, batchnorm=False, l2norm=False,
                          tfg_head=True)
    if name == "generalogbconv" and cfg.dataset.edge_encoder:
        raise NotImplementedError(
            "generalogbconv behind an edge encoder: its bond ids are the "
            "raw edge features' (the batch's 'edge_bond' pack), the JAX "
            "layer's the encoder's output cast to int (ROADMAP A0)")
    return GNNOptions(**common, stage_type=cfg.gnn.stage_type,
                      layers_pre_mp=cfg.gnn.layers_pre_mp,
                      layers_post_mp=max(cfg.gnn.layers_post_mp, 1),
                      skip_every=cfg.gnn.skip_every,
                      batchnorm=cfg.gnn.batchnorm, dropout=cfg.gnn.dropout,
                      l2norm=cfg.gnn.l2norm,
                      node_encoder=(cfg.dataset.node_encoder_name
                                    if cfg.dataset.node_encoder else ""),
                      node_encoder_bn=cfg.dataset.node_encoder_bn,
                      edge_encoder=(cfg.dataset.edge_encoder_name
                                    if cfg.dataset.edge_encoder else ""),
                      edge_encoder_bn=cfg.dataset.edge_encoder_bn,
                      encoder_dim=cfg.dataset.encoder_dim,
                      remat=bool(cfg.tpu.remat))


def _gnn_layer(opts: GNNOptions, dim_in: int, gen: torch.Generator,
               drop_gen: Optional[torch.Generator],
               has_act: bool = True) -> GeneralLayer:
    """GeneralLayer(conv) of the MP stage (nn/model.py:165-176),
    rematerialized with ``opts.remat`` (cfg.tpu.remat; the Tfg models
    ignore it, as the JAX package's do); a registered layer is called
    as the JAX make_conv calls it, with the port's input width and init
    generator."""
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
                        bn_mom=opts.bn_mom, dropout_generator=drop_gen,
                        remat=opts.remat)


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
        h = torch.relu(mm(graph.node_feat, self.head_kernel1)
                       + self.head_bias1)
        return gather_supervised(graph, mm(h, self.head_kernel2)
                                 + self.head_bias2)


def _encoder(table: dict, registered: dict, name: str, dim: int,
             generator: torch.Generator) -> nn.Module:
    """The encoder ``name``, a registered one first (nn/model.py:
    272-285 merges the registry over the built-ins)."""
    found = {**table, **registered}
    if name not in found:
        raise ValueError(f"Unknown encoder {name!r}")
    return found[name](dim, generator)


class GNN(nn.Module):
    """Full model (nn/model.py:227-336; reference gnn.py:123-168):
    encoders -> pre-MP layers -> MP stage (``STAGES``, else a stage registered in
    register.stage_dict, called as STAGES' are; nn/model.py:310-312)
    -> head (nn/model.py:314-335: a head
    registered for the task, called as the JAX model calls it with the
    options and, here, the head's input width and init generator; else
    the Tfg head, or the node, edge or graph head by task).  ``forward`` returns
    (pred, label, mask) at the supervised slots.  The node encoder
    (then ``MaskedBatchNorm`` on the node mask with node_encoder_bn) and
    the edge encoder (then one on the edge mask with edge_encoder_bn)
    come first (nn/model.py:265-290), their BatchNorms at the default
    eps and momentum, and the node encoder's width encoder_dim is the
    pre-MP input's.  ``pre_mp`` holds
    GeneralLayer(Linear) blocks, each Linear + BN + dropout + act
    (GNNPreMP, nn/model.py:291-308)."""

    def __init__(self, opts: GNNOptions, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.opts = opts
        dim = opts.dim_in
        if opts.node_encoder:
            self.node_encoder = _encoder(
                encoders.node_encoder_dict, register.node_encoder_dict,
                opts.node_encoder, opts.encoder_dim, generator)
            if opts.node_encoder_bn:
                self.node_encoder_bn = MaskedBatchNorm(opts.encoder_dim)
            dim = opts.encoder_dim
        if opts.edge_encoder:
            self.edge_encoder = _encoder(
                encoders.edge_encoder_dict, register.edge_encoder_dict,
                opts.edge_encoder, opts.encoder_dim, generator)
            if opts.edge_encoder_bn:
                self.edge_encoder_bn = MaskedBatchNorm(opts.encoder_dim)
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
            stage = STAGES.get(opts.stage_type)
            if stage is None:
                stage = register.stage_dict[opts.stage_type]
            self.mp = stage(opts, dim, generator, dropout_generator)
            dim = self.mp.dim_out
        if opts.task in register.head_dict:
            self.post_mp = register.head_dict[opts.task](
                opts, dim_in=dim, generator=generator)
        elif opts.tfg_head:
            self.post_mp = TfgMLPHead(dim, opts.dim_out, generator)
        elif opts.task in ("edge", "link_pred"):
            self.post_mp = GNNEdgeHead(
                dim, opts.dim_out, decoding=opts.edge_decoding,
                layers_post_mp=opts.layers_post_mp,
                dim_inner=opts.dim_inner, act=opts.act,
                generator=generator)
        elif opts.task == "graph":
            self.post_mp = GNNGraphHead(
                dim, opts.dim_out, pooling=opts.graph_pooling,
                ego=opts.ego, layers_post_mp=opts.layers_post_mp,
                dim_inner=opts.dim_inner, act=opts.act,
                generator=generator)
        else:
            self.post_mp = GNNNodeHead(
                dim, opts.dim_out, layers_post_mp=opts.layers_post_mp,
                dim_inner=opts.dim_inner, act=opts.act,
                generator=generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        opts = self.opts
        if opts.node_encoder:
            graph = self.node_encoder(graph)
            if opts.node_encoder_bn:
                graph = graph.replace(node_feat=self.node_encoder_bn(
                    graph.node_feat, graph.node_mask))
        if opts.edge_encoder:
            graph = self.edge_encoder(graph)
            if opts.edge_encoder_bn:
                graph = graph.replace(edge_feat=self.edge_encoder_bn(
                    graph.edge_feat, graph.edge_mask))
        for layer in self.pre_mp:
            graph = layer(graph)
        if self.mp is not None:
            graph = self.mp(graph)
        return self.post_mp(graph)


class TfgAPPNPNet(nn.Module):
    """The Tfg APPNP model (nn/model.py:419-434; reference main_zd.py:
    245-257): one APPNP block, Dense layers [64, C] then 10 iterations
    of the propagation with alpha 0.1, and the logits gathered at the
    supervised nodes; no MLP head.  Its kernels ('kernel0', 'kernel1')
    take the Tfg path's kernel L2 term."""

    def __init__(self, opts: GNNOptions, generator: torch.Generator):
        super().__init__()
        self.appnp = APPNP(opts.dim_in, (64, opts.dim_out), alpha=0.1,
                           num_iterations=10, generator=generator)

    def forward(self, graph: GraphBatch) -> HeadOut:
        graph = self.appnp(graph)
        return gather_supervised(graph, graph.node_feat)


def build_model(cfg, device: torch.device) -> nn.Module:
    """create_model equivalent (reference model_builder.py:15): kernels
    drawn from a torch.Generator seeded with cfg.seed, zero biases, on
    ``device``; the Tfg or the torch model by layer type, or the Tfg
    APPNP model for 'Tfg-appnp' (nn/model.py:448-449); a network
    registered in register.network_dict under cfg.model.type first,
    called as GNN is (nn/model.py:446-447).  With dropout or
    att_dropout > 0 the layers draw their masks from a second Generator
    on ``device``, seeded with cfg.seed (train mode only); so does
    generalsampleedgeconv its kept edges."""
    opts = options_from_cfg(cfg)
    generator = torch.Generator().manual_seed(int(cfg.seed))
    dropout_generator = None
    if opts.dropout > 0 or opts.att_dropout > 0 or (
            opts.layer_type == "generalsampleedgeconv"
            and opts.keep_edge < 1):
        dropout_generator = torch.Generator(device=device).manual_seed(
            int(cfg.seed))
    if cfg.model.type in register.network_dict:
        return register.network_dict[cfg.model.type](
            opts, generator, dropout_generator).to(device)
    if opts.layer_type == APPNP_TYPE:
        return TfgAPPNPNet(opts, generator).to(device)
    return GNN(opts, generator, dropout_generator).to(device)
