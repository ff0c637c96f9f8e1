"""Layer building blocks of the port (graphgym_tpu/nn/layers.py subset):
the glorot initializer with its gain, the packed SpMM, aggregation and
attention dispatch, ``Linear``, ``MLP`` and the ``GeneralLayer``
wrapper (conv, BatchNorm, dropout, activation), the packed-branch GCN,
SAGE and GIN convs with the GIN MLP, GraphGym's ``GeneralConv``, the
additive ``GATConv`` and the Tfg dot-product GAT.  Modules take and
return a GraphBatch whose arrays are tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import agg_kind
from graphgym_tpu_torch.nn.act import PReLU, act_dict
from graphgym_tpu_torch.nn.norm import MaskedBatchNorm
from graphgym_tpu_torch.ops.cuda.spmm_kernel import (
    pack_rows, packed_max_vjp, packed_node_scores, packed_scaled_dot,
    packed_segment_softmax, segment_matmul_headed_vjp, spmm_pack_vjp,
    take_padded)


# xavier gain of the torch path's nn.Linear equivalents (Linear, MLP,
# ginconv's MLP; reference init.py:6-16)
LINEAR_GAIN = math.sqrt(2)


def glorot(shape, generator: torch.Generator,
           gain: float = 1.0) -> nn.Parameter:
    """xavier_uniform with a gain: uniform in +-gain * sqrt(6 / (fan_in
    + fan_out)), the fans of flax's ``variance_scaling(gain^2, fan_avg,
    uniform)`` (graphgym_tpu/nn/layers.py:48-61): fan_in = shape[-2] and
    fan_out = shape[-1], each times the product of the leading axes.
    gain 1 is TF/flax glorot; the torch path's nn.Linear equivalents
    take LINEAR_GAIN."""
    w = torch.empty(shape)
    if len(shape) == 2:
        nn.init.xavier_uniform_(w, gain=gain, generator=generator)
    else:
        field = math.prod(shape[:-2])
        bound = gain * math.sqrt(6.0 / ((shape[-2] + shape[-1]) * field))
        w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


def zeros(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape))


def _packs(graph: GraphBatch, kind: str) -> tuple:
    """The batch-carried packs of ``kind``.  The port always builds the
    packs a layer consumes, so a missing pack is an error."""
    if graph.packs is None or kind not in graph.packs:
        raise ValueError(f"batch carries no {kind!r} pack")
    return graph.packs[kind]


def packed_spmm(graph: GraphBatch, kind: str,
                h: torch.Tensor) -> torch.Tensor:
    """SpMM over the batch-carried packs of ``kind`` (layers.py:63-84,
    single-device branch)."""
    fwd, bwd = _packs(graph, kind)
    return spmm_pack_vjp(fwd, bwd, h)


def packed_aggregate(graph: GraphBatch, h: torch.Tensor, agg: str,
                     normalize_adj: bool) -> torch.Tensor:
    """GeneralConv's aggregation of the messages h over the receivers
    (graphgym_tpu/ops/sparse.py:25-57 as layers.py:626-642 calls it):
    'add' and 'mean' are K1 on the pack ``agg_kind`` names (the mean's
    division is in its weights), 'max' the segmented max on it, each
    with its backward on the transpose pack: no float atomics."""
    fwd, bwd = _packs(graph, agg_kind(agg, normalize_adj))
    if agg == "max":
        return packed_max_vjp(fwd, bwd, h)
    return spmm_pack_vjp(fwd, bwd, h)


def packed_attention(graph: GraphBatch, h_heads: torch.Tensor,
                     score_fn: Optional[Callable] = None,
                     values: Optional[torch.Tensor] = None,
                     keys: Optional[torch.Tensor] = None,
                     node_scores: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                     score_transform: Optional[Callable] = None,
                     dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Multi-head attention over the 'att' pack (layers.py:92-176):
    per-edge scores and the softmax run on scalars in packed slot
    order, and the value aggregation runs through the per-head kernel
    K3 (``segment_matmul_headed_vjp``), which gathers v[senders]
    itself.  The softmax's row sums (``packed_segment_softmax``) and
    the node scores' gradients (``packed_node_scores``) are K3 row sums
    too: no float atomics forward or backward.

    h_heads: [N, H, d] receiver-side (query) features; keys and values
    default to h_heads.  score_fn(h_i, h_j) -> [NC, C, H] raw scores of
    the gathered [NC, C, H, d] features; a ``ScaledDot`` score_fn is
    computed on the packs instead (``packed_scaled_dot``: the SDDMM
    kernel, and K3 for its gradients), with no [NC, C, H, d] tensor.
    node_scores: optional (s_dst [N, H], s_src [N, H]) for scores that
    decompose per node (GAT's additive attention); only those scalars
    are gathered per edge, and alpha = score_transform(s_dst[i] +
    s_src[j]).  dropout_rate > 0 drops coefficients with a mask drawn
    from ``generator``.  Returns [N, H, dv]."""
    if score_fn is None and node_scores is None:
        raise ValueError("packed_attention needs score_fn or node_scores")
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-device attention is not ported yet (ROADMAP A16)")
    fwd, bwd, slot_map = _packs(graph, "att")
    n = graph.num_nodes
    heads = h_heads.shape[1]
    v = values if values is not None else h_heads
    dv = v.shape[-1]
    if node_scores is not None:
        alpha = packed_node_scores(*node_scores, fwd, bwd, slot_map)
        if score_transform is not None:
            alpha = score_transform(alpha)
    else:
        k = keys if keys is not None else h_heads
        if isinstance(score_fn, ScaledDot):
            alpha = packed_scaled_dot(h_heads, k, fwd, bwd, slot_map,
                                      score_fn.scale)    # [NC, C, H]
        else:
            alpha = score_fn(take_padded(h_heads, pack_rows(fwd)),
                             take_padded(k, fwd.senders))
    # masked to the slots of nonzero pack weight: padding slots have
    # local row 0, so their rows name a real row
    alpha = packed_segment_softmax(alpha.reshape(
        fwd.senders.shape + (heads,)), fwd)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(alpha.shape, generator=generator,
                          device=alpha.device) < 1.0 - dropout_rate
        alpha = torch.where(keep, alpha / (1.0 - dropout_rate), 0.0)
    out = segment_matmul_headed_vjp(v.reshape(n, heads * dv), alpha, fwd,
                                    bwd, slot_map)
    return out.view(n, heads, dv)


class ScaledDot:
    """The score sum(q_i * k_j) / scale over the last axis.
    ``packed_attention`` recognises it and computes it on the packs."""

    def __init__(self, scale: float):
        self.scale = scale

    def __call__(self, q_i: torch.Tensor, k_j: torch.Tensor) -> torch.Tensor:
        return (q_i * k_j).sum(-1) / self.scale


def scaled_dot(dh: int, dtype: torch.dtype) -> ScaledDot:
    """score(q_i, k_j) = sum(q_i * k_j) / sqrt(dh), the scale rounded
    to the input dtype as in the JAX package (layers.py:454)."""
    return ScaledDot(torch.sqrt(torch.tensor(float(dh), dtype=dtype)).item())


class TfgGATConv(nn.Module):
    """tf_geometric-style multi-head dot-product attention GAT
    (layers.py:415-499; reference TfgIDLayer.py:269-388 ``gat_id``
    without the identity kernel):

      Q = relu(x Wq + bq),  K = relu(x Wk + bk),  V = x Wv
      score = sum_h(Q_h[i] * K_h[j]) / sqrt(d_h);  alpha = edge softmax
      h = per-head alpha-weighted sum of V_h[j], heads concatenated

    Only the packed branch is ported: value heads split (dim_out
    divisible by heads), attention width dim_out, relu on Q and K (the
    JAX layer's defaults, which no model overrides)."""

    has_id_kernel = False

    def __init__(self, dim_in: int, dim_out: int, heads: int = 1,
                 use_bias: bool = True, att_dropout: float = 0.0, *,
                 generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim_out % heads != 0:
            raise NotImplementedError(
                f"{type(self).__name__}: {heads} heads do not divide "
                f"{dim_out}; the non-packed attention branch is not "
                "ported yet (ROADMAP A10b)")
        if att_dropout > 0 and dropout_generator is None:
            raise ValueError("att_dropout > 0 needs a dropout_generator")
        self.heads = heads
        self.att_dropout = att_dropout
        self.dropout_generator = dropout_generator
        self.query_kernel = glorot((dim_in, dim_out), generator)
        self.query_bias = zeros((dim_out,))
        self.key_kernel = glorot((dim_in, dim_out), generator)
        self.key_bias = zeros((dim_out,))
        self.kernel = glorot((dim_in, dim_out), generator)
        if self.has_id_kernel:
            self.id_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def values(self, graph: GraphBatch) -> torch.Tensor:
        return torch.matmul(graph.node_feat, self.kernel)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        n, dim_out = x.shape[0], self.kernel.shape[1]
        dh = dim_out // self.heads
        q = torch.relu(x @ self.query_kernel + self.query_bias)
        k = torch.relu(x @ self.key_kernel + self.key_bias)
        v = self.values(graph)
        out = packed_attention(
            graph, q.view(n, self.heads, dh), scaled_dot(dh, x.dtype),
            values=v.view(n, self.heads, dh),
            keys=k.view(n, self.heads, dh),
            dropout_rate=self.att_dropout if self.training else 0.0,
            generator=self.dropout_generator).reshape(n, dim_out)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GATConv(nn.Module):
    """PyG-style additive-attention GAT (layers.py:336-412; reference
    layer.py:155-162):

      h = x W (heads of dim_out / H columns)
      e_ij = leakyrelu(a_l . h_i + a_r . h_j), alpha = edge softmax
      out_i = sum_j alpha_ij h_j, heads concatenated; + b

    The score decomposes per endpoint, so only the [N, H] node scores
    are gathered per slot (``packed_attention``'s node_scores branch,
    the JAX layer's packed branch): self-loops are those of the 'att'
    pack, one per real node.  The non-packed branch, and heads that do
    not divide dim_out, are ROADMAP A10b."""

    has_id_kernel = False

    def __init__(self, dim_in: int, dim_out: int, heads: int = 1,
                 use_bias: bool = False, negative_slope: float = 0.2,
                 att_dropout: float = 0.0, *, generator: torch.Generator,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim_out % heads != 0:
            raise NotImplementedError(
                f"{type(self).__name__}: {heads} heads do not divide "
                f"{dim_out}; the non-packed attention branch is not "
                "ported yet (ROADMAP A10b)")
        if att_dropout > 0 and dropout_generator is None:
            raise ValueError("att_dropout > 0 needs a dropout_generator")
        self.heads = heads
        self.negative_slope = negative_slope
        self.att_dropout = att_dropout
        self.dropout_generator = dropout_generator
        per_head = dim_out // heads
        self.kernel = glorot((dim_in, dim_out), generator)
        if self.has_id_kernel:
            self.id_kernel = glorot((dim_in, dim_out), generator)
        self.att = glorot((1, heads, 2 * per_head), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def project(self, graph: GraphBatch) -> torch.Tensor:
        return graph.node_feat @ self.kernel

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = self.project(graph)
        n, dim_out = h.shape
        per_head = dim_out // self.heads
        h = h.view(n, self.heads, per_head)
        s_dst = (h * self.att[:, :, :per_head]).sum(-1)     # [N, H]
        s_src = (h * self.att[:, :, per_head:]).sum(-1)
        out = packed_attention(
            graph, h, node_scores=(s_dst, s_src),
            score_transform=functools.partial(
                F.leaky_relu, negative_slope=self.negative_slope),
            dropout_rate=self.att_dropout if self.training else 0.0,
            generator=self.dropout_generator).reshape(n, dim_out)
        if self.bias is not None:
            out = out + self.bias
        return graph.replace(node_feat=out)


class GCNConv(nn.Module):
    """GCN with the renormalization trick: h = D^-1/2 (A+I) D^-1/2 (x W)
    + b (layers.py:266-293; reference layer.py:135-142,
    TfgIDLayer.py:478-525 without the id kernel), on the 'gcn' pack.
    The JAX layer's ``improved`` option takes the COO path (ROADMAP A0)
    and no model sets it."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = packed_spmm(graph, "gcn", graph.node_feat @ self.kernel)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class SAGEConv(nn.Module):
    """GraphSAGE with mean aggregation over the 'mean' pack
    (layers.py:296-333).  combine='concat' is tfg MeanGraphSage
    (TfgIDLayer.py:86-120): h = [x W_self || mean_nb(x) W_nb];
    combine='sum' is pyg SAGEConv (reference layer.py:145-152):
    h = x W_self + mean_nb(x) W_nb."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 combine: str = "sum", *, generator: torch.Generator):
        super().__init__()
        if combine not in ("sum", "concat"):
            raise ValueError(f"SAGEConv combine {combine!r}")
        if combine == "concat" and dim_out % 2:
            raise ValueError("SAGEConv concat needs an even dim_out (tfg: "
                             "'units must be an even number if concat is "
                             "True')")
        self.combine = combine
        d = dim_out // 2 if combine == "concat" else dim_out
        self.self_kernel = glorot((dim_in, d), generator)
        self.neighbor_kernel = glorot((dim_in, d), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h_nb = packed_spmm(graph, "mean", x) @ self.neighbor_kernel
        h_self = x @ self.self_kernel
        h = (torch.cat([h_self, h_nb], -1) if self.combine == "concat"
             else h_self + h_nb)
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class GeneralConv(nn.Module):
    """GraphGym's configurable conv (layers.py:606-652; reference
    contrib/layer/generalconv.py:12-114), the default gnn.layer_type:

      h = x W;  h_msg = agg over receivers of w * h[senders] (+ b)
      self_msg 'none': h_msg;  'add': h_msg + h;  'concat': h_msg + x W_self

    w is the edge weight, or the GCN sym-norm weight with self-loops if
    normalize_adj; agg is 'add', 'mean' or 'max' (``packed_aggregate``),
    taken after the projection, at dim_out.  The JAX layer's
    ``improved`` is set by no config (as in ``gcn_norm``)."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 agg: str = "add", self_msg: str = "concat",
                 normalize_adj: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        if self_msg not in ("none", "add", "concat"):
            raise ValueError(f"self_msg {self_msg} not defined")
        agg_kind(agg, normalize_adj)
        self.agg, self.self_msg = agg, self_msg
        self.normalize_adj = normalize_adj
        self.kernel = glorot((dim_in, dim_out), generator)
        if self_msg == "concat":
            self.self_kernel = glorot((dim_in, dim_out), generator)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h = x @ self.kernel
        out = packed_aggregate(graph, h, self.agg, self.normalize_adj)
        if self.bias is not None:
            out = out + self.bias
        if self.self_msg == "add":
            out = out + h
        elif self.self_msg == "concat":
            out = out + x @ self.self_kernel
        return graph.replace(node_feat=out)


def gin_mlp_init(mod: nn.Module, prefix: str, dim_in: int, dim_out: int,
                 with_bn: bool, generator: torch.Generator,
                 gain: float = 1.0) -> None:
    """Register the GIN MLP's parameters on ``mod`` under the flax
    names: <prefix>_kernel1/_bias1/_kernel2/_bias2 (kernels drawn at
    ``gain``: LINEAR_GAIN for the torch path's ginconv, whose MLP is
    nn.Linear, layers.py:551-562) and, with BN, the submodule
    <prefix>_bn (its eps and momentum are the JAX layer's defaults, not
    cfg.bn's, as at layers.py:568)."""
    setattr(mod, f"{prefix}_kernel1",
            glorot((dim_in, dim_out), generator, gain))
    setattr(mod, f"{prefix}_bias1", zeros((dim_out,)))
    setattr(mod, f"{prefix}_kernel2",
            glorot((dim_out, dim_out), generator, gain))
    setattr(mod, f"{prefix}_bias2", zeros((dim_out,)))
    if with_bn:
        setattr(mod, f"{prefix}_bn", MaskedBatchNorm(dim_out))


def _gin_mlp(mod: nn.Module, prefix: str, h: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The 2-layer GIN MLP (layers.py:551-570): Dense -> ReLU -> Dense,
    then BN over the ``mask`` rows -> ReLU when <prefix>_bn exists (the
    Tfg variant, reference main_zd.py:181-186).  Its weight names
    contain 'kernel', so the Tfg L2 term covers them."""
    def p(name):
        return getattr(mod, f"{prefix}_{name}")
    h = torch.relu(h @ p("kernel1") + p("bias1"))
    h = h @ p("kernel2") + p("bias2")
    bn = getattr(mod, f"{prefix}_bn", None)
    if bn is not None:
        h = torch.relu(bn(h, mask))
    return h


class GINConv(nn.Module):
    """GIN: h = MLP((1 + eps) x + sum_neighbors x) (layers.py:502-548;
    reference layer.py:165-174, TfgIDLayer.py:123-167), the neighbor sum
    on the 'plain' pack, with eps = 0 (the JAX layer's default, which no
    model changes).  Only ``agg='sum'`` is ported: the JAX package's
    other cfg.gnn.gin_agg ablations take the COO SpMM (ROADMAP A0)."""

    def __init__(self, dim_in: int, dim_out: int, mlp_bn: bool = False,
                 agg: str = "sum", mlp_gain: float = 1.0, *,
                 generator: torch.Generator):
        super().__init__()
        if agg != "sum":
            raise NotImplementedError(
                f"GINConv agg {agg!r} needs the COO SpMM, which is not "
                "ported yet (ROADMAP A0)")
        gin_mlp_init(self, "mlp", dim_in, dim_out, mlp_bn, generator,
                     mlp_gain)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h = x + packed_spmm(graph, "plain", x)
        return graph.replace(node_feat=_gin_mlp(self, "mlp", h,
                                                graph.node_mask))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax nn.Dropout in train mode: each entry kept with probability
    1 - rate, from a uniform draw of ``generator``, and scaled by 1 /
    (1 - rate); dropped entries are 0."""
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


class GeneralLayer(nn.Module):
    """conv + BatchNorm + dropout + act wrapper
    (graphgym_tpu/nn/layers.py:204-234; reference layer.py:16-47):
    ``layer``, then ``bn`` (MaskedBatchNorm over the real nodes), then
    dropout (train mode only, masks from ``dropout_generator``), then
    the activation (act ``prelu`` is the learnable ``PReLU`` module
    ``act``).  The JAX wrapper's own L2 norm is set by no caller: the
    stages apply theirs.  The Tfg path's wrapper is a conv and its
    activation."""

    def __init__(self, layer: nn.Module, dim_out: Optional[int] = None,
                 has_act: bool = True, has_bn: bool = False,
                 dropout: float = 0.0, act: str = "relu",
                 bn_eps: float = 1e-5, bn_mom: float = 0.1,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        if dropout > 0 and dropout_generator is None:
            raise ValueError("dropout > 0 needs a dropout_generator")
        self.layer = layer
        self.bn = (MaskedBatchNorm(dim_out, eps=bn_eps, momentum=bn_mom)
                   if has_bn else None)
        self.dropout = dropout
        self.dropout_generator = dropout_generator
        if has_act and act == "prelu":
            self.act = PReLU()
        else:
            self.act = act_dict[act] if has_act else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        graph = self.layer(graph)
        x = graph.node_feat
        if self.bn is not None:
            x = self.bn(x, graph.node_mask)
        if self.dropout > 0 and self.training:
            x = dropout(x, self.dropout, self.dropout_generator)
        if self.act is not None:
            x = self.act(x)
        return graph.replace(node_feat=x)


class Linear(nn.Module):
    """Linear layer on node features (graphgym_tpu/nn/layers.py:183-201;
    reference layer.py:72-82), its kernel drawn at LINEAR_GAIN."""

    def __init__(self, dim_in: int, dim_out: int, use_bias: bool = False,
                 *, generator: torch.Generator):
        super().__init__()
        self.kernel = glorot((dim_in, dim_out), generator, LINEAR_GAIN)
        self.bias = zeros((dim_out,)) if use_bias else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        h = graph.node_feat @ self.kernel
        if self.bias is not None:
            h = h + self.bias
        return graph.replace(node_feat=h)


class MLP(nn.Module):
    """MLP on node features (graphgym_tpu/nn/layers.py:237-259;
    reference layer.py:109-132): num_layers - 1 hidden Linear + BN +
    act blocks (width ``dim_inner``, else the input's), then a plain
    Linear; no dropout, as no caller of the JAX MLP sets it.
    ``layers`` holds them all, each a GeneralLayer around its Linear
    (the last with no BN or act), as flax names them: ``Linear_<j>``
    and ``GeneralLayer_<j>``."""

    def __init__(self, dim_in: int, dim_out: int, num_layers: int = 2,
                 dim_inner: Optional[int] = None, use_bias: bool = True,
                 act: str = "relu", *, generator: torch.Generator):
        super().__init__()
        layers = []
        for _ in range(num_layers - 1):
            d = dim_inner if dim_inner is not None else dim_in
            layers.append(GeneralLayer(
                Linear(dim_in, d, generator=generator), d, has_act=True,
                has_bn=True, act=act))
            dim_in = d
        layers.append(GeneralLayer(
            Linear(dim_in, dim_out, use_bias=use_bias, generator=generator),
            has_act=False))
        self.layers = nn.ModuleList(layers)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        for layer in self.layers:
            graph = layer(graph)
        return graph
