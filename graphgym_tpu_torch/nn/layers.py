"""Layer building blocks of the port (graphgym_tpu/nn/layers.py subset):
the glorot initializer, the packed SpMM and packed attention dispatch,
the packed-branch GCN, SAGE and GIN convs with the GIN MLP, the Tfg
dot-product GAT and the GeneralLayer wrapper.  Modules take and return
a GraphBatch whose arrays are tensors.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.nn.act import act_dict
from graphgym_tpu_torch.nn.norm import MaskedBatchNorm
from graphgym_tpu_torch.ops import segment as S
from graphgym_tpu_torch.ops.cuda.spmm_kernel import (
    pack_rows, packed_scaled_dot, segment_matmul_headed_vjp, spmm_pack_vjp)


def glorot(shape, generator: torch.Generator) -> nn.Parameter:
    """TF/flax glorot: uniform in +-sqrt(6 / (fan_in + fan_out)) for a
    [fan_in, fan_out] kernel (``variance_scaling(1, fan_avg, uniform)``,
    graphgym_tpu/nn/layers.py:48)."""
    w = torch.empty(shape)
    nn.init.xavier_uniform_(w, generator=generator)
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
    itself.

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
    rows = pack_rows(fwd)                        # [NC, C]
    # padding slots have local row 0, so their rows name a real row:
    # without the mask each would add exp(0) to that row's denominator
    valid = fwd.weights > 0

    def take_padded(arr, idx):
        # pack padding slots gather from index n: append a zero row
        padded = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
        return padded.index_select(0, idx.reshape(-1).long()).view(
            idx.shape + arr.shape[1:])

    if node_scores is not None:
        s_dst, s_src = node_scores
        alpha = take_padded(s_dst, rows) + take_padded(s_src, fwd.senders)
        if score_transform is not None:
            alpha = score_transform(alpha)
    else:
        k = keys if keys is not None else h_heads
        if isinstance(score_fn, ScaledDot):
            alpha = packed_scaled_dot(h_heads, k, fwd, bwd, slot_map,
                                      score_fn.scale)    # [NC, C, H]
        else:
            alpha = score_fn(take_padded(h_heads, rows),
                             take_padded(k, fwd.senders))
    flat = alpha.reshape(-1, heads)
    mask = valid.reshape(-1, 1).expand_as(flat)
    alpha = S.segment_softmax(flat, rows.reshape(-1), n, mask=mask)
    alpha = alpha.view(fwd.senders.shape + (heads,))
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
                "ported yet (ROADMAP A10)")
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


def gin_mlp_init(mod: nn.Module, prefix: str, dim_in: int, dim_out: int,
                 with_bn: bool, generator: torch.Generator) -> None:
    """Register the GIN MLP's parameters on ``mod`` under the flax
    names: <prefix>_kernel1/_bias1/_kernel2/_bias2 and, with BN, the
    submodule <prefix>_bn (its eps and momentum are the JAX layer's
    defaults, not cfg.bn's, as at layers.py:568)."""
    setattr(mod, f"{prefix}_kernel1", glorot((dim_in, dim_out), generator))
    setattr(mod, f"{prefix}_bias1", zeros((dim_out,)))
    setattr(mod, f"{prefix}_kernel2", glorot((dim_out, dim_out), generator))
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
                 agg: str = "sum", *, generator: torch.Generator):
        super().__init__()
        if agg != "sum":
            raise NotImplementedError(
                f"GINConv agg {agg!r} needs the COO SpMM, which is not "
                "ported yet (ROADMAP A0)")
        gin_mlp_init(self, "mlp", dim_in, dim_out, mlp_bn, generator)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        x = graph.node_feat
        h = x + packed_spmm(graph, "plain", x)
        return graph.replace(node_feat=_gin_mlp(self, "mlp", h,
                                                graph.node_mask))


class GeneralLayer(nn.Module):
    """conv + act wrapper (reference layer.py:16-47) for the Tfg path,
    which has no BatchNorm, dropout or L2 norm (nn/model.py:347-371)."""

    def __init__(self, layer: nn.Module, has_act: bool = True,
                 act: str = "relu"):
        super().__init__()
        if act == "prelu":
            raise NotImplementedError(
                "the learnable PReLU is not ported yet (ROADMAP A11)")
        self.layer = layer
        self.act = act_dict[act] if has_act else None

    def forward(self, graph: GraphBatch) -> GraphBatch:
        graph = self.layer(graph)
        if self.act is not None:
            graph = graph.replace(node_feat=self.act(graph.node_feat))
        return graph
