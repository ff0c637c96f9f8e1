"""Integer feature encoders (the port of graphgym_tpu/nn/encoders.py;
reference graphgym/models/feature_encoder.py:13-118): categorical node
or edge features embedded before message passing.

AtomEncoder / BondEncoder follow the OGB molecule convention: one table
a feature column, the columns' rows summed (``ATOM_FEATURE_DIMS``,
``BOND_FEATURE_DIMS``; ids clipped into each table).  The
IntegerFeatureEncoder (256 rows, Glorot-uniform) and SingleAtomEncoder
embed column 0 as flax's ``nn.Embed`` does: an id outside the table
gives a NaN row, a negative one counts from the table's end.

The lookup reads the batch's embedding pack (``graphs/packing.
build_embed_pack``), which the loader builds beside the batch: the
forward gathers the stacked tables' rows, and the tables' gradient is
K2's segmented sum (``csrc/packed_segment.cu``) of the output gradient's
item rows, read in place, over the (item, column) slots sorted by row,
so no float atomics, no gathered copy and no copy to the host in a
captured step.  Modules take (emb_dim,
init generator) and map a GraphBatch to a GraphBatch, as a registered
encoder (register.node_encoder_dict / edge_encoder_dict) does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.graphs.packing import (EDGE_ENCODER, EMBED_TABLES,
                                               NODE_ENCODER, EmbedPack,
                                               embed_index)
from graphgym_tpu_torch.nn.layers import glorot
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K


def table_grad(pack: EmbedPack, g: torch.Tensor, num_rows: int,
               kind: str = "") -> torch.Tensor:
    """The stacked tables' gradient [num_rows, D] of the lookup: per
    table row, the sum of ``g``'s rows of its slots' items in slot order,
    by K2 reading g in place (its plain version on the CPU; counted
    under the pack's ``kind``); the slots of ids outside the tables land
    past num_rows and are dropped."""
    out = K.segment_sum(g, embed_index(pack), kind)
    return out[:num_rows].to(g.dtype)


class EmbedSumFn(torch.autograd.Function):
    """out[m] = sum over the pack's columns c, in column order, of
    table[rows[m, c]] (a NaN row for rows[m, c] == table rows); the
    table's gradient ``table_grad``, its K2 counted under the batch
    pack's ``kind``.  The pack gets no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, pack: EmbedPack,
                kind: str) -> torch.Tensor:
        ctx.pack, ctx.kind = pack, kind
        ctx.num_rows = table.shape[0]
        ext = torch.cat([table, table.new_full((1, table.shape[1]),
                                               float("nan"))])
        out = ext.index_select(0, pack.rows[:, 0])
        for c in range(1, pack.rows.shape[1]):
            out = out + ext.index_select(0, pack.rows[:, c])
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return table_grad(ctx.pack, g, ctx.num_rows, ctx.kind), None, None


def embed_pack(graph: GraphBatch, kind: str) -> EmbedPack:
    if graph.packs is None or kind not in graph.packs:
        raise ValueError(f"the encoder needs the batch's {kind!r} pack, "
                         "which the loader builds (graphs/packing."
                         "build_embed_pack)")
    return graph.packs[kind][0]


def embed_init(shape, generator: torch.Generator) -> nn.Parameter:
    """flax nn.Embed's default init (variance_scaling(1, fan_in, normal,
    out_axis=0)): a normal truncated at two deviations, of deviation
    sqrt(1 / width) / 0.8796 (the truncation's correction)."""
    std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    return nn.Parameter(w)


class IntegerFeatureEncoder(nn.Module):
    """One table of 256 rows over node feature column 0 (reference
    feature_encoder.py:13-31), flax's Glorot-uniform init."""

    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__()
        self.embedding = glorot((EMBED_TABLES["Integer"][0][0], emb_dim),
                                generator)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        return graph.replace(node_feat=EmbedSumFn.apply(
            self.embedding, embed_pack(graph, NODE_ENCODER), NODE_ENCODER))


class SingleAtomEncoder(nn.Module):
    """One table over the atom-type column 0 of the OGB atom features
    (reference feature_encoder.py:34-53)."""

    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__()
        self.embedding = embed_init(
            (EMBED_TABLES["SingleAtom"][0][0], emb_dim), generator)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        return graph.replace(node_feat=EmbedSumFn.apply(
            self.embedding, embed_pack(graph, NODE_ENCODER), NODE_ENCODER))


class _MultiColumnEncoder(nn.Module):
    """A table ``col<i>`` a column of ``dims`` rows, flax's default
    embedding init; the lookup sums the tables of the pack's columns."""
    kind = NODE_ENCODER

    def __init__(self, emb_dim: int, dims: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        self.num_cols = len(dims)
        for i, n in enumerate(dims):
            setattr(self, f"col{i}", embed_init((n, emb_dim), generator))

    def lookup(self, graph: GraphBatch) -> torch.Tensor:
        pack = embed_pack(graph, self.kind)
        table = torch.cat([getattr(self, f"col{i}")
                           for i in range(pack.rows.shape[1])])
        return EmbedSumFn.apply(table, pack, self.kind)


class AtomEncoder(_MultiColumnEncoder):
    """The sum of the atom feature columns' embeddings (reference
    feature_encoder.py:56-81)."""

    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__(emb_dim, EMBED_TABLES["Atom"][0], generator)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        return graph.replace(node_feat=self.lookup(graph))


class BondEncoder(_MultiColumnEncoder):
    """The sum of the bond feature columns' embeddings over edge_feat
    (reference feature_encoder.py:84-118)."""
    kind = EDGE_ENCODER

    def __init__(self, emb_dim: int, generator: torch.Generator):
        super().__init__(emb_dim, EMBED_TABLES["Bond"][0], generator)

    def forward(self, graph: GraphBatch) -> GraphBatch:
        if graph.edge_feat is None:
            raise ValueError("the Bond encoder needs edge features, and "
                             "the batch has none")
        return graph.replace(edge_feat=self.lookup(graph))


node_encoder_dict = {
    "Integer": IntegerFeatureEncoder,
    "SingleAtom": SingleAtomEncoder,
    "Atom": AtomEncoder,
}

edge_encoder_dict = {
    "Bond": BondEncoder,
}
