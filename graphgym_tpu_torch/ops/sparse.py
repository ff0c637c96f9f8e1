"""COO SpMM, GCN normalization, row scatter and the ID-GNN
identity-colored projection.

The port of ``spmm``, ``degree``, ``inv_sqrt_degree``, ``gcn_norm``,
``scatter_add_rows`` and ``apply_id_weights`` from
graphgym_tpu/ops/sparse.py:25-57 and 77-152.  The JAX package leaves
the COO gather -> scale -> segment reduce and the row scatter to XLA;
here they are ``index_select``, ``index_add`` and ``scatter_reduce``
(``index_add`` adds with atomics on the card, in no fixed order).  The
COO ``spmm`` with ``implementation="pallas"`` packs the edges on the
host and runs the hand-written Hopper kernel K1 instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphgym_tpu_torch.ops import segment as S


def spmm(senders: torch.Tensor, receivers: torch.Tensor,
         edge_weight: Optional[torch.Tensor], x: torch.Tensor,
         num_nodes: int, *, reduce: str = "sum",
         edge_mask: Optional[torch.Tensor] = None,
         implementation: str = "xla") -> torch.Tensor:
    """out[r] = reduce over the edges (s, r) of edge_weight * x[s]
    (graphgym_tpu/ops/sparse.py:25-57), reduce 'sum', 'mean' or 'max';
    mean and max take an optional edge mask.

    ``implementation`` keeps the JAX package's names, so that
    ``cfg.tpu.spmm_impl`` and the benchmark's ``--impl`` read the same:
    'xla' is the gather and segment reduce above; 'pallas' routes a sum
    through ``spmm_pallas`` (a host pack, then the hand-written Hopper
    kernel K1 on a CUDA x; there is no Pallas here)."""
    if implementation == "pallas" and reduce == "sum":
        from graphgym_tpu_torch.ops.cuda.spmm_kernel import spmm_pallas
        return spmm_pallas(senders, receivers, edge_weight, x, num_nodes)
    msg = x.index_select(0, senders)
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    if reduce == "sum":
        return S.segment_sum(msg, receivers, num_nodes)
    if reduce == "mean":
        return S.segment_mean(msg, receivers, num_nodes, mask=edge_mask)
    if reduce == "max":
        return S.segment_max(msg, receivers, num_nodes, mask=edge_mask)
    raise ValueError(f"Unknown reduce: {reduce}")


def degree(receivers: torch.Tensor, edge_weight: torch.Tensor,
           num_nodes: int) -> torch.Tensor:
    """Weighted in-degree (graphgym_tpu/ops/sparse.py:77-83)."""
    return S.segment_sum(edge_weight, receivers, num_nodes)


def inv_sqrt_degree(deg: torch.Tensor) -> torch.Tensor:
    """deg^-1/2, 0 where that is not finite (reference
    TfgIDLayer.py:550-555)."""
    d = deg.pow(-0.5)
    return torch.where(torch.isfinite(d), d, d.new_zeros(()))


def gcn_norm(senders: torch.Tensor, receivers: torch.Tensor,
             num_nodes: int):
    """GCN renormalization D^-1/2 (A + I) D^-1/2 of a unit-weight graph
    (graphgym_tpu/ops/sparse.py:95-125 at its defaults): one self-loop
    of weight 1 is appended per node slot, never deduplicated, then each
    edge weight is scaled by both endpoints' deg^-1/2.  The degrees add
    with ``index_add``, which on the card adds in no fixed order; with
    unit weights every partial sum is an exact integer.

    Returns (senders, receivers, normed_edge_weight) with E + N entries
    (E without the loops)."""
    loop = torch.arange(num_nodes, dtype=senders.dtype,
                        device=senders.device)
    senders = torch.cat([senders, loop])
    receivers = torch.cat([receivers, loop])
    ones = torch.ones(senders.shape, dtype=torch.float32,
                      device=senders.device)
    dis = inv_sqrt_degree(degree(receivers, ones, num_nodes))
    return senders, receivers, dis[receivers] * dis[senders]


def scatter_add_rows(x: torch.Tensor, index: torch.Tensor,
                     updates: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x.at[index] += updates, out of place (reference idconv.py:64-67
    ``index_add_`` / TfgIDLayer.py:107 ``tensor_scatter_nd_add``)."""
    if mask is not None:
        updates = torch.where(mask[:, None], updates,
                              updates.new_zeros(()))
    return x.index_add(0, index, updates)


def apply_id_weights(x: torch.Tensor, id_index: torch.Tensor,
                     weight: torch.Tensor, weight_id: torch.Tensor,
                     id_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """h = x @ W with rows in id_index additionally += x[id] @ W_id
    (the identity-coloring trick, reference idconv.py:62-67)."""
    h = torch.matmul(x, weight)
    h_id = torch.matmul(x.index_select(0, id_index), weight_id)
    return scatter_add_rows(h, id_index, h_id, mask=id_mask)
