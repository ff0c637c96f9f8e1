"""Masked segment reductions (the port of graphgym_tpu/ops/segment.py).

The JAX package's equivalents of tf.math.unsorted_segment_{sum,min,max}
and tf_geometric's segment_softmax (reference sparse_adj.py:84-97,
136-151).  Here they are ``index_add`` and ``scatter_reduce`` over a
fixed ``num_segments``; every segment id must lie in [0, num_segments).
Under the GraphBatch padding convention padded elements target the
padding segment, so sums need no mask; mean, max, min and softmax take
an optional mask.
"""

from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0.0)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over each segment; empty segments yield 0 (tf_geometric's
    mean_reducer, TfgIDLayer.py:98)."""
    if mask is not None:
        data = torch.where(_expand(mask, data), data, 0.0)
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments, mask).clamp_min(1.0)
    return total / _expand(count, total)


def _segment_extreme(data, segment_ids, num_segments, mask, reduce, fill):
    if mask is not None:
        data = torch.where(_expand(mask, data), data, fill)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    index = _expand(segment_ids, data).expand_as(data)
    out = out.scatter_reduce(0, index, data, reduce)
    return torch.where(torch.isfinite(out), out, 0.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max over each segment; empty segments yield 0 (torch_scatter's
    'max' fills empty outputs with 0 in the reference's pooling)."""
    return _segment_extreme(data, segment_ids, num_segments, mask, "amax",
                            float("-inf"))


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, mask, "amin",
                            float("inf"))


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within each segment (the GAT edge
    softmax, reference sparse_adj.py:136-151), computed in f32.
    Masked-out entries get probability 0; fully masked segments give
    all-zero probabilities rather than NaN.

    The segment max is taken without gradient: the softmax does not
    depend on the shift, so its gradient through the max is zero in
    exact arithmetic (the JAX package differentiates it and gets zero
    up to rounding)."""
    in_dtype = logits.dtype
    logits = logits.float()
    neg_inf = -1e30
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    with torch.no_grad():
        seg_max = logits.new_full((num_segments,) + tuple(logits.shape[1:]),
                                  float("-inf"))
        index = _expand(segment_ids, logits).expand_as(logits)
        seg_max = seg_max.scatter_reduce(0, index, logits, "amax")
        seg_max = torch.where(torch.isfinite(seg_max)
                              & (seg_max > neg_inf / 2), seg_max, 0.0)
    exp = torch.exp(logits - seg_max.index_select(0, segment_ids))
    if mask is not None:
        exp = torch.where(mask, exp, 0.0)
    denom = segment_sum(exp, segment_ids, num_segments).clamp_min(1e-16)
    return (exp / denom.index_select(0, segment_ids)).to(in_dtype)


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-row vector against trailing dims of ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))
