"""Normalization layers aware of node padding (the port of
graphgym_tpu/nn/norm.py).

The reference applies plain nn.BatchNorm1d over node features
(graphgym/models/layer.py:28-29, 85-106).  Under the static-shape
padding scheme the batch statistics must exclude padded rows, so the
batch norm here takes a row mask.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graphgym_tpu_torch.nn.remat import recomputing


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the rows ``mask`` selects (all rows without one).

    torch BatchNorm1d semantics: the batch is normalized with its biased
    variance, the running variance tracks the unbiased one (count /
    (count - 1)), ``momentum`` is the weight of the new batch statistic
    (cfg.bn.mom), and ``eval()`` normalizes with the running ``mean``
    and ``var`` buffers, as the JAX eval step uses ``batch_stats``.  A
    rematerialized layer's recompute (nn/remat.py) leaves the buffers as
    its forward moved them.
    Statistics are taken in f32 (float64 for float64 x).  Parameters ``scale`` and ``bias`` and
    the buffers keep the flax names."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        xs = x if x.dtype == torch.float64 else x.float()
        if self.training:
            if mask is not None:
                m = mask.to(xs.dtype)[:, None]
                count = m.sum().clamp_min(1.0)
                mean = (xs * m).sum(0) / count
                var = (m * (xs - mean) ** 2).sum(0) / count
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
            else:
                n = xs.shape[0]
                mean = xs.mean(0)
                var = xs.var(0, unbiased=False)
                unbiased = var * n / max(n - 1, 1)
            if not recomputing():    # once a step under remat
                with torch.no_grad():
                    mom = self.momentum
                    self.mean.copy_((1 - mom) * self.mean + mom * mean)
                    self.var.copy_((1 - mom) * self.var + mom * unbiased)
        else:
            mean, var = self.mean, self.var
        y = ((xs - mean) * torch.reciprocal(torch.sqrt(var + self.eps)))
        return y.to(x.dtype) * self.scale + self.bias


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) (reference gnn.py:79-80), the norm taken in
    f32 (float64 for float64 x).  The sum of squares is clamped at eps^2 before its square root,
    so a row of norm below eps (an all-zero padding row, which a model
    without BatchNorm keeps at 0) divides by eps and passes no gradient
    to its norm, as F.normalize's does.  The JAX package clamps after
    the root (graphgym_tpu/nn/norm.py:68-74), whose gradient at a zero
    row is 0 * inf = NaN (ROADMAP C5); on every other row the two are
    the same function."""
    xs = x if x.dtype == torch.float64 else x.float()
    norm = torch.sqrt((xs * xs).sum(dim, keepdim=True).clamp_min(eps * eps))
    return (xs / norm).to(x.dtype)
