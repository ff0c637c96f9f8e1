"""Loss computation (the port of graphgym_tpu/train/loss.py:27-100).

Masked: padded prediction slots contribute zero and the mean divides by
the real count.  Covers the multi-class cross-entropy branch and the
Tfg path's 5e-4 * sum of l2_loss over 'kernel' parameters
(reference loss.py:53-67).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LossOptions:
    loss_fun: str = "cross_entropy"
    size_average: str = "mean"        # mean | sum
    l2_kernel: float = 0.0            # Tfg path: 5e-4 on kernels


def compute_loss(pred: torch.Tensor, true: torch.Tensor,
                 mask: Optional[torch.Tensor], opts: LossOptions
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, softmax score).  pred: [L, C] logits; true: [L]
    int labels; mask: [L] bool over supervised slots."""
    pred = pred.float()
    if mask is None:
        mask = torch.ones(pred.shape[:1], dtype=torch.bool,
                          device=pred.device)
    if opts.loss_fun != "cross_entropy" or pred.dim() != 2 \
            or true.dim() != 1:
        raise NotImplementedError(
            "only multi-class cross-entropy is ported (ROADMAP A13b)")
    count = mask.float().sum().clamp_min(1.0)
    logp = torch.log_softmax(pred, dim=-1)
    nll = -logp.gather(1, true.long()[:, None])[:, 0]
    loss = torch.where(mask, nll, nll.new_zeros(())).sum()
    if opts.size_average == "mean":
        loss = loss / count
    return loss, logp.exp()


def kernel_l2(model: nn.Module, coeff: float) -> torch.Tensor:
    """coeff * sum(l2_loss(w)) over parameters whose name contains
    'kernel' (reference loss.py:65-67; l2_loss = sum(x^2)/2)."""
    total = sum((p.float().pow(2).sum() / 2.0
                 for name, p in model.named_parameters()
                 if "kernel" in name),
                torch.zeros((), device=next(model.parameters()).device))
    return coeff * total
