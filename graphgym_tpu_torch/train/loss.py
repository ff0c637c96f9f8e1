"""Loss computation (the port of graphgym_tpu/train/loss.py:27-100;
reference graphgym/loss.py:11-67).

Masked: padded prediction slots contribute zero and the mean divides by
the real count.  Covers the torch path (cross_entropy: multi-class via
log_softmax + nll, binary or multi-label via BCE with logits; mse;
loss.py:36-47), a loss registered in register.loss_dict, and the Tfg
path's 5e-4 * sum of l2_loss over 'kernel' parameters (loss.py:53-67).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from graphgym_tpu_torch import register


@dataclasses.dataclass(frozen=True)
class LossOptions:
    loss_fun: str = "cross_entropy"   # cross_entropy | mse
    size_average: str = "mean"        # mean | sum
    l2_kernel: float = 0.0            # Tfg path: 5e-4 on kernels
    thresh: float = 0.5


def compute_loss(pred: torch.Tensor, true: torch.Tensor,
                 mask: Optional[torch.Tensor], opts: LossOptions
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (loss, normalized prediction score).  pred: [L] or [L, C]
    logits; true: [L] int labels, or labels of pred's shape (binary,
    multi-label, mse); mask: [L] bool over the supervised slots.  A
    trailing axis of 1 is squeezed from both.  The first loss in
    register.loss_dict that returns a value wins."""
    pred = pred.float()
    if pred.dim() > 1 and pred.shape[-1] == 1:
        pred = pred.squeeze(-1)
    if true.dim() > 1 and true.shape[-1] == 1:
        true = true.squeeze(-1)
    if mask is None:
        mask = torch.ones(pred.shape[:1], dtype=torch.bool,
                          device=pred.device)
    count = mask.float().sum().clamp_min(1.0)
    for func in register.loss_dict.values():
        value = func(pred, true, mask, opts)
        if value is not None:
            return value

    if opts.loss_fun == "cross_entropy":
        if pred.dim() > 1 and true.dim() == 1:
            logp = torch.log_softmax(pred, dim=-1)
            per = -logp.gather(1, true.long()[:, None])[:, 0]
            score = logp.exp()
        else:
            # BCE with logits, max(x, 0) - x t + log1p(exp(-|x|)); a
            # multi-label row averaged over its classes
            per = (pred.clamp_min(0) - pred * true.to(pred.dtype)
                   + torch.log1p(torch.exp(-pred.abs())))
            if per.dim() > 1:
                per = per.mean(-1)
            score = torch.sigmoid(pred)
    elif opts.loss_fun == "mse":
        per = (pred - true.to(pred.dtype)) ** 2
        if per.dim() > 1:
            per = per.mean(-1)
        score = pred
    else:
        raise ValueError(f"Loss func {opts.loss_fun} not supported")
    loss = torch.where(mask, per, per.new_zeros(())).sum()
    if opts.size_average == "mean":
        loss = loss / count
    return loss, score


def kernel_l2(model: nn.Module, coeff: float) -> torch.Tensor:
    """coeff * sum(l2_loss(w)) over parameters whose name contains
    'kernel' (reference loss.py:65-67; l2_loss = sum(x^2)/2)."""
    total = sum((p.float().pow(2).sum() / 2.0
                 for name, p in model.named_parameters()
                 if "kernel" in name),
                torch.zeros((), device=next(model.parameters()).device))
    return coeff * total
