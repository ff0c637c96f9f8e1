"""Optimizer and learning-rate schedule (the port of
graphgym_tpu/train/optim.py, reference graphgym/optimizer.py:9-49).

torch.optim.Adam has the semantics the JAX package builds from optax
(weight decay added to the gradient before the moments).  The Tfg path
puts its L2 term in the loss and runs Adam without weight decay
(main_zd.py:311).  The schedule is stepped once per optimizer step, as
the optax schedules are:

  none  — base_lr
  steps — base_lr * lr_decay^(number of epoch boundaries passed)
  cos   — base_lr * 0.5 * (1 + cos(pi * min(step, T) / T)),
          T = max_epoch * steps_per_epoch (optax.cosine_decay_schedule)

On a CUDA card Adam is capturable and its learning rate a 0-d float32
tensor on the card: the captured train step (train/graphed.py) reads
both from device memory.  The schedule fills the tensor in place
between steps, on the host, rather than computing it in the graph
from Adam's step count: one definition of each schedule serves both
devices and the log (which records the host float of each step's lr,
as the JAX Trainer does), at the cost of one small fill launch a step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch


def make_lr_factor(optim_cfg, steps_per_epoch: int
                   ) -> Callable[[int], float]:
    """step -> lr / base_lr."""
    if optim_cfg.scheduler == "none":
        return lambda step: 1.0
    if optim_cfg.scheduler == "steps":
        bounds = [int(e) * steps_per_epoch for e in optim_cfg.steps]
        decay = optim_cfg.lr_decay
        return lambda step: decay ** sum(step >= b for b in bounds)
    if optim_cfg.scheduler == "cos":
        total = max(optim_cfg.max_epoch * steps_per_epoch, 1)
        return lambda step: 0.5 * (1.0 + math.cos(
            math.pi * min(step, total) / total))
    raise ValueError(f"Scheduler {optim_cfg.scheduler} not supported")


class StepSchedule:
    """The per-step learning rate: ``lr(step) = base_lr * factor(step)``,
    set on every param group at construction and after each optimizer
    step (LambdaLR's arithmetic).  A group whose lr is a tensor gets it
    filled in place, so a captured step that holds the tensor reads the
    new value; a float lr is replaced.  ``last_epoch`` counts the steps
    taken, as LambdaLR's does, and is all the state a checkpoint
    keeps."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 factor: Callable[[int], float], base_lr: float):
        self.optimizer = optimizer
        self.factor = factor
        self.base_lr = float(base_lr)
        self.last_epoch = 0
        self._apply()

    def lr(self, step: Optional[int] = None) -> float:
        """The host float of the lr of ``step`` (default: the next)."""
        return self.base_lr * self.factor(
            self.last_epoch if step is None else step)

    def step(self) -> None:
        self.last_epoch += 1
        self._apply()

    def _apply(self) -> None:
        lr = self.lr()
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.last_epoch = int(state["last_epoch"])
        self._apply()


def create_optimizer(params: Iterable[torch.nn.Parameter], optim_cfg,
                     steps_per_epoch: int, use_loss_l2: bool = False,
                     device: Optional[torch.device] = None):
    """(optimizer, StepSchedule).  use_loss_l2=True (Tfg path) disables
    optimizer weight decay.  On a CUDA ``device`` Adam is capturable,
    its lr a 0-d float32 tensor there."""
    if optim_cfg.optimizer != "adam":
        raise NotImplementedError(
            f"optimizer {optim_cfg.optimizer!r} is not ported yet "
            "(ROADMAP A15)")
    wd = 0.0 if use_loss_l2 else optim_cfg.weight_decay
    cuda = device is not None and torch.device(device).type == "cuda"
    lr = (torch.tensor(optim_cfg.base_lr, dtype=torch.float32, device=device)
          if cuda else optim_cfg.base_lr)
    opt = torch.optim.Adam(params, lr=lr, weight_decay=wd, capturable=cuda)
    sched = StepSchedule(opt, make_lr_factor(optim_cfg, steps_per_epoch),
                         optim_cfg.base_lr)
    return opt, sched
