"""Optimizer and learning-rate schedule (the port of
graphgym_tpu/train/optim.py, reference graphgym/optimizer.py:9-49).

torch.optim.Adam has the semantics the JAX package builds from optax
(weight decay added to the gradient before the moments).  SGD is the
optax chain add_decayed_weights(wd) -> trace(momentum) -> lr
(train/optim.py:51-58), which is torch's SGD with dampening 0 (the
first step's buffer is the gradient in both); it is written out here
as foreach ops (``SGD``) because torch.optim.SGD reads a tensor lr back
to the host, which a captured step cannot do.  The Tfg path
puts its L2 term in the loss and runs Adam without weight decay
(main_zd.py:311).  The schedule is stepped once per optimizer step, as
the optax schedules are:

  none  — base_lr
  steps — base_lr * lr_decay^(number of epoch boundaries passed)
  cos   — base_lr * 0.5 * (1 + cos(pi * min(step, T) / T)),
          T = max_epoch * steps_per_epoch (optax.cosine_decay_schedule)

On a CUDA card Adam is capturable and the learning rate of either
optimizer a 0-d float32 tensor on the card: the captured train step
(train/graphed.py) reads both from device memory.  The schedule fills
the tensor in place between steps, on the host, rather than computing
it in the graph from the step count: one definition of each schedule
serves both devices and the log (which records the host float of each
step's lr, as the JAX Trainer does), at the cost of one small fill
launch a step.
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


class SGD(torch.optim.Optimizer):
    """SGD with momentum and weight decay, as optax's chain builds it
    (graphgym_tpu/train/optim.py:51-58):

      u = g + wd * p;  buf = u at the first step, else momentum * buf + u
      (no buffer at momentum 0: buf = u);  p += buf * -lr

    The update is foreach ops that take the lr as it is, a float or a
    0-d tensor (which the captured step reads from the card); nothing
    is read back to the host, so a CUDA graph can capture a step after
    the first (the first builds the momentum buffers)."""

    def __init__(self, params, lr, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"] != 0:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            if group["momentum"] != 0:
                states = [self.state[p] for p in params]
                if all("momentum_buffer" in st for st in states):
                    bufs = [st["momentum_buffer"] for st in states]
                    torch._foreach_mul_(bufs, group["momentum"])
                    torch._foreach_add_(bufs, grads)
                else:
                    bufs = [g.clone() for g in grads]
                    for st, buf in zip(states, bufs):
                        st["momentum_buffer"] = buf
                grads = bufs
            torch._foreach_add_(params,
                                torch._foreach_mul(grads, -group["lr"]))


def create_optimizer(params: Iterable[torch.nn.Parameter], optim_cfg,
                     steps_per_epoch: int, use_loss_l2: bool = False,
                     device: Optional[torch.device] = None):
    """(optimizer, StepSchedule): Adam or SGD.  use_loss_l2=True (Tfg
    path) disables optimizer weight decay.  On a CUDA ``device`` the lr
    is a 0-d float32 tensor there and Adam is capturable."""
    if optim_cfg.optimizer not in ("adam", "sgd"):
        raise NotImplementedError(
            f"optimizer {optim_cfg.optimizer!r} is not ported yet "
            "(ROADMAP A15b)")
    wd = 0.0 if use_loss_l2 else optim_cfg.weight_decay
    cuda = device is not None and torch.device(device).type == "cuda"
    lr = (torch.tensor(optim_cfg.base_lr, dtype=torch.float32, device=device)
          if cuda else optim_cfg.base_lr)
    if optim_cfg.optimizer == "sgd":
        opt = SGD(params, lr=lr, momentum=optim_cfg.momentum,
                  weight_decay=wd)
    else:
        opt = torch.optim.Adam(params, lr=lr, weight_decay=wd,
                               capturable=cuda)
    sched = StepSchedule(opt, make_lr_factor(optim_cfg, steps_per_epoch),
                         optim_cfg.base_lr)
    return opt, sched
