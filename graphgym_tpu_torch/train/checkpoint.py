"""Checkpointing (the port of graphgym_tpu/train/checkpoint.py,
reference graphgym/checkpoint.py:8-62) with torch.save.

<out_dir>/ckpt/<epoch>.ckpt holds the model, optimizer and scheduler
state dicts; load latest-or-given epoch; clean keeps only the last.
"""

from __future__ import annotations

import os

import torch


def _ckpt_dir(out_dir: str) -> str:
    return os.path.join(out_dir, "ckpt")


def _ckpt_path(out_dir: str, epoch: int) -> str:
    return os.path.join(_ckpt_dir(out_dir), f"{epoch}.ckpt")


def list_ckpt_epochs(out_dir: str):
    d = _ckpt_dir(out_dir)
    if not os.path.isdir(d):
        return []
    return sorted(int(f.split(".")[0]) for f in os.listdir(d)
                  if f.endswith(".ckpt"))


def save_ckpt(model, optimizer, scheduler, out_dir: str,
              epoch: int) -> None:
    os.makedirs(_ckpt_dir(out_dir), exist_ok=True)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()},
               _ckpt_path(out_dir, epoch))


def load_ckpt(model, optimizer, scheduler, out_dir: str,
              epoch: int = -1) -> int:
    """Restores in place; returns the epoch to start from (0 when there
    is nothing to resume; reference load_ckpt, checkpoint.py:25-40)."""
    epochs = list_ckpt_epochs(out_dir)
    if not epochs:
        return 0
    if epoch == -1 or epoch not in epochs:
        epoch = epochs[-1]
    state = torch.load(_ckpt_path(out_dir, epoch),
                       map_location=next(model.parameters()).device)
    model.load_state_dict(state["model"])
    # the loaded groups bring the saving run's lr object and capturable
    # flag: keep this run's (a tensor lr on the card), and Adam's step
    # counts where a capturable Adam reads them, on the parameters'
    # device; the schedule then sets the lr of the next step
    kept = [(g["lr"], g.get("capturable", False))
            for g in optimizer.param_groups]
    optimizer.load_state_dict(state["optimizer"])
    for group, (lr, capturable) in zip(optimizer.param_groups, kept):
        group["lr"], group["capturable"] = lr, capturable
        for p in group["params"] if capturable else ():
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device, torch.float32)
    scheduler.load_state_dict(state["scheduler"])
    return epoch + 1


def clean_ckpt(out_dir: str) -> None:
    """Keep only the latest checkpoint (checkpoint.py:56-62)."""
    for e in list_ckpt_epochs(out_dir)[:-1]:
        os.remove(_ckpt_path(out_dir, e))


def is_eval_epoch(cur_epoch: int, eval_period: int, max_epoch: int) -> bool:
    """reference utils/epoch.py:4-10."""
    return (cur_epoch % eval_period == 0 or cur_epoch == max_epoch - 1
            or cur_epoch == 0)


def is_ckpt_epoch(cur_epoch: int, ckpt_period: int, max_epoch: int) -> bool:
    """reference utils/epoch.py:13-18."""
    return cur_epoch % ckpt_period == 0 or cur_epoch == max_epoch - 1
