"""What tpu.remat costs and saves on a grid point's first train batch.

    python -m graphgym_tpu_torch.exp.remat_cost --point idgraph_ba500 \\
        [--opts dataset.dir D ...]

Loads the point (a parity tool ``POINTS`` name, with the overrides of
``--opts`` last), takes its first train batch, and trains it ``STEPS``
steps twice from the same seed: once with tpu.remat off, then, the
first trainer freed, once with it on (each torch-path MP layer
recomputed in the backward, nn/remat.py).  On the card the steps are
the trainer's captured ones.  Prints one JSON line: the device, the
batch's nodes, the model width and MP depth, and for each run its
losses, the median wall ms of the steps after the first two (on the
card: replays of the captured graph), and on the card its peak device
memory above what was allocated before its trainer was built (null on
the CPU); the two runs' losses must be bitwise equal, else it exits 1.
Nothing is written.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data.loaders import create_dataset, create_loader
from graphgym_tpu_torch.device import resolve_device
from graphgym_tpu_torch.exp.parity import point_config
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer


def run(cfg, loaders, host_batch, device: torch.device, remat: bool,
        steps: int, extra: Optional[Callable[[Trainer], dict]] = None
        ) -> dict:
    """``steps`` train steps of a fresh trainer at tpu.remat ``remat``
    (with ``extra``'s entries, read from the trainer after them)."""
    cuda = device.type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    cfg = cfg.clone()
    cfg.tpu.remat = remat
    trainer = Trainer(build_model(cfg, device), loaders, cfg, device)
    batch = trainer._place(host_batch)
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(batch)[0].item())
        walls.append((time.perf_counter() - t0) * 1e3)
    return dict(losses=losses, step_wall_ms=float(np.median(walls[2:])),
                peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                                   - base) if cuda else None,
                **(extra(trainer) if extra is not None else {}))


# the steps of each run: two to capture, five replays timed
STEPS = 7


def remat_cost(cfg) -> dict:
    device = resolve_device(cfg.device)
    loaders = create_loader(create_dataset(cfg), cfg)
    host_batch = loaders[0].batches(0)[0]
    out = dict(device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
               nodes=int(host_batch.num_nodes), width=cfg.gnn.dim_inner,
               layers_mp=cfg.gnn.layers_mp, steps=STEPS)
    for remat in (False, True):
        out["remat" if remat else "plain"] = run(cfg, loaders, host_batch,
                                                 device, remat, STEPS)
    out["losses_bitwise_equal"] = (out["plain"]["losses"]
                                   == out["remat"]["losses"])
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="peak memory and step time with tpu.remat off and on")
    parser.add_argument("--point", required=True)
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    cfg_file, opts = point_config(args.point)
    out = remat_cost(load_cfg(cfg_file, opts + list(args.opts)))
    print(json.dumps(out), flush=True)
    if not out["losses_bitwise_equal"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
