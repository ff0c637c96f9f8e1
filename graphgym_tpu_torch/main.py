"""Experiment entry point of the port (reference run/main.py:21-63).

Usage:
    python -m graphgym_tpu_torch.main --cfg configs/idgcn_ws.yaml \
        [--repeat 3] [--mark_done] [gnn.dim_inner 64 ...]

Runs on the first CUDA card unless the config says ``device: cpu``.
A synthetic corpus that no pickle holds (ba, ws, scalefree, smallworld,
ba500, ws500) is regenerated from seed 0 and cached as
``<dataset.dir>/<name>.torch.pkl``.  Every layer type of the packed
paths runs, the torch path's (gcnidconv, ginconv, ...: pre-MP, the
BatchNorm wrapper, the node head, on ``dataset.task graph`` the graph
head's pooling and MLP, on ``link_pred`` / ``edge`` the edge head's pair
decoding, or with ``dataset.transform edge`` the node head on the
edge-net union) and the Tfg one's (Tfg-idgcn, ...: node tasks).
After the seeds, ``exp/agg.agg_runs`` writes their aggregate under
``<out_dir>/<cfg-name>/agg/`` (and its tensorboard copy with
``tensorboard_agg``, where tensorboardX imports); a mixed-precision run
(tpu.dtype bfloat16) names its dtype in every aggregated line
(``exp/agg.tag_runs``).
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np
import torch


def parse_args(argv=None):
    """reference cmd_args.py:5-39."""
    parser = argparse.ArgumentParser(description="graphgym_tpu_torch")
    parser.add_argument("--cfg", dest="cfg_file", required=True,
                        help="The configuration file path.")
    parser.add_argument("--repeat", type=int, default=1,
                        help="Repeated experiment times.")
    parser.add_argument("--mark_done", action="store_true",
                        help="Mark yaml as done after a job finishes.")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="See graphgym_tpu_torch/config.py for options")
    return parser.parse_args(argv)


def run_single(cfg, out_dir_parent: str, cfg_file: str):
    """One seed: data, loaders, model and Trainer.run on cfg.device."""
    from graphgym_tpu_torch.config import dump_cfg, update_out_dir
    from graphgym_tpu_torch.data.loaders import create_dataset, create_loader
    from graphgym_tpu_torch.device import resolve_device
    from graphgym_tpu_torch.nn.model import build_model
    from graphgym_tpu_torch.train.logger import create_logger, setup_printing
    from graphgym_tpu_torch.train.loop import Trainer

    device = resolve_device(cfg.device)
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    update_out_dir(cfg, out_dir_parent, cfg_file)
    dump_cfg(cfg)
    setup_printing(cfg.print, cfg.out_dir)
    logging.info("device: %s%s", device,
                 f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else "")

    splits = create_dataset(cfg)
    loaders = create_loader(splits, cfg)
    model = build_model(cfg, device)
    loggers = create_logger(cfg, len(loaders))
    if cfg.train.mode != "standard":
        from graphgym_tpu_torch import register
        return register.train_dict[cfg.train.mode](
            loggers, loaders, model, cfg)
    trainer = Trainer(model, loaders, cfg, device)
    logging.info("params: %d", cfg.params)
    return trainer.run(loggers)


def main(argv=None):
    from graphgym_tpu_torch.config import get_parent_dir, load_cfg
    from graphgym_tpu_torch.exp.agg import agg_runs, tag_runs
    from graphgym_tpu_torch.train.graphed import compute_dtype_of

    args = parse_args(argv)
    results = []
    for i in range(args.repeat):
        cfg = load_cfg(args.cfg_file, args.opts)
        cfg.seed = cfg.seed + i
        out_dir_parent = cfg.out_dir
        results.append(run_single(cfg, out_dir_parent, args.cfg_file))
    # aggregate across seeds (reference main.py:60-61), with the metric
    # rules of graphgym_tpu/main.py:90-100
    metric = cfg.metric_best if cfg.metric_best != "auto" \
        else ("accuracy" if "classification" in cfg.dataset.task_type
              else "mae")
    parent = get_parent_dir(out_dir_parent, args.cfg_file)
    agg_runs(parent, metric=metric, metric_agg=cfg.metric_agg,
             tensorboard=cfg.tensorboard_agg)
    if compute_dtype_of(cfg.tpu.dtype) is not None:
        tag_runs(parent, {"dtype": cfg.tpu.dtype})
    if args.mark_done:
        os.rename(args.cfg_file, args.cfg_file + "_done")
    return results


if __name__ == "__main__":
    main()
