"""Training loop: the epoch driver around the train and eval steps.

The port of graphgym_tpu/train/loop.py for one device (reference
graphgym/train.py:15-155).  A train step is the forward, masked loss
(+ kernel L2 on the Tfg path; Adam's weight decay on the torch path),
backward and Adam update, one captured CUDA graph on the
card (train/graphed.py), then one per-step learning-rate step; the
epoch driver brings back the scalar loss and the supervised scores for
logging.  With ``cfg.tpu.prefetch`` a host thread collates epoch e+1's
train batches while epoch e trains (graphgym_tpu/train/loop.py:406-434).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from graphgym_tpu_torch.train import checkpoint as ckpt
from graphgym_tpu_torch.train.graphed import make_eval_step, make_train_step
from graphgym_tpu_torch.train.logger import Logger
from graphgym_tpu_torch.train.loss import LossOptions
from graphgym_tpu_torch.train.optim import create_optimizer


# the interpreter's switch interval while the prefetch worker runs: its
# Python would otherwise keep the GIL for up to the default 5 ms each
# time the training thread wants it back, several times a step
PREFETCH_SWITCH_S = 1e-4


def count_params(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def _to_host(score, label, mask):
    score = score.detach().cpu().numpy()
    label = label.detach().cpu().numpy()
    if mask is None:
        return label, score
    mask = mask.detach().cpu().numpy().astype(bool)
    return label[mask], score[mask]


def masked_accuracy(score: np.ndarray, label: np.ndarray) -> float:
    if score.ndim > 1 and label.ndim > 1:     # multi-label: per-entry
        pred = score > 0.5
    elif score.ndim > 1:
        pred = score.argmax(-1)
    else:
        pred = score > 0.5
    return float((pred == label).mean()) if len(label) else 0.0


class Trainer:
    """Epoch driver (reference train(), train.py:116-154) on one
    device: ``device`` holds the model and receives every batch.  The
    train and eval steps are built here, as the JAX Trainer builds its
    jit programs: on a CUDA device each runs as captured CUDA graphs,
    on the CPU eagerly on the same static buffers.  ``eager=True`` runs
    every step eagerly on the batch itself, on any device (the
    comparisons of captured against eager steps)."""

    def __init__(self, model: torch.nn.Module, loaders, cfg,
                 device: torch.device, eager: bool = False):
        if cfg.view_emb:
            raise NotImplementedError(
                "embedding views are not ported yet (ROADMAP A15b)")
        self.model = model
        self.loaders = loaders
        self.cfg = cfg
        self.device = device
        tfg = cfg.gnn.layer_type.startswith("Tfg-")
        self.loss_opts = LossOptions(
            loss_fun=cfg.model.loss_fun,
            size_average=cfg.model.size_average,
            l2_kernel=5e-4 if tfg else 0.0, thresh=cfg.model.thresh)
        steps_per_epoch = max(len(loaders[0]), 1)
        self.optimizer, self.scheduler = create_optimizer(
            model.parameters(), cfg.optim, steps_per_epoch,
            use_loss_l2=tfg, device=device)
        self.task_type = cfg.dataset.task_type
        # the reference Trainer draws one batch list at construction for
        # its init example (train/loop.py:166); drawing it here as well
        # keeps a shuffled loader's epochs the reference's batches
        loaders[0].batches(0)
        cfg.params = count_params(model)
        # device copies of host batches, keyed by the batch object:
        # static loaders hand out the same batches every epoch, so they
        # move once; reshuffled batches fall out of the LRU
        self._placed: collections.OrderedDict = collections.OrderedDict()
        self._place_cap = min(max(8, sum(len(ld) for ld in loaders) + 4),
                              64)
        # train and eval graphs share one memory pool; each step keeps
        # at most as many programs as there are placements
        pool = (torch.cuda.graph_pool_handle()
                if device.type == "cuda" and not eager else None)
        self.train_step = make_train_step(
            model, self.optimizer, self.loss_opts, self.scheduler,
            max_programs=self._place_cap, pool=pool, eager=eager)
        self.eval_step = make_eval_step(
            model, self.loss_opts, max_programs=self._place_cap, pool=pool,
            eager=eager)
        # on the card batches move on a stream of their own, so the next
        # one moves while the device runs the step just enqueued
        self._copy_stream = (torch.cuda.Stream(device)
                             if device.type == "cuda" else None)
        self._staging: Optional[torch.Tensor] = None

    def _place(self, batch):
        """``batch`` on the trainer's device, moved once and kept while it
        is among the last ``_place_cap`` placed.  On the card a batch
        moves through a pinned staging buffer on the copy stream, which
        runs beside the step the device may be running; the copies have
        ended when this returns, and the placed tensors are recorded on
        the step's stream, so the allocator reuses none of them before
        that stream has read them."""
        hit = self._placed.get(id(batch))
        if hit is not None and hit[0] is batch:
            self._placed.move_to_end(id(batch))
            return hit[1]
        if self._copy_stream is None:
            placed = batch.to(self.device)
        else:
            size = batch.staging_bytes()
            if self._staging is None or self._staging.numel() < size:
                self._staging = torch.empty(size, dtype=torch.uint8,
                                            pin_memory=True)
            with torch.cuda.stream(self._copy_stream):
                placed = batch.to(self.device, self._staging)
            self._copy_stream.synchronize()
            stream = torch.cuda.current_stream(self.device)
            for t in placed.leaves():
                t.record_stream(stream)
        while len(self._placed) >= self._place_cap:
            self._placed.popitem(last=False)
        self._placed[id(batch)] = (batch, placed)
        return placed

    def load_checkpoint(self, epoch: int = -1) -> int:
        """Restore the latest (or ``epoch``'s) checkpoint before any step
        (ckpt.load_ckpt); returns the epoch to start from.  A captured
        graph holds the parameters' and Adam's state tensors, which a
        load would replace, so a load after a capture raises."""
        if self.train_step.captured or self.eval_step.captured:
            raise RuntimeError(
                "a checkpoint load after the steps were captured would "
                "replace state tensors the graphs read; load before the "
                "first step")
        return ckpt.load_ckpt(self.model, self.optimizer, self.scheduler,
                              self.cfg.out_dir, epoch)

    # ------------------------------------------------------------ epochs
    def train_epoch(self, logger: Logger, epoch: int, batches=None,
                    upcoming=None):
        """One epoch of train steps on ``batches`` (by default the train
        loader's of ``epoch``).  After each step is enqueued the next
        batch is placed (``_place``), while the device runs the step;
        after the last, the first of ``upcoming`` (a Future of the next
        epoch's batches) where it is ready."""
        if batches is None:
            batches = self.loaders[0].batches(epoch)
        t0 = time.time()
        for i, batch in enumerate(batches):
            lr = self.scheduler.lr()     # the host float of this step's lr
            loss, score, label, mask = self.train_step(self._place(batch))
            if i + 1 < len(batches):
                self._place(batches[i + 1])
            elif (upcoming is not None and upcoming.done()
                  and upcoming.exception() is None and upcoming.result()):
                self._place(upcoming.result()[0])
            label_h, score_h = _to_host(score, label, mask)
            logger.update_stats(true=label_h, pred=score_h,
                                loss=float(loss), lr=lr,
                                time_used=time.time() - t0,
                                params=self.cfg.params)
            t0 = time.time()

    def eval_epoch(self, logger: Optional[Logger], split: int) -> float:
        """The epoch's model-selection score: accuracy for
        classification, negative MSE for regression (so the best epoch
        is the largest either way), size-weighted over the split or
        (cfg.val.accuracy_average 'batch') the mean of per-batch scores
        (reference train.py:107).  A score is 1-D (a binary task's
        sigmoid) or [L, C] (softmax)."""
        accs, counts = [], []
        t0 = time.time()
        regression = self.task_type == "regression"
        for batch in self.loaders[split].batches(0):
            loss, score, label, mask = self.eval_step(self._place(batch))
            label_h, score_h = _to_host(score, label, mask)
            if regression:
                accs.append(-float(np.mean(
                    (score_h.astype(np.float64)
                     - label_h.astype(np.float64)) ** 2))
                    if len(label_h) else 0.0)
            else:
                accs.append(masked_accuracy(score_h, label_h))
            counts.append(len(label_h))
            if logger is not None:
                logger.update_stats(
                    true=label_h, pred=score_h, loss=float(loss), lr=0,
                    time_used=time.time() - t0, params=self.cfg.params)
                t0 = time.time()
        if self.cfg.val.accuracy_average == "batch":
            real = [a for a, c in zip(accs, counts) if c > 0]
            return float(np.mean(real)) if real else 0.0
        total = max(sum(counts), 1)
        return float(sum(a * c for a, c in zip(accs, counts)) / total)

    def run(self, loggers: Optional[List[Logger]] = None) -> Dict:
        cfg = self.cfg
        start_epoch = 0
        if cfg.train.auto_resume:
            start_epoch = self.load_checkpoint(cfg.train.epoch_resume)
        logging.info("Start from epoch %d", start_epoch)
        val_curve: List[Tuple[int, float]] = []
        curve_path = None
        if cfg.out_dir:
            curve_path = os.path.join(cfg.out_dir, "val_curve.json")
            if start_epoch > 0 and os.path.exists(curve_path):
                with open(curve_path) as f:
                    val_curve = [(int(e), float(a)) for e, a in json.load(f)
                                 if int(e) < start_epoch]
        edges_per_epoch = sum(b.count_real_edges()
                              for b in self.loaders[0].batches(0))
        # The epoch prefetch: one worker collates epoch e+1's train
        # batches while epoch e trains, so the loader's draws keep the
        # serial order (the constructor's, the one above, epoch
        # start_epoch on this thread, then e+1 on the worker after e)
        # and the batches are the serial path's, bit for bit.  The
        # worker makes no CUDA call: a step captured while it runs
        # (train/graphed.py) sees no other thread's work on the card.
        prefetch = (ThreadPoolExecutor(1, thread_name_prefix="prefetch")
                    if cfg.tpu.prefetch
                    and cfg.optim.max_epoch - start_epoch > 1 else None)
        ahead, switch = None, sys.getswitchinterval()
        if prefetch is not None:
            sys.setswitchinterval(PREFETCH_SWITCH_S)
        try:
            for epoch in range(start_epoch, cfg.optim.max_epoch):
                t_ep = time.time()
                batches = (ahead.result() if ahead is not None
                           else self.loaders[0].batches(epoch))
                ahead = None
                if prefetch is not None and epoch + 1 < cfg.optim.max_epoch:
                    ahead = prefetch.submit(self.loaders[0].batches,
                                            epoch + 1)
                self.train_epoch(loggers[0] if loggers else Logger("train"),
                                 epoch, batches=batches, upcoming=ahead)
                dt_ep = time.time() - t_ep
                if epoch == start_epoch or (loggers and epoch % 50 == 0):
                    logging.info("epoch %d: %.3fs, %.0f edges/s", epoch,
                                 dt_ep, edges_per_epoch / max(dt_ep, 1e-9))
                if loggers:
                    loggers[0].write_epoch(epoch)
                if ckpt.is_eval_epoch(epoch, cfg.train.eval_period,
                                      cfg.optim.max_epoch):
                    accs = []
                    for i in range(1, len(self.loaders)):
                        accs.append(self.eval_epoch(
                            loggers[i] if loggers else None, i))
                        if loggers:
                            loggers[i].write_epoch(epoch)
                    if accs:
                        val_curve.append((epoch, float(np.mean(accs))))
                        logging.info("epoch %d, acc:%s", epoch,
                                     round(float(np.mean(accs)), 4))
                        if curve_path:
                            with open(curve_path, "w") as f:
                                json.dump(val_curve, f)
                if ckpt.is_ckpt_epoch(epoch, cfg.train.ckpt_period,
                                      cfg.optim.max_epoch):
                    ckpt.save_ckpt(self.model, self.optimizer,
                                   self.scheduler, cfg.out_dir, epoch)
        finally:
            # an error in an epoch, or the worker's own (raised by
            # result() above), leaves no collation running on
            if prefetch is not None:
                prefetch.shutdown(wait=True, cancel_futures=True)
                sys.setswitchinterval(switch)
        best = max(val_curve, key=lambda t: t[1]) if val_curve else (0, 0.0)
        if cfg.train.ckpt_clean:
            ckpt.clean_ckpt(cfg.out_dir)
        logging.info(
            "Task done, results saved in %s; best val acc %.4f @ epoch %d",
            cfg.out_dir, best[1], best[0])
        return {"val_curve": val_curve, "best_epoch": best[0],
                "best_val_acc": best[1]}
