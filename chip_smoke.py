"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; a failure prints {"phase": ..., "error":
...} on stdout and exits 1):
  1. device   — nvidia-smi name and power limit;
  2. build    — nvcc builds the kernels, one library per source
                (csrc/packed_spmm.cu, csrc/packed_segment.cu,
                csrc/packed_attention.cu, csrc/packed_sddmm.cu,
                csrc/packed_max.cu), side by side; then three processes
                start regenerating the synthetic corpora (ba, and the
                design grid's scalefree and smallworld), beside the
                phases up to the ba paths;
  ID-GCN Full / ws (configs/idgcn_ws.yaml), kernel K1:
  3. kernel   — at the shapes of the train batch (the real 'gcn' packs
                from the port's loader, D = 128): kernel vs its plain
                PyTorch version on the fwd and bwd packs, in float32 and
                bfloat16, bitwise-repeatable launches, the same bits as
                K3 at one head with alpha = the pack's weights (the row
                walk both run), and on both packs times of the kernel,
                the plain version, one library call (torch.sparse.mm on
                a CSR tensor of the same matrix) and the launch floor (an
                empty kernel over K1's grid) beside the bound, and of the
                kernel in bfloat16 on the fwd pack;
  4. model    — the full-width model's logits and gradients on the card
                against the same model on the CPU (plain versions), and
                then its eval-mode logits;
  5. train    — the config through graphgym_tpu_torch.main for a few
                epochs at full width (3 x 128, head 256), its train and
                eval steps captured CUDA graphs (train/graphed.py: step
                0 eager, step 1 captured and replayed, then replays):
                finite losses, 6 K1 launches per train step plus 3 per
                eval batch, counted per replay, none at D = 1, no launch
                of another kernel;
  6. profile  — the captured train step beside the eager one (eager=True,
                the same capturable Adam), each in a trainer of its own:
                wall ms per step, torch.profiler's device time by kernel
                (and of the port's own kernels), the device's idle
                share, host operator calls and host ms per step, the
                peak of device memory, the graphs captured and the time
                of step 0 and of step 1 (the capture); the widest tensor
                any op of the eager step takes; two captured trainers
                from one seed must give bitwise-equal losses and
                parameters;
  6b. graphed — captured against eager (capturable Adam) over 5 train
                steps and 2 eval steps: losses, parameters and buffers
                bitwise equal, the same launches; and ID-GCN at
                train.batch_size 8 (three shuffled batches an epoch, one
                graph for them all), per-step losses and val accuracy
                equal over two epochs.
  ID-GAT Full / ws (configs/idgat_ws.yaml), kernels K3 and the SDDMM:
  7. kernel_att  — at the real train 'att' pack (D = 128, H = 1) with a
                   softmax'd random alpha: kernel vs plain on the fwd
                   pack and, alpha carried by the slot map, the bwd pack,
                   in float32 (a warp a row) and bfloat16 (a half-warp),
                   and at H = 4 (dv = 32); bitwise-repeatable launches;
                   kernel, plain and library (torch.sparse.mm, CSR of
                   alpha) times beside the bound at H = 1 and 4; the
                   attention softmax (its row sums: K3 at dv = 1) card
                   vs plain and CPU, values and gradient, at H = 1 and
                   4, bitwise repeats, the row sums' times beside the
                   bound and index_add_;
  8. kernel_sddmm — at the real train 'att' fwd pack, D = 128: the SDDMM
                   against its plain version in float32 and bfloat16, at
                   H = 1 and 4, exact 0 on every slot of pack weight 0,
                   bitwise-repeatable launches; kernel, plain and library
                   (torch.sparse.sampled_addmm on a CSR of the valid
                   slots, H = 1) times beside the bound;
  9. model_att   — as 4, for the full-width Tfg-idgat model;
 10. train_att   — as 5: 18 K3 launches (per layer: the softmax's row
                   sums and the aggregation forward; dv, the softmax's
                   row sum, dq and dk backward; 6 of them at width 1, the
                   row sums) and 6 SDDMM launches (score, dalpha) per
                   train step; 6 K3 (3 at width 1) and 3 SDDMM per eval
                   batch; no K1 or K2 launch;
 11. profile_att — as 6, no op taking a tensor as wide as [E, D] (E the
                   pack's slots) and no index_add_ over the E slots;
                   graphed_att as 6b.
  ID-GIN Full / ws (configs/idgin_ws.yaml), kernel K1 on the 'plain'
  pack:
 12. kernel_gin  — as 3, at the train 'plain' packs, D = 128 and D = 1
                   (layer 0 aggregates the raw 1-wide features: K1's
                   narrow walk, a thread a row);
 13. model_gin   — as 4 (the GIN MLP's BatchNorm in train mode), the
                   running statistics after it and the eval-mode logits
                   that use them, on seeded random features (see
                   check_model);
 14. train_gin   — as 5: 5 K1 launches per train step (layer 0's input
                   needs no gradient) plus 3 per eval batch, one of each
                   at D = 1, no other;
 15. profile_gin — as 6; graphed_gin as 6b.
  ID-SAGE Full / ws (configs/idsage_ws.yaml), K1 on the 'mean' pack:
 16. kernel_sage — as 3, at the train 'mean' packs, D = 1;
 17. model_sage, 18. train_sage, 19. profile_sage, graphed_sage — as 13,
     14, 15 and 6b.
  ID-GNN Fast / ws (configs/{gcnconv,sageconv,ginconv,gatconv}Fast_ws.yaml:
  identity features, diag(A^1..A^10) on the card, before the node
  feature, dim_in 11; no ego transform, N = 1,536) and ID-GNN Full on
  the regenerated ba corpus (configs/id{gcn,gin,gat}_ba.yaml), each
  through drive_path's phases, named <phase>_<config>:
    kernel_*   — as 3 (K1 at the model width and at each narrow width
                 the path runs: D = 11 on the Fast 'mean' / 'plain' packs,
                 K1's scalar walk; D = 1 on ba's 'plain' pack, the narrow
                 walk's hub rows of up to 48 slots), or as 7 and 8 (K3,
                 its softmax row sums and the SDDMM); the pack's longest
                 rows;
    model_*    — as 4 (on ID-GIN ba seeded random features, its own are
                 constant, and each gradient held as a whole: its
                 weight gradients sum over 98,304 rows, check_model);
    train_*    — as 5: K1 6 per train step and 3 per eval batch
                 (gcnconvFast, ID-GCN ba), 5 and 3 with 1 and 1 at D = 11
                 (sageconvFast, ginconvFast) or at D = 1 (ID-GIN ba); K3
                 18 and 6 (6 and 3 at width 1) and the SDDMM 6 and 3
                 (gatconvFast, ID-GAT ba); no other launch;
    profile_*  — as 6, with the peak of device memory (ID-GCN and ID-GAT
                 on ba) and repeat_steps; graphed_* as 6b.
  corpus       — before the ba paths: waits for ba (256 asked, seed 0,
                 no networkx), regenerated into the git-ignored build
                 directory (CORPUS_DIR) through load_nx by its process,
                 and reports its seconds there; fails unless it is
                 the corpus the CPU tests hold to the JAX package's (116
                 graphs, BA_DIGEST); the longest rows of ID-GCN's 'gcn'
                 and ID-GIN's 'plain' train packs.
  The GraphGym torch path (pre-MP Linear + BN + act, GeneralLayer(conv)
  with BN and act, the L2 norm, the node head's MLP), six grid points
  of grids/IDGNN/node.txt as base configs with overrides, each through
  drive_path's phases: gcnid_ws, sageid_ws, ginid_ws (idgcn_ws with
  gnn.layer_type gcnidconv / sageidconv / ginidconv: K1 on the 'gcn',
  'mean', 'plain' packs), gcn_id_ws (gcnconvFast_ws, gcnconv), design_ws
  (ginidconv, act prelu, stage skipsum, dropout 0.3: the model check at
  dropout 0, the dropout held apart by check_dropout), gatid_ba
  (idgcn_ba, gatidconv, 2 layers: K3, its row sums and the SDDMM); K1 6
  per train step and 3 per eval batch, all at D = 128 (pre-MP hands
  each layer a 128-wide input that needs a gradient); gatid_ba K3 12 (8
  at width 1) and 4 (2), SDDMM 2 and 0; ws's and ba's constant
  features replaced by seeded random ones in the model check.
  full_idgcn_ws — configs/idgcn_ws.yaml for its 1000 epochs, 3 seeds,
                  through graphgym_tpu_torch.main.main --repeat 3 and its
                  aggregate (exp/agg): each seed's best val accuracy,
                  mean and std, seconds per run, median time_iter
                  (graphgym_tpu_torch/exp/parity.py's run_config, the
                  port's parity tool); fails unless the mean meets
                  results/parity/PARITY.md's pass rule (the tool's
                  pass_rule) against parity.json's row (0.99375 +-
                  0.0006);
  full_gcnid_ws — the same for gnn.layer_type gcnidconv, reported only
                  (no reference number).
  kernel_max    — the segmented max (csrc/packed_max.cu; XLA's
                  segment_max in the JAX package, no Pallas kernel),
                  forward and backward, against its plain version on the
                  CPU (out and tie counts bitwise, dx at F32_TOL), on
                  seeded normal x and on x rounded to three levels (ties
                  in most columns), on ID-GIN's ws ego 'plain' pack
                  (49,152 rows) and ba's (rows of up to 48 slots), at
                  D = 128 and 256; times beside the bound, the launch
                  floor and scatter_reduce(amax) over gathered messages
                  and its backward (the messages' gradients).
  design_corpus — waits for the scalefree and smallworld corpora their
                  processes regenerated (DESIGN_CORPUS_DIR); fails unless
                  they are the ba corpus and datasets/ws.pkl, edge for
                  edge.
  The design space (grids/design/round1.txt's synthetic node chunks) on
  GraphGym's default conv generalconv at dim_inner 256, the aggregation
  after the projection: design_sf (results/design_v1_grid_round1's
  point: scalefree, pagerank feature, batch 64, 3 pre-MP and 8 MP
  layers, PReLU, agg add: K1 16 per train step and 8 per eval batch, all
  at D = 256, 'plain' pack), design_sw_mean (smallworld, one-hot
  feature, skipconcat, no BN, the contrib example's swish, dropout 0.3,
  agg mean, SGD: K1 8 and 4 at D = 256, 'mean' pack), design_sf_max
  (scalefree, constant feature, skipsum, dropout 0.6, agg max: the
  max's forward 6 and backward 6 per train step, forward 6 per eval
  batch, no K1), and idconv_ws (idgcn_ws with gnn.layer_type idconv,
  the fifth ID-GNN Full variant: K1 6 and 3 at D = 128); each through
  drive_path's phases (kernel_design_sf_max holds the max on its train
  pack; the model check gives the CPU the card's max choices, SameMax).
  full_design_sf — design_sf for its 100 epochs, 3 seeds, reported.
  The graph task (the graph head: global pooling on the batch's
  pooling pack, then its MLP over the graph slots, BatchNorm masked to
  the real ones), each through drive_path's phases after the design
  paths: design_graph_sf (results/design_v1_grid_round1's graph point:
  scalefree, graph_path_len labels in 5 classes, batch 16 (6 train and
  2 val batches, 17 graph slots), generalconv with mean aggregation at
  256, skipconcat, PReLU, add pooling of every node at the stage's 768
  columns: K1 6 per train step (4 at 256, 2 at 768) and 3 per eval
  batch (2 and 1)) and idgraph_ba (grids/IDGNN/graph.txt's ID chunk on
  configs/idgcn_ba.yaml: gcnidconv, ego, graph_clustering_coefficient
  labels, the ba corpus for the grid's ba500; add pooling of the 64
  ego centers of each of the 93 graph slots: K1 8 per train step and 4
  per eval batch, all at 128); seeded random features in the model
  check (both corpora's are constant).
  kernel_pool   — the pooling kernels on each graph path's first train
                  batch, at the width it pools: K1 forward (graph slots
                  from node rows) and backward (node rows from graph
                  slots) on the add and mean pooling packs, at F32_TOL
                  against the plain version on the CPU; the segmented
                  max forward and backward on the max pooling packs,
                  bitwise / F32_TOL, on random and tied x; times beside
                  the bound (the input rows the slots read), the launch
                  floor and the library calls (torch.sparse.mm of the
                  pooling matrix and its transpose; scatter_reduce(amax)
                  and its backward).
  full_design_graph_sf — design_graph_sf for its 200 epochs, 3 seeds,
                  reported.
  The link-prediction and edge tasks, each through drive_path's phases:
  linkid_ws (grids/IDGNN/link.txt:21-34 on configs/idgcn_ws.yaml:
  gcnidconv, 5 layers, the edge transform, so a node task on the
  64-copy edge-net union of 90,112 nodes; the disjoint protocol of
  results/parity/LINK_PARITY.md: K1 10 per train step and 5 per eval
  batch at D = 128), edgeid_ws (path.txt:21-34: path-length labels of
  1,000 pairs a graph drawn with replacement, 5 classes; the node head
  gathers its repeated supervised nodes on the 'labels' gather pack: K1
  12 and 6, of them its forward and backward, 2 and 1, at D = 5) and
  link_ba (link.txt:5-18 on configs/idgcn_ba.yaml: gcnconv,
  node_identity features, the disjoint protocol, concat decoding; 92
  train graphs in 3 batches re-collated each epoch; the edge head
  gathers both ends of each pair on the 'pairs' gather pack: K1 12 and
  6, of them 2 and 1 on the pack, all at D = 128); the kernel phase
  also holds K1 on the gather packs (check_gather_k1); seeded random
  features in the model check.
  full_linkid_ws — linkid_ws for its 100 epochs (link.txt:33), 3 seeds,
                  reported beside the JAX package's CPU result at the
                  same point and seeds (JAX_LINKID_WS) and
                  LINK_PARITY.md's row (context, another protocol; read
                  from link_parity.json by the parity tool).
  prefetch_idgin_ba — ID-GIN ba's train loader (2 batches of 48 graphs
                  re-collated each epoch): the run with cfg.tpu.prefetch
                  off and on (train_path, 10 epochs, the launches of
                  train_idgin_ba): every batches() call's arrays and
                  every loss bitwise equal, the epochs past the first
                  collated on the prefetch thread; each run's median
                  time_iter and train seconds per epoch; and on the
                  first train batch each pack's build time, native
                  (graphgym_tpu_torch/native, g++) against the numpy
                  packer, the packs equal array for array, and an
                  epoch's collation with each.  prefetch_design_graph_sf
                  and prefetch_link_ba (after the link paths): the same
                  on 6 and 3 small batches an epoch, without the packs.
  full_idgin_ba — configs/idgin_ba.yaml for its 1000 epochs, 3 seeds,
                  as full_idgcn_ws, reported against parity.json's row
                  (0.6596 +- 0.0297) by the pass rule, not gated.
  Kernel K2, which no path runs:
 20. kernel_seg  — at the train 'plain' fwd pack of ID-GIN, D = 128: K2
                   against its plain version with a random message on
                   every slot (padding slots included), against K1 with
                   msg = x[senders] * w, in bfloat16, on a pack built
                   with group G = 2; bitwise-repeatable launches;
                   segment_matmul_vjp's gradient against the plain
                   version's; kernel, plain and library (index_add_,
                   torch.sparse.mm of the 0/1 slot matrix) times beside
                   the bound.
  The benchmark (graphgym_tpu_torch/bench.py, the root bench.py's
  defaults: N = 131,072, E = 2,000,000, D = 128; row 0 of each pack
  takes ~5,500 slots):
 21. bench       — K1 on make_graph's fwd and bwd packs against its plain
                   version (f32, bf16; a share of each row's sum of
                   |terms|), bitwise repeats, spmm_bidir's gradient,
                   times beside the bound, the launch floor and
                   torch.sparse.mm, each pack's longest row; on its
                   'att' packs, at bench_attention's shapes, K3's
                   aggregation (fwd) and dv (bwd) at H = 8, dv = 16, its
                   row sums on both packs (H = 8 and 1) and the SDDMM at
                   H = 8, dh = 16, held and timed the same way; the
                   segmented max forward on the fwd pack and its
                   backward on the bwd pack at D = 128, held and timed
                   as in kernel_max (no path runs it there: the case of
                   ws500 / ba500's 500-slot pooling rows, and longer);
 22. bench_runs  — the entry points with exact launch counts: bench.main
                   (K1 2 per fwd_bwd step, 1 per fwd step), the bf16 chain,
                   bench_attention (K3 6 per step, 4 of them row sums
                   at width 8, and SDDMM 1; gradients
                   of two calls bitwise equal; card vs CPU on a small
                   graph) and bench_train_epoch of the four ws paths
                   (captured steps after two warm-up epochs), rates and
                   epoch times as median and IQR.
Then the kernel table as one JSON line, also written to
OUT/kernels.json (K1 at D = 128, at D = 1 and on
make_graph's pack; K3's aggregation and its softmax row sums on ws and
at H = 8 on make_graph's 'att' pack; the SDDMM on ws and on that pack;
K1 at D = 128 and D = 11 on the Fast packs and at D = 128 and D = 1 on
ba's; K3, its row sums and the SDDMM on gatconvFast_ws and ID-GAT ba;
K1 on each torch-path K1 grid point's pack, K3, its row sums and the
SDDMM on gatid_ba's; K1 at D = 256 on design_sf's and design_sw_mean's
packs and at D = 128 on idconv_ws's, the max forward and backward on
design_sf_max's pack, on kernel_max's and on make_graph's; K1 on the
graph paths' layer packs, K1's add and mean pooling and the max's
pooling forward and backward on their pooling packs; K1 on the link
and edge paths' layer packs and on their gather packs), and last the
result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PHASE = ["import"]   # the phase running now, named in a failure line
T0 = time.perf_counter()


def fail(msg: str) -> None:
    """Print why the run failed as one JSON line on stdout (and on
    stderr), then exit 1."""
    line = json.dumps({"phase": _PHASE[0], "error": msg})
    print(line, flush=True)
    print(f"chip_smoke: FAILED: {line}", file=sys.stderr, flush=True)
    sys.exit(1)


if not torch.cuda.is_available():
    _PHASE[0] = "device"
    fail("no CUDA device (torch.cuda.is_available() is False); this "
         "script runs the port on the card only")

try:
    from graphgym_tpu_torch import bench as B
    from graphgym_tpu_torch.config import load_cfg
    from graphgym_tpu_torch.data.loaders import create_dataset, create_loader
    from graphgym_tpu_torch.device import resolve_device
    from graphgym_tpu_torch.exp import parity
    from graphgym_tpu_torch.graphs.packing import (LABELS, PAIRS, POOLINGS,
                                                   build_pool_packs,
                                                   pool_kind)
    from graphgym_tpu_torch.main import run_single
    from graphgym_tpu_torch.nn.model import build_model
    from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
    from graphgym_tpu_torch.train import checkpoint as ckpt
    from graphgym_tpu_torch.train.loop import Trainer
except ImportError as exc:
    fail(f"{type(exc).__name__}: {exc} (run from the root of a checkout "
         "of the repository)")

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "configs", "idgcn_ws.yaml")
CFG_ATT = os.path.join(ROOT, "configs", "idgat_ws.yaml")
CFG_GIN = os.path.join(ROOT, "configs", "idgin_ws.yaml")
CFG_SAGE = os.path.join(ROOT, "configs", "idsage_ws.yaml")
# the regenerated ba corpus (seed 0), cached under the git-ignored build
# directory; tests/test_torch_fast.py holds the same count and digest
CORPUS_DIR = os.path.join(ROOT, "graphgym_tpu_torch", "csrc", "build",
                          "corpus")
BA_GRAPHS = 116
BA_DIGEST = ("fc3beb9b7b0effd6f75f3110d5119f3d"
             "570e40ab93423ced0554a58984554a40")
# the design grid's corpora (scalefree and smallworld: the ba and ws
# generators under other names), regenerated beside the earlier phases
DESIGN_CORPUS_DIR = os.path.join(ROOT, "graphgym_tpu_torch", "csrc",
                                 "build", "design_corpus")
CHILDREN = []   # processes this script starts, killed at its exit
# the design_v1 point of results/design_v1_grid_round1 (scalefree, node
# task, generalconv at 256): design_sf's and full_design_sf's overrides
DESIGN_SF = ("dataset.format", "nx", "dataset.name", "scalefree",
             "dataset.task", "node", "dataset.transductive", "True",
             "dataset.augment_feature", "['node_pagerank']",
             "dataset.augment_label", "node_clustering_coefficient",
             "train.batch_size", "64", "gnn.layers_pre_mp", "3",
             "gnn.layers_mp", "8", "gnn.layers_post_mp", "1",
             "gnn.stage_type", "stack", "gnn.batchnorm", "True", "gnn.act",
             "prelu", "gnn.dropout", "0.0", "gnn.agg", "add",
             "optim.optimizer", "adam", "optim.base_lr", "0.01")
# the graph task: the design grid's graph chunk (grids/design/
# round1.txt:81-98) at the point results/design_v1_grid_round1 ran
# (scalefree, graph_path_len labels, generalconv with mean aggregation,
# skipconcat, add pooling), and the ID chunk of grids/IDGNN/graph.txt:
# 49-61 (gcnidconv, ego, graph_clustering_coefficient labels) on
# configs/idgcn_ba.yaml, cut from ba500 to ba
DESIGN_GRAPH_SF = ("dataset.format", "nx", "dataset.name", "scalefree",
                   "dataset.task", "graph", "dataset.transductive", "True",
                   "dataset.augment_feature", "['node_const']",
                   "dataset.augment_label", "graph_path_len",
                   "train.batch_size", "16", "gnn.layers_pre_mp", "2",
                   "gnn.layers_mp", "2", "gnn.layers_post_mp", "2",
                   "gnn.stage_type", "skipconcat", "gnn.batchnorm", "True",
                   "gnn.act", "prelu", "gnn.dropout", "0.0", "gnn.agg",
                   "mean", "optim.optimizer", "adam", "optim.base_lr",
                   "0.001")
# grids/IDGNN/link.txt:21-34 and path.txt:21-34 (the ID chunks on ws,
# gcnidconv; the link point with the disjoint protocol of
# results/parity/LINK_PARITY.md) on configs/idgcn_ws.yaml, and
# link.txt:5-18 (the plain chunk on ba, gcnconv, node_identity) on
# configs/idgcn_ba.yaml with the disjoint protocol and the reference
# base's concat decoding (tools/run_parity.py:360-363); the grid's 100
# epochs only in full_linkid_ws
LINK_GRID = ("dataset.format", "nx", "dataset.transductive", "False",
             "dataset.augment_label", "", "gnn.layers_pre_mp", "1",
             "gnn.layers_mp", "5", "gnn.layers_post_mp", "1",
             "train.batch_size", "32")
LINKID_WS = LINK_GRID + ("dataset.transform", "edge", "dataset.task",
                         "link_pred", "dataset.augment_feature", "[]",
                         "gnn.layer_type", "gcnidconv",
                         "dataset.edge_train_mode", "disjoint")
EDGEID_WS = LINK_GRID + ("dataset.transform", "edge", "dataset.task", "edge",
                         "dataset.augment_feature", "[]",
                         "gnn.layer_type", "gcnidconv")
LINK_BA = LINK_GRID + ("dataset.transform", "none", "dataset.task",
                       "link_pred", "dataset.augment_feature",
                       "['node_identity']", "gnn.layer_type", "gcnconv",
                       "dataset.edge_train_mode", "disjoint",
                       "model.edge_decoding", "concat")
# full_linkid_ws's point on the JAX package, the same seeds (1-3), on a
# CPU: python -m graphgym_tpu.main --cfg configs/idgcn_ws.yaml --repeat 3
# <LINKID_WS> optim.max_epoch 100 tpu.spmm_impl xla: each seed's best val
# accuracy and agg/val/best.json's mean and std
JAX_LINKID_WS = dict(best_val_acc_per_seed=[0.5897, 0.5, 0.5449],
                     mean=0.5449, std=0.0366)
# results/parity/LINK_PARITY.md:16, gcnidconv on ws: the JAX package and
# the reference on the reference's edge.yaml base at a matched parameter
# budget (tools/run_parity.py:333-355), another protocol
_LINK_WS = parity.link_reference("gcnidconv", "ws")
LINK_PARITY_WS = dict(jax=(_LINK_WS["ours"], _LINK_WS["ours_std"]),
                      reference=(_LINK_WS["reference"],
                                 _LINK_WS["reference_std"]))
IDGRAPH_BA = ("dataset.task", "graph", "dataset.transductive", "False",
              "dataset.transform", "ego", "dataset.augment_feature", "[]",
              "dataset.augment_label", "graph_clustering_coefficient",
              "gnn.layers_pre_mp", "1", "gnn.layers_mp", "3",
              "gnn.layers_post_mp", "3", "gnn.layer_type", "gcnidconv")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
EPOCHS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_TOL = dict(rtol=1e-5, atol=1e-6)    # only the sum order differs
BF16_TOL = dict(rtol=1e-2, atol=1e-3)   # one bf16 ulp after the f32 sum
# K2 sums up to 41,286 messages into one row: two f32 sums in different
# orders differ by a share of the row's sum of |msg|, not of its value
SEG_REL, SEG_ATOL = 1e-5, 1e-6
# the bench phase: the root bench.py's defaults (make_graph's row 0 gets
# ~5,500 slots), 3 repeats of each timed chain
BENCH_DIMS = (131072, 2_000_000, 128)
BENCH_ITERS, BENCH_REPEATS = 20, 3
BENCH_HEADS, BENCH_DV = 8, 16
SMALL_GRAPH = (2048, 32768)   # the attention step, card against CPU


def begin(name: str) -> None:
    """Name the phase that runs from here on (a failure line names it)."""
    _PHASE[0] = name


def phase(name: str, **kw) -> None:
    """One phase's line, with the seconds since the script started, on
    stdout and appended to OUT/phases.jsonl (the full-length runs' logs
    push early lines out of a short tail)."""
    line = json.dumps({"phase": name,
                       "at_s": round(time.perf_counter() - T0, 1), **kw})
    print(line, flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "phases.jsonl"), "a") as f:
        f.write(line + "\n")


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Wall time per call of a loop of calls, by CUDA events: the device
    time, or the host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_events(fn, iters: int = 20):
    """torch.profiler's per-name averages over iters calls of fn, after
    three calls of warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms_by_kernel(fn, iters: int = 20, events=None) -> dict:
    """Device time per call of each kernel fn launches (torch.profiler;
    annotation ranges excluded, they would count their kernels twice)."""
    events = events if events is not None else profile_events(fn, iters)
    return {ev.key: ev.self_device_time_total / iters / 1e3
            for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)}


def host_ms_by_op(events, iters: int) -> dict:
    """Host time per call of fn in each operator's own code (self CPU
    time, torch.profiler), and its calls per call of fn."""
    return {ev.key: (ev.self_cpu_time_total / iters / 1e3, ev.count / iters)
            for ev in events
            if ev.device_type == torch.autograd.DeviceType.CPU
            and not getattr(ev, "is_user_annotation", False)}


def profiled_ms(fn, iters: int = 20):
    """Device ms per call of fn by torch.profiler, and whether the
    profile holds every launch (``holds_every_launch``).  Late in a long
    process, after the card has idled for a minute or two, the profiler
    can keep only some of a loop's kernel records."""
    events = profile_events(fn, iters)
    return (sum(device_ms_by_kernel(None, iters, events).values()),
            holds_every_launch(events, iters))


# profiles that lost records: (phase, kernel names, least share kept)
LOSSY_PROFILES = []


def holds_every_launch(events, iters: int) -> bool:
    """Whether a profile of ``iters`` calls kept each kernel's records of
    every call: some kernel recorded, each name's count a multiple of
    ``iters``.  A profile that did not is noted in LOSSY_PROFILES."""
    counts = {ev.key: ev.count for ev in events
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)}
    lost = {k: c for k, c in counts.items() if c % iters}
    if counts and not lost:
        return True
    LOSSY_PROFILES.append((_PHASE[0], sorted(k[:40] for k in lost),
                           min(lost.values(), default=0) / iters))
    return False


def queued_ms(fn, iters: int = 20) -> float:
    """Device ms per call of a loop of calls queued behind a sleep
    kernel: the host enqueues the whole loop while the card sleeps, so
    the CUDA events around it time the card's work back to back and not
    the launches.  The sleep doubles until the start event is still
    pending when the loop's last call has been enqueued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = int(4e9 * host_s) + 2_000_000   # 2x the host's time at 2 GHz
    for _ in range(8):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / iters
        cycles *= 2
    fail("queued_ms: the card ran out of sleep before the loop was queued")


def time_calls(calls: dict, bound_ms: float):
    """Device ms per call of each fn, its CUDA-event loop time (with
    the launches), how the device ms was taken, and the queued time
    (``queued_ms``).  The device ms is torch.profiler's where its
    profile holds every launch and reads at least ``bound_ms``, the
    least time the card could take for the call's work; else
    ("queued") the queued time, also a device time."""
    loop = {k: call_ms(f) for k, f in calls.items()}
    queued = {k: queued_ms(f) for k, f in calls.items()}
    ms, timed_by = {}, {}
    for k, f in calls.items():
        t, whole = profiled_ms(f)
        ms[k], timed_by[k] = ((t, "profiler") if whole and t >= bound_ms
                              else (queued[k], "queued"))
    return ms, loop, timed_by, queued


def csr_of(pack: K.PackedCSR, n: int, values=None,
           cols_n=None) -> torch.Tensor:
    """The pack's matrix (or, given per-slot values, that matrix) as a
    torch CSR tensor of n rows and ``cols_n`` columns (by default n: a
    square pack), padding slots dropped."""
    cols_n = n if cols_n is None else cols_n
    rows = K.pack_rows(pack).reshape(-1)
    cols = pack.senders.long().reshape(-1)
    vals = (pack.weights if values is None else values).reshape(-1)
    keep = cols < cols_n
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep], (n, cols_n)).coalesce()
    return coo.to_sparse_csr()


def k1_floor(pack: K.PackedCSR, x: torch.Tensor, out: torch.Tensor):
    """The launch floor under K1 (csrc/packed_spmm.cu,
    packed_spmm_floor_*): an empty kernel over the grid K1 takes for
    these arguments, launched as its wrapper launches K1.  Counts no
    launch of K1."""
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    fn = getattr(K.library("packed_spmm"), f"packed_spmm_floor_{suffix}")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    args = (x.data_ptr(), x.shape[0], x.shape[1], pack.senders.data_ptr(),
            pack.weights.data_ptr(), pack.row_range.data_ptr(),
            out.shape[0], out.data_ptr())

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"K1 floor launch: CUDA error {err}")
    return launch


def check_kernel(packs, n: int, d: int, device) -> dict:
    """K1 against its plain version on the fwd and bwd packs, f32 and
    bf16 (at F32_TOL / BF16_TOL; in f32 on packs with rows of more than
    32 slots by hold_sums' rule); bitwise-repeatable launches; the same
    bits as K3 at one head with alpha = the pack's weights (the walk
    both run); times of the kernel, the plain version, the library call
    and the launch floor on both packs, and of the kernel in bf16 on the
    fwd pack."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, d, generator=gen, device=device)
    fwd, bwd = packs
    # rows of more than 32 slots (ba's hubs, up to 49 terms of weight 1):
    # two f32 sums of them in different orders differ by a share of the
    # row's sum of |terms|, as on make_graph's packs (check_bench_kernels)
    long_rows = max(longest_rows(p)["longest_row_slots"]
                    for p in packs) > 32
    errs = {}
    for name, pack in (("fwd", fwd), ("bwd", bwd)):
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            xin = x.to(dtype)
            key = f"{name}_{str(dtype)[6:]}"
            got = K.spmm_packed(pack, xin)
            want = K.spmm_packed_plain(pack, xin)
            torch.cuda.synchronize()
            if got.shape != (n, d) or not torch.isfinite(got).all():
                fail(f"{name}/{dtype}: bad output {tuple(got.shape)}")
            if long_rows and dtype == torch.float32:
                errs[key] = hold_sums(f"{name}/{dtype}", got, want,
                                      K.spmm_packed_plain(pack, xin.abs()))
            elif not torch.allclose(got.float(), want.float(), **tol):
                err = (got.float() - want.float()).abs().max().item()
                fail(f"{name}/{dtype}: kernel vs plain max err {err} "
                     f"beyond {tol}")
            else:
                errs[key] = (got.float() - want.float()).abs().max().item()
            again = K.spmm_packed(pack, xin)
            if not torch.equal(got, again):
                fail(f"{name}/{dtype}: two launches differ")
            if not torch.equal(K.packed_spmm_cuda(pack, xin),
                               K.packed_segment_matmul_headed_cuda(
                                   pack, xin, pack.weights[..., None])):
                fail(f"{name}/{dtype}: K1 differs from K3 at one head "
                     "with alpha = the pack's weights")
    out = {}
    for name, pack in (("fwd", fwd), ("bwd", bwd)):
        a = csr_of(pack, n)
        lib_err = (torch.sparse.mm(a, x)
                   - K.spmm_packed(pack, x)).abs().max().item()
        calls = {"kernel": lambda: K.packed_spmm_cuda(pack, x),
                 "plain": lambda: K.spmm_packed_plain(pack, x),
                 "library": lambda: torch.sparse.mm(a, x)}
        out[name] = dict(library_err=lib_err,
                         **timings(calls, pack, x, slot_bytes=8),
                         **floor_timings(pack, x))
    xb = x.bfloat16()
    bf16 = timings({"kernel": lambda: K.packed_spmm_cuda(fwd, xb)}, fwd,
                   xb, slot_bytes=8)
    return dict(width=d,
                max_abs_err=max(errs["fwd_float32"], errs["bwd_float32"]),
                errs=errs, **out["fwd"], bwd=out["bwd"],
                bf16={k: bf16[k] for k in ("ms", "call_ms", "timed_by",
                                           "bound_ms", "bytes")})


def floor_timings(pack: K.PackedCSR, x: torch.Tensor) -> dict:
    """The launch floor's device ms per call (time_calls) and its
    CUDA-event loop time; out has the pack's rows."""
    out = torch.empty(pack.row_range.shape[0], x.shape[1],
                      dtype=torch.float32, device=x.device)
    ms, loop_ms, timed_by, queued = time_calls(
        {"floor": k1_floor(pack, x, out)}, bound_ms=1e-9)
    return dict(floor_ms=ms["floor"], floor_call_ms=loop_ms["floor"],
                floor_timed_by=timed_by["floor"],
                floor_queued_ms=queued["floor"])


def timings(calls: dict, pack: K.PackedCSR, x: torch.Tensor,
            slot_bytes: int) -> dict:
    """Device ms per call of the kernel and, where given, the plain
    version and the library call, their CUDA-event loop times, and the
    bound: each input read once (x, the pack's slot_bytes on each slot
    the kernel reads, row_range), the f32 output written once, over the
    card's memory rate, against 2 flops per slot and column over its f32
    rate."""
    n, d = x.shape
    real_slots = real_slots_of(pack)
    moved = (x.numel() * x.element_size()        # x read once
             + real_slots * slot_bytes
             + pack.row_range.numel() * 4
             + n * d * 4)                         # out written once
    return dict(**bounded_times(calls, moved, 2 * real_slots * d),
                slots=pack.senders.numel(), real_slots=real_slots)


def real_slots_of(pack: K.PackedCSR) -> int:
    """The slots the pack's row ranges span (the ones a row walk reads)."""
    ranges = pack.row_range.long()
    return int((ranges[:, 1] - ranges[:, 0]).sum().item())


def bounded_times(calls: dict, moved: int, flops: int) -> dict:
    """time_calls' times of the kernel, plain version and library call,
    beside the bound of a function that moves ``moved`` bytes and does
    ``flops`` f32 operations."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    ms, loop_ms, timed_by, queued = time_calls(calls, bound_ms)
    return dict(ms=ms["kernel"], plain_ms=ms.get("plain"),
                library_ms=ms.get("library"), call_ms=loop_ms,
                timed_by=timed_by, queued_ms=queued, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved, flops=flops)


def row_sum_timings(calls: dict, pack: K.PackedCSR, heads: int) -> dict:
    """Times of a row sum of per-slot values c [NC, C, H] f32 beside its
    bound: the sum reads c on each slot of the row ranges (4 bytes a
    head) and row_range, writes the f32 [N, H] output once, and adds
    once per slot and head; it needs no sender and no v (K3 at dv = 1
    reads both)."""
    real_slots = real_slots_of(pack)
    moved = (real_slots * 4 * heads + pack.row_range.numel() * 4
             + pack.row_range.shape[0] * heads * 4)
    return dict(**bounded_times(calls, moved, real_slots * heads),
                real_slots=real_slots)


def sddmm_bound(pack: K.PackedCSR, a: torch.Tensor) -> tuple:
    """(bytes, flops) of the SDDMM on a pack with a and b like ``a``
    [N, H, dh]: a and b read once, a sender and a weight on each slot of
    the row ranges, row_range, the f32 [NC, C, H] output written on
    every slot; 2 flops per real slot and column."""
    n, heads, dh = a.shape
    real_slots = real_slots_of(pack)
    moved = (2 * a.numel() * a.element_size() + real_slots * 8
             + pack.row_range.numel() * 4
             + pack.senders.numel() * heads * 4)
    return moved, 2 * real_slots * heads * dh


def check_attention_kernel(packs, n: int, d: int, device) -> dict:
    """K3 against its plain version at the train 'att' pack: alpha is a
    segment softmax of random logits over the valid slots, as the layer
    makes it; the bwd pack takes it through the slot map.  In f32 on
    packs with rows of more than 32 slots (ba's hubs), by hold_sums'
    rule, as check_kernel holds K1 there: the plain version's index_add_
    sums in no fixed order on the card, and two f32 orders of a 49-term
    sum differ by a share of the row's sum of |terms|."""
    fwd, bwd, slot_map = packs
    gen = torch.Generator(device=device).manual_seed(1)
    v = torch.randn(n, d, generator=gen, device=device)
    long_rows = max(longest_rows(p)["longest_row_slots"]
                    for p in (fwd, bwd)) > 32

    def softmax_alpha(heads):
        logits = torch.randn(fwd.senders.shape + (heads,), generator=gen,
                             device=device)
        return K.packed_segment_softmax(logits, fwd)

    k3 = K.packed_segment_matmul_headed_cuda
    alphas = {heads: softmax_alpha(heads) for heads in (1, 4)}
    errs = {}
    for heads, alpha in alphas.items():
        for name, pack, a in (("fwd", fwd, alpha),
                              ("bwd", bwd, K.alpha_to_bwd(alpha,
                                                          slot_map))):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                vin = v.to(dtype)
                got = K.packed_segment_matmul_headed(pack, vin, a)
                want = K.packed_segment_matmul_headed_plain(pack, vin, a)
                torch.cuda.synchronize()
                case = f"{name}_h{heads}_{str(dtype)[6:]}"
                if got.shape != (n, d) or not torch.isfinite(got).all():
                    fail(f"K3 {case}: bad output {tuple(got.shape)}")
                err = (got - want).abs().max().item()
                if long_rows and dtype == torch.float32:
                    err = hold_sums(f"K3 {case}", got, want,
                                    K.packed_segment_matmul_headed_plain(
                                        pack, vin.abs(), a.abs()))
                elif not torch.allclose(got, want, **tol):
                    fail(f"K3 {case}: kernel vs plain max err {err} "
                         f"beyond {tol}")
                errs[case] = err
                if not torch.equal(
                        got, K.packed_segment_matmul_headed(pack, vin, a)):
                    fail(f"K3 {case}: two launches differ")
    alpha1 = alphas[1]
    a = csr_of(fwd, n, alpha1[..., 0])
    lib_err = (torch.sparse.mm(a, v)
               - K.packed_segment_matmul_headed(fwd, v, alpha1)).abs().max()
    calls = {
        "kernel": lambda: k3(fwd, v, alpha1),
        "plain": lambda: K.packed_segment_matmul_headed_plain(fwd, v,
                                                              alpha1),
        "library": lambda: torch.sparse.mm(a, v)}
    alpha4 = alphas[4]
    calls4 = {
        "kernel": lambda: k3(fwd, v, alpha4),
        "plain": lambda: K.packed_segment_matmul_headed_plain(fwd, v,
                                                              alpha4)}
    return dict(max_abs_err=max(e for k, e in errs.items()
                                if k.endswith("float32")),
                errs=errs, library_err=lib_err.item(),
                **timings(calls, fwd, v, slot_bytes=8),  # sender, alpha
                h4=timings(calls4, fwd, v, slot_bytes=4 + 4 * 4))


def check_softmax(pack: K.PackedCSR, n: int, device) -> dict:
    """The attention softmax (``packed_segment_softmax``, whose row sums
    are K3 at dv = 1) at the train 'att' fwd pack, H = 1 (K3's narrow
    walk) and H = 4 (its scalar walk): K3 at dv = 1 against its plain
    version; the Function's values and gradient on the card against the
    CPU (F32_TOL: exp and the sum order differ); bitwise-repeatable
    forward and backward; at H = 1 times of the row sums (K3, plain, and
    index_add_ into [N, 1], the atomic call it replaced) beside the
    bound."""
    gen = torch.Generator(device=device).manual_seed(5)
    cpu_pack = K.PackedCSR(*(a.cpu() for a in pack))
    valid = (pack.weights > 0)[..., None]
    errs, c1 = {}, None
    for heads in (1, 4):
        shape = pack.senders.shape + (heads,)
        c = torch.where(valid, torch.rand(shape, generator=gen,
                                          device=device), 0.0)
        ones = torch.ones(n, heads, device=device)
        got = K.packed_row_sum(pack, c)
        want = K.packed_segment_matmul_headed_plain(pack, ones, c)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, **F32_TOL):
            fail(f"K3 row sums H = {heads}: max err "
                 f"{(got - want).abs().max().item()} beyond {F32_TOL}")
        errs[f"row_sum_h{heads}"] = (got - want).abs().max().item()
        if not torch.equal(got, K.packed_row_sum(pack, c)):
            fail(f"K3 row sums H = {heads}: two launches differ")
        logits = torch.randn(shape, generator=gen, device=device) * 3
        g = torch.randn(shape, generator=gen, device=device)
        runs = []
        for pk, lg, gg in ((pack, logits, g), (pack, logits, g),
                           (cpu_pack, logits.cpu(), g.cpu())):
            x = lg.clone().requires_grad_(True)
            alpha = K.packed_segment_softmax(x, pk)
            alpha.backward(gg)
            runs.append((alpha.detach().cpu(), x.grad.cpu()))
        (a0, d0), (a1, d1), (a_cpu, d_cpu) = runs
        if not (torch.equal(a0, a1) and torch.equal(d0, d1)):
            fail(f"softmax H = {heads}: two runs on the card differ")
        for what, x, y in (("values", a0, a_cpu), ("gradient", d0, d_cpu)):
            if not torch.allclose(x, y, **F32_TOL):
                fail(f"softmax H = {heads} {what}: card vs CPU max err "
                     f"{(x - y).abs().max().item()} beyond {F32_TOL}")
            errs[f"softmax_h{heads}_{what}"] = (x - y).abs().max().item()
        if heads == 1:
            c1 = c
    ones = torch.ones(n, 1, device=device)
    rows = K.pack_rows(pack).reshape(-1)
    out_lib = torch.zeros(n, 1, device=device)
    calls = {"kernel": lambda: K.packed_segment_matmul_headed_cuda(
                 pack, ones, c1),
             "plain": lambda: K.packed_segment_matmul_headed_plain(
                 pack, ones, c1),
             "library": lambda: out_lib.index_add_(0, rows,
                                                   c1.view(-1, 1))}
    return dict(max_abs_err=errs["row_sum_h1"], errs=errs, width=1,
                library="index_add_", **row_sum_timings(calls, pack, 1))


def valid_csr(pack: K.PackedCSR, n: int) -> torch.Tensor:
    """The slots of nonzero pack weight as an [n, n] CSR pattern of ones
    (the SDDMM library call's sampling matrix)."""
    live = (pack.weights > 0).reshape(-1)
    rows = K.pack_rows(pack).reshape(-1)[live]
    cols = pack.senders.reshape(-1)[live].long()
    return torch.sparse_coo_tensor(
        torch.stack([rows, cols]),
        torch.ones(rows.numel(), device=rows.device),
        (n, n)).coalesce().to_sparse_csr()


def check_sddmm_kernel(pack: K.PackedCSR, n: int, d: int, device) -> dict:
    """The SDDMM at the train 'att' fwd pack against its plain version:
    f32 and bf16, H = 1 and 4, within SEG_REL of the slot's sum of
    |a * b| products (two f32 sums of 128 products in different orders),
    exact 0 on every slot of pack weight 0, bitwise repeats; times at
    H = 1 and 4 and, at H = 1, torch.sparse.sampled_addmm on a CSR of the
    valid slots."""
    gen = torch.Generator(device=device).manual_seed(4)
    sddmm = K.packed_sddmm_cuda
    zero_w = pack.weights == 0
    errs, inputs = {}, {}
    for heads in (1, 4):
        a, b = (torch.randn(n, heads, d // heads, generator=gen,
                            device=device) for _ in range(2))
        inputs[heads] = (a, b)
        for dtype in (torch.float32, torch.bfloat16):
            case = f"h{heads}_{str(dtype)[6:]}"
            ai, bi = a.to(dtype), b.to(dtype)
            got = K.packed_sddmm(pack, ai, bi)
            want = K.packed_sddmm_plain(pack, ai, bi)
            scale = K.packed_sddmm_plain(pack, ai.float().abs(),
                                         bi.float().abs())
            torch.cuda.synchronize()
            if got.shape != pack.senders.shape + (heads,) \
                    or not torch.isfinite(got).all():
                fail(f"SDDMM {case}: bad output {tuple(got.shape)}")
            err = (got - want).abs()
            if (err > SEG_REL * scale + SEG_ATOL).any():
                fail(f"SDDMM {case}: max err {err.max().item()} beyond "
                     f"{SEG_REL} x sum|a*b| + {SEG_ATOL}")
            if (got[zero_w] != 0).any():
                fail(f"SDDMM {case}: a slot of pack weight 0 is not 0")
            errs[case] = err.max().item()
            if not torch.equal(got, K.packed_sddmm(pack, ai, bi)):
                fail(f"SDDMM {case}: two launches differ")

    # the library call: the valid slots as a CSR pattern, H = 1
    live = (pack.weights > 0).reshape(-1)
    csr = valid_csr(pack, n)
    a1, b1 = (t[:, 0] for t in inputs[1])
    b1t = b1.t()

    def library():
        return torch.sparse.sampled_addmm(csr, a1, b1t, beta=0.0)

    lib = library().values()
    kern = K.packed_sddmm(pack, *inputs[1]).reshape(-1)[live]
    # the CSR holds the valid slots in slot order (rows, then senders,
    # ascending) unless an edge repeats
    lib_err = ((lib - kern).abs().max().item()
               if lib.numel() == kern.numel() else None)
    out = {}
    for heads in (1, 4):
        a, b = inputs[heads]
        calls = {"kernel": lambda: sddmm(pack, a, b),
                 "plain": lambda: K.packed_sddmm_plain(pack, a, b)}
        if heads == 1:
            calls["library"] = library
        out[f"h{heads}"] = bounded_times(calls, *sddmm_bound(pack, a))
    return dict(max_abs_err=max(e for k, e in errs.items()
                                if k.endswith("float32")),
                errs=errs, library_err=lib_err, slots=pack.senders.numel(),
                real_slots=real_slots_of(pack),
                csr_nnz=csr.values().numel(), **out["h1"], h4=out["h4"])


def hold_sums(case: str, got: torch.Tensor, want: torch.Tensor,
              scale: torch.Tensor, rel: float = SEG_REL) -> float:
    """A kernel's sums against a reference sum of the same terms:
    |got - want| <= rel * (the row's sum of |terms|) + SEG_ATOL."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{case}: bad output {tuple(got.shape)}")
    err = (got.float() - want.float()).abs()
    excess = (err - rel * scale - SEG_ATOL).max().item()
    if excess > 0:
        fail(f"{case}: max err {err.max().item()} beyond "
             f"{rel} x sum|terms| + {SEG_ATOL} (by {excess})")
    return err.max().item()


def check_segment_kernel(host_batch, pack: K.PackedCSR, n: int, d: int,
                         device) -> dict:
    """K2 at the train 'plain' fwd pack: against its plain version with
    a random message on every slot, against K1 with msg = x[senders] *
    w, in bf16, on a pack built with G = 2; bitwise repeats; the vjp's
    gradient; times.  Returns the launches of the checks (the timing
    loops not counted)."""
    K.packed_segment_matmul_cuda.launches = 0
    gen = torch.Generator(device=device).manual_seed(2)
    local, tiles = pack.local_rows, pack.tiles
    nt = K.num_tiles_of(n)
    t0 = time.perf_counter()
    runs = K.segment_runs_host(local.cpu().numpy(), tiles.cpu().numpy(), nt)
    index_s = time.perf_counter() - t0

    def seg(m, loc=local, til=tiles, group=1):
        return K.packed_segment_matmul(m, loc, til, nt, group=group)

    def plain(m, loc=local, til=tiles):
        return K.packed_segment_matmul_plain(m, loc, til, nt)

    errs = {}
    msg = torch.randn(pack.senders.shape + (d,), generator=gen,
                      device=device)
    scale = plain(msg.abs())
    got = seg(msg)
    errs["random_f32"] = hold_sums("K2 random f32", got, plain(msg), scale)
    if not torch.equal(got, seg(msg)):
        fail("K2 f32: two launches differ")
    # every slot counts: zeroing the padding slots' messages changes rows
    real = (pack.senders < n)[..., None]
    if torch.equal(got, seg(msg * real)):
        fail("K2: the padding slots' messages were not summed")
    # against K1 on the same pack: msg = x[senders] * w
    x = torch.randn(n, d, generator=gen, device=device)
    xp = torch.cat([x, x.new_zeros(1, d)])
    wmsg = (xp.index_select(0, pack.senders.reshape(-1).long())
            .view(msg.shape) * pack.weights[..., None])
    errs["vs_k1"] = hold_sums("K2 vs K1", seg(wmsg)[:n],
                              K.spmm_packed(pack, x), plain(wmsg.abs())[:n])
    # bf16 messages, f32 sums
    mb = msg.bfloat16()
    got = seg(mb)
    errs["random_bf16"] = hold_sums("K2 random bf16", got, plain(mb),
                                    plain(mb.float().abs()))
    if not torch.equal(got, seg(mb)):
        fail("K2 bf16: two launches differ")
    # a pack built with group G = 2 from the same edges ('plain': raw A)
    p2 = K.pack_csr(host_batch.senders, host_batch.receivers,
                    host_batch.edge_weight, n, group=2)
    loc2, til2 = (torch.from_numpy(a).to(device)
                  for a in (p2.local_rows, p2.tiles))
    m2 = torch.randn(p2.senders.shape + (d,), generator=gen, device=device)
    got = seg(m2, loc2, til2, group=2)
    errs["group2_f32"] = hold_sums("K2 G = 2", got, plain(m2, loc2, til2),
                                   plain(m2.abs(), loc2, til2))
    if not torch.equal(got, seg(m2, loc2, til2, group=2)):
        fail("K2 G = 2: two launches differ")
    # segment_matmul_vjp: forward by K2, d_msg = g[rows]; the plain
    # version's autograd gives the same gather (n is a whole number of
    # tiles here, so the clamp does not act)
    g = torch.randn(n, d, generator=gen, device=device)
    grads = []
    for fn in (lambda m: K.segment_matmul_vjp(m, local, tiles, n),
               lambda m: plain(m)[:n]):
        mr = msg.clone().requires_grad_(True)
        out = fn(mr)
        out.backward(g)
        grads.append((out.detach(), mr.grad))
    (out_k, d_k), (out_p, d_p) = grads
    errs["vjp_fwd"] = hold_sums("K2 vjp forward", out_k, out_p, scale[:n])
    if not torch.equal(d_k, d_p):
        fail(f"K2 vjp: d_msg differs from the plain version's by "
             f"{(d_k - d_p).abs().max().item()}")
    torch.cuda.synchronize()
    launches = K.packed_segment_matmul_cuda.launches

    # times at f32: kernel, plain, and two library calls for the same
    # function (atomic index_add_; a 0/1 CSR [rows, slots] times msg)
    rows = K.slot_rows(local, tiles).reshape(-1)
    flat = msg.view(-1, d)
    out_lib = torch.zeros(nt * K.ROWS_PER_TILE, d, device=device)
    ones = torch.sparse_coo_tensor(
        torch.stack([rows, torch.arange(rows.numel(), device=device)]),
        torch.ones(rows.numel(), device=device),
        (nt * K.ROWS_PER_TILE, rows.numel())).coalesce().to_sparse_csr()
    lib_err = (torch.sparse.mm(ones, flat) - seg(msg)).abs().max().item()
    calls = {"kernel": lambda: K.packed_segment_matmul_cuda(msg, local,
                                                            tiles, nt),
             "plain": lambda: plain(msg),
             "index_add": lambda: out_lib.index_add_(0, rows, flat),
             "sparse_mm": lambda: torch.sparse.mm(ones, flat)}
    moved = (msg.numel() * msg.element_size()        # every slot once
             + (local.numel() + tiles.numel()) * 4     # the pack ints
             + nt * K.ROWS_PER_TILE * d * 4)           # out written once
    flops = msg.numel()                                # one add each
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    ms, loop_ms, timed_by, queued = time_calls(calls,
                                               max(t_bytes, t_ops) * 1e3)
    library = min(("index_add", "sparse_mm"), key=ms.get)
    return dict(max_abs_err=errs["random_f32"], errs=errs, launches=launches,
                library_err=lib_err, ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms[library], library=library,
                index_add_ms=ms["index_add"], sparse_mm_ms=ms["sparse_mm"],
                call_ms=loop_ms, timed_by=timed_by, queued_ms=queued,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved, flops=flops, slots=rows.numel(),
                runs=len(runs.run_out), partials=runs.num_partials,
                combined_rows=len(runs.comb_rows),
                longest_row_slots=int(np.bincount(
                    rows.cpu().numpy()).max()),
                index_build_s=index_s)


def longest_rows(pack: K.PackedCSR) -> dict:
    """A pack's longest row (the slots its row_range spans) and how many
    rows are longer than the narrow walk's kLongRow (32 slots)."""
    lengths = (pack.row_range[:, 1] - pack.row_range[:, 0]).long()
    return dict(longest_row=int(lengths.argmax()),
                longest_row_slots=int(lengths.max()),
                rows_over_32_slots=int((lengths > 32).sum()))


def max_floor(n: int, d: int, backward: bool):
    """The launch floor under the segmented max (csrc/packed_max.cu,
    packed_max_floor): an empty kernel over the grid the max's forward
    (or backward) takes for n rows of d f32 columns.  Counts no
    launch."""
    fn = K.library("packed_max").packed_max_floor
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(n, d, 0, int(backward),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"max floor launch: CUDA error {err}")
    return launch


def max_messages(pack: K.PackedCSR, x: torch.Tensor):
    """The segmented max's messages w * x[sender] on the slots it takes
    (weight != 0, sender a row of x), and their rows."""
    senders, w = pack.senders.reshape(-1).long(), pack.weights.reshape(-1)
    live = (w != 0) & (senders < x.shape[0])
    return (x.index_select(0, senders[live]) * w[live][:, None],
            K.pack_rows(pack).reshape(-1)[live])


def live_rows(pack: K.PackedCSR, n_src: int) -> int:
    """How many distinct input rows the pack's slots of nonzero weight
    read (all but the padding rows on a layer's pack; the ego centers,
    or the real nodes, on a pooling pack; the real graph slots on its
    transpose)."""
    senders = pack.senders.reshape(-1).long()
    live = (pack.weights.reshape(-1) != 0) & (senders < n_src)
    return int(torch.unique(senders[live]).numel())


def check_max_kernel(packs, n: int, d: int, device) -> dict:
    """The segmented max (csrc/packed_max.cu) against its plain version
    on the CPU, f32, at width d on the fwd pack and its backward on the
    bwd pack: on seeded normal x and on x rounded to three levels
    (-1, 0, 1: ties in most columns, which a model check on random
    features never sees).  x has n rows; out, cnt and g have the fwd
    pack's rows (n on a layer's pack, the graph slots on a pooling
    pack).  The forward's out and tie counts bitwise (a max is exact),
    dx at F32_TOL (the CPU's index_add_ sums in slot order too;
    ``bwd_bitwise`` says whether it was exact); two launches bitwise
    equal.  Times of both kernels, the plain versions and the library
    calls beside the bound and the launch floor: the forward against
    scatter_reduce(amax) over messages gathered before the timing (one
    library call, the gather not timed), the backward against that
    call's own backward (the gradient of each gathered message, a tie
    split evenly, without the sum of the messages' gradients into dx).
    The forward reads the x rows its live slots name, the pack's 8
    bytes on each slot of the row ranges and row_range, and writes out
    and the tie counts; the backward reads the x rows of its live rows,
    g, out and the counts, the bwd pack and its row_range, and writes
    dx."""
    gen = torch.Generator(device=device).manual_seed(0)
    fwd, bwd = packs
    rows = fwd.row_range.shape[0]
    cpu_fwd, cpu_bwd = (K.PackedCSR(*(a.cpu() for a in p)) for p in packs)
    x = torch.randn(n, d, generator=gen, device=device)
    g = torch.randn(rows, d, generator=gen, device=device)
    errs, fwd_errs, ties = {}, {}, {}
    for case, xin in (("random", x), ("tied", x.round().clamp(-1, 1))):
        out, cnt = K.packed_max(fwd, xin)
        dx = K.packed_max_bwd(bwd, xin, g, out, cnt)
        torch.cuda.synchronize()
        want, want_cnt = K.packed_max_plain(cpu_fwd, xin.cpu())
        want_dx = K.packed_max_bwd_plain(cpu_bwd, xin.cpu(), g.cpu(), want,
                                         want_cnt)
        if not (torch.equal(out.cpu(), want)
                and torch.equal(cnt.cpu(), want_cnt)):
            fail(f"max {case} d={d}: forward differs from the plain "
                 f"version by {(out.cpu() - want).abs().max().item()}, "
                 f"tie counts by {(cnt.cpu() - want_cnt).abs().max()}")
        if not torch.allclose(dx.cpu(), want_dx, **F32_TOL):
            fail(f"max {case} d={d}: backward vs plain max err "
                 f"{(dx.cpu() - want_dx).abs().max().item()}")
        again = K.packed_max(fwd, xin)
        if not (torch.equal(again[0], out) and torch.equal(again[1], cnt)
                and torch.equal(K.packed_max_bwd(bwd, xin, g, out, cnt),
                                dx)):
            fail(f"max {case} d={d}: two launches differ")
        errs[case] = (dx.cpu() - want_dx).abs().max().item()
        fwd_errs[case] = (out.cpu() - want).abs().max().item()
        ties[case] = dict(tied_entries=int((cnt > 1).sum()),
                          most_tied=int(cnt.max()),
                          bwd_bitwise=torch.equal(dx.cpu(), want_dx))
    out, cnt = K.packed_max(fwd, x)
    msg, msg_rows = max_messages(fwd, x)
    index = msg_rows[:, None].expand(-1, d)
    msg = msg.requires_grad_()
    lib_out = torch.zeros(rows, d, device=device).scatter_reduce(
        0, index, msg, "amax", include_self=False)

    def library():
        with torch.no_grad():
            return torch.zeros(rows, d, device=device).scatter_reduce_(
                0, index, msg, "amax", include_self=False)

    def library_bwd():
        return torch.autograd.grad(lib_out, msg, g, retain_graph=True)[0]
    if not torch.equal(library(), out):
        fail(f"max d={d}: scatter_reduce(amax) differs from the kernel")
    floors = {name: time_calls({"floor": max_floor(r, d, name == "bwd")},
                               bound_ms=1e-9)[0]["floor"]
              for name, r in (("fwd", rows), ("bwd", n))}
    rd4 = rows * d * 4
    f_slots, b_slots = real_slots_of(fwd), real_slots_of(bwd)
    fwd_t = bounded_times(
        {"kernel": lambda: K.packed_max_cuda(fwd, x),
         "plain": lambda: K.packed_max_plain(fwd, x),
         "library": library},
        moved=(live_rows(fwd, n) * d * 4 + 2 * rd4 + f_slots * 8
               + fwd.row_range.numel() * 4),
        flops=2 * f_slots * d)
    bwd_t = bounded_times(
        {"kernel": lambda: K.packed_max_bwd_cuda(bwd, x, g, out, cnt),
         "plain": lambda: K.packed_max_bwd_plain(bwd, x, g, out, cnt),
         "library": library_bwd},
        moved=(int((bwd.row_range[:, 1] > bwd.row_range[:, 0]).sum())
               * d * 4 + 3 * rd4 + n * d * 4 + b_slots * 8
               + bwd.row_range.numel() * 4),
        flops=4 * b_slots * d)
    return dict(width=d, ties=ties, slots=f_slots, rows=rows,
                fwd=dict(max_abs_err=max(fwd_errs.values()),
                         floor_ms=floors["fwd"],
                         library="scatter_reduce amax, messages gathered "
                                 "before", **fwd_t),
                bwd=dict(max_abs_err=max(errs.values()),
                         floor_ms=floors["bwd"], errs=errs,
                         library="scatter_reduce amax's backward (the "
                                 "messages' gradients)", **bwd_t))


def check_pool_k1(packs, n: int, d: int, device) -> dict:
    """K1 on a graph task's add or mean pooling packs (graphs/packing.
    build_pool_packs): the fwd pack's graph slots (its rows) from x
    [n, d], the bwd pack's n rows from g [graph slots, d]; the library
    call torch.sparse.mm of the pooling matrix and of its transpose
    (``check_rect_k1``)."""
    def library(name, pack, xin, out_rows):
        a = csr_of(pack, out_rows, cols_n=xin.shape[0])
        return lambda: torch.sparse.mm(a, xin)
    return check_rect_k1(packs, n, d, device, library, "pool")


def check_gather_k1(packs, index: np.ndarray, mask: np.ndarray, n: int,
                    d: int, device) -> dict:
    """K1 on a head's gather packs (graphs/packing.build_gather_packs):
    the fwd pack's rows x[index] from x [n, d] (zero rows at padding
    entries), the bwd pack's n rows from g [entries, d], each node's
    entries summed in index order; the library calls the gather's own,
    index_select and, for its gradient, index_add_ into zeros, whose
    error is taken where they compute the same function (the real
    entries forward; every node but the padding one, which the padding
    entries name, backward) (``check_rect_k1``)."""
    idx = torch.from_numpy(np.asarray(index, np.int64)).to(device)
    live = torch.from_numpy(np.asarray(mask, bool)).to(device)
    keep = {"fwd": live,
            "bwd": torch.arange(n, device=device) != n - 1}

    def library(name, pack, xin, out_rows):
        if name == "fwd":
            return lambda: xin.index_select(0, idx)
        return lambda: torch.zeros(n, d, device=device).index_add_(
            0, idx, xin)
    return check_rect_k1(packs, n, d, device, library, "gather", keep)


def check_rect_k1(packs, n: int, d: int, device, library, what: str,
                  keep=None) -> dict:
    """K1 on a rectangular pack pair (a pooling or gather pack and its
    transpose): the fwd pack's rows from x [n, d], the bwd pack's n rows
    from g [fwd rows, d], against the plain versions on the CPU (slot
    order, as the kernel) at F32_TOL, bitwise repeats; times of the
    kernel, the plain version on the card, the library call
    (``library(name, pack, input, out_rows)`` gives it; its error where
    ``keep[name]`` marks the output rows it shares with K1) and the
    launch floor beside the bound: each direction reads the input rows
    its live slots name, 8 bytes of pack a slot of the row ranges and
    row_range, and writes its f32 output once."""
    gen = torch.Generator(device=device).manual_seed(0)
    fwd, bwd = packs
    rows = fwd.row_range.shape[0]
    cpu_fwd, cpu_bwd = (K.PackedCSR(*(a.cpu() for a in p)) for p in packs)
    x = torch.randn(n, d, generator=gen, device=device)
    g = torch.randn(rows, d, generator=gen, device=device)
    out = {}
    for name, pack, cpu_pack, xin, out_rows in (
            ("fwd", fwd, cpu_fwd, x, rows), ("bwd", bwd, cpu_bwd, g, n)):
        got = K.spmm_packed(pack, xin)
        want = K.spmm_packed_plain(cpu_pack, xin.cpu())
        torch.cuda.synchronize()
        if got.shape != (out_rows, d) or not torch.isfinite(got).all():
            fail(f"{what} {name}: bad output {tuple(got.shape)}")
        err = (got.cpu() - want).abs().max().item()
        if not torch.allclose(got.cpu(), want, **F32_TOL):
            fail(f"{what} {name}: kernel vs plain max err {err} beyond "
                 f"{F32_TOL}")
        if not torch.equal(K.spmm_packed(pack, xin), got):
            fail(f"{what} {name}: two launches differ")
        lib = library(name, pack, xin, out_rows)
        shared = (slice(None) if keep is None else keep[name])
        real_slots = real_slots_of(pack)
        calls = {"kernel": lambda: K.packed_spmm_cuda(pack, xin),
                 "plain": lambda: K.spmm_packed_plain(pack, xin),
                 "library": lib}
        moved = (live_rows(pack, xin.shape[0]) * d * 4 + real_slots * 8
                 + pack.row_range.numel() * 4 + out_rows * d * 4)
        out[name] = dict(max_abs_err=err,
                         bitwise=torch.equal(got.cpu(), want),
                         library_err=(lib()[shared]
                                      - got[shared]).abs().max().item(),
                         rows=out_rows, real_slots=real_slots,
                         longest=longest_rows(pack),
                         **bounded_times(calls, moved, 2 * real_slots * d),
                         **floor_timings(pack, xin))
    return dict(width=d, **out)


def median_iqr(values) -> dict:
    """The benchmark's median and IQR, unrounded, and the values."""
    return dict(**B._stats(values, ndigits=None), values=list(values))


def check_bench_kernels(device) -> dict:
    """K1, K3 and the segmented max on the benchmark's graph (make_graph
    at the root bench.py's defaults: row 0 of each pack takes ~5,500
    slots): K1
    against its plain version on the fwd and bwd packs, f32 and bf16,
    held by hold_sums' rule; bitwise-repeatable launches;
    spmm_bidir's gradient of sum(out^2) against the plain version's
    (one unchained call: the benchmark's chain overflows); on the
    attention workload's 'att' packs, K3 at H = 8, dv = 16 on the fwd
    pack and (alpha through the slot map) the bwd pack, its row sums at
    dv = 1 on both (H = 8: the scalar walk; H = 1: the narrow walk's hub
    rows) and the SDDMM at H = 8 (``check_bench_sddmm``), held the same
    way; the max's forward and backward on the fwd and bwd packs at
    D = 128 (``check_max_kernel``); times of the kernels, plain
    versions, library calls and K1's and the max's launch floors beside
    the bounds."""
    n, e, d = BENCH_DIMS
    t0 = time.perf_counter()
    *_, x_host, host_pack = B.bidir_graph(n, e, d)
    out = dict(n=n, edges=e, d=d, host_pack_s=time.perf_counter() - t0)
    pack = host_pack.to(device)
    x = torch.from_numpy(x_host).to(device)
    out.update(fwd_rows=longest_rows(pack.fwd),
               bwd_rows=longest_rows(pack.bwd))
    errs = {}
    for name, p in (("fwd", pack.fwd), ("bwd", pack.bwd)):
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype)
            case = f"K1 make_graph {name} {str(dtype)[6:]}"
            got = K.packed_spmm_cuda(p, xin)
            errs[f"{name}_{str(dtype)[6:]}"] = hold_sums(
                case, got, K.spmm_packed_plain(p, xin.float()),
                K.spmm_packed_plain(p, xin.float().abs()))
            if not torch.equal(got, K.packed_spmm_cuda(p, xin)):
                fail(f"{case}: two launches differ")
    grads = []
    for fn in (lambda t: K.spmm_bidir(pack, t, n),
               lambda t: K.spmm_packed_plain(pack.fwd, t)):
        xg = x.clone().requires_grad_(True)
        (fn(xg) ** 2).sum().backward()
        grads.append(xg.grad)
    # |out| <= A|x| (w >= 0): the forward's and the backward's rounding
    # both count against 2 A^T A |x|
    scale = 2 * K.spmm_packed_plain(pack.bwd,
                                    K.spmm_packed_plain(pack.fwd, x.abs()))
    errs["spmm_bidir_dx"] = hold_sums("spmm_bidir dx", *grads, scale,
                                      rel=2 * SEG_REL)
    for name, p in (("fwd", pack.fwd), ("bwd", pack.bwd)):
        a = csr_of(p, n)
        calls = {"kernel": lambda: K.packed_spmm_cuda(p, x),
                 "plain": lambda: K.spmm_packed_plain(p, x),
                 "library": lambda: torch.sparse.mm(a, x)}
        out[f"k1_{name}"] = dict(
            library_err=(torch.sparse.mm(a, x)
                         - K.packed_spmm_cuda(p, x)).abs().max().item(),
            **timings(calls, p, x, slot_bytes=8), **floor_timings(p, x))
    xb = x.bfloat16()
    out["k1_fwd_bf16"] = timings(
        {"kernel": lambda: K.packed_spmm_cuda(pack.fwd, xb)}, pack.fwd, xb,
        slot_bytes=8)
    out["k1_errs"] = errs

    # K3 and the SDDMM on the attention workload's 'att' packs (edges +
    # self-loops), at the shapes bench_attention gives them
    batch, h, *_ = B.attention_graph(n, e, BENCH_HEADS, BENCH_DV)
    att, att_bwd, slot_map = batch.to(device).packs["att"]
    na = batch.num_nodes
    gen = torch.Generator(device=device).manual_seed(6)
    valid = (att.weights > 0)[..., None]
    v = torch.from_numpy(h).to(device).view(na, -1)
    logits = torch.randn(att.senders.shape + (BENCH_HEADS,), generator=gen,
                         device=device)
    alpha = K.packed_segment_softmax(logits, att)
    plain = K.packed_segment_matmul_headed_plain
    k3 = K.packed_segment_matmul_headed_cuda
    # the aggregation (fwd pack) and its dv (bwd pack, alpha carried by
    # the slot map)
    errs, k3_times = {}, {}
    for name, p, a in (("fwd", att, alpha),
                       ("bwd", att_bwd, K.alpha_to_bwd(alpha, slot_map))):
        case = f"K3 make_graph {name} H = {BENCH_HEADS}"
        got = k3(p, v, a)
        errs[f"{name}_h{BENCH_HEADS}"] = hold_sums(
            case, got, plain(p, v, a), plain(p, v.abs(), a))
        if not torch.equal(got, k3(p, v, a)):
            fail(f"{case}: two launches differ")
        k3_times[name] = timings({"kernel": lambda: k3(p, v, a),
                                  "plain": lambda: plain(p, v, a)},
                                 p, v, slot_bytes=4 + 4 * BENCH_HEADS)
    # the row sums: the softmax's and ds_dst's on the fwd pack, ds_src's
    # on the bwd pack (c carried by the slot map); H = 8 takes the scalar
    # walk, H = 1 the narrow walk's hub rows
    sums = {}
    for heads in (BENCH_HEADS, 1):
        c = torch.where(valid, torch.rand(att.senders.shape + (heads,),
                                          generator=gen, device=device), 0.0)
        ones = torch.ones(na, heads, device=device)
        for name, p, cc in (("fwd", att, c),
                            ("bwd", att_bwd, K.alpha_to_bwd(c, slot_map))):
            case = f"K3 make_graph row sums {name} H = {heads}"
            got = K.packed_row_sum(p, cc)
            want = plain(p, ones, cc)
            errs[f"row_sum_{name}_h{heads}"] = hold_sums(case, got, want,
                                                         want)
            if not torch.equal(got, K.packed_row_sum(p, cc)):
                fail(f"{case}: two launches differ")
            rows = K.pack_rows(p).reshape(-1)
            out_lib = torch.zeros(na, heads, device=device)
            sums[f"{name}_h{heads}"] = row_sum_timings(
                {"kernel": lambda: k3(p, ones, cc),
                 "plain": lambda: plain(p, ones, cc),
                 "library": lambda: out_lib.index_add_(
                     0, rows, cc.view(-1, heads))}, p, heads)
    alpha1 = alpha[..., :1].contiguous()
    a1 = csr_of(att, na, alpha1[..., 0])
    out.update(
        att_rows=longest_rows(att), att_bwd_rows=longest_rows(att_bwd),
        k3_errs=errs, k3_h8=k3_times["fwd"], k3_h8_bwd=k3_times["bwd"],
        k3_h1=dict(**timings({"kernel": lambda: k3(att, v, alpha1),
                              "plain": lambda: plain(att, v, alpha1),
                              "library": lambda: torch.sparse.mm(a1, v)},
                             att, v, slot_bytes=8),
                   **floor_timings(att, v)),
        row_sums=sums, sddmm=check_bench_sddmm(att, na, gen))
    # the segmented max forward on the fwd pack and its backward on the
    # bwd pack (row 0 ~5,400 slots: the forward splits it over a block,
    # the backward's one owner walks its hubs)
    out["max"] = check_max_kernel((pack.fwd, pack.bwd), n, d, device)
    return out


def check_bench_sddmm(att: K.PackedCSR, n: int, gen) -> dict:
    """The SDDMM at bench_attention's dalpha (a = the output's gradient,
    b = v, [N, 8, 16] f32) on make_graph's 'att' fwd pack: within
    SEG_REL of each slot's sum of |a * b|, exact 0 on the slots of pack
    weight 0, bitwise repeats; kernel, plain and library (a batched
    torch.sparse.sampled_addmm, one CSR pattern of the valid slots per
    head) times beside the bound."""
    a, b = (torch.randn(n, BENCH_HEADS, BENCH_DV, generator=gen,
                        device=att.senders.device) for _ in range(2))
    got = K.packed_sddmm_cuda(att, a, b)
    err = hold_sums(f"SDDMM make_graph H = {BENCH_HEADS}", got,
                    K.packed_sddmm_plain(att, a, b),
                    K.packed_sddmm_plain(att, a.abs(), b.abs()))
    if (got[att.weights == 0] != 0).any():
        fail("SDDMM make_graph: a slot of pack weight 0 is not 0")
    if not torch.equal(got, K.packed_sddmm_cuda(att, a, b)):
        fail("SDDMM make_graph: two launches differ")
    csr = valid_csr(att, n)
    nnz = csr.values().numel()
    batched = torch.sparse_csr_tensor(
        csr.crow_indices().expand(BENCH_HEADS, -1).contiguous(),
        csr.col_indices().expand(BENCH_HEADS, -1).contiguous(),
        torch.ones(BENCH_HEADS, nnz, device=a.device), (BENCH_HEADS, n, n))
    ah = a.transpose(0, 1).contiguous()            # [H, N, dh]
    bt = b.permute(1, 2, 0).contiguous()           # [H, dh, N]
    calls = {"kernel": lambda: K.packed_sddmm_cuda(att, a, b),
             "plain": lambda: K.packed_sddmm_plain(att, a, b),
             "library": lambda: torch.sparse.sampled_addmm(
                 batched, ah, bt, beta=0.0)}
    live = (att.weights > 0).reshape(-1)
    lib = calls["library"]().values()
    kern = got.reshape(-1, BENCH_HEADS)[live].t()
    # the CSR holds the valid slots in slot order unless an edge repeats
    lib_err = ((lib - kern).abs().max().item()
               if lib.shape == kern.shape else None)
    return dict(max_abs_err=err, library_err=lib_err, csr_nnz=nnz,
                heads=BENCH_HEADS, dh=BENCH_DV,
                **bounded_times(calls, *sddmm_bound(att, a)))


def check_bench_runs(device) -> dict:
    """The benchmark's entry points (graphgym_tpu_torch/bench.py) at the
    root bench.py's defaults, each run's launches counted: ``main`` (its
    one JSON line: K1 fwd_bwd, fwd only and the COO fwd_bwd chains, K1
    twice per fwd_bwd step and once per fwd step), the bf16 fwd_bwd
    chain, ``bench_attention`` (K3 6 and the SDDMM 1 per step: forward
    the softmax sums and the aggregation; backward dv, the SDDMM's
    dalpha, the softmax row sum and the two node-score gradients; the
    four row sums at width H, the two aggregations at width H * dv), the
    attention gradients from two calls bitwise equal and, at a small
    graph, card against CPU, and ``bench_train_epoch`` of the four ws
    paths (one batch an epoch).  Rates and epoch times as median and
    IQR over BENCH_REPEATS."""
    import contextlib
    import io

    n, e, d = BENCH_DIMS
    it, rep = BENCH_ITERS, BENCH_REPEATS
    k1, k3, sddmm = (K.packed_spmm_cuda, K.packed_segment_matmul_headed_cuda,
                     K.packed_sddmm_cuda)
    chain = 1 + it * rep      # a warm-up step, then rep chains of it

    def run(what, fn, want, widths=()):
        """fn's result and launches, held to ``want``; ``widths`` holds
        the launches at each (width, {kernel: (count, how)}) given."""
        result, (launches, by_width, _) = counted(fn)
        hold_counts(f"bench {what}", launches,
                    {k.__name__: v for k, v in want.items()})
        for width, want_w in widths:
            hold_counts(f"bench {what}, at width {width}",
                        at_width(by_width, width),
                        {k.__name__: v for k, v in want_w.items()})
        return result, launches, by_width

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line, main_launches, _ = run("main", lambda: B.main(
            ["--nodes", str(n), "--edges", str(e), "--dim", str(d),
             "--iters", str(it), "--repeats", str(rep), "--device",
             "cuda"]), {k1: (3 * chain, f"2 per fwd_bwd and 1 per fwd "
                             f"step, {chain} steps each")})
    lines = buf.getvalue().strip().splitlines()
    if len(lines) != 1 or json.loads(lines[0]) != line \
            or "vs_baseline" in line:
        fail(f"bench main printed {lines}")
    bf16, bf16_launches, _ = run("bf16", lambda: B.bench_spmm(
        n, e, d, it, "pallas", "bfloat16", "fwd_bwd", rep, device),
        {k1: (2 * chain, f"2 per fwd_bwd step, {chain} steps")})
    att_steps = (1 + it) * rep
    # K3 per step: 4 row sums at width H (the softmax's two, ds_dst,
    # ds_src) and 2 aggregations at width H * dv (forward, dv)
    att, att_launches, att_by_width = run("attention", lambda: [B.bench_attention(
        n, e, BENCH_HEADS, BENCH_DV, it, device) for _ in range(rep)],
        {k3: (6 * att_steps, f"6 per step, {att_steps} steps"),
         sddmm: (att_steps, f"1 per step, {att_steps} steps")},
        widths=[(BENCH_HEADS,
                 {k3: (4 * att_steps, "4 row sums per step")}),
                (BENCH_HEADS * BENCH_DV,
                 {k3: (2 * att_steps, "2 aggregations per step")})])
    step, inputs = B.attention_step(n, e, BENCH_HEADS, BENCH_DV, device)
    g0, g1 = step(*inputs), step(*inputs)
    if not all(torch.isfinite(g).all() for g in g0):
        fail("bench attention: a gradient is not finite")
    if not all(map(torch.equal, g0, g1)):
        fail("bench attention: the gradients of two calls differ")
    sn, se = SMALL_GRAPH
    step_c, in_c = B.attention_step(sn, se, BENCH_HEADS, BENCH_DV, device)
    step_h, in_h = B.attention_step(sn, se, BENCH_HEADS, BENCH_DV, "cpu")
    small_err = {}
    for name, x, y in zip(("h", "s_dst", "s_src"), step_c(*in_c),
                          step_h(*in_h)):
        x = x.cpu()
        if not torch.allclose(x, y, rtol=1e-3, atol=1e-5):
            fail(f"bench attention d{name}: card vs CPU max err "
                 f"{(x - y).abs().max().item()} (small graph {sn}, {se})")
        small_err[name] = (x - y).abs().max().item()
    per_step = {"Tfg-idgcn": {k1: 6}, "Tfg-idgat": {k3: 18, sddmm: 6},
                "Tfg-idgin": {k1: 5}, "Tfg-idsage": {k1: 5}}
    epochs, steps = {}, (2 + EPOCHS) * rep   # two warm-up epochs
    for layer in B.TRAIN_LAYERS:
        runs, launches, _ = run(layer, lambda: [B.bench_train_epoch(
            layer, "pallas", EPOCHS, device=device) for _ in range(rep)],
            {k: (c * steps, f"{c}/train step x {steps}")
             for k, c in per_step[layer].items()})
        epochs[layer] = dict(epoch_s=median_iqr([dt for dt, _ in runs]),
                             train_edges_per_s=median_iqr(
                                 [eps for _, eps in runs]),
                             launches=launches)
    return dict(iters=it, repeats=rep, main=line,
                main_launches=main_launches,
                bf16_fwd_bwd_edges_per_s=median_iqr(bf16),
                bf16_launches=bf16_launches,
                attention_fwd_bwd_edges_per_s=median_iqr(att),
                attention_launches=att_launches,
                attention_launches_by_width=att_by_width,
                attention_grads_bitwise_equal=True,
                attention_small_card_vs_cpu_max_err=small_err,
                train_epochs=epochs)


LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)   # card vs CPU, forward values


# the kinks a forward takes: ReLU, leaky ReLU (the skip stage's 'prelu'
# merge act, GAT's scores) and the learnable PReLU, each with its
# backward
KINKS = {torch.ops.aten.relu.default: "relu",
         torch.ops.aten.leaky_relu.default: "leaky_relu",
         torch.ops.aten._prelu_kernel.default: "prelu"}


class CardKinks(TorchDispatchMode):
    """Records the input of every kink (KINKS) a forward runs, in call
    order, with the op's name."""

    def __init__(self):
        super().__init__()
        self.inputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in KINKS:
            self.inputs.append((KINKS[func], args[0].detach().cpu()))
        return func(*args, **(kwargs or {}))


class SameKinks(TorchDispatchMode):
    """Runs the CPU reference with the card's kink decisions (ReLU,
    leaky ReLU and PReLU, KINKS).  The i-th kink input must be the card's i-th
    kink of the same op and match it at LOGIT_TOL's rtol and its atol
    times the call's largest |input| (else fail), so the two lie on
    either side of 0 only where both are within that tolerance of it;
    there the op and its backward (threshold_backward on the saved
    ReLU result, leaky_relu_backward and _prelu_kernel_backward on the
    saved input) take the card's side.  ``flips`` counts those entries and ``flip_max_abs``
    is the largest |input| among them; ``input_max_err`` is the largest
    difference."""

    def __init__(self, card_inputs: list):
        super().__init__()
        self.card = card_inputs
        self.calls = self.flips = 0
        self.flip_max_abs = self.input_max_err = 0.0
        self.keep = {}

    def _hold(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """The card's side of 0 for each entry of the next kink input."""
        if self.calls == len(self.card):
            fail(f"the CPU ran more than the card's {self.calls} kinks")
        card_name, yc = self.card[self.calls]
        yc = yc.to(y.dtype)      # a float64 witness run holds f32 inputs
        self.calls += 1
        # atol scales with the call's largest input: a GEMM's or a
        # BatchNorm's rounding does, where the entry itself cancels
        atol = LOGIT_TOL["atol"] * max(1.0, yc.abs().max().item())
        if card_name != name or y.shape != yc.shape or not torch.allclose(
                y, yc, rtol=LOGIT_TOL["rtol"], atol=atol):
            fail(f"kink input {self.calls - 1} card vs CPU: "
                 f"{card_name} / {name}, shapes {tuple(yc.shape)} / "
                 f"{tuple(y.shape)}, max err "
                 f"{(y - yc).abs().max().item()} beyond rtol "
                 f"{LOGIT_TOL['rtol']}, atol {atol}")
        self.input_max_err = max(self.input_max_err,
                                 (y - yc).abs().max().item())
        keep = yc > 0
        flipped = keep != (y > 0)
        if flipped.any():
            self.flips += int(flipped.sum())
            self.flip_max_abs = max(self.flip_max_abs,
                                    y[flipped].abs().max().item())
        return keep

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        aten = torch.ops.aten
        if func is aten.relu.default:
            keep = self._hold("relu", args[0])
            out = torch.where(keep, args[0], args[0].new_zeros(()))
            self.keep[out.data_ptr()] = keep
            return out
        if func is aten.leaky_relu.default:
            y = args[0]
            slope = args[1] if len(args) > 1 else kwargs.get(
                "negative_slope", 0.01)
            self.keep[y.data_ptr()] = keep = self._hold("leaky_relu", y)
            return torch.where(keep, y, y * slope)
        if func is aten._prelu_kernel.default:
            y, slope = args
            self.keep[y.data_ptr()] = keep = self._hold("prelu", y)
            return torch.where(keep, y, y * slope)
        if func is aten.threshold_backward.default:
            keep = self.keep.get(args[1].data_ptr())
            if keep is not None:
                return torch.where(keep, args[0], args[0].new_zeros(()))
        if func is aten.leaky_relu_backward.default:
            keep = self.keep.get(args[1].data_ptr())
            if keep is not None:
                return torch.where(keep, args[0], args[0] * args[2])
        if func is aten._prelu_kernel_backward.default:
            grad, y, slope = args
            keep = self.keep.get(y.data_ptr())
            if keep is not None:
                # input and (elementwise, summed by autograd) slope grads
                return (torch.where(keep, grad, grad * slope),
                        torch.where(keep, grad.new_zeros(()), grad * y))
        return func(*args, **kwargs)


class CardMax:
    """Records each segmented max the card runs (``K.packed_max``, which
    PackedMaxFn calls), in call order: its input, out and tie counts."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.real = K.packed_max

        def record(pack, x):
            out, cnt = self.real(pack, x)
            self.calls.append((x.detach().cpu(), out.cpu(), cnt.cpu()))
            return out, cnt
        K.packed_max = record
        return self

    def __exit__(self, *exc):
        K.packed_max = self.real


class SameMax:
    """Runs the CPU reference's segmented maxes with the card's
    decisions, the max's kinks as SameKinks shares ReLU's: the i-th
    max's out must match the card's i-th at LOGIT_TOL's rtol and its
    atol times the call's largest |out| (else fail), and its backward
    takes the card's input, out and tie counts, so it credits the slots
    the card's max took.  Two f32 programs may break a near tie (two
    messages within rounding of each other) differently, and there the
    gradient moves a whole upstream entry from one sender to another,
    which is no difference of the programs.  ``flips`` counts the
    (slot, column) pairs where the CPU's own choice differs."""

    def __init__(self, card_calls: list):
        self.card = card_calls
        self.calls = self.flips = 0
        self.out_max_err = 0.0
        self.by_out = {}

    def __enter__(self):
        self.real_max, self.real_bwd = K.packed_max, K.packed_max_bwd

        def same_max(pack, x):
            if self.calls == len(self.card):
                fail(f"the CPU ran more than the card's {self.calls} maxes")
            xc, oc, cc = self.card[self.calls]
            self.calls += 1
            out, cnt = self.real_max(pack, x)
            atol = LOGIT_TOL["atol"] * max(1.0, oc.abs().max().item())
            if out.shape != oc.shape or not torch.allclose(
                    out, oc, rtol=LOGIT_TOL["rtol"], atol=atol):
                fail(f"max {self.calls - 1} card vs CPU: max err "
                     f"{(out - oc).abs().max().item()}")
            self.out_max_err = max(self.out_max_err,
                                   (out - oc).abs().max().item())
            (msg, rows), (msg_c, _) = (max_messages(pack, v)
                                       for v in (x, xc))
            self.flips += int(((msg == out.index_select(0, rows))
                               != (msg_c == oc.index_select(0, rows)))
                              .sum())
            self.by_out[out.data_ptr()] = (xc, oc, cc)
            return out, cnt

        def same_bwd(bwd_pack, x, g, out, cnt):
            xc, oc, cc = self.by_out[out.data_ptr()]
            return self.real_bwd(bwd_pack, xc, g, oc, cc)
        K.packed_max, K.packed_max_bwd = same_max, same_bwd
        return self

    def __exit__(self, *exc):
        K.packed_max, K.packed_max_bwd = self.real_max, self.real_bwd


class LinearSums:
    """On the CPU reference, each Linear's (pre-MP, MLP, head) kernel
    gradient scale: the gradient is a sum over the batch's rows, x^T d
    (x the layer's input, d its output's gradient), and its sum of
    |terms| per entry is |x|^T |d|.  Kept by kernel name."""

    def __init__(self, model: torch.nn.Module):
        from graphgym_tpu_torch.nn import layers

        self.scale = {}
        for name, mod in model.named_modules():
            if isinstance(mod, layers.Linear):
                mod.register_forward_hook(self._hook(f"{name}.kernel"))

    def _hook(self, key: str):
        def hook(mod, inputs, out):
            if not out.node_feat.requires_grad:    # the eval forward
                return
            x = inputs[0].node_feat.detach().abs()

            def grad(d):
                self.scale[key] = x.t() @ d.detach().abs()
            out.node_feat.register_hook(grad)
        return hook


def f64_gradients(cfg, state: dict, batch, kink_inputs: list,
                  max_calls: list) -> dict:
    """The CPU reference's parameter gradients in float64: the same
    parameters (``state``), the batch's features in float64, the card's
    kink and max decisions (SameKinks, SameMax), one train-mode forward
    and backward of the cross entropy.  The kernels' plain versions sum
    in f32, so only the dense layers, BatchNorm and the loss run in
    float64; that is where a Linear kernel's gradient sums its
    terms."""
    m = build_model(cfg, torch.device("cpu"))
    m.load_state_dict(state)
    m.double().train()
    b = batch.to(torch.device("cpu"))
    b = b.replace(node_feat=b.node_feat.double())
    with SameKinks(kink_inputs), SameMax(max_calls):
        pred, label, mask = m(b)
        torch.nn.functional.cross_entropy(pred[mask], label[mask]).backward()
    return {k: p.grad for k, p in m.named_parameters()}


def check_model(cfg, batch, device, random_features: bool = False) -> dict:
    """Full-width logits, gradients and BatchNorm running statistics,
    card (kernel) vs CPU (plain), and then the eval-mode logits (which
    read those running statistics).  ``random_features`` replaces the
    batch's features with seeded normal ones: ws's are a constant 1, on
    which ID-GIN's layer-0 id MLP sees nearly the same row at every ego
    center, so its BatchNorm normalizes rounding noise and its gradients
    differ between any two f32 summation orders (on the CPU, f32 against
    float64 by more than their own size); with random features every
    gradient holds at the tolerance below.

    The CPU runs with the card's kink decisions (SameKinks; SameMax for
    the segmented max's choices): every ReLU,
    leaky ReLU and PReLU input is held to the card's,
    and at an input within rounding of 0 the two f32 programs may take
    either side of the kink.  There the gradient steps by that row's
    whole upstream gradient (ba's 98,304-row ID-GIN batch has such
    inputs, a few millionths from 0), which is no difference of the
    programs; with the kinks shared, the gradients are held
    elementwise.

    A Linear kernel's gradient sums its input times its output's
    gradient over the batch's rows; where those terms cancel (a 1-wide
    input under BatchNorm, whose output does not change with the
    kernel's scale: the pre-MP layer of the ba paths), f32 arithmetic
    leaves a share of the sum of |terms|, not of the value, on either
    side.  Where a Linear kernel's gradient misses the elementwise
    tolerance, the CPU reference runs once more in float64
    (``f64_gradients``): only if the CPU's own f32 gradient of that
    kernel also misses float64's at the elementwise tolerance (so f32
    itself cannot hold it) are its entries beyond the tolerance held by
    hold_sums' rule, 1e-5 x their sum of |terms| (``LinearSums``) +
    1e-6, and counted in ``sum_rule_entries`` (the CPU's own misses in
    ``f32_vs_f64_entries``); anywhere else a miss fails.
    tests/test_torch_graph_task.py::test_pre_mp_kernel_gradient_cancels_in_f32
    shows the same on the CPU at a cut size.

    With gnn.dropout > 0 the two sides would draw their masks from
    different generators, so the comparison runs at dropout 0, and the
    dropout itself is held apart (``check_dropout``)."""
    if random_features:
        gen = torch.Generator().manual_seed(3)
        batch = batch.replace(node_feat=torch.randn(
            batch.node_feat.shape, generator=gen).numpy()
            * batch.node_mask[:, None])
    dropout = {}
    if cfg.gnn.dropout > 0:
        dropout = check_dropout(cfg, batch, device)
        cfg = cfg.clone()
        cfg.gnn.dropout = 0.0
    model = build_model(cfg, device)
    ref = build_model(cfg, torch.device("cpu"))
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    sums = LinearSums(ref)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    card_train, card_eval = CardKinks(), CardKinks()
    max_train, max_eval = CardMax(), CardMax()
    same_max = (SameMax(max_train.calls), SameMax(max_eval.calls))
    outs, kinks = [], []
    for m, b, train_mode, eval_mode, maxes in (
            (model, batch.to(device), card_train, card_eval,
             (max_train, max_eval)),
            (ref, batch.to(torch.device("cpu")),
             SameKinks(card_train.inputs), SameKinks(card_eval.inputs),
             same_max)):
        with train_mode, maxes[0]:
            pred, label, mask = m(b)
            loss = torch.nn.functional.cross_entropy(pred[mask],
                                                     label[mask])
            loss.backward()
        m.eval()
        with torch.no_grad(), eval_mode, maxes[1]:
            pred_eval = m(b)[0]
        outs.append((pred.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()},
                     {k: v.cpu() for k, v in m.named_buffers()},
                     pred_eval.cpu()))
        kinks.append((train_mode, eval_mode))
    (p_gpu, g_gpu, b_gpu, e_gpu), (p_cpu, g_cpu, b_cpu, e_cpu) = outs
    same = kinks[1]
    for mode, card in zip(same, kinks[0]):
        if mode.calls != len(card.inputs):
            fail(f"the CPU ran {mode.calls} ReLUs, the card "
                 f"{len(card.inputs)}")
    for mode in same_max:
        if mode.calls != len(mode.card):
            fail(f"the CPU ran {mode.calls} maxes, the card "
                 f"{len(mode.card)}")
    buf_err = 0.0
    for k in b_cpu:       # BatchNorm running statistics after the step
        if not torch.allclose(b_gpu[k], b_cpu[k], **LOGIT_TOL):
            fail(f"buffer {k} card vs CPU: max err "
                 f"{(b_gpu[k] - b_cpu[k]).abs().max().item()}")
        buf_err = max(buf_err, (b_gpu[k] - b_cpu[k]).abs().max().item())
    for name, got, want in (("train", p_gpu, p_cpu), ("eval", e_gpu, e_cpu)):
        if not torch.allclose(got, want, **LOGIT_TOL):
            fail(f"model {name}-mode logits card vs CPU: max err "
                 f"{(got - want).abs().max().item()}")
    worst, sum_rule, own_misses, g64 = 0.0, {}, {}, None
    for k in g_cpu:
        err = (g_gpu[k] - g_cpu[k]).abs()
        close = torch.isclose(g_gpu[k], g_cpu[k], rtol=1e-3, atol=1e-5)
        if not close.all():
            if k in sums.scale and g64 is None:
                g64 = f64_gradients(cfg, state, batch, card_train.inputs,
                                    max_train.calls)
            own = (torch.zeros_like(close) if k not in sums.scale else
                   ~torch.isclose(g_cpu[k].double(), g64[k], rtol=1e-3,
                                  atol=1e-5))
            if not own.any():
                fail(f"gradient {k} card vs CPU: max err "
                     f"{err.max().item()}, {int((~close).sum())} entries "
                     f"beyond rtol 1e-3, atol 1e-5 (the CPU's own f32 "
                     f"holds float64 there, or {k} is no Linear kernel)")
            hold_sums(f"gradient {k} card vs CPU", g_gpu[k][~close],
                      g_cpu[k][~close], sums.scale[k][~close])
            sum_rule[k] = int((~close).sum())
            own_misses[k] = int(own.sum())
        worst = max(worst, err.max().item())
    return dict(logits_max_err=(p_gpu - p_cpu).abs().max().item(),
                eval_logits_max_err=(e_gpu - e_cpu).abs().max().item(),
                grad_max_err=worst, sum_rule_entries=sum_rule,
                f32_vs_f64_entries=own_misses,
                buffers=len(b_cpu),
                buffers_max_err=buf_err,
                relus=[mode.calls for mode in same],
                relu_inputs_max_err=max(mode.input_max_err
                                        for mode in same),
                relu_kink_flips=[mode.flips for mode in same],
                relu_kink_flip_max_abs=max(mode.flip_max_abs
                                           for mode in same),
                maxes=[mode.calls for mode in same_max],
                max_out_max_err=max(mode.out_max_err for mode in same_max),
                max_choice_flips=[mode.flips for mode in same_max],
                **dropout)


def check_dropout(cfg, batch, device) -> dict:
    """The model's dropout on the card: ``layers.dropout`` with the
    model's own generator on a tensor of the width and rows the model
    drops (seeded normal values), twice.  Fails unless the kept share is
    within 5 sigma of 1 - rate, every kept entry is exactly x / (1 -
    rate), the two masks differ (the generator advances) and a
    generator of the same seed draws the first mask again."""
    from graphgym_tpu_torch.nn import layers

    model = build_model(cfg, device)
    gens = {id(m.dropout_generator): m.dropout_generator
            for m in model.modules() if getattr(m, "dropout", 0)}
    if len(gens) != 1:
        fail(f"{len(gens)} dropout generators in the model, expected 1")
    (gen,) = gens.values()
    rate = cfg.gnn.dropout
    x = torch.randn(batch.num_nodes, cfg.gnn.dim_inner, device=device,
                    generator=torch.Generator(device=device).manual_seed(4))
    first, second = (layers.dropout(x, rate, gen) for _ in range(2))
    again = layers.dropout(x, rate, torch.Generator(
        device=device).manual_seed(int(cfg.seed)))
    kept = first != 0
    share = kept.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / x.numel())
    if abs(share - (1 - rate)) > 5 * sigma \
            or not torch.equal(first[kept], x[kept] / (1 - rate)) \
            or torch.equal(first, second) or not torch.equal(first, again):
        fail(f"dropout {rate}: kept share {share} (want {1 - rate} +- "
             f"{5 * sigma}), scale exact "
             f"{torch.equal(first[kept], x[kept] / (1 - rate))}, masks "
             f"differ {not torch.equal(first, second)}, seeded again "
             f"{torch.equal(first, again)}")
    return dict(dropout_rate=rate, dropout_kept_share=share,
                dropout_kept_sigma=sigma)


def widest_op_inputs(fn, top: int = 5) -> list:
    """The ops of one call of fn (forward and backward) whose widest
    tensor argument has the most elements (torch.profiler with shapes),
    and the longest index any index_add of the call takes."""
    from torch.profiler import ProfilerActivity, profile

    def numel(shape) -> int:
        if isinstance(shape, (list, tuple)) and shape and all(
                isinstance(x, int) for x in shape):
            return math.prod(shape)
        if isinstance(shape, (list, tuple)):
            return max((numel(x) for x in shape), default=0)
        return 0

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) \
            as prof:
        fn()
        torch.cuda.synchronize()
    ops, index_add = {}, 0
    for ev in prof.events():
        shapes = ev.input_shapes or []
        widest = max((numel(sh) for sh in shapes), default=0)
        if widest > ops.get(ev.name, (0, None))[0]:
            ops[ev.name] = (widest, shapes)
        if "index_add" in ev.name and len(shapes) > 2 \
                and len(shapes[2]) == 1:   # (self, dim, index, source)
            index_add = max(index_add, shapes[2][0])
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return [dict(op=name, numel=w, shapes=str(sh)[:160])
            for name, (w, sh) in ranked], index_add


def step_profile(trainer, batch, device, steps: int, base: int) -> dict:
    """One trainer's train step on one batch: the wall ms of step 0 and
    step 1 (on the card, eager and the capture), then over ``steps``
    more: the wall ms per step, the device time by kernel
    (torch.profiler; ``profile_holds_every_launch`` false where three
    profiles each lost records), the device's busy share, the host time in
    operators' own code and their calls per step, the CUDA-event time
    of a loop of steps, and the peak of device memory from the
    trainer's first step on, less ``base``, what was allocated before
    the trainer was built."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    first = []
    for _ in range(2):
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        first.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(device) - base
    for _ in range(3):   # a profile that lost records is taken again
        events = profile_events(lambda: trainer.train_step(batch), steps)
        whole = holds_every_launch(events, steps)
        if whole:
            break
    by_kernel = device_ms_by_kernel(None, steps, events)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the port's own kernels (csrc/): row_walk_* runs K1 and K3
    own = sorted((kv for kv in by_kernel.items()
                  if "row_walk" in kv[0] or "packed_" in kv[0]),
                 key=lambda kv: -kv[1])
    by_op = host_ms_by_op(events, steps)
    host_top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(step0_ms=first[0], step1_ms=first[1], step_wall_ms=wall_ms,
                event_loop_ms=call_ms(lambda: trainer.train_step(batch),
                                      iters=4 * steps, warmup=1),
                device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                profile_holds_every_launch=whole,
                peak_memory_bytes=peak,
                graphs=trainer.train_step.captured,
                top=[dict(name=k[:80], ms_per_step=v) for k, v in top],
                port_kernels=[dict(name=k[:80], ms_per_step=v)
                              for k, v in own],
                host_ops_ms=sum(ms for ms, _ in by_op.values()),
                host_op_calls=sum(c for _, c in by_op.values()),
                host_top=[dict(name=k[:60], ms_per_step=ms,
                               calls_per_step=c)
                          for k, (ms, c) in host_top])


def profile_steps(cfg, loaders, device, steps: int = 5,
                  forbid_numel: int = 0, forbid_index_add: int = 0) -> dict:
    """The captured train step (the port's) beside the eager one, each
    in a trainer of its own built from the same seed, the eager one
    first and freed before the other (``step_profile``); the captured
    step's capture time and host operator calls, and the ops of the
    eager step with the widest tensor arguments.  With ``forbid_numel``,
    fails if an op of the step takes a tensor that large, or an
    index_add an index that long (one entry per pack slot: a scatter of
    per-slot values).  The captured graph runs the eager step's ops."""
    import gc

    out = {}
    host_batch = loaders[0].batches(0)[0]   # one batch for both trainers
    for mode in ("eager", "captured"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(device)
        trainer = Trainer(build_model(cfg, device), loaders, cfg, device,
                          eager=mode == "eager")
        batch = trainer._place(host_batch)
        out[mode] = step_profile(trainer, batch, device, steps, base)
        out[mode]["allocated_before_bytes"] = base
        if mode == "eager":
            widest, index_add = widest_op_inputs(
                lambda: trainer.train_step(batch))
        else:
            (prog,) = trainer.train_step.programs.values()
            out[mode]["capture_s"] = prog.capture_s
        del trainer, batch
    if out["captured"]["graphs"] != 1:
        fail(f"{cfg.gnn.layer_type}: {out['captured']['graphs']} train "
             "graphs captured for one batch")
    if out["captured"]["host_op_calls"] > 48:
        fail(f"{cfg.gnn.layer_type}: the captured train step makes "
             f"{out['captured']['host_op_calls']} host operator calls "
             "(a few dozen at most: the lr fill and the graph launch)")
    if forbid_numel and widest[0]["numel"] >= forbid_numel:
        fail(f"an op of the train step takes a tensor of "
             f"{widest[0]['numel']} elements (>= {forbid_numel}): "
             f"{widest[0]}")
    if forbid_index_add and index_add >= forbid_index_add:
        fail(f"an index_add of the train step takes an index of "
             f"{index_add} entries (>= {forbid_index_add}, the pack's "
             "slots)")
    return dict(out, widest_op_inputs=widest,
                longest_index_add_index=index_add)


def graphed_check(cfg, loaders, device, steps: int = 5) -> dict:
    """Captured against eager steps, both with capturable Adam, each
    trainer from the same seed: ``steps`` train steps and 2 eval steps
    on the first batches; fails unless losses, parameters and buffers
    are bitwise equal and the launches (per replay) are the same."""
    runs = {}
    # one batch for both trainers (a loader of several train batches
    # re-partitions them at each call)
    host_batch, host_vbatch = (ld.batches(0)[0] for ld in loaders[:2])
    for mode in ("captured", "eager"):
        trainer = Trainer(build_model(cfg, device), loaders, cfg, device,
                          eager=mode == "eager")
        batch = trainer._place(host_batch)
        vbatch = trainer._place(host_vbatch)

        def run():
            return ([trainer.train_step(batch)[0].item()
                     for _ in range(steps)],
                    [trainer.eval_step(vbatch)[0].item() for _ in range(2)])
        (losses, evals), (launches, *_) = counted(run)
        runs[mode] = (losses, evals, launches, trainer.model.state_dict(),
                      trainer.train_step.captured
                      + trainer.eval_step.captured)
    (lc, ec, nc, sc, graphs), (le, ee, ne, se, _) = (runs["captured"],
                                                     runs["eager"])
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(sc.values(), se.values()))
    if lc != le or ec != ee or diff != 0.0 or nc != ne or graphs != 2:
        fail(f"{cfg.gnn.layer_type}: captured vs eager: losses {lc} / "
             f"{le}, eval {ec} / {ee}, state max diff {diff}, launches "
             f"{nc} / {ne}, graphs {graphs}")
    return dict(losses=lc, eval_losses=ec, launches=nc, graphs=graphs,
                bitwise_equal=True)


def graphed_batches(cfg_file: str, overrides, epochs: int = 2) -> dict:
    """Captured against eager on a multi-batch loader (three shuffled
    train batches an epoch at train.batch_size 8): per-step losses and
    the val accuracy equal over ``epochs`` epochs, one train graph for
    every batch."""
    cfg = load_cfg(cfg_file, overrides)
    splits = create_dataset(cfg)
    device = resolve_device(cfg.device)
    runs = {}
    for mode in ("captured", "eager"):
        rec = StepRecorder()
        loaders = create_loader(splits, cfg)    # the same shuffles
        trainer = Trainer(build_model(cfg, device), loaders, cfg, device,
                          eager=mode == "eager")
        for epoch in range(epochs):
            trainer.train_epoch(rec, epoch)
        runs[mode] = (rec.losses, trainer.eval_epoch(None, 1),
                      len(trainer.train_step.programs))
    (lc, ac, programs), (le, ae, _) = runs["captured"], runs["eager"]
    if lc != le or ac != ae or programs != 1 or len(lc) != epochs * 3:
        fail(f"{cfg_file} at batch 8: captured vs eager losses {lc} / "
             f"{le}, val acc {ac} / {ae}, {programs} train programs")
    return dict(batches_per_epoch=len(loaders[0]), losses=lc, val_acc=ac,
                train_programs=programs, bitwise_equal=True)


class StepRecorder:
    """Duck-typed Logger: each step's loss."""

    def __init__(self):
        self.losses = []

    def update_stats(self, loss, **kw):
        self.losses.append(loss)


def repeat_steps(cfg, loaders, device, steps: int = 3) -> dict:
    """Two trainers (captured steps) from the same seed on the same
    batch: fails unless
    their losses, step for step, and their parameters after the last
    step are bitwise equal (the port's contract: no float atomics; the
    index_add_ left on the paths adds rows of unique ids, or exact
    zeros at the padding row)."""
    runs = []
    host_batch = loaders[0].batches(0)[0]   # one batch for both trainers
    for _ in range(2):
        trainer = Trainer(build_model(cfg, device), loaders, cfg, device)
        batch = trainer._place(host_batch)
        losses = [trainer.train_step(batch)[0].item() for _ in range(steps)]
        runs.append((losses, [p.detach().clone()
                              for p in trainer.model.parameters()]))
    (l0, p0), (l1, p1) = runs
    out = dict(losses=[l0, l1], losses_bitwise_equal=l0 == l1,
               params_bitwise_equal=all(map(torch.equal, p0, p1)),
               params_max_abs_diff=max((a - b).abs().max().item()
                                       for a, b in zip(p0, p1)))
    if not (out["losses_bitwise_equal"] and out["params_bitwise_equal"]):
        fail(f"{cfg.gnn.layer_type}: two train runs from one seed differ: "
             f"{out}")
    return out


def ptxas_report(log: str) -> list:
    """Registers and spills of each kernel from nvcc's -Xptxas -v output:
    one line per entry function, its (mangled) name first."""
    out, fn = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln.strip()
        elif fn and "spill" in ln:
            out.append(f"{fn}: {ln.strip()}")
        elif fn and "registers" in ln and out:
            out[-1] += "; " + ln.split(":", 1)[-1].strip()
    return out


def read_stats(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def kernels() -> tuple:
    """Every kernel wrapper of the port (each counts its launches)."""
    return K.KERNELS


def by_width_kernels() -> tuple:
    """The wrappers that also count their launches by width (K1, K3)."""
    return (K.packed_spmm_cuda, K.packed_segment_matmul_headed_cuda)


def counted(fn):
    """fn's result and the launches of every kernel during it: each
    count set to 0 just before, read just after (launches, K1's and
    K3's launches by width, and K1's rectangular launches by width:
    those on a pooling or gather pack or its transpose)."""
    for k in kernels():
        k.launches = 0
    for k in by_width_kernels():
        k.launches_by_width.clear()
    K.packed_spmm_cuda.launches_rectangular.clear()
    result = fn()
    torch.cuda.synchronize()
    return result, ({k.__name__: k.launches for k in kernels()},
                    {k.__name__: dict(k.launches_by_width)
                     for k in by_width_kernels()},
                    dict(K.packed_spmm_cuda.launches_rectangular))


def at_width(by_width: dict, width: int) -> dict:
    """Each kernel's launches at one width, from counted's by-width map."""
    return {k: counts.get(width, 0) for k, counts in by_width.items()}


def hold_counts(what: str, launches: dict, want: dict) -> None:
    """Fail unless every kernel launched exactly ``want`` times (0 where
    ``want`` names it not); ``want`` maps a wrapper to (count, how)."""
    for k, count in launches.items():
        total, how = want.get(k, (0, "no launch"))
        if count != total:
            fail(f"{what}: {k} launches {count}, expected {total} ({how})")


def train_path(cfg_file: str, overrides, out: str, loaders,
               expected: dict, widths=None, rect=(0, 0)) -> dict:
    """Drive graphgym_tpu_torch.main's run_single on one config, loaded
    afresh (its data pipeline writes label bins into the cfg), launches
    counted (``counted``).  ``expected`` maps a kernel wrapper to its
    launches (per train step, per eval batch), ``loaders`` give the
    batch counts; every other kernel must not launch.  ``widths`` maps a
    narrow width to the share of those launches at it, per kernel (K1's
    narrow walk of a 1-wide input, its scalar walk of an 11-wide one,
    K3's softmax row sums at one head); a width it does not name must
    see no launch of K1 or K3 at width 1.  ``rect`` is K1's rectangular
    launches (the graph head's pooling, or a head's gather, forward and
    backward) per train step and eval batch, of those ``expected``
    counts; the result reports them and the rest, the layers', as
    measured."""
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_cfg(cfg_file, overrides + ["out_dir", out])
    epochs = cfg.optim.max_epoch
    steps = epochs * len(loaders[0])
    evals = sum(ckpt.is_eval_epoch(e, cfg.train.eval_period, epochs)
                for e in range(epochs)) * len(loaders[1])

    def totals(per):
        return {k.__name__: (s * steps + e * evals,
                             f"{s}/train step x {steps} + {e}/eval batch "
                             f"x {evals}") for k, (s, e) in per.items()}
    with LoaderCalls(keep=False) as calls:
        result, (launches, by_width, rectangular) = counted(
            lambda: run_single(cfg, cfg.out_dir, cfg_file))
    k1 = K.packed_spmm_cuda.__name__
    rect_launches = sum(rectangular.values())
    parity.drop_checkpoints(out)
    widths = dict(widths or {})
    widths.setdefault(1, {})
    at = {w: at_width(by_width, w) for w in widths}
    train = read_stats(os.path.join(cfg.out_dir, "train", "stats.json"))
    val = read_stats(os.path.join(cfg.out_dir, "val", "stats.json"))
    losses = [s["loss"] for s in train]
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        fail(f"{cfg_file}: train losses {losses}")
    hold_counts(cfg_file, launches, totals(expected))
    for w, per in widths.items():
        hold_counts(f"{cfg_file}, at width {w}", at[w], totals(per))
    hold_counts(f"{cfg_file}, on rectangular packs", {k1: rect_launches},
                totals({K.packed_spmm_cuda: rect}))
    accs = [s["accuracy"] for s in val]
    if not all(0.0 <= a <= 1.0 for a in accs):
        fail(f"{cfg_file}: val accuracies {accs}")
    step_s = [s["time_iter"] for s in train]
    return dict(epochs=epochs, steps_per_epoch=len(loaders[0]),
                train_steps=steps, eval_batches=evals,
                losses=losses, val_acc=accs,
                best_val_acc=result["best_val_acc"], step_s=step_s,
                step_s_median_replays=float(np.median(step_s[2:])),
                train_s_per_epoch=calls.run_s[0] / epochs,
                launches=launches, launches_at_width=at,
                k1_rect_launches=rect_launches,
                k1_layer_launches=launches[k1] - rect_launches,
                k1_rect_launches_by_width=rectangular,
                launches_per_train_step_and_eval_batch={
                    k.__name__: v for k, v in expected.items()},
                params=cfg.params)


def load_path(cfg_file: str, overrides):
    """The config, its loaders, and the host time to build them (load,
    labels, split, ego union, collate, packs)."""
    cfg = load_cfg(cfg_file, overrides)
    t0 = time.perf_counter()
    loaders = create_loader(create_dataset(cfg), cfg)
    loaders[0].batches(0)
    return cfg, loaders, time.perf_counter() - t0


def corpus_digest(graphs) -> str:
    """sha256 over the graphs' edge lists (int32), in order."""
    digest = hashlib.sha256()
    for g in graphs:
        digest.update(np.ascontiguousarray(g.edge_index, np.int32).tobytes())
    return digest.hexdigest()


# the corpora regenerated beside the first phases, one process each:
# ba (the ba paths) and the design grid's scalefree and smallworld
CORPORA = {"ba": CORPUS_DIR, "scalefree": DESIGN_CORPUS_DIR,
           "smallworld": DESIGN_CORPUS_DIR}


def start_corpora() -> dict:
    """Regenerate the synthetic corpora of CORPORA (256 graphs asked,
    seed 0, no networkx) through load_nx into their directories, one
    process each, while the ws phases run; ``wait_corpus`` takes each
    one's seconds."""
    for d in set(CORPORA.values()):
        shutil.rmtree(d, ignore_errors=True)
    code = ("import sys, time\n"
            "from graphgym_tpu_torch.data.loaders import load_nx\n"
            "t0 = time.perf_counter()\n"
            "load_nx(sys.argv[1], sys.argv[2])\n"
            "print(time.perf_counter() - t0)\n")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, name, d], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, d in CORPORA.items()}
    CHILDREN.extend(procs.values())
    return procs


def wait_corpus(procs: dict, name: str) -> float:
    """Seconds ``start_corpora``'s process took to regenerate ``name``;
    fails if it did not end well."""
    out, err = procs[name].communicate(timeout=900)
    if procs[name].returncode != 0:
        fail(f"regenerating {name}: exit {procs[name].returncode}: "
             f"{err[-2000:]}")
    return float(out.split()[-1])


def design_corpus_phase(procs: dict) -> dict:
    """Wait for the design grid's corpora and hold them: scalefree must
    be the ba corpus (BA_GRAPHS graphs, BA_DIGEST), smallworld the ws
    corpus the repository ships (datasets/ws.pkl), edge for edge."""
    from graphgym_tpu_torch.data.loaders import load_nx

    seconds = {name: wait_corpus(procs, name)
               for name in ("scalefree", "smallworld")}
    sf = load_nx("scalefree", DESIGN_CORPUS_DIR)
    sw = load_nx("smallworld", DESIGN_CORPUS_DIR)
    ws = load_nx("ws", os.path.join(ROOT, "datasets"))
    if len(sf) != BA_GRAPHS or corpus_digest(sf) != BA_DIGEST:
        fail(f"scalefree: {len(sf)} graphs, digest {corpus_digest(sf)}; "
             f"expected the ba corpus ({BA_GRAPHS}, {BA_DIGEST})")
    if corpus_digest(sw) != corpus_digest(ws):
        fail(f"smallworld ({len(sw)} graphs) is not datasets/ws.pkl "
             f"({len(ws)})")
    return dict(seconds=seconds, graphs={"scalefree": len(sf),
                                         "smallworld": len(sw)},
                cache=sorted(os.listdir(DESIGN_CORPUS_DIR)))


def corpus_phase(overrides, procs: dict) -> dict:
    """The ba corpus (256 graphs of 64 nodes asked, seed 0), regenerated
    into CORPUS_DIR through load_nx by ``start_corpora``'s process, as a
    config naming ba does when no pickle holds it, and its seconds
    there; fail unless it is the corpus the CPU tests hold to the JAX
    package's (BA_GRAPHS graphs, BA_DIGEST over their edges).  Then the
    longest rows of the train packs of ID-GCN ('gcn') and ID-GIN
    ('plain') on it, read from the port's loader."""
    from graphgym_tpu_torch.data.loaders import load_nx

    seconds = wait_corpus(procs, "ba")
    graphs = load_nx("ba", CORPUS_DIR)
    digest = corpus_digest(graphs)
    if len(graphs) != BA_GRAPHS or digest != BA_DIGEST:
        fail(f"ba corpus: {len(graphs)} graphs, digest {digest}; "
             f"expected {BA_GRAPHS}, {BA_DIGEST}")
    rows = {}
    for tag, kind in (("idgcn_ba", "gcn"), ("idgin_ba", "plain")):
        _, loaders, host_s = load_path(config(tag), overrides)
        fwd, bwd = loaders[0].batches(0)[0].to(torch.device("cpu")) \
            .packs[kind][:2]
        rows[tag] = dict(pack=kind, host_data_s=host_s,
                         fwd=longest_rows(fwd), bwd=longest_rows(bwd))
    return dict(seconds=seconds, graphs=len(graphs),
                nodes=sum(g.num_nodes for g in graphs),
                edges=sum(g.num_edges for g in graphs),
                cache=sorted(os.listdir(CORPUS_DIR)), rows=rows)


def pool_phase(paths: dict, device) -> dict:
    """kernel_pool: the graph head's pooling kernels on the first train
    batch of each graph path (``paths``: tag -> config, overrides, the
    width it pools at), with the pooling packs of add, mean and max
    built from it (ego centers where the path pools them): K1 forward
    and backward (``check_pool_k1``) for add and mean, the segmented max
    forward and backward (``check_max_kernel`` on the rectangular
    packs) for max."""
    out = {}
    for tag, (cfg_file, overrides, width) in paths.items():
        cfg, loaders, _ = load_path(cfg_file, overrides)
        batch = loaders[0].batches(0)[0]
        del loaders
        ego = cfg.dataset.transform == "ego"
        n, g = batch.num_nodes, batch.num_graphs
        checks = {}
        for kind in POOLINGS:
            packs = build_pool_packs(
                batch.graph_ids, batch.node_mask, g, kind,
                batch.node_id_index if ego else None,
                batch.id_mask if ego else None)[pool_kind(kind, ego)]
            dev = tuple(K.PackedCSR(*(torch.from_numpy(a).to(device)
                                      for a in p)) for p in packs)
            checks[kind] = (check_max_kernel(dev, n, width, device)
                            if kind == "max" else
                            check_pool_k1(dev, n, width, device))
        out[tag] = dict(n=n, graph_slots=g, ego=ego, width=width, **checks)
    return out


def config(tag: str) -> str:
    return os.path.join(ROOT, "configs", f"{tag}.yaml")


def drive_path(tag: str, device, overrides, expected: dict, widths=None,
               random_features: bool = False, base: str = "",
               extra=(), rect_width=None, rect=(0, 0)) -> dict:
    """The phases of one more path, as the ws paths have them:
    kernel_<tag> (its kernels at the train pack's shapes: K1 at the
    model width and at each narrow width ``widths`` names, or K3, its
    softmax row sums and the SDDMM, or the segmented max forward and
    backward (a generalconv / idconv with gnn.agg max); the pack's
    longest rows),
    model_<tag> (``check_model``), train_<tag> (``train_path`` with
    ``expected``, ``widths`` and ``rect``), profile_<tag> (with ``repeat_steps``;
    no op of the eager step takes a tensor of the pack's slots times the
    width, and no index_add an index of the pack's slots) and
    graphed_<tag>.  The config is configs/<base or tag>.yaml with
    ``extra`` overrides (a grid point).  On a graph task the kernel
    phase names the pooling pack's rows and slots; on a batch with a
    head's gather pack ('pairs' of the edge head, 'labels' of the node
    head where supervised nodes repeat) it holds K1 on it
    (``check_gather_k1``) at the width the head gathers (the stage's
    for pairs, dim_out for labels) and names the supervised pairs or
    nodes.  ``rect_width`` is the width of the head's rectangular packs
    where it is none of the layers' (kernel_pool and the gather check
    hold those packs' kernels, check_kernel the layers')."""
    from graphgym_tpu_torch.graphs.packing import kinds_for_layer
    from graphgym_tpu_torch.train.graphed import signature

    cfg_file = config(base or tag)
    overrides = list(overrides) + list(extra)
    begin(f"kernel_{tag}")
    cfg, loaders, host_s = load_path(cfg_file, overrides)
    batch = loaders[0].batches(0)[0]
    # one captured program per signature: over the epochs a training
    # re-collates (its packs padded to the loader's running chunk counts)
    signatures = len({signature(b.to(torch.device("cpu")))
                      for e in range(cfg.optim.max_epoch)
                      for b in loaders[0].batches(e)})
    n, d = batch.num_nodes, cfg.gnn.dim_inner
    (kind,) = kinds_for_layer(cfg.gnn.layer_type, cfg.gnn.agg,
                              cfg.gnn.normalize_adj)
    packs = batch.to(device).packs[kind]
    if kind == "att":
        checks = dict(k3=check_attention_kernel(packs, n, d, device),
                      softmax=check_softmax(packs[0], n, device),
                      sddmm=check_sddmm_kernel(packs[0], n, d, device))
    elif cfg.gnn.layer_type in ("generalconv", "idconv") \
            and cfg.gnn.agg == "max":
        checks = dict(max=check_max_kernel(packs, n, d, device))
    else:
        checks = {f"d{w}": check_kernel(packs, n, w, device)
                  for w in sorted({d, *(widths or {})} - {rect_width})}
    pool = {}
    if cfg.dataset.task == "graph":
        name = next(k for k in batch.packs if k.startswith("pool_"))
        fwd_pool, bwd_pool = batch.to(device).packs[name]
        pool = dict(pack=name, graph_slots=int(batch.num_graphs),
                    real_slots=real_slots_of(fwd_pool),
                    fwd_rows=longest_rows(fwd_pool),
                    bwd_rows=longest_rows(bwd_pool),
                    centers=(None if batch.node_id_index is None
                             else int(np.sum(batch.id_mask))))
    gathers = {}
    for name, index, mask, width in (
            (PAIRS, lambda: batch.edge_label_index.reshape(-1),
             lambda: np.tile(batch.edge_label_mask, 2), d),
            (LABELS, lambda: batch.node_label_index,
             lambda: batch.label_mask, cfg.share.dim_out)):
        if name in batch.packs:
            gathers[name] = check_gather_k1(
                batch.to(device).packs[name], index(), mask(), n, width,
                device)
    supervised = {}
    if batch.edge_label_mask is not None:
        supervised["pairs"] = int(np.sum(batch.edge_label_mask))
        supervised["pair_slots"] = len(batch.edge_label_mask)
    if batch.label_mask is not None:
        real = batch.node_label_index[batch.label_mask]
        supervised.update(nodes=len(real), unique_nodes=len(np.unique(real)),
                          label_slots=len(batch.label_mask))
    phase(f"kernel_{tag}", n=n, d=d, d_in=cfg.share.dim_in,
          d_out=cfg.share.dim_out, pack=kind,
          layer_type=cfg.gnn.layer_type, graphs=int(batch.num_graphs) - 1,
          real_nodes=int(np.sum(batch.node_mask)),
          edge_slots=len(batch.senders),
          real_edges=int(np.sum(batch.edge_mask)),
          chunks=int(packs[0].senders.shape[0]), host_data_s=host_s,
          batches=len(loaders[0]), train_signatures=signatures,
          slots=int(packs[0].senders.numel()),
          fwd_rows=longest_rows(packs[0]),
          bwd_rows=longest_rows(packs[1]), pool=pool, gathers=gathers,
          supervised=supervised, **checks)
    begin(f"model_{tag}")
    phase(f"model_{tag}", **check_model(cfg, loaders[1].batches(0)[0],
                                        device, random_features))
    begin(f"train_{tag}")
    train = train_path(cfg_file, overrides, os.path.join(OUT, tag),
                       loaders, expected, widths, rect)
    phase(f"train_{tag}", **train)
    begin(f"profile_{tag}")
    slots = packs[0].senders.numel()
    profile = profile_steps(cfg, loaders, device, forbid_numel=slots * d,
                            forbid_index_add=slots)
    phase(f"profile_{tag}", **profile,
          repeat=repeat_steps(cfg, loaders, device))
    begin(f"graphed_{tag}")
    phase(f"graphed_{tag}", **graphed_check(cfg, loaders, device))
    return dict(width=d, pack=f"{kind}, {base or tag}", checks=checks,
                gathers=gathers, train=train, profile=profile)


def reference_of(model: str, dataset: str) -> tuple:
    """results/parity/parity.json's reference mean best val accuracy
    over the reference's seeds, and their spread (the parity tool's
    reader)."""
    row = parity.reference(model, dataset)
    return row["reference"], row["reference_std"]


class LoaderCalls:
    """While installed, the seconds of each ``Trainer.run`` and, where
    ``keep``, every ``GraphLoader.batches`` call of a train loader
    (shuffled): its epoch, the thread that made it and the batches it
    gave, hashed when read (``digests``) so the hashing stays off the
    timed run."""

    def __init__(self, keep: bool = True):
        self.keep = keep

    def __enter__(self):
        from graphgym_tpu_torch.data import loaders as L

        self.calls, self.run_s = [], []
        self.real_batches, self.real_run = L.GraphLoader.batches, Trainer.run

        def batches(loader, epoch=0):
            out = self.real_batches(loader, epoch)
            if self.keep and loader.shuffle:
                self.calls.append((epoch, threading.current_thread().name,
                                   out))
            return out

        def run(trainer, *args, **kw):
            t0 = time.perf_counter()
            result = self.real_run(trainer, *args, **kw)
            self.run_s.append(time.perf_counter() - t0)
            return result
        L.GraphLoader.batches, Trainer.run = batches, run
        return self

    def __exit__(self, *exc):
        from graphgym_tpu_torch.data import loaders as L

        L.GraphLoader.batches, Trainer.run = self.real_batches, self.real_run

    def digests(self) -> list:
        out = []
        for epoch, thread, batches in self.calls:
            h = hashlib.sha256()
            for b in batches:
                for a in b.leaves():
                    h.update(np.ascontiguousarray(a).tobytes())
            out.append((epoch, thread, h.hexdigest()))
        return out


def numpy_pack(s, r, w, rows, senders, least=0, slots=False):
    """The numpy packer (the plain version of packing._pack): the pack,
    its chunks padded to max(bucket, least)."""
    from graphgym_tpu_torch.graphs.container import bucket_size

    pack, slot = K.pack_csr_with_slots(s, r, w, rows, num_senders=senders)
    pack = K.pad_pack(pack, max(bucket_size(pack.senders.shape[0]), least),
                      rows, senders)
    return pack, (slot if slots else None)


def median_s(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def prefetch_phase(cfg_file: str, overrides, expected: dict,
                   widths=None, rect=(0, 0), packs: str = "") -> dict:
    """prefetch_<path>: the path's training (``train_path``, 10 epochs,
    ``expected`` launches) with cfg.tpu.prefetch off and on: the train
    loader's batches of every call and every loss bitwise equal, the
    calls after the first three (the constructor's, the edge count's,
    epoch 0's) made on the prefetch thread; each run's median time_iter
    of the replays and train seconds per epoch.  With ``packs`` (a pack
    kind that takes the batch's edges as they are), on the first train
    batch its fwd and bwd packs built natively (packing._pack:
    graphgym_tpu_torch/native) and by the numpy packer, array for array
    equal, each build's median seconds, and the median seconds of an
    epoch's collation with each packer (the card machine's CPU)."""
    from graphgym_tpu_torch.graphs import packing

    epochs = ["optim.max_epoch", "10"]
    _, loaders, _ = load_path(cfg_file, overrides + epochs)
    runs = {}
    for prefetch in ("False", "True"):
        with LoaderCalls() as calls:
            train = train_path(cfg_file, overrides + epochs
                               + ["tpu.prefetch", prefetch],
                               os.path.join(OUT, f"prefetch_{prefetch}"),
                               loaders, expected, widths, rect)
        runs[prefetch] = dict(train=train, calls=calls.digests())
    serial, ahead = runs["False"], runs["True"]
    if [c[::2] for c in serial["calls"]] != [c[::2] for c in ahead["calls"]]:
        fail("prefetched batches differ from the serial ones")
    threads = [c[1] for c in ahead["calls"]]
    if any(t.startswith("prefetch") for t in threads[:3]) \
            or not all(t.startswith("prefetch") for t in threads[3:]):
        fail(f"prefetch threads {threads}")
    if serial["train"]["losses"] != ahead["train"]["losses"] \
            or serial["train"]["val_acc"] != ahead["train"]["val_acc"]:
        fail("prefetched losses or val accuracies differ from the serial "
             "ones")
    both = (("serial", serial), ("prefetch", ahead))
    out = dict(
        batches=len(loaders[0]), calls=len(serial["calls"]),
        threads=threads, losses_equal=True,
        time_iter_median_s={k: v["train"]["step_s_median_replays"]
                            for k, v in both},
        train_s_per_epoch={k: v["train"]["train_s_per_epoch"]
                           for k, v in both},
        launches=ahead["train"]["launches"], host_cpus=os.cpu_count())
    if not packs:
        return out
    batch = loaders[0].batches(0)[0]
    n = batch.num_nodes
    s, r, w = batch.senders, batch.receivers, batch.edge_weight
    builds = {}
    for half, (a, b) in (("fwd", (s, r)), ("bwd", (r, s))):
        got, _ = packing._pack(a, b, w, n, n)
        want, _ = numpy_pack(a, b, w, n, n)
        if any(not np.array_equal(x, y) for x, y in zip(got, want)):
            fail(f"native {half} {packs} pack differs from the numpy "
                 "packer's")
        builds[half] = dict(
            native_s=median_s(lambda: packing._pack(a, b, w, n, n)),
            numpy_s=median_s(lambda: numpy_pack(a, b, w, n, n)),
            slots=int(got.senders.size))
    epoch_s = {"native": median_s(lambda: loaders[0].batches(1), 3)}
    real_pack = packing._pack
    packing._pack = numpy_pack
    try:
        epoch_s["numpy"] = median_s(lambda: loaders[0].batches(1), 3)
    finally:
        packing._pack = real_pack
    return dict(out, pack=packs, packs=builds, epoch_collation_s=epoch_s)


# results/parity/PARITY.md:29 and :30: ID-GCN Full on ws, ID-GIN Full
# on ba
IDGCN_WS_REF = reference_of("idgcn", "ws")
IDGIN_BA_REF = reference_of("idgin", "ba")


def full_run(tag: str, cfg_file: str, overrides, seeds: int = 3,
             reference=None, gated: bool = True) -> dict:
    """A config's whole training (its own max_epoch) through the port's
    parity tool (``parity.run_config``: graphgym_tpu_torch.main.main
    with --repeat ``seeds``, into OUT/<tag>, then the aggregate the
    entry point wrote): each seed's best val accuracy and the seeds'
    mean and std from agg/val/best.json, the seconds of each run (data,
    model and training) and the median ``time_iter`` of the train
    steps over all seeds, and every kernel's launches over the runs.
    With ``reference`` (mean, sigma), the mean against it by PARITY.md's
    pass rule (``parity.pass_rule``); fails on a miss where ``gated``."""
    out = os.path.join(OUT, tag)
    shutil.rmtree(out, ignore_errors=True)
    (results, summary), (launches, _, _) = counted(
        lambda: parity.run_config(cfg_file, seeds, out, overrides))
    parity.drop_checkpoints(out)
    per_seed, mean, std = (summary["best_val_acc_per_seed"],
                           summary["mean"], summary["std"])
    out_row = dict(summary, best_val_acc_from_main=[r["best_val_acc"]
                                                    for r in results],
                   launches=launches)
    if len(per_seed) != seeds or abs(np.mean(per_seed) - mean) > 1e-4:
        fail(f"{tag}: the aggregate ({mean}+-{std}) does not hold the "
             f"{seeds} seeds' best val accuracies {per_seed}")
    if reference is not None:
        ref_mean, ref_sigma = reference
        delta = mean - ref_mean
        passes, limit = parity.pass_rule(delta, ref_sigma, std)
        out_row.update(reference=ref_mean, reference_sigma=ref_sigma,
                       delta=delta, limit=limit, passes=passes)
        if gated and not passes:
            fail(f"{tag}: mean best val accuracy {mean}+-{std} against "
                 f"{ref_mean}+-{ref_sigma}: |delta| {abs(delta)} > {limit}")
    return out_row


def path_launches(kernel, trains: dict, width=None,
                  other_than=()) -> dict:
    """A kernel's launches on each path run (``train_path``'s results):
    all of them, those at ``width``, or those at none of the widths
    ``other_than``."""
    name = kernel.__name__

    def count(t):
        at = t.get("launches_at_width", {})
        if width is not None:
            return at[width][name]
        return t["launches"][name] - sum(at[w][name] for w in other_than
                                         if w in at)
    by_path = {p: count(t) for p, t in trains.items()}
    return dict(launches=sum(by_path.values()), launches_by_path=by_path)


def new_path_rows(fast: dict, ba: dict, row: tuple, srcs: tuple) -> list:
    """The kernels line's rows of the Fast and ba paths (``drive_path``'s
    results): K1 at D = 128 and at D = 11 on the Fast packs, K1 at
    D = 128 and at D = 1 (the narrow walk's hub rows) on ba's; K3's
    aggregation, its softmax row sums and the SDDMM on the
    gatconvFast_ws and idgat_ba 'att' packs."""
    k1_src, k3_src, sddmm_src = srcs
    k1, k3, sddmm = (K.packed_spmm_cuda, K.packed_segment_matmul_headed_cuda,
                     K.packed_sddmm_cuda)
    k1_row = row + ("floor_ms",)

    def pick(check, keys=row):
        return {k: check[k] for k in keys}

    def k1_at(path, width=None):   # width: the model's by default
        return path["checks"][f"d{width or path['width']}"]

    def trains(paths, tags):
        return {t: paths[t]["train"] for t in tags}

    fast_k1 = trains(fast, ("gcnconvFast_ws", "sageconvFast_ws",
                            "ginconvFast_ws"))
    d11 = trains(fast, ("sageconvFast_ws", "ginconvFast_ws"))
    ba_k1 = trains(ba, ("idgcn_ba", "idgin_ba"))
    rows = [
        {"name": "packed_spmm_fast_ws", **k1_src, "path": ", ".join(fast_k1),
         "pack": "gcn, gcnconvFast_ws",
         "width": fast["gcnconvFast_ws"]["width"],
         **pick(k1_at(fast["gcnconvFast_ws"]), k1_row),
         **path_launches(k1, fast_k1, other_than=(11,))},
        {"name": "packed_spmm_d11", **k1_src, "path": ", ".join(d11),
         "pack": "mean, sageconvFast_ws", "width": 11,
         **pick(k1_at(fast["sageconvFast_ws"], 11), k1_row),
         "plain_pack_ms": k1_at(fast["ginconvFast_ws"], 11)["ms"],
         **path_launches(k1, d11, width=11)},
        {"name": "packed_spmm_ba", **k1_src, "path": ", ".join(ba_k1),
         "pack": "gcn, idgcn_ba", "width": ba["idgcn_ba"]["width"],
         **pick(k1_at(ba["idgcn_ba"]), k1_row),
         **path_launches(k1, ba_k1, other_than=(1,))},
        {"name": "packed_spmm_ba_d1", **k1_src, "path": "idgin_ba",
         "pack": "plain, idgin_ba", "width": 1,
         **pick(k1_at(ba["idgin_ba"], 1), k1_row),
         **path_launches(k1, trains(ba, ("idgin_ba",)), width=1)},
    ]
    for tag, paths in (("fast_ws", fast), ("ba", ba)):
        path = "gatconvFast_ws" if tag == "fast_ws" else "idgat_ba"
        checks, att = paths[path]["checks"], trains(paths, (path,))
        rows += [
            {"name": f"packed_attention_{tag}", **k3_src, "path": path,
             "width": paths[path]["width"], **pick(checks["k3"]),
             **path_launches(k3, att, other_than=(1,))},
            {"name": f"packed_attention_row_sums_{tag}", **k3_src,
             "path": path, "width": 1, "library": "index_add_",
             **pick(checks["softmax"]),
             **path_launches(k3, att, width=1)},
            {"name": f"packed_sddmm_{tag}", **sddmm_src, "path": path,
             **pick(checks["sddmm"]), **path_launches(sddmm, att)}]
    return rows


def torch_path_rows(paths: dict, row: tuple, srcs: tuple) -> list:
    """The kernels line's rows of the torch-path grid points
    (``drive_path``'s results): K1 at the model width on each K1 path's
    pack, the segmented max forward and backward on each max path's,
    and K3's aggregation, its softmax row sums and the SDDMM on
    gatid_ba's 'att' pack."""
    k1_src, k3_src, sddmm_src, max_src = srcs
    k1, k3, sddmm = (K.packed_spmm_cuda, K.packed_segment_matmul_headed_cuda,
                     K.packed_sddmm_cuda)
    rows = []
    for tag, path in paths.items():
        train = {tag: path["train"]}
        checks = path["checks"]
        if "max" in checks:
            rows += [{"name": f"{kernel.__name__[:-5]}_{tag}", **max_src,
                      "path": tag, "pack": path["pack"],
                      "width": path["width"],
                      **{k: checks["max"][half][k]
                         for k in row + ("floor_ms",)},
                      **path_launches(kernel, train)}
                     for half, kernel in (("fwd", K.packed_max_cuda),
                                          ("bwd", K.packed_max_bwd_cuda))]
            continue
        if "k3" not in checks:
            check = checks[f"d{path['width']}"]
            rows.append({"name": f"packed_spmm_{tag}", **k1_src,
                         "path": tag, "pack": path["pack"],
                         "width": path["width"],
                         **{k: check[k] for k in row + ("floor_ms",)},
                         **path_launches(k1, train)})
            continue
        rows += [
            {"name": f"packed_attention_{tag}", **k3_src, "path": tag,
             "width": path["width"], **{k: checks["k3"][k] for k in row},
             **path_launches(k3, train, other_than=(1,))},
            {"name": f"packed_attention_row_sums_{tag}", **k3_src,
             "path": tag, "width": 1, "library": "index_add_",
             **{k: checks["softmax"][k] for k in row},
             **path_launches(k3, train, width=1)},
            {"name": f"packed_sddmm_{tag}", **sddmm_src, "path": tag,
             **{k: checks["sddmm"][k] for k in row},
             **path_launches(sddmm, train)}]
    return rows


def graph_rows(paths: dict, pools: dict, row: tuple, srcs: tuple) -> list:
    """The kernels line's rows of the graph task (``drive_path``'s and
    ``pool_phase``'s results): K1 on each graph path's layer pack, K1's
    add and mean pooling (forward timed, the backward beside it) and the
    segmented max's pooling forward and backward on each path's pooling
    packs.  The launches are train_path's counts of the path's run: K1's
    rectangular ones (the pooling pack and its transpose) for the add
    pooling, the rest for the layers.  No path pools by mean or max:
    their rows launch 0."""
    k1_src, max_src = srcs
    keys = row + ("floor_ms",)
    rows = []
    for tag, path in paths.items():
        t, pool = path["train"], pools[tag]
        count = {"layers": t["k1_layer_launches"],
                 "pool": t["k1_rect_launches"]}
        check = path["checks"][f"d{path['width']}"]
        rows.append({"name": f"packed_spmm_{tag}", **k1_src, "path": tag,
                     "pack": path["pack"], "width": path["width"],
                     **{k: check[k] for k in keys},
                     "launches": count["layers"], "launch_split": count})
        suffix = "_ego" if pool["ego"] else ""
        for kind in ("add", "mean"):
            rows.append({
                "name": f"packed_spmm_pool_{kind}_{tag}", **k1_src,
                "path": tag if kind == "add" else None,
                "pack": f"pool_{kind}{suffix}, {tag}",
                "width": pool["width"],
                **{k: pool[kind]["fwd"][k] for k in keys},
                "bwd": {k: pool[kind]["bwd"][k] for k in keys},
                "launches": count["pool"] if kind == "add" else 0,
                "launch_split": count})
        rows += [{"name": f"{kernel.__name__[:-5]}_pool_{tag}", **max_src,
                  "path": None, "pack": f"pool_max{suffix}, {tag}",
                  "width": pool["width"],
                  **{k: pool["max"][half][k] for k in keys},
                  "launches": 0}
                 for half, kernel in (("fwd", K.packed_max_cuda),
                                      ("bwd", K.packed_max_bwd_cuda))]
    return rows


def link_rows(paths: dict, row: tuple, k1_src: dict) -> list:
    """The kernels line's rows of the link and edge paths
    (``drive_path``'s results): K1 on each path's layer pack, and on
    each gather pack a path has (the forward timed, the backward
    beside it).  The launches are train_path's counts of the path's run:
    K1's rectangular ones (the gather pack and its transpose) for the
    gather, the rest for the layers."""
    keys = row + ("floor_ms",)
    rows = []
    for tag, path in paths.items():
        t = path["train"]
        count = {"layers": t["k1_layer_launches"],
                 "gather": t["k1_rect_launches"]}
        check = path["checks"][f"d{path['width']}"]
        rows.append({"name": f"packed_spmm_{tag}", **k1_src, "path": tag,
                     "pack": path["pack"], "width": path["width"],
                     **{k: check[k] for k in keys},
                     "launches": count["layers"], "launch_split": count})
        for kind, gather in path["gathers"].items():
            rows.append({
                "name": f"packed_spmm_{kind}_{tag}", **k1_src, "path": tag,
                "pack": f"{kind}, {tag}", "width": gather["width"],
                "library": "index_select (backward: index_add_)",
                **{k: gather["fwd"][k] for k in keys},
                "bwd": {k: gather["bwd"][k] for k in keys},
                "launches": count["gather"], "launch_split": count})
    return rows


def main() -> None:
    shutil.rmtree(OUT, ignore_errors=True)
    begin("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    begin("build")
    info = K.build()
    for name in K.SOURCES:
        K.library(name)
    phase("build", seconds=max(b.seconds for b in info.values()),
          ptxas={name: ptxas_report(b.log) for name, b in info.items()})
    atexit.register(lambda: [p.kill() for p in CHILDREN
                             if p.poll() is None])
    corpora = start_corpora()

    overrides = ["device", "cuda", "optim.max_epoch", str(EPOCHS),
                 "train.eval_period", "1"]

    k1_, k3_, sddmm_ = (K.packed_spmm_cuda,
                        K.packed_segment_matmul_headed_cuda,
                        K.packed_sddmm_cuda)
    max_, max_bwd_ = K.packed_max_cuda, K.packed_max_bwd_cuda

    # ---- ID-GCN Full / ws: kernel K1
    begin("kernel")
    cfg, loaders, host_s = load_path(CFG, overrides)
    train_batch = loaders[0].batches(0)[0]
    n, d = train_batch.num_nodes, cfg.gnn.dim_inner
    dev_batch = train_batch.to(device)
    k1 = check_kernel(dev_batch.packs["gcn"], n, d, device)
    phase("kernel", n=n, d=d, chunks=int(dev_batch.packs["gcn"][0]
                                         .senders.shape[0]),
          host_data_s=host_s, **k1)
    begin("model")
    phase("model", **check_model(cfg, loaders[1].batches(0)[0], device))
    # every layer's SpMM input (x W) needs a gradient: 2 per layer
    begin("train")
    train = train_path(CFG, overrides, os.path.join(OUT, "idgcn"), loaders,
                       {k1_: (6, 3)})
    phase("train", **train)
    begin("profile")
    phase("profile", **profile_steps(cfg, loaders, device),
          repeat=repeat_steps(cfg, loaders, device))
    begin("graphed")
    phase("graphed", **graphed_check(cfg, loaders, device),
          batch_size_8=graphed_batches(CFG, overrides
                                       + ["train.batch_size", "8"]))

    # ---- ID-GAT Full / ws: kernels K3 and the SDDMM
    begin("kernel_att")
    cfg, loaders, host_s = load_path(CFG_ATT, overrides)
    train_batch = loaders[0].batches(0)[0]
    n, d = train_batch.num_nodes, cfg.gnn.dim_inner
    dev_batch = train_batch.to(device)
    att_packs = dev_batch.packs["att"]
    k3 = check_attention_kernel(att_packs, n, d, device)
    softmax = check_softmax(att_packs[0], n, device)
    phase("kernel_att", n=n, d=d, heads=cfg.gnn.att_heads,
          chunks=int(att_packs[0].senders.shape[0]), host_data_s=host_s,
          softmax=softmax, **k3)
    begin("kernel_sddmm")
    sddmm = check_sddmm_kernel(att_packs[0], n, d, device)
    phase("kernel_sddmm", n=n, d=d, **sddmm)
    begin("model_att")
    phase("model_att", **check_model(cfg, loaders[1].batches(0)[0],
                                     device))
    # per layer: K3 forward (the softmax's row sums, the aggregation) and
    # backward (dv, the softmax's row sum, dq, dk); SDDMM score, dalpha
    # (layer 0's Wq, Wk, Wv train too); an eval batch runs the forwards.
    # The row sums run K3 at width 1 (one head).
    begin("train_att")
    train_att = train_path(CFG_ATT, overrides, os.path.join(OUT, "idgat"),
                           loaders, {k3_: (18, 6), sddmm_: (6, 3)},
                           widths={1: {k3_: (6, 3)}})
    phase("train_att", **train_att)
    begin("profile_att")
    att_slots = att_packs[0].senders.numel()
    phase("profile_att", **profile_steps(
        cfg, loaders, device, forbid_numel=att_slots * d,
        forbid_index_add=att_slots),
        repeat=repeat_steps(cfg, loaders, device))
    begin("graphed_att")
    phase("graphed_att", **graphed_check(cfg, loaders, device))

    # ---- ID-GIN Full / ws: kernel K1 on the 'plain' pack
    begin("kernel_gin")
    cfg, loaders, host_s = load_path(CFG_GIN, overrides)
    gin_batch = loaders[0].batches(0)[0]
    n, d = gin_batch.num_nodes, cfg.gnn.dim_inner
    plain_packs = gin_batch.to(device).packs["plain"]
    d_in = gin_batch.node_feat.shape[1]
    k1_gin = {f"d{dd}": check_kernel(plain_packs, n, dd, device)
              for dd in (d, d_in)}
    phase("kernel_gin", n=n, chunks=int(plain_packs[0].senders.shape[0]),
          host_data_s=host_s, **k1_gin)
    begin("model_gin")
    phase("model_gin", **check_model(cfg, loaders[1].batches(0)[0],
                                     device, random_features=True))
    # layer 0 aggregates the raw 1-wide features, which need no
    # gradient: 1 + 2 x 2 per train step, one of them at D = 1
    begin("train_gin")
    train_gin = train_path(CFG_GIN, overrides, os.path.join(OUT, "idgin"),
                           loaders, {k1_: (5, 3)},
                           widths={1: {k1_: (1, 1)}})
    phase("train_gin", **train_gin)
    begin("profile_gin")
    phase("profile_gin", **profile_steps(cfg, loaders, device),
          repeat=repeat_steps(cfg, loaders, device))
    begin("graphed_gin")
    phase("graphed_gin", **graphed_check(cfg, loaders, device))

    # ---- ID-SAGE Full / ws: kernel K1 on the 'mean' pack
    begin("kernel_sage")
    cfg, loaders, host_s = load_path(CFG_SAGE, overrides)
    sage_batch = loaders[0].batches(0)[0]
    mean_packs = sage_batch.to(device).packs["mean"]
    phase("kernel_sage", n=sage_batch.num_nodes, d=d_in,
          chunks=int(mean_packs[0].senders.shape[0]),
          **check_kernel(mean_packs, sage_batch.num_nodes, d_in, device))
    begin("model_sage")
    phase("model_sage", host_data_s=host_s,
          **check_model(cfg, loaders[1].batches(0)[0], device,
                        random_features=True))
    begin("train_sage")
    train_sage = train_path(CFG_SAGE, overrides,
                            os.path.join(OUT, "idsage"), loaders,
                            {k1_: (5, 3)}, widths={1: {k1_: (1, 1)}})
    phase("train_sage", **train_sage)
    begin("profile_sage")
    phase("profile_sage", **profile_steps(cfg, loaders, device),
          repeat=repeat_steps(cfg, loaders, device))
    begin("graphed_sage")
    phase("graphed_sage", **graphed_check(cfg, loaders, device))

    # ---- ID-GNN Fast / ws (identity features of width 10 before the
    # node feature: dim_in 11; no ego transform): the plain Tfg layers.
    # GCNConv aggregates x W (D = 128, 2 per layer); SAGEConv and GINConv
    # aggregate layer 0's raw input at D = 11 (K1's scalar walk, forward
    # only) and 128-wide hidden rows after it; GATConv as ID-GAT
    fast = {
        "gcnconvFast_ws": drive_path("gcnconvFast_ws", device, overrides,
                                     {k1_: (6, 3)}),
        "sageconvFast_ws": drive_path("sageconvFast_ws", device, overrides,
                                      {k1_: (5, 3)},
                                      widths={11: {k1_: (1, 1)}}),
        "ginconvFast_ws": drive_path("ginconvFast_ws", device, overrides,
                                     {k1_: (5, 3)},
                                     widths={11: {k1_: (1, 1)}}),
        "gatconvFast_ws": drive_path("gatconvFast_ws", device, overrides,
                                     {k3_: (18, 6), sddmm_: (6, 3)},
                                     widths={1: {k3_: (6, 3)}}),
    }

    # ---- ID-GNN Full on the ba corpus, regenerated here without
    # networkx: ID-GCN (K1 at D = 128 on ba's 'gcn' packs), ID-GIN (K1's
    # narrow walk at D = 1 on the 'plain' packs, rows of up to 48 slots
    # walked by their warp; constant features, so seeded random ones in
    # the model check, as on ws), ID-GAT (its peak memory)
    begin("corpus")
    ba_overrides = overrides + ["dataset.dir", CORPUS_DIR]
    corpus = corpus_phase(ba_overrides, corpora)
    phase("corpus", **corpus)
    ba = {
        "idgcn_ba": drive_path("idgcn_ba", device, ba_overrides,
                               {k1_: (6, 3)}),
        "idgin_ba": drive_path("idgin_ba", device, ba_overrides,
                               {k1_: (5, 3)}, widths={1: {k1_: (1, 1)}},
                               random_features=True),
        "idgat_ba": drive_path("idgat_ba", device, ba_overrides,
                               {k3_: (18, 6), sddmm_: (6, 3)},
                               widths={1: {k3_: (6, 3)}}),
    }
    # the epoch prefetch and the native pack builder on ID-GIN ba's two
    # train batches of 48 graphs a epoch
    begin("prefetch_idgin_ba")
    phase("prefetch_idgin_ba", **prefetch_phase(
        config("idgin_ba"), ba_overrides, {k1_: (5, 3)},
        {1: {k1_: (1, 1)}}, packs="plain"))

    # ---- the GraphGym torch path (pre-MP Linear + BN + act, the stage of
    # GeneralLayer(conv) with BN and act, the L2 norm, the node head's
    # MLP), the ID-GNN grid's synthetic node points as base configs with
    # overrides (grids/IDGNN/node.txt:70-96, :6-18).  Pre-MP hands every
    # layer a 128-wide input that needs a gradient: K1 2 per layer on
    # each K1 path (gcnidconv 'gcn', sageidconv 'mean', ginidconv and
    # design_ws 'plain', gcnconv on the Fast 'gcn' pack); gatidconv (2
    # layers) per layer K3 2 forward (row sums, aggregation) and 4
    # backward (dv; row sums: the softmax's and the node scores' two
    # gradients) and SDDMM 1 (dalpha; the additive score needs none).
    # ws's and ba's features are constant: seeded random ones in the
    # model check (the pre-MP BN would normalize rounding noise).
    def grid_point(tag, base, *extra, ovr=overrides, **kw):
        return drive_path(tag, device, ovr, base=base, extra=extra, **kw)
    torch_paths = {
        "gcnid_ws": grid_point("gcnid_ws", "idgcn_ws", "gnn.layer_type",
                               "gcnidconv", expected={k1_: (6, 3)},
                               random_features=True),
        "sageid_ws": grid_point("sageid_ws", "idgcn_ws", "gnn.layer_type",
                                "sageidconv", expected={k1_: (6, 3)},
                                random_features=True),
        "ginid_ws": grid_point("ginid_ws", "idgcn_ws", "gnn.layer_type",
                               "ginidconv", expected={k1_: (6, 3)},
                               random_features=True),
        "gcn_id_ws": grid_point("gcn_id_ws", "gcnconvFast_ws",
                                "gnn.layer_type", "gcnconv",
                                expected={k1_: (6, 3)}),
        "gatid_ba": grid_point("gatid_ba", "idgcn_ba", "gnn.layer_type",
                               "gatidconv", "gnn.layers_mp", "2",
                               ovr=ba_overrides,
                               expected={k3_: (12, 4), sddmm_: (2, 0)},
                               widths={1: {k3_: (8, 2)}},
                               random_features=True),
        "design_ws": grid_point("design_ws", "idgcn_ws", "gnn.layer_type",
                                "ginidconv", "gnn.act", "prelu",
                                "gnn.stage_type", "skipsum", "gnn.dropout",
                                "0.3", expected={k1_: (6, 3)},
                                random_features=True),
    }

    # ---- the segmented max (csrc/packed_max.cu), no Pallas counterpart:
    # forward and backward on the ws ego 'plain' pack (ID-GIN's, 49,152
    # rows) and on the ba ego 'plain' pack (rows of up to 48 slots), at
    # the widths the ID and design paths run
    begin("kernel_max")
    _, ba_loaders, _ = load_path(config("idgin_ba"), ba_overrides)
    ba_batch = ba_loaders[0].batches(0)[0]
    ba_plain = ba_batch.to(device).packs["plain"]
    del ba_loaders
    kmax = {f"{tag}_d{w}": check_max_kernel(packs, nn_, w, device)
            for tag, packs, nn_ in (
                ("ws", plain_packs, gin_batch.num_nodes),
                ("ba", ba_plain, ba_batch.num_nodes))
            for w in (128, 256)}
    phase("kernel_max", ws_rows=longest_rows(plain_packs[0]),
          ba_rows=longest_rows(ba_plain[0]), **kmax)
    del ba_plain

    # ---- the design space (grids/design/round1.txt's synthetic node
    # chunks) on GraphGym's default conv: configs/design/design_v1.yaml
    # plus a grid point's overrides, at its width (dim_inner 256), on the
    # corpora regenerated beside the earlier phases; and idconv, the
    # fifth ID-GNN Full variant, at gcnid_ws's point.  The aggregation
    # runs after the projection, at 256: K1 2 per layer (add on 'plain',
    # mean on 'mean'), or the segmented max forward per layer and its
    # backward (pre-MP hands layer 0 an input that needs a gradient)
    begin("design_corpus")
    phase("design_corpus", **design_corpus_phase(corpora))
    dz = overrides + ["dataset.dir", DESIGN_CORPUS_DIR]
    node = ("dataset.format", "nx", "dataset.task", "node",
            "dataset.transductive", "True")
    design = {
        "design_sf": grid_point(
            "design_sf", "design/design_v1", *DESIGN_SF, ovr=dz,
            expected={k1_: (16, 8)}, widths={256: {k1_: (16, 8)}}),
        "design_sw_mean": grid_point(
            "design_sw_mean", "design/design_v1", *node, "dataset.name",
            "smallworld", "dataset.augment_feature", "['node_onehot']",
            "dataset.augment_label", "node_pagerank", "train.batch_size",
            "32", "gnn.layers_pre_mp", "2", "gnn.layers_mp", "4",
            "gnn.layers_post_mp", "2", "gnn.stage_type", "skipconcat",
            "gnn.batchnorm", "False", "gnn.act", "swish", "gnn.dropout",
            "0.3", "gnn.agg", "mean", "optim.optimizer", "sgd",
            "optim.base_lr", "0.1", ovr=dz, expected={k1_: (8, 4)},
            widths={256: {k1_: (8, 4)}}),
        "design_sf_max": grid_point(
            "design_sf_max", "design/design_v1", *node, "dataset.name",
            "scalefree", "dataset.augment_feature", "['node_const']",
            "dataset.augment_label", "node_clustering_coefficient",
            "train.batch_size", "16", "gnn.layers_pre_mp", "1",
            "gnn.layers_mp", "6", "gnn.layers_post_mp", "3",
            "gnn.stage_type", "skipsum", "gnn.batchnorm", "True",
            "gnn.act", "relu", "gnn.dropout", "0.6", "gnn.agg", "max",
            "optim.optimizer", "adam", "optim.base_lr", "0.001", ovr=dz,
            expected={max_: (6, 6), max_bwd_: (6, 0)},
            random_features=True),
        "idconv_ws": grid_point("idconv_ws", "idgcn_ws", "gnn.layer_type",
                                "idconv", expected={k1_: (6, 3)},
                                widths={128: {k1_: (6, 3)}},
                                random_features=True),
    }

    # ---- the graph task: the graph head pools on the batch's pooling
    # pack (K1 for add and mean, the segmented max for max) and its MLP
    # runs over the graph slots.  design_graph_sf: per train step K1 2
    # per mean layer at 256 (pre-MP gives layer 0's input a gradient)
    # and the add pooling's forward and backward at the skipconcat
    # stage's 768 columns; per eval batch 2 and 1.  idgraph_ba: K1 2 per
    # gcnidconv layer and the pooling of the ego centers, all at 128; 3
    # and 1 per eval batch.  ``rect``: the pooling's share, which
    # train_path counts apart (K1's rectangular launches).  Constant
    # features: seeded random ones in the model check.
    graph_paths = {
        "design_graph_sf": grid_point(
            "design_graph_sf", "design/design_v1", *DESIGN_GRAPH_SF,
            ovr=dz, expected={k1_: (6, 3)},
            widths={256: {k1_: (4, 2)}, 768: {k1_: (2, 1)}},
            rect_width=768, rect=(2, 1), random_features=True),
        "idgraph_ba": grid_point(
            "idgraph_ba", "idgcn_ba", *IDGRAPH_BA, ovr=ba_overrides,
            expected={k1_: (8, 4)}, widths={128: {k1_: (8, 4)}},
            rect=(2, 1), random_features=True),
    }
    # ---- the link-prediction and edge tasks (grids/IDGNN/link.txt and
    # path.txt's synthetic chunks): per train step K1 2 per layer at 128
    # (pre-MP gives layer 0 an input that needs a gradient), 5 layers,
    # and 1 per layer per eval batch; edgeid_ws's node head gathers its
    # repeated supervised nodes on the 'labels' pack at dim_out 5 (K1
    # forward and backward, 2 per train step, 1 per eval batch), link_ba's
    # edge head both ends of each pair on the 'pairs' pack at 128 (the
    # same counts); ``rect``: that share.  Constant ws features and ba's
    # constant column: seeded random ones in the model check.
    link_paths = {
        "linkid_ws": grid_point(
            "linkid_ws", "idgcn_ws", *LINKID_WS, expected={k1_: (10, 5)},
            widths={128: {k1_: (10, 5)}}, random_features=True),
        "edgeid_ws": grid_point(
            "edgeid_ws", "idgcn_ws", *EDGEID_WS, expected={k1_: (12, 6)},
            widths={128: {k1_: (10, 5)}, 5: {k1_: (2, 1)}}, rect_width=5,
            rect=(2, 1), random_features=True),
        "link_ba": grid_point(
            "link_ba", "idgcn_ba", *LINK_BA, ovr=ba_overrides,
            expected={k1_: (12, 6)}, widths={128: {k1_: (12, 6)}},
            rect=(2, 1), random_features=True),
    }
    # the prefetch on two loaders of many small batches (6 and 3 an
    # epoch)
    begin("prefetch_design_graph_sf")
    phase("prefetch_design_graph_sf", **prefetch_phase(
        config("design/design_v1"), dz + list(DESIGN_GRAPH_SF),
        {k1_: (6, 3)}, {256: {k1_: (4, 2)}, 768: {k1_: (2, 1)}},
        rect=(2, 1)))
    begin("prefetch_link_ba")
    phase("prefetch_link_ba", **prefetch_phase(
        config("idgcn_ba"), ba_overrides + list(LINK_BA), {k1_: (12, 6)},
        {128: {k1_: (12, 6)}}, rect=(2, 1)))
    begin("kernel_pool")
    pools = pool_phase({
        "design_graph_sf": (config("design/design_v1"),
                            dz + list(DESIGN_GRAPH_SF), 768),
        "idgraph_ba": (config("idgcn_ba"), ba_overrides + list(IDGRAPH_BA),
                       128)}, device)
    phase("kernel_pool", **pools)

    # ---- full-length runs: the configs' 1000 epochs, 3 seeds each,
    # through the entry point and its seed aggregate (the logs to the
    # run directories only)
    full_overrides = ["device", "cuda", "print", "file"]
    begin("full_idgcn_ws")
    phase("full_idgcn_ws", **full_run("full_idgcn_ws", CFG, full_overrides,
                                      reference=IDGCN_WS_REF))
    begin("full_gcnid_ws")
    phase("full_gcnid_ws", **full_run(
        "full_gcnid_ws", CFG,
        full_overrides + ["gnn.layer_type", "gcnidconv"]))
    # the design point of results/design_v1_grid_round1 for its 100
    # epochs (reported: no reference number for the port to meet)
    begin("full_design_sf")
    phase("full_design_sf", **full_run(
        "full_design_sf", config("design/design_v1"),
        full_overrides + ["dataset.dir", DESIGN_CORPUS_DIR, *DESIGN_SF,
                          "optim.max_epoch", "100"]))
    # the graph point of results/design_v1_grid_round1 for its 200
    # epochs (reported: that directory holds a 3-epoch smoke run only)
    begin("full_design_graph_sf")
    phase("full_design_graph_sf", **full_run(
        "full_design_graph_sf", config("design/design_v1"),
        full_overrides + ["dataset.dir", DESIGN_CORPUS_DIR,
                          *DESIGN_GRAPH_SF, "optim.max_epoch", "200"]))

    # the ID link point for the grid's 100 epochs (link.txt:33), beside
    # the JAX package's CPU run at the same point and seeds (reported)
    begin("full_linkid_ws")
    phase("full_linkid_ws", jax_cpu=JAX_LINKID_WS,
          link_parity_ws=LINK_PARITY_WS, **full_run(
              "full_linkid_ws", CFG, full_overrides + list(LINKID_WS)
              + ["optim.max_epoch", "100"]))

    # ID-GIN on ba for its 1000 epochs at batch 48 (two train batches
    # an epoch, collated ahead by the prefetch), against the reference's
    # row (reported)
    begin("full_idgin_ba")
    phase("full_idgin_ba", **full_run(
        "full_idgin_ba", config("idgin_ba"),
        full_overrides + ["dataset.dir", CORPUS_DIR],
        reference=IDGIN_BA_REF, gated=False))

    # ---- kernel K2, at the train 'plain' fwd pack of ID-GIN
    begin("kernel_seg")
    k2 = check_segment_kernel(gin_batch, plain_packs[0], gin_batch.num_nodes,
                              d, device)
    phase("kernel_seg", n=gin_batch.num_nodes, d=d, **k2)

    # ---- the benchmark (graphgym_tpu_torch/bench.py): K1 and K3 on
    # make_graph's packs, then its entry points
    begin("bench")
    bench_kernels = check_bench_kernels(device)
    phase("bench", **bench_kernels)
    begin("bench_runs")
    bench_runs = check_bench_runs(device)
    phase("bench_runs", **bench_runs)

    begin("profiler_records")
    phase("profiler_records", lossy=len(LOSSY_PROFILES),
          least_share_kept=min((p[2] for p in LOSSY_PROFILES), default=1.0),
          first=[dict(phase=p, kernels=k, share_kept=r)
                 for p, k, r in LOSSY_PROFILES[:12]])

    row = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
           "library_ms", "timed_by")
    k1_paths = {"idgcn_ws": train, "idgin_ws": train_gin,
                "idsage_ws": train_sage}

    # K1's rows: D = 128 at the ID-GCN 'gcn' fwd pack, its narrow walk's
    # D = 1 at the ID-GIN 'plain' fwd pack, and D = 128 at make_graph's
    # fwd pack (the benchmark's chains); K3's and the SDDMM's: at the
    # ID-GAT 'att' pack (the row sums at width 1 there), and at H = 8 on
    # make_graph's 'att' pack (bench_attention: the row sums at width 8)
    k1_d1 = k1_gin[f"d{d_in}"]
    bk = bench_kernels
    bench_k1 = {"bench_spmm main": {"launches": bench_runs["main_launches"]},
                "bench_spmm bf16": {"launches": bench_runs["bf16_launches"]}}
    att_launches = bench_runs["attention_launches"]
    att_by_width = bench_runs["attention_launches_by_width"][k3_.__name__]
    k1_src = dict(route="cuda", source="graphgym_tpu_torch/csrc/"
                  "packed_spmm.cu",
                  replaces="graphgym_tpu/ops/pallas/spmm_kernel.py:334")
    k3_src = dict(route="cuda", source="graphgym_tpu_torch/csrc/"
                  "packed_attention.cu",
                  replaces="graphgym_tpu/ops/pallas/spmm_kernel.py:537")
    sddmm_src = dict(route="cuda",
                     source="graphgym_tpu_torch/csrc/packed_sddmm.cu",
                     replaces="graphgym_tpu/ops/pallas/spmm_kernel.py:655, "
                              "graphgym_tpu/nn/layers.py:152")
    max_src = dict(route="cuda",
                   source="graphgym_tpu_torch/csrc/packed_max.cu",
                   replaces="graphgym_tpu/ops/segment.py:50 (XLA's "
                            "segment_max; no Pallas kernel)")
    srcs = (k1_src, k3_src, sddmm_src, max_src)
    kernels_line = json.dumps({"kernels": [
        {"name": "packed_spmm", **k1_src,
         "path": ", ".join(k1_paths), "width": k1["width"],
         **{k: k1[k] for k in row + ("floor_ms",)},
         **path_launches(k1_, k1_paths, other_than=(1,))},
        {"name": "packed_spmm_d1", **k1_src,
         "path": "idgin_ws, idsage_ws", "width": k1_d1["width"],
         **{k: k1_d1[k] for k in row + ("floor_ms",)},
         **path_launches(k1_, k1_paths, width=1)},
        {"name": "packed_spmm_make_graph", **k1_src,
         "path": "bench_spmm", "width": bk["d"],
         "max_abs_err": bk["k1_errs"]["fwd_float32"],
         **{k: bk["k1_fwd"][k] for k in row[1:] + ("floor_ms",)},
         **path_launches(k1_, bench_k1)},
        {"name": "packed_segment", "route": "cuda",
         "source": "graphgym_tpu_torch/csrc/packed_segment.cu",
         "replaces": "graphgym_tpu/ops/pallas/spmm_kernel.py:309",
         "path": None, "launches": k2["launches"],
         **{k: k2[k] for k in row}},
        {"name": "packed_attention", **k3_src,
         "path": "idgat_ws", **{k: k3[k] for k in row},
         **path_launches(k3_, {"idgat_ws": train_att},
                          other_than=(1,))},
        {"name": "packed_attention_row_sums", **k3_src,
         "path": "idgat_ws", **{k: softmax[k] for k in row},
         **path_launches(k3_, {"idgat_ws": train_att}, width=1)},
        {"name": "packed_attention_make_graph", **k3_src,
         "path": "bench_attention", "width": BENCH_HEADS * BENCH_DV,
         "heads": BENCH_HEADS,
         "max_abs_err": bk["k3_errs"][f"fwd_h{BENCH_HEADS}"],
         **{k: bk["k3_h8"][k] for k in row[1:]},
         "launches": att_by_width.get(BENCH_HEADS * BENCH_DV, 0)},
        {"name": "packed_attention_row_sums_make_graph", **k3_src,
         "path": "bench_attention", "width": BENCH_HEADS,
         "heads": BENCH_HEADS, "library": "index_add_",
         "max_abs_err": bk["k3_errs"][f"row_sum_fwd_h{BENCH_HEADS}"],
         **{k: bk["row_sums"][f"fwd_h{BENCH_HEADS}"][k] for k in row[1:]},
         "launches": att_by_width.get(BENCH_HEADS, 0)},
        {"name": "packed_sddmm", **sddmm_src, "path": "idgat_ws",
         **{k: sddmm[k] for k in row},
         **path_launches(sddmm_, {"idgat_ws": train_att})},
        {"name": "packed_sddmm_make_graph", **sddmm_src,
         "path": "bench_attention", "heads": BENCH_HEADS, "dh": BENCH_DV,
         **{k: bk["sddmm"][k] for k in row},
         "launches": att_launches[sddmm_.__name__]},
        *new_path_rows(fast, ba, row, srcs[:3]),
        *torch_path_rows(torch_paths, row, srcs),
        *torch_path_rows(design, row, srcs),
        *graph_rows(graph_paths, pools, row, (k1_src, max_src)),
        *link_rows(link_paths, row, k1_src),
        *({"name": f"{kernel.__name__[:-5]}_{key}", **max_src,
           "path": None, "pack": f"plain, idgin_{key.split('_')[0]}",
           "width": check["width"],
           **{k: check[half][k] for k in row + ("floor_ms",)},
           "launches": 0}
          for key, check in kmax.items()
          for half, kernel in (("fwd", max_), ("bwd", max_bwd_))),
        *({"name": f"{kernel.__name__[:-5]}_make_graph", **max_src,
           "path": None, "pack": f"{half}, make_graph",
           "width": bk["max"]["width"],
           **{k: bk["max"][half][k] for k in row + ("floor_ms",)},
           "launches": 0}
          for half, kernel in (("fwd", max_), ("bwd", max_bwd_))),
    ]})
    with open(os.path.join(OUT, "kernels.json"), "w") as f:
        f.write(kernels_line + "\n")
    print(kernels_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:   # a phase's own error: name it on stdout
        import traceback

        traceback.print_exc()
        fail(f"{type(exc).__name__}: {exc}")
