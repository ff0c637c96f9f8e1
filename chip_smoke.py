"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; a failure prints {"phase": ..., "error":
...} on stdout and exits 1):
  1. device   — nvidia-smi name and power limit;
  2. build    — nvcc builds the kernels, one library per source
                (csrc/packed_spmm.cu, csrc/packed_segment.cu,
                csrc/packed_attention.cu, csrc/packed_sddmm.cu,
                csrc/packed_max.cu), side by side; then five processes
                start regenerating the synthetic corpora (ba, the
                design grid's scalefree and smallworld, and the ID-GNN
                graph grid's ws500 and ba500), beside the phases up to
                the ba paths (ws500 and ba500: the graph paths);
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
  6c. registered_optim — torch's RMSprop registered in
                register.optimizer_dict (not capturable) on gcnidconv:
                the trainer logs once that its train steps run eagerly
                on the card; 3 train steps equal, bitwise, the same
                optimizer stepped directly on the same batch from the
                same seed (K1 6 a step in both), the parameters and the
                optimizer's state stay on the card, and 2 eval steps
                beside them are captured (K1 3 each).
  6d. bf16_main — the main path at tpu.dtype bfloat16 (mixed precision,
                train/graphed.py): 5 epochs captured, K1 6 a train step
                and 3 an eval batch, every launch on bf16 input; two
                trainings and captured against eager bitwise; card vs
                CPU at BF16_TIGHT, no witness, which turns down a
                planted K1 that leaves its weights unrounded; the
                masters, Adam and the buffers f32; replay
                ms and peak memory at f32 and bf16 on the train batch;
                K1 on bf16 input timed beside its bound.
  6e. coo_route — the main path at tpu.spmm_impl xla (nn/coo.py), 2
                epochs captured: K2 9 a train step and 6 an eval batch
                on the 'coo_loops' entry, each of its three roles (the
                sum, the degree, the gather's gradient) counted under
                its own label, no K1; two trainings bitwise;
                card vs CPU; K2 on the entry's receiver and sender
                indexes against its plain version and timed beside its
                bound; K2's ms a step beside K1's route, and both
                routes' replay ms on the same graphs.
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
                   slots, H = 1) times beside the bound and the launch
                   floor (an empty kernel over the SDDMM's grid of slot
                   runs, packed_sddmm_floor_*);
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
  features replaced by seeded random ones in the model check.  Then
  appnp_ws (configs/idgcn_ws.yaml with gnn.layer_type Tfg-appnp: the
  Tfg APPNP model, Dense [64, 6] then 10 propagations on the 'gcn'
  pack: K1 20 per train step and 10 per eval batch, all at D = 6, the
  narrow walk; seeded random features in the model check).
  (The full-length runs full_idgcn_ws (its 1000 epochs, 3 seeds, held
  to PARITY.md's pass rule against 0.99375 +- 0.0006), full_gcnid_ws,
  full_design_sf, full_design_graph_sf and full_linkid_ws left the
  script in PR 20 for its time: the parity tool runs them in calls of
  their own, ``python -m graphgym_tpu_torch.exp.parity --configs
  configs/idgcn_ws.yaml --repeat 3 --opts device cuda`` (add
  ``gnn.layer_type gcnidconv`` for full_gcnid_ws); the JAX package's
  CPU run of full_linkid_ws's point, seeds 1-3: 0.5897, 0.5, 0.5449.)
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
  Then grids/design/round1att.txt's synthetic chunks at scalefree on
  configs/design/design_v1att.yaml (parity.POINTS; dim_inner 256, the
  whole corpus one batch), each through drive_path's phases:
  design_att_sf_mul (gmulconv, 4 layers, the node chunk: K3 24 per
  train step, 8 of them row sums at width 1, and the SDDMM 8 (score,
  dalpha); K3 8 (4) and the SDDMM 4 per eval batch) and
  design_att_sf_add_graph (gaddconv = the port's GATConv, 2 layers,
  skipsum, dropout 0.3, add pooling of every node at 256, the graph
  chunk: K3 12 (8) and the SDDMM 2 per train step, K3 4 (2) per eval
  batch; K1 only the pooling's 2 and 1).  Then three layer types no
  config sets, card vs CPU (check_model) on design_sf's val batch
  without a training (model_phase), the launches of the card side held
  and the layer pack's kernel checked and timed at 256: model_v2_mean
  and model_v2_max (generalconv_v2 with flow target_to_source and the
  directed norm: K1 24 on 'rev_dir_mean'; the max's forward 16 and
  backward 8 on 'rev_dir') and model_sageinit (sageinitconv built with
  its L2 norm: K1 24 on 'mean').
  corpus500     — waits for ws500 and ba500 (graph.txt's 500-node
                  corpora, 256 graphs asked, seed 0) their processes
                  regenerated into CORPUS500_DIR, holds each to its
                  graph count and digest (CORPUS500: 28 and 32 graphs)
                  and reports their seconds.
  Then that grid's chunks on their corpora (parity.POINTS), each
  through drive_path's phases: idgraph_ba500 (the ID chunk on ba500:
  gcnidconv cut to 2 MP layers, so ego nets at r = 2, for the script's
  time (IDGRAPH_BA500_DEPTH; the parity tool runs the grid's 3 layers,
  a ~2.1 M-node union of 25 graphs' ego nets), each graph's 500 ego
  centers pooled: K1 6 per train step and 3 per eval batch, all at 128,
  the pooling's 2 and 1 of them; the model check on the first 10 train
  graphs' union) and graph_ws500
  (the plain chunk on ws500: gatconv, node_identity features, every
  graph's 500 nodes pooled: K3 18 (12 row sums at width 1) and the
  SDDMM 3 per train step, K3 6 (3) and no SDDMM per eval batch, K1 only
  the add pooling's 2 and 1 at 128; the model check on the train
  batch).
  sweep_round1  — (before corpus500) scripts/design/run_design_round1.sh's
                  steps through the port: exp/grid's
                  gen_grid_sample_aliased samples grids/design/round1.txt
                  along 'agg' at sample_num 8, each point budget-matched
                  to configs/design/design_v1.yaml (exp/budget, the
                  port's parameter count); three nx points are kept (a
                  scalefree node point, a smallworld node point with agg
                  max, a graph-task point) and exp/runner's run_batch
                  runs them one process at a time through
                  graphgym_tpu_torch.main --mark_done on the card for 3
                  epochs; exp/agg's agg_batch aggregates them.  Fails
                  unless no config failed, each was renamed _done, each
                  job's log names the CUDA device, every loss is finite,
                  every val accuracy in [0, 1] and val_best.csv has a row
                  a run.
  model_planted — graph_ws500's model check with a wrong K1 planted in
                  its pooling (planted_faults): the forward's walk one
                  slot short of each row, and the backward's output
                  times 1 + 2^-8; each must fail, the second by the
                  float64 witness; their messages.
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
                  and its backward); on the 500-node paths' packs too
                  (rows of 500 slots: a graph's nodes or ego centers),
                  and on idgraph_enzymes'.
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
  6, of them 2 and 1 on the pack, all at D = 128) and linkid_ba
  (link.txt:21-34 on configs/idgcn_ba.yaml at gatidconv, the parity
  tool's point: the 64-copy edge-net union of ~131 k nodes a batch of
  32, 3 train batches; K3 30 per train step, 20 of them row sums at
  width 1, and the SDDMM 5; K3 10 (5) and no SDDMM per eval batch); the
  kernel phase also holds K1 on the gather packs (check_gather_k1);
  seeded random features in the model check.
  The ID-GNN paper's real-dataset points, after linkid_ba:
  raw_files     — Cora's Planetoid files (ind.cora.*: scipy CSR
                  features, a defaultdict graph, Python 2 pickles) and
                  ENZYMES' TU text files written into RAW_DIR at the
                  published sizes, content drawn from seed 0 with numpy
                  (graphgym_tpu_torch/data/standins.py; the real files
                  are not in the repository), parsed by the port's
                  load_planetoid and load_tu, each timed, and held to
                  those sizes;
  then through drive_path's phases cora_gatid (grids/IDGNN/node.txt:
  22-34 on configs/idgcn_Cora.yaml: PyG Cora, transductive, the class
  labels, the ego union at r = 2 of ~131 k nodes a split with 1,433
  features; gatidconv, 2 layers: K3 12 per train step (8 row sums at
  width 1) and the SDDMM 2, K3 4 (2) per eval batch) and
  idgraph_enzymes (graph_enzyme.txt:21-33 at gcnidconv on
  configs/idgcn_ENZYMES.yaml: TU_ENZYMES' 600 graphs, the graph task,
  ego at r = 3, 4 train batches of 128 graphs an epoch, re-collated on
  the prefetch thread; K1 8 per train step and 4 per eval batch at 128,
  the add pooling of the ego centers 2 and 1 of them; the model check
  on the first 32 train graphs); their own features in the model
  check.
  OGB raw directories (A13c's second half), after them:
  ogb_files     — ogbg-molhiv's and ogbn-arxiv's raw directories
                  (raw/*.csv.gz and split/) written into OGB_DIR at the
                  published sizes by data/standins.py, each timed and
                  held to those sizes, and molhiv's cut (MOLHIV_CUT);
  then through drive_path's phases ogbg_molhiv_gcnid (graph_ogb.txt:
  21-33 at gcnidconv on configs/design/design_v2ogb.yaml: the Atom
  encoder and its BN at 300, ego at r = 3 over an eighth of the
  molecules (MOLHIV_CUT: 5,141, for the script's time), 33 train
  batches of 128 an epoch; K1 8 per train step and 4 per
  eval batch at 300, the add pooling of the ego centers 2 and 1 of
  them, K1 also held on that pooling pack; K2 1 per train step, the
  encoder tables' gradient, held on the Atom encoder's embedding pack
  with its library calls and the one-hot product) and
  ogbn_arxiv_design (configs/design/design_v2.yaml on ogbn-arxiv, full
  batch, the official time split: K1 4 and 2 at 256 on the 'plain'
  pack; the model check on the subgraph of the first 40,000 papers),
  the processed splits kept in the dataset cache (OGB_CACHE) after the
  first load;
  samplers_arxiv — the arxiv point trained 2 epochs with each
                  train.sampler (neighbor, saint_node, saint_edge,
                  saint_rw, random_node, cluster; train.iter_per_epoch
                  cut, SAMPLER_ITERS) and with train.sample_node: each
                  epoch's draws, host seconds, signatures and captures,
                  finite losses, K1's launches held exactly;
  model_bond    — the Bond edge encoder on a TU set with edge labels
                  (BOND_TU; ENZYMES has none): model_phase's card vs
                  CPU check of the ENZYMES graph point at gcnconv with
                  dataset.edge_encoder, the edge BN's statistics
                  included.
  ego_union     — (after ogb_files) the native ego-net union
                  (native/graph_native.cpp through data/transforms.
                  ego_nets) against its numpy plain version on
                  MOLHIV_CUT's molecules at r = 3, every union equal
                  array for array, both timed (the native at least 5x
                  the numpy's speed); the native union alone on all of
                  the stand-in's molecules; the native betweenness on
                  ba500's first graph against the Python loop, bitwise,
                  both timed.  Host seconds on the card machine's CPU.
  ginconv_ba_gcn_noself — (after the ba paths) the GIN aggregation
                  ablation (cfg.gnn.gin_agg, results/ablation_gin):
                  configs/ginconv_ba.yaml (Tfg-ginconv, 3 x 128, batch
                  48) with gin_agg gcn_noself through drive_path's
                  phases: K1 on the 'gcn_noself' pack, 5 per train step
                  (1 at D = 1) and 3 per eval batch (1), as ID-GIN ba on
                  'plain'; then model_ginconv_ba_gcn and _mean, card vs
                  CPU on its val batch without a training (K1 8 on
                  'gcn' and 'wmean'); then ginconv_ba_sum_beside: the
                  same batch under gin_agg sum ('plain') and gcn_noself,
                  K1 on each fwd pack at 128 timed in turn over three
                  rounds, and each config's captured replay ms.
  remat         — (after the 500-node paths) tpu.remat: design_ws's
                  point (BN, dropout 0.3) trained 5 captured steps by a
                  trainer without remat and two with it, all from one
                  seed: losses, gradients, parameters, BN statistics
                  and the dropout generator's end state bitwise equal;
                  K1 6 a train step without remat, 9 with it (each MP
                  layer's forward again in the backward); then
                  idgraph_ba500's loaded train batch without and with
                  remat, one trainer freed before the other: each one's
                  peak device memory, capture and replay wall ms (K1 6
                  and 8 a step).
  bf16_models   — (after the edge models) check_model at bf16 on
                  ID-GAT ws, design_sf_max, edge_general and the molhiv
                  cut, the card side's launches by input dtype; each
                  path's kernels on bf16 input against their plain
                  versions and timed beside their bounds (K3 and the
                  SDDMM on 'att', the max on 'plain', K2 on 'edge', K1
                  on 'gcn' and K2 on the Atom pack); ID-GCN ba's replay
                  ms and peak memory at f32 and bf16.
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
  (ID-GIN ba's 1000-epoch runs go through the parity tool, in calls of
  their own: python -m graphgym_tpu_torch.exp.parity --configs
  configs/idgin_ba.yaml --repeat 3 ...)
  Kernel K2 off its path (its path: ogbg_molhiv_gcnid's encoder):
 20. kernel_seg  — at the train 'plain' fwd pack of ID-GIN, D = 128: K2
                   against its plain version with a random message on
                   every slot (padding slots included), against K1 with
                   msg = x[senders] * w, in bfloat16, on a pack built
                   with group G = 2; bitwise-repeatable launches;
                   segment_matmul_vjp's gradient against the plain
                   version's; kernel, plain and library (index_add_,
                   torch.sparse.mm of the 0/1 slot matrix) times beside
                   the bound, the launch floor, bf16, and one timer
                   over the kernel, torch.sparse.mm and K1 on the same
                   arrangement (k2_yardsticks; so on every K2 check).
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
                   H = 8, dh = 16, held and timed the same way (the
                   SDDMM beside its launch floor); the
                   segmented max forward on the fwd pack and its
                   backward on the bwd pack at D = 128, held and timed
                   as in kernel_max (no path runs it there: the case of
                   ws500 / ba500's 500-slot pooling rows, and longer);
 22. bench_runs  — the entry points with exact launch counts: bench.main
                   (K1 2 per fwd_bwd step, 1 per fwd step), the bf16 chain,
                   bench_attention (K3 6 per step, 4 of them row sums
                   at width 8, and SDDMM 1; gradients
                   of two calls bitwise equal; card vs CPU on a small
                   graph), bench_train_epoch of the four ws paths
                   (captured steps after two warm-up epochs) and
                   bench_tu_epoch on the ENZYMES stand-in (gcnconv, 8
                   batches an epoch: K1 8 per step), rates and epoch
                   times as median and IQR; then one run each of the
                   suite's other modes: ID-GCN's epoch at impl xla (K2 9
                   a step, no K1) and in bf16 (K1 6), the TU epoch at
                   xla (K2 9, the pooling's K1 2).
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
pooling forward and backward on their pooling packs; K3, its row sums
and the SDDMM on the round1att paths' 'att' packs at 256; K1 at D = 6
on appnp_ws's 'gcn' pack; K1 and the max on the model-only checks'
packs; K1 on the link and edge paths' layer packs and on their gather
packs; K3, its row sums and the SDDMM on linkid_ba's 'att' pack and on
cora_gatid's; K1 on idgraph_enzymes' layer pack and its pooling
packs; K1 on the molhiv ID point's 'gcn' pack and its add pooling at
300, K2 on its Atom encoder's embedding pack, K1 on the arxiv design
point's 'plain' pack at 256; each kernel on bf16 input on its bf16
path's pack, with its launches there on bf16 input; K2 on the COO
route's indexes), and last the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import collections
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
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_PHASE = ["import"]   # the phase running now, named in a failure line
T0 = time.perf_counter()


class CheckFailed(Exception):
    """A check's failure while a planted fault runs (``planted_faults``)."""


_PLANTED = [False]    # True while a planted fault runs: fail() raises


def fail(msg: str) -> None:
    """Print why the run failed as one JSON line on stdout (and on
    stderr), then exit 1; raise CheckFailed instead while a planted
    fault runs."""
    if _PLANTED[0]:
        raise CheckFailed(msg)
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
    from graphgym_tpu_torch import native
    from graphgym_tpu_torch.config import load_cfg
    from graphgym_tpu_torch.data.loaders import create_dataset, create_loader
    from graphgym_tpu_torch.device import resolve_device
    from graphgym_tpu_torch.exp import parity
    from graphgym_tpu_torch.exp import remat_cost
    from graphgym_tpu_torch.exp.corpus_time import corpus_digest
    from graphgym_tpu_torch.graphs.packing import (BOND_FEATURE_DIMS,
                                                   EDGE, EDGE_BOND,
                                                   EDGE_CONVS, EDGE_DST,
                                                   EDGE_ENCODER,
                                                   EDGE_SRC, EMBED_KINDS,
                                                   EMBED_TABLES, LABELS,
                                                   NODE_ENCODER, PAIRS,
                                                   POOLINGS,
                                                   build_pool_packs,
                                                   coo_recv_index,
                                                   coo_send_index,
                                                   edge_index, embed_index,
                                                   gin_kind, kinds_for_cfg,
                                                   pool_kind)
    from graphgym_tpu_torch.main import run_single
    from graphgym_tpu_torch.nn import model as M
    from graphgym_tpu_torch.nn.att_layers import SAGEInitConv
    from graphgym_tpu_torch.nn.coo import COO_DEGREE, COO_GRAD, COO_SUM
    from graphgym_tpu_torch.nn import encoders as ENC
    from graphgym_tpu_torch.nn import layers as LY
    from graphgym_tpu_torch.nn.model import build_model
    from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
    from graphgym_tpu_torch.train import checkpoint as ckpt
    from graphgym_tpu_torch.train.graphed import forward
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
# the ID-GNN graph grid's 500-node corpora (grids/IDGNN/graph.txt:37,52),
# regenerated from seed 0 beside the earlier phases: each one's graph
# count and digest over its edge lists (the rejection loop's 51,200
# attempts; every graph lands in the path-length histogram's clipped top
# row, so neither reaches the 256 asked)
CORPUS500_DIR = os.path.join(ROOT, "graphgym_tpu_torch", "csrc", "build",
                             "corpus500")
CORPUS500 = {"ws500": (28, "d51d19e85d5b5fc6468121c026c2eecaf"
                           "b4c3c24fd84eee3c42dac224faef86d"),
             "ba500": (32, "d88b42103842ff39888113d909a9087d"
                           "2bbef269fc4bb1e8cd31d450b6a7fa92")}
CHILDREN = []   # processes this script starts, killed at its exit
# the design_v1 point of results/design_v1_grid_round1 (scalefree, node
# task, generalconv at 256): design_sf's overrides
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
# epochs only in the parity tool (full_linkid_ws)
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
IDGRAPH_BA = ("dataset.task", "graph", "dataset.transductive", "False",
              "dataset.transform", "ego", "dataset.augment_feature", "[]",
              "dataset.augment_label", "graph_clustering_coefficient",
              "gnn.layers_pre_mp", "1", "gnn.layers_mp", "3",
              "gnn.layers_post_mp", "3", "gnn.layer_type", "gcnidconv")
# that grid's synthetic chunks at their own size, the parity tool's
# points (base config, overrides): the ID chunk's gcnidconv on ba500 (ego
# at r = 3, its centers pooled) and the plain chunk's gatconv with
# node_identity features on ws500 (500 nodes pooled a graph)
# design_ws's point on configs/idgcn_ws.yaml (at ginidconv): PReLU,
# skipsum, dropout 0.3 (BatchNorm on, the config's)
DESIGN_WS = ("gnn.act", "prelu", "gnn.stage_type", "skipsum",
             "gnn.dropout", "0.3")
IDGRAPH_BA500 = parity.POINTS["idgraph_ba500"]
# idgraph_ba500 runs here at 2 MP layers (ego nets at r = 2, the layers'
# depth), the script's time: at the grid's 3 its ego union (~2.1 M
# nodes) and the CPU side of its model check took ~20% of a run
IDGRAPH_BA500_DEPTH = ("gnn.layers_mp", "2")
GRAPH_WS500 = parity.POINTS["graph_ws500"]
# grids/design/round1att.txt's synthetic chunks on scalefree, the parity
# tool's points: gmulconv on the node chunk, gaddconv on the graph chunk
ATT_SF_MUL = parity.POINTS["design_att_sf_mul"]
ATT_SF_ADD_GRAPH = parity.POINTS["design_att_sf_add_graph"]
# grids/IDGNN/link.txt:21-34's ID point on ba at gatidconv, the parity
# tool's point (its grid's 100 epochs there, EPOCHS here)
LINKID_BA = parity.POINTS["linkid_ba"]
# the ID-GNN paper's real-dataset points (parity.POINTS): node.txt:22-34
# on Cora and graph_enzyme.txt:21-33 at gcnidconv on TU_ENZYMES, each on
# a stand-in written in its dataset's published raw format at the
# published sizes (graphgym_tpu_torch/data/standins.py, seed 0) into the
# git-ignored RAW_DIR
RAW_DIR = os.path.join(ROOT, "graphgym_tpu_torch", "csrc", "build", "raw")
CORA_GATID = parity.POINTS["cora_gatid"]
IDGRAPH_ENZYMES = parity.POINTS["idgraph_enzymes"]
# git-ignored OGB_DIR: the OGB stand-ins (data/standins.py, seed 0, the
# published sizes), the TU set of the Bond check, and the dataset cache
# of their processed splits (the molhiv ego union is built once and
# read back by the later phases: OGB_CACHE)
OGB_DIR = os.path.join(ROOT, "graphgym_tpu_torch", "csrc", "build", "ogb")
# ogbg_molhiv_gcnid runs the molhiv stand-in cut to an eighth of its
# molecules (the same writer, the per-molecule shape unchanged), in
# OGB_CUT_DIR: at all 41,127 the ego union took 40.0-52.6 s of host time
# and an epoch of 258 batches 11.6-16.5 s, host-bound (PR 20's calls 1-2),
# which the script's time does not hold; the parity tool runs the set
OGB_CUT_DIR = os.path.join(OGB_DIR, "cut")
MOLHIV_CUT = dict(graphs=5141, split=(4113, 514, 514))
MOLHIV_ID = parity.POINTS["ogbg_molhiv_gcnid"]
ARXIV_DESIGN = parity.POINTS["ogbn_arxiv_design"]
OGB_CACHE = ("dataset.cache_save", "True", "dataset.cache_load", "True")
# ogbn_arxiv_design's model check: the subgraph of the first 40,000
# papers (all in the train split), full width; on the whole graph its
# CPU side took 23.6-31.3 s (PR 20's calls)
ARXIV_MODEL_NODES = 40000
# samplers_arxiv: each sampler's draws an epoch, train.iter_per_epoch
# cut from its 32 for the phase's time (neighbor's four hops from 256
# seeds reach 98% of the graph, 4.3 s a draw: one draw)
SAMPLER_ITERS = {"neighbor": 1, "saint_node": 4, "saint_edge": 4,
                 "saint_rw": 4, "random_node": 4, "cluster": 4}
# model_bond: a TU set with edge labels (ENZYMES has none), its ego
# graph point with the Bond edge encoder
BOND_TU = dict(graphs=120, nodes=3000, edges=6000, min_nodes=8,
               max_nodes=60, large=0, attributes=4, edge_labels=4)
# the edge-feature convs' paths: configs/design/design_v2ogb.yaml's model
# (1 pre-MP, 5 MP, 1 post-MP layers at 300, BN, PReLU, add pooling,
# batch 128, Adam at 0.01) on the BONDS stand-in that model_bond writes
# (its four edge label columns one-hot, the convs' edge features), no
# encoders, no ego transform (it would misalign the edge features)
EDGE_MODEL = "design/design_v2ogb"
EDGE_BONDS = ("dataset.format", "PyG", "dataset.name", "TU_BONDS",
              "dataset.transform", "none", "dataset.node_encoder", "False",
              "dataset.edge_encoder", "False", "dataset.split",
              "[0.8, 0.1, 0.1]")
# sweep_round1: grids/design/round1.txt sampled along 'agg' at this
# sample_num, budget-matched to configs/design/design_v1.yaml (24
# configs, 18 of them on the nx chunks), of which three run
SWEEP_SAMPLE_NUM, SWEEP_ALIASES = 8, ("agg",)
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
    stdout and appended to OUT/phases.jsonl (the trainings' logs push
    early lines out of a short tail)."""
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


def kernel_records(events) -> dict:
    """Each kernel's count of records in a profile."""
    return {ev.key: ev.count for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)}


def holds_every_launch(events, iters: int) -> bool:
    """Whether a profile of ``iters`` calls kept each kernel's records of
    every call: some kernel recorded, each name's count a multiple of
    ``iters``.  A profile that did not is noted in LOSSY_PROFILES."""
    counts = kernel_records(events)
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
    """K1's launch floor (``launch_floor_times``); out has the pack's
    rows."""
    out = torch.empty(pack.row_range.shape[0], x.shape[1],
                      dtype=torch.float32, device=x.device)
    return launch_floor_times(k1_floor(pack, x, out))


def launch_floor_times(launch) -> dict:
    """A launch floor's device ms per call (time_calls), its CUDA-event
    loop time, how it was timed and its queued time."""
    ms, loop_ms, timed_by, queued = time_calls({"floor": launch},
                                               bound_ms=1e-9)
    return dict(floor_ms=ms["floor"], floor_call_ms=loop_ms["floor"],
                floor_timed_by=timed_by["floor"],
                floor_queued_ms=queued["floor"])


def timings(calls: dict, pack: K.PackedCSR, x: torch.Tensor,
            slot_bytes: int) -> dict:
    """Device ms per call of the kernel and, where given, the plain
    version and the library call, their CUDA-event loop times, and the
    bound: each input read once (the rows of x the live slots name, the
    pack's slot_bytes on each slot the kernel reads, row_range), the f32
    output written once, over the card's memory rate, against 2 flops
    per slot and column over its f32 rate."""
    return dict(**bounded_times(calls, *timings_moved(pack, x, slot_bytes)),
                slots=pack.senders.numel(), real_slots=real_slots_of(pack))


def timings_moved(pack: K.PackedCSR, x: torch.Tensor, slot_bytes: int):
    """(bytes, flops) of a row walk at x's width and dtype: the rows of x
    the live slots name read once, the pack's slot_bytes on each slot of
    the row ranges, row_range, the f32 output written once; 2 flops per
    slot and column."""
    n, d = x.shape
    real_slots = real_slots_of(pack)
    return (live_rows(pack, n) * d * x.element_size()
            + real_slots * slot_bytes + pack.row_range.numel() * 4
            + n * d * 4), 2 * real_slots * d


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
    [N, H, dh]: the rows of a (the rows of the live slots) and of b (the
    live slots' senders) read once, a sender and a weight on each slot
    of the row ranges, row_range, the f32 [NC, C, H] output written on
    every slot; 2 flops per real slot and column."""
    n, heads, dh = a.shape
    real_slots = real_slots_of(pack)
    live = (pack.weights.reshape(-1) != 0) \
        & (pack.senders.reshape(-1).long() < n)
    a_rows = int(torch.unique(K.pack_rows(pack).reshape(-1)[live]).numel())
    moved = ((a_rows + live_rows(pack, n)) * heads * dh * a.element_size()
             + real_slots * 8
             + pack.row_range.numel() * 4
             + pack.senders.numel() * heads * 4)
    return moved, 2 * real_slots * heads * dh


def sddmm_floor(pack: K.PackedCSR, a: torch.Tensor, b: torch.Tensor):
    """The launch floor under the SDDMM (csrc/packed_sddmm.cu,
    packed_sddmm_floor_*): an empty kernel over the grid the SDDMM takes
    for these arguments (a run of slots an owner), launched with the
    wrapper's arguments.  Counts no launch of the SDDMM."""
    n, heads, dh = a.shape
    suffix = "f32" if a.dtype == torch.float32 else "bf16"
    fn = getattr(K.library("packed_sddmm"), f"packed_sddmm_floor_{suffix}")
    fn.argtypes = K._ARGTYPES["packed_sddmm"]
    fn.restype = ctypes.c_int
    a2, b2 = (t.reshape(n, heads * dh).contiguous() for t in (a, b))
    out = torch.empty(pack.senders.shape + (heads,), dtype=torch.float32,
                      device=a.device)
    args = (a2.data_ptr(), b2.data_ptr(), n, heads * dh, heads,
            pack.senders.data_ptr(), pack.weights.data_ptr(),
            pack.local_rows.data_ptr(), pack.tiles.data_ptr(),
            pack.senders.numel(), out.data_ptr())

    def launch(keep=(a2, b2, out)):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"SDDMM floor launch: CUDA error {err}")
    return launch



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


def softmax_miss(pack: K.PackedCSR, cpu_pack: K.PackedCSR,
                 logits: torch.Tensor, g: torch.Tensor, card: dict,
                 cpu: dict, what: str) -> dict:
    """Where ``check_softmax``'s card and CPU results part, for its
    failure line (ROADMAP C6): the entries beyond F32_TOL and their
    rows; the slot, head and row of the largest miss, the row's slot
    range and, over it, the logits and both sides' results; whether the
    card's pack still equals the CPU's copy of it; and a second CPU run
    from fresh copies of the card's inputs against both results (which
    side moved)."""
    heads = logits.shape[-1]
    off = ~torch.isclose(card[what], cpu[what], **F32_TOL)
    worst = int((card[what] - cpu[what]).abs().argmax())
    slot, head = divmod(worst, heads)
    rows = K.pack_rows(cpu_pack).reshape(-1)
    row = int(rows[slot])
    lo, hi = cpu_pack.row_range[row].tolist()
    x = logits.cpu().requires_grad_(True)
    alpha = K.packed_segment_softmax(x, K.PackedCSR(*(a.cpu()
                                                      for a in pack)))
    alpha.backward(g.cpu())
    again = {"values": alpha.detach(), "gradient": x.grad}[what]

    def over_row(t):
        return t.reshape(-1, heads)[lo:hi, head].tolist()
    return dict(entries=int(off.sum()),
                rows=int(rows[off.reshape(-1, heads).any(1)].unique().numel()),
                slot=slot, head=head, row=row, row_range=[lo, hi],
                logits=over_row(x.detach()), card=over_row(card[what]),
                cpu=over_row(cpu[what]),
                pack_unchanged=all(torch.equal(a.cpu(), b)
                                   for a, b in zip(pack, cpu_pack)),
                fresh_cpu_vs_card=(again - card[what]).abs().max().item(),
                fresh_cpu_vs_cpu=(again - cpu[what]).abs().max().item())


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
        card, again, cpu = ({"values": a, "gradient": d} for a, d in runs)
        if not all(torch.equal(card[k], again[k]) for k in card):
            fail(f"softmax H = {heads}: two runs on the card differ")
        for what in card:
            x, y = card[what], cpu[what]
            if not torch.allclose(x, y, **F32_TOL):
                fail(f"softmax H = {heads} {what}: card vs CPU max err "
                     f"{(x - y).abs().max().item()} beyond {F32_TOL}; "
                     + json.dumps(softmax_miss(pack, cpu_pack, logits, g,
                                               card, cpu, what)))
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
        out[f"h{heads}"] = dict(
            **bounded_times(calls, *sddmm_bound(pack, a)),
            **launch_floor_times(sddmm_floor(pack, a, b)))
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


def cpu_index(index: K.SegmentIndex) -> K.SegmentIndex:
    return K.SegmentIndex(*(None if a is None else a.cpu() for a in index))


def k2_floor(msg: torch.Tensor, index: K.SegmentIndex):
    """The launch floor under K2 (csrc/packed_segment.cu,
    packed_segment_floor_*): an empty kernel over the grid K2 takes for
    these arguments.  Counts no launch of K2."""
    suffix = "f32" if msg.dtype == torch.float32 else "bf16"
    fn = getattr(K.library("packed_segment"),
                 f"packed_segment_floor_{suffix}")
    fn.argtypes = K._ARGTYPES["packed_segment"]
    fn.restype = ctypes.c_int
    args = (msg.data_ptr(), msg.shape[0], msg.shape[1], None, None,
            index.row_ptr.numel() - 1, None, None, None,
            index.run_row.numel(), None, None, None)

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"K2 floor launch: CUDA error {err}")
    return launch


def index_matrix(index: K.SegmentIndex, n_src: int) -> torch.Tensor:
    """The 0/1 [n_out, n_src] CSR matrix of K2's index (a row's entry at
    each summed position's source, repeats summed): its product with
    the messages [n_src, D] is K2's function on the same inputs."""
    positions = (index.src.numel() if index.src is not None
                 else int(index.row_ptr[-1]))
    rows = K.index_rows(index, positions)
    cols = (index.src.long() if index.src is not None
            else torch.arange(positions, device=rows.device))
    n_out = index.row_ptr.numel() - 1
    summed = (rows < n_out) & (cols < n_src)   # none left out
    return torch.sparse_coo_tensor(
        torch.stack([rows[summed], cols[summed]]),
        torch.ones(int(summed.sum()), device=rows.device),
        (n_out, n_src)).coalesce().to_sparse_csr()


def k1_arrangement(index: K.SegmentIndex, n_src: int) -> K.PackedCSR:
    """K1's pack of K2's arrangement (a yardstick): a row per output
    row, a slot per position, its sender the position's message row,
    weight 1, so K1 on the messages computes K2's function (each
    product by 1 exact), one owner a row."""
    cpu = cpu_index(index)
    positions = cpu.src.numel() if cpu.src is not None else n_src
    summed = int(cpu.row_ptr[-1])                 # none left out
    rows = K.index_rows(cpu, positions).numpy()[:summed]
    src = (cpu.src.numpy() if cpu.src is not None
           else np.arange(positions, dtype=np.int32))[:summed]
    pack, _ = native.pack_csr_with_slots(src, rows, None,
                                         cpu.row_ptr.numel() - 1,
                                         num_senders=n_src, slots=False)
    return K.PackedCSR(*(torch.from_numpy(a).to(index.row_ptr.device)
                         for a in pack))


def k2_checks(case: str, msg: torch.Tensor, index: K.SegmentIndex) -> dict:
    """K2 against its plain version on the CPU (hold_sums' rule; the rows
    one owner sums, at most OWNER_SLOTS positions, bitwise) and bitwise
    between two
    launches, in f32 and bf16."""
    out = {}
    cpu = cpu_index(index)
    short = torch.from_numpy(np.diff(cpu.row_ptr.numpy()) <= K.OWNER_SLOTS)
    for name, m in (("f32", msg), ("bf16", msg.bfloat16())):
        got = K.segment_sum_cuda(m, index)
        want = K.segment_sum_plain(m.cpu(), cpu)
        out[f"{name}_err"] = hold_sums(
            f"{case} {name}", got.cpu(), want,
            K.segment_sum_plain(m.cpu().float().abs(), cpu))
        if not torch.equal(got.cpu()[short], want[short]):
            fail(f"{case} {name}: the rows of one owner "
                 "differ from the plain version's bits")
        if not torch.equal(got, K.segment_sum_cuda(m, index)):
            fail(f"{case} {name}: two launches differ")
    if not torch.equal(index.arrivals, torch.zeros_like(index.arrivals)):
        fail(f"{case}: the run counters were not set back to 0")
    return out


def k2_yardsticks(msg: torch.Tensor, index: K.SegmentIndex, moved: int,
                  bf16_moved: int, flops: int, calls: dict) -> dict:
    """K2's launch floor, its bf16 time and the share of its bound
    (queued CUDA events), and one timer (``interleaved_ms``) over the
    kernel and ``calls`` (torch.sparse.mm of the 0/1 matrix, K1 on the
    same arrangement ...): each median, each round, and whether the
    kernel was the faster in every round."""
    mb = msg.bfloat16()
    one_timer = interleaved_ms(
        {"kernel": lambda: K.segment_sum_cuda(msg, index), **calls})
    rounds = one_timer["rounds_ms"]
    med = one_timer["median_ms"]
    bound_ms = max(moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3
    bf16_bound = max(bf16_moved / HBM_BYTES_PER_S,
                     flops / F32_FLOPS_PER_S) * 1e3
    bf16_ms = queued_ms(lambda: K.segment_sum_cuda(mb, index))
    return dict(
        floor_ms=queued_ms(k2_floor(msg, index)), floor_timed_by="queued",
        bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound,
        bf16_share_of_bound=bf16_bound / bf16_ms,
        interleaved=one_timer, interleaved_ms=med["kernel"],
        interleaved_share_of_bound=bound_ms / med["kernel"],
        **{f"interleaved_{k}_ms": v for k, v in med.items()
           if k != "kernel"},
        faster_every_round={k: all(a < b for a, b in zip(rounds["kernel"],
                                                        rounds[k]))
                            for k in calls})


def index_stats(index: K.SegmentIndex) -> dict:
    counts = np.diff(index.row_ptr.cpu().numpy())
    live = index.run_row >= 0
    return dict(positions=int(counts.sum()), out_rows=len(counts),
                runs=int(live.sum().item()),
                padded_runs=int(index.run_row.numel()),
                run_len_max=int(index.run_len[live].max().item())
                if live.any() else 0,
                long_rows=int((counts > K.OWNER_SLOTS).sum()),
                longest_row_slots=int(counts.max(initial=0)),
                index_bytes=4 * sum(a.numel() for a in index
                                    if a is not None))


def check_segment_kernel(host_batch, pack: K.PackedCSR, n: int, d: int,
                         device) -> dict:
    """K2 at the train 'plain' fwd pack (the TPU contract: every slot
    counts, on the pack's index, its slots stably sorted by row):
    against its plain version with a random message on every slot,
    against K1 with msg = x[senders] * w, in bf16, on a pack built with
    G = 2; bitwise repeats; the vjp's gradient; times, floor, bf16, and
    one timer over the kernel, torch.sparse.mm of the 0/1 slot matrix
    and K1 on the same arrangement.  Returns the launches of the checks
    (the timing loops not counted)."""
    K.packed_segment_matmul_cuda.launches = 0
    gen = torch.Generator(device=device).manual_seed(2)
    local, tiles = pack.local_rows, pack.tiles
    nt = K.num_tiles_of(n)
    t0 = time.perf_counter()
    K.pack_segment_index_host(local.cpu().numpy(), tiles.cpu().numpy(), nt)
    index_s = time.perf_counter() - t0
    index = K.segment_index(local, tiles, nt)

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
    ones = index_matrix(index, rows.numel())
    lib_err = (torch.sparse.mm(ones, flat) - seg(msg)).abs().max().item()
    k1_pack = k1_arrangement(index, rows.numel())
    k1_err = hold_sums("K1 on K2's arrangement", K.spmm_packed(k1_pack, flat),
                       plain(msg), scale)
    calls = {"kernel": lambda: K.packed_segment_matmul_cuda(msg, local,
                                                            tiles, nt),
             "plain": lambda: plain(msg),
             "index_add": lambda: out_lib.index_add_(0, rows, flat),
             "sparse_mm": lambda: torch.sparse.mm(ones, flat)}
    stats = index_stats(index)
    moved = (msg.numel() * msg.element_size()        # every slot once
             + stats["index_bytes"]                    # K2's index
             + nt * K.ROWS_PER_TILE * d * 4)           # out written once
    flops = msg.numel()                                # one add each
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    ms, loop_ms, timed_by, queued = time_calls(calls,
                                               max(t_bytes, t_ops) * 1e3)
    library = min(("index_add", "sparse_mm"), key=ms.get)
    yard = k2_yardsticks(
        flat, index, moved, moved - msg.numel() * 2, flops,
        {"library": lambda: torch.sparse.mm(ones, flat),
         "k1": lambda: K.packed_spmm_cuda(k1_pack, flat)})
    return dict(max_abs_err=errs["random_f32"], errs=errs, launches=launches,
                library_err=lib_err, k1_err=k1_err, ms=ms["kernel"],
                plain_ms=ms["plain"], library_ms=ms[library],
                library=library, index_add_ms=ms["index_add"],
                sparse_mm_ms=ms["sparse_mm"], call_ms=loop_ms,
                timed_by=timed_by, queued_ms=queued,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                share_of_bound=max(t_bytes, t_ops) * 1e3 / ms["kernel"],
                bytes=moved, flops=flops, slots=rows.numel(), **stats,
                index_build_s=index_s, **yard)


def check_embed_kernel(pack, table_rows: int, d: int, device,
                       live_items) -> dict:
    """K2 on an encoder's embedding pack (graphs/packing.
    build_embed_pack, on the card), the tables' gradient of the lookup:
    per table row, the rows of a seeded g [items, d] of its slots'
    items, read in place.  Against its plain version on the CPU
    (``k2_checks``: f32 and bf16, bitwise repeats), and the encoder's
    whole gradient (``table_grad``, now K2 alone) against the plain
    gathers' autograd on the CPU.  Times at f32: the kernel, the plain
    version on the card, torch.sparse.mm of the 0/1 [rows, items]
    matrix with g (the library call of the same function on the same
    inputs), index_add_ and torch.sparse.mm of the 0/1 [rows, slots]
    matrix on the messages gathered in slot order (the route before
    K2 read g in place), the one-hot product count^T @ g
    (``onehot_ms``), the encoder's backward (``backward_ms``); the
    floor, bf16 and one timer over the kernel, the two sparse.mm and K1
    on the same arrangement (``k2_yardsticks``).  The bound: each row
    of g that a live slot names read once (an item of ``live_items``,
    the batch's real nodes or edges, in a slot of a table row; an item
    is named by a slot of each of its columns, and read once), K2's
    index read once, the tables' rows written once."""
    gen = torch.Generator(device=device).manual_seed(4)
    index = embed_index(pack)
    items = pack.rows.shape[0]
    n_out = index.row_ptr.numel() - 1
    g = torch.randn(items, d, generator=gen, device=device)
    K.packed_segment_matmul_cuda.launches = 0
    errs = k2_checks("K2 embedding", g, index)
    # the encoder's gradient: K2 against autograd of the plain gathers
    grad = ENC.table_grad(pack, g, table_rows)
    table = torch.zeros(table_rows + 1, d, requires_grad=True)
    cpu_ids = pack.rows.long().cpu()
    plain = sum(table.index_select(0, cpu_ids[:, c])
                for c in range(cpu_ids.shape[1]))
    (want,) = torch.autograd.grad(plain, table, g.cpu(), retain_graph=True)
    (scale,) = torch.autograd.grad(plain, table, g.abs().cpu())
    grad_err = hold_sums("encoder table gradient", grad.cpu(),
                         want[:table_rows], scale[:table_rows])
    torch.cuda.synchronize()
    launches = K.packed_segment_matmul_cuda.launches
    got = K.segment_sum_cuda(g, index)
    positions = index.src.numel()
    rows = K.index_rows(index, positions)
    msg = g.index_select(0, index.src)
    ones = index_matrix(index, items)
    slot_ones = slot_matrix(rows, n_out)
    count = ones.to_dense()
    out_lib = torch.zeros(n_out, d, device=device)
    lib_err = (torch.sparse.mm(ones, g) - got).abs().max().item()
    onehot_err = (count @ g - got).abs().max().item()
    k1_pack = k1_arrangement(index, items)
    k1_err = hold_sums("K1 on the embedding arrangement",
                       K.spmm_packed(k1_pack, g).cpu(),
                       K.segment_sum_plain(g.cpu(), cpu_index(index)),
                       K.segment_sum_plain(g.abs().cpu(), cpu_index(index)))
    calls = {"kernel": lambda: K.segment_sum_cuda(g, index),
             "plain": lambda: K.segment_sum_plain(g, index),
             "library": lambda: torch.sparse.mm(ones, g),
             "index_add": lambda: out_lib.index_add_(0, rows, msg),
             "sparse_mm_slots": lambda: torch.sparse.mm(slot_ones, msg),
             "onehot_mm": lambda: count @ g,
             "backward": lambda: ENC.table_grad(pack, g, table_rows)}
    stats = index_stats(index)
    live = (torch.as_tensor(np.asarray(live_items), dtype=torch.bool,
                            device=device)[index.src.long()]
            & (rows < table_rows))
    live_slots = int(live.sum())
    live_sources = int(torch.unique(index.src[live]).numel())
    moved = (live_sources * d * 4 + stats["index_bytes"]
             + table_rows * d * 4)
    flops = live_slots * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    ms, loop_ms, timed_by, queued = time_calls(calls,
                                               max(t_bytes, t_ops) * 1e3)
    yard = k2_yardsticks(
        g, index, moved, moved - live_sources * d * 2, flops,
        {"library": lambda: torch.sparse.mm(ones, g),
         "slot_library": lambda: torch.sparse.mm(slot_ones, msg),
         "k1": lambda: K.packed_spmm_cuda(k1_pack, g)})
    return dict(max_abs_err=errs["f32_err"], errs=errs,
                table_grad_err=grad_err, launches=launches,
                library="sparse.mm of the 0/1 [rows, items] matrix",
                library_err=lib_err, onehot_err=onehot_err, k1_err=k1_err,
                ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms["library"], index_add_ms=ms["index_add"],
                sparse_mm_slots_ms=ms["sparse_mm_slots"],
                onehot_ms=ms["onehot_mm"], backward_ms=ms["backward"],
                call_ms=loop_ms, timed_by=timed_by, queued_ms=queued,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                share_of_bound=max(t_bytes, t_ops) * 1e3 / ms["kernel"],
                bytes=moved, flops=flops, width=d, items=items,
                columns=int(pack.rows.shape[1]), table_rows=table_rows,
                live_slots=live_slots, live_sources=live_sources, **stats,
                **yard)


INTERLEAVE_ROUNDS = 7


def interleaved_ms(calls: dict, rounds: int = INTERLEAVE_ROUNDS,
                   iters: int = 20) -> dict:
    """One timer for every call: ``queued_ms`` of each fn (CUDA events
    around a loop queued behind a sleep kernel), the fns taking turns
    round after round, so each side sees the same stretch of the card's
    clocks.  Returns each fn's median over the rounds, and the rounds."""
    per = {k: [] for k in calls}
    for _ in range(rounds):
        for k, f in calls.items():
            per[k].append(queued_ms(f, iters))
    return dict(median_ms={k: float(np.median(v)) for k, v in per.items()},
                rounds_ms=per)


def slot_matrix(rows: torch.Tensor, n_out: int) -> torch.Tensor:
    """The 0/1 [n_out, slots] CSR matrix of a slot -> row index: its
    product with messages [slots, D] gathered in slot order is K2's
    function."""
    n = rows.numel()
    return torch.sparse_coo_tensor(
        torch.stack([rows.long(), torch.arange(n, device=rows.device)]),
        torch.ones(n, device=rows.device), (n_out, n)).coalesce() \
        .to_sparse_csr()


def check_edge_kernel(entry, graph, n: int, d: int, device) -> dict:
    """K2 on an edge conv's 'edge' entry (graphs/packing.build_edge_pack,
    on the card): seeded per-edge messages [E, d] (0 on the padding
    edges, as the layers give them, which the index leaves out) summed
    per receiver by K2 on the entry's index of the edges, read in place
    (``k2_checks``: against
    the plain version on the CPU, f32 and bf16, bitwise repeats); the
    layers' Function (``segment_sum_vjp``) forward and its gradient (the
    gather g[receiver]) against the CPU's, the gradient bitwise.  Times:
    the kernel, its plain version and torch.sparse.mm of the 0/1
    [nodes, edges] matrix with the messages (the library call of the
    same function on the same inputs), by ``time_calls``; the floor,
    bf16 and one timer over the kernel, that sparse.mm, sparse.mm of
    the 0/1 [rows, slots] matrix of the pack's slots on the messages
    copied into slot order (the route before the index read them in
    place) and K1 on the same arrangement (the 'edge' pack with the slots' edges as senders
    and their liveness as weights, as ``edge_max_packs`` builds its fwd
    pack), ``k2_yardsticks``.  The bound: the
    real edges' messages read once, K2's index read once, the n node
    rows written once."""
    fwd, slots = entry
    gen = torch.Generator(device=device).manual_seed(6)
    index = edge_index(slots)
    e = index.src.numel()
    live = graph.edge_weight != 0
    msg = torch.randn(e, d, generator=gen, device=device) * live[:, None]
    K.packed_segment_matmul_cuda.launches = 0
    errs = k2_checks("K2 edge", msg, index)
    got = K.segment_sum_cuda(msg, index)
    g = torch.randn(n, d, generator=gen, device=device)
    outs = []
    for m, idx, recv in ((msg, index, slots.edge_row),
                         (msg.cpu(), cpu_index(index),
                          slots.edge_row.cpu())):
        m = m.clone().requires_grad_(True)
        out = K.segment_sum_vjp(m, idx, recv, n)
        out.backward(g.to(m.device))
        outs.append((out.detach().cpu(), m.grad.cpu()))
    cpu = cpu_index(index)
    vjp_err = hold_sums("K2 edge vjp forward", outs[0][0], outs[1][0],
                        K.segment_sum_plain(msg.cpu().abs(), cpu)[:n])
    if not torch.equal(outs[0][1], outs[1][1]):
        fail("K2 edge vjp: the gradient differs from the CPU's")
    torch.cuda.synchronize()
    launches = K.packed_segment_matmul_cuda.launches
    ones = index_matrix(index, e)
    lib_err = (torch.sparse.mm(ones, msg) - got).abs().max().item()
    # the older route: the messages in slot order, every slot of the pack
    msg_slots = K.take_padded(msg, slots.slot_edge.reshape(-1))
    slot_ones = slot_matrix(K.pack_rows(fwd).reshape(-1), n)
    k1_pack = fwd._replace(senders=slots.slot_edge,
                           weights=K.take_padded(live.float(),
                                                 slots.slot_edge))
    k1_err = hold_sums("K1 on the edge arrangement",
                       K.spmm_packed(k1_pack, msg).cpu(),
                       K.segment_sum_plain(msg.cpu(), cpu),
                       K.segment_sum_plain(msg.cpu().abs(), cpu))
    calls = {"kernel": lambda: K.segment_sum_cuda(msg, index),
             "plain": lambda: K.segment_sum_plain(msg, index),
             "library": lambda: torch.sparse.mm(ones, msg)}
    stats = index_stats(index)
    live_slots = int(live.sum())
    moved = live_slots * d * 4 + stats["index_bytes"] + n * d * 4
    flops = live_slots * d
    times = bounded_times(calls, moved, flops)
    yard = k2_yardsticks(
        msg, index, moved, moved - live_slots * d * 2, flops,
        {"library": lambda: torch.sparse.mm(ones, msg),
         "slot_library": lambda: torch.sparse.mm(slot_ones, msg_slots),
         "k1": lambda: K.packed_spmm_cuda(k1_pack, msg)})
    return dict(max_abs_err=errs["f32_err"], errs=errs, vjp_err=vjp_err,
                launches=launches,
                library="sparse.mm of the 0/1 [nodes, edges] matrix",
                library_err=lib_err, k1_err=k1_err, width=d,
                pack_slots=int(fwd.senders.numel()), edges=e,
                real_edges=live_slots,
                share_of_bound=times["bound_ms"] / times["ms"],
                **stats, **times, **yard,
                interleaved_ratio=(yard["interleaved_ms"]
                                   / yard["interleaved_library_ms"]))


class CardLive:
    """Records the edges each generalsampleedgeconv call keeps on the
    card (``GeneralEdgeConv.live_edges``), in call order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.real = LY.GeneralEdgeConv.live_edges

        def record(mod, graph):
            live = self.real(mod, graph)
            self.calls.append(live.cpu())
            return live
        LY.GeneralEdgeConv.live_edges = record
        return self

    def __exit__(self, *exc):
        LY.GeneralEdgeConv.live_edges = self.real


class SameLive:
    """Gives the CPU reference's generalsampleedgeconv calls the card's
    kept edges, in call order: the two sides draw from generators of
    different devices."""

    def __init__(self, card_calls: list):
        self.card = card_calls
        self.calls = 0

    def __enter__(self):
        self.real = LY.GeneralEdgeConv.live_edges

        def same(mod, graph):
            if self.calls == len(self.card):
                fail(f"the CPU drew more than the card's {self.calls} "
                     "edge samples")
            live = self.card[self.calls]
            self.calls += 1
            return live
        LY.GeneralEdgeConv.live_edges = same
        return self

    def __exit__(self, *exc):
        LY.GeneralEdgeConv.live_edges = self.real


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


def max_library(fwd: K.PackedCSR, x: torch.Tensor, g: torch.Tensor,
                out: torch.Tensor, case: str) -> tuple:
    """The segmented max's library calls: scatter_reduce(amax) over the
    f32 messages w * x (``max_messages``) gathered before the timing,
    and that call's backward (the gradient of each gathered message, a
    tie split evenly, without the sum of the messages' gradients into
    dx).  Fails unless the forward equals the kernel's ``out``."""
    rows, d = out.shape
    msg, msg_rows = max_messages(fwd, x)
    index = msg_rows[:, None].expand(-1, d)
    msg = msg.requires_grad_()
    lib_out = torch.zeros(rows, d, device=x.device).scatter_reduce(
        0, index, msg, "amax", include_self=False)

    def library():
        with torch.no_grad():
            return torch.zeros(rows, d, device=x.device).scatter_reduce_(
                0, index, msg, "amax", include_self=False)

    def library_bwd():
        return torch.autograd.grad(lib_out, msg, g, retain_graph=True)[0]
    if not torch.equal(library(), out):
        fail(f"{case}: scatter_reduce(amax) differs from the kernel")
    return library, library_bwd


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
    library, library_bwd = max_library(fwd, x, g, out, f"max d={d}")
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
            # the f32 sums of the kernel's products: its weights as it
            # takes them against xin (rounded to bf16 for bf16)
            wp = p._replace(weights=K.weight_as(p.weights, xin).float())
            errs[f"{name}_{str(dtype)[6:]}"] = hold_sums(
                case, got, K.spmm_packed_plain(wp, xin.float()),
                K.spmm_packed_plain(wp, xin.float().abs()))
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
                **bounded_times(calls, *sddmm_bound(att, a)),
                **launch_floor_times(sddmm_floor(att, a, b)))


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
    graph, card against CPU, ``bench_train_epoch`` of the four ws
    paths (one batch an epoch) and ``bench_tu_epoch`` on the ENZYMES
    stand-in in RAW_DIR (8 batches an epoch).  Rates and epoch times as
    median and IQR over BENCH_REPEATS."""
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
        result, (launches, by_width, *_) = counted(fn)
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
    # the multi-batch graph task on the ENZYMES stand-in raw_phase wrote:
    # gcnconv, 3 layers, 8 train batches of 64 graphs; K1 2 per layer and
    # the add pooling's 2 per step, one warm-up epoch
    tu_steps = 8 * (1 + EPOCHS) * rep
    runs, launches, _ = run("tu_epoch", lambda: [B.bench_tu_epoch(
        "pallas", EPOCHS, device=device, dataset_dir=RAW_DIR)
        for _ in range(rep)],
        {k1: (8 * tu_steps, f"8/train step x {tu_steps}")})
    if {source for *_, source in runs} != {"ENZYMES"}:
        fail(f"bench tu_epoch ran {[r[2] for r in runs]}, not ENZYMES")
    tu_epoch = dict(epoch_s=median_iqr([r[0] for r in runs]),
                    train_edges_per_s=median_iqr([r[1] for r in runs]),
                    dataset="ENZYMES", launches=launches)
    # the suite's other two modes (A14, A0's COO route), one run each, for
    # time: ID-GCN's epoch at impl xla (K2 9 a step: per layer the degree
    # and the sum forward, the gather's gradient backward; no K1) and at
    # bf16 (K1 6 a step), and the TU epoch at xla (K2 9 and the add
    # pooling's K1 2 a step)
    k2 = K.packed_segment_matmul_cuda
    ws_steps, tu1 = 2 + EPOCHS, 8 * (1 + EPOCHS)
    (xla,), xla_launches, _ = run("idgcn xla", lambda: [B.bench_train_epoch(
        "Tfg-idgcn", "xla", EPOCHS, device=device)],
        {k2: (9 * ws_steps, f"9/train step x {ws_steps}")})
    (bf16_epoch,), bf16_epoch_launches, _ = run(
        "idgcn bf16", lambda: [B.bench_train_epoch(
            "Tfg-idgcn", "pallas", EPOCHS, "bfloat16", device=device)],
        {k1: (6 * ws_steps, f"6/train step x {ws_steps}")})
    (tu_xla,), tu_xla_launches, _ = run("tu_epoch xla", lambda: [
        B.bench_tu_epoch("xla", EPOCHS, device=device, dataset_dir=RAW_DIR)],
        {k2: (9 * tu1, f"9/train step x {tu1}"),
         k1: (2 * tu1, f"2/train step x {tu1} (the pooling)")})
    filled = {"idgcn_ws_epoch_s_xla": xla[0],
              "idgcn_ws_train_edges_per_s_xla": xla[1],
              "idgcn_ws_epoch_s_pallas_bf16": bf16_epoch[0],
              "idgcn_ws_train_edges_per_s_pallas_bf16": bf16_epoch[1],
              "tu_enzymes_epoch_s_xla": tu_xla[0],
              "tu_enzymes_train_edges_per_s_xla": tu_xla[1]}
    if not all(v > 0 for v in filled.values()) or tu_xla[2] != "ENZYMES":
        fail(f"bench: the xla and bf16 modes gave {filled} ({tu_xla[2]})")
    return dict(iters=it, repeats=rep, main=line,
                main_launches=main_launches,
                bf16_fwd_bwd_edges_per_s=median_iqr(bf16),
                bf16_launches=bf16_launches,
                attention_fwd_bwd_edges_per_s=median_iqr(att),
                attention_launches=att_launches,
                attention_launches_by_width=att_by_width,
                attention_grads_bitwise_equal=True,
                attention_small_card_vs_cpu_max_err=small_err,
                train_epochs=epochs, tu_epoch=tu_epoch,
                xla_and_bf16=filled,
                xla_and_bf16_launches={"idgcn_xla": xla_launches,
                                       "idgcn_bf16": bf16_epoch_launches,
                                       "tu_xla": tu_xla_launches})


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


class MatmulSums(TorchFunctionMode):
    """On the CPU reference's train step, each matmul kernel's gradient
    scale: a parameter W in x @ W (a Linear layer's kernel, a
    convolution's) gets the gradient x^T d summed over the rows (d the
    product's gradient), whose sum of |terms| per entry is |x|^T |d|,
    added up over the kernel's uses.  Kept by parameter name."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.names = {id(p): k for k, p in model.named_parameters()}
        self.scale = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = (self.names.get(id(args[1])) if len(args) == 2
                and getattr(func, "__name__", "") in ("matmul", "__matmul__")
                else None)
        if name is not None and out.requires_grad:
            x = args[0].detach().abs()

            def grad(d):
                s = x.t() @ d.detach().abs()
                self.scale[name] = self.scale.get(name, 0) + s
            out.register_hook(grad)
        return out


def f64_witness(cfg, state: dict, batch, kinks: tuple, maxes: tuple,
                lives: tuple = ((), ())) -> dict:
    """The CPU reference in float64: the same parameters (``state``),
    the batch's features in float64, the card's kink and max decisions
    (SameKinks, SameMax; ``kinks`` and ``maxes`` the card's train and
    eval records) and kept edges (SameLive, ``lives``), the batch's
    edge features in float64 too, one train-mode forward and backward
    of the cross
    entropy, then an eval-mode forward, as check_model runs them.  Every
    sum runs in float64, the kernels' plain versions' too; the segmented
    max's messages stay f32, which a max does not round further.
    Returns the train and eval logits, the gradients and the buffers
    under check_model's keys."""
    cpu = torch.device("cpu")
    m = build_model(cfg, cpu)
    m.load_state_dict(state)
    m.double().train()
    b = batch.to(cpu)
    b = b.replace(node_feat=b.node_feat.double(),
                  edge_feat=None if b.edge_feat is None
                  else b.edge_feat.double())
    with SameKinks(kinks[0]), SameMax(maxes[0]), SameLive(lives[0]):
        pred, label, mask = m(b)
        torch.nn.functional.cross_entropy(pred[mask], label[mask]).backward()
    m.eval()
    with torch.no_grad(), SameKinks(kinks[1]), SameMax(maxes[1]), \
            SameLive(lives[1]):
        pred_eval = m(b)[0]
    return dict(train=pred.detach(), eval=pred_eval,
                **{k: p.grad for k, p in m.named_parameters()},
                **dict(m.named_buffers()))


GRAD_TOL = dict(rtol=1e-3, atol=1e-5)    # card vs CPU, gradients
# card vs CPU at tpu.dtype bfloat16, both sides in bf16: a bf16 value
# rounded on either side of a sum that the two programs add in another
# order moves by one bf16 ulp (2^-8 relative), and the ulps carry
# through the layers.  Each path is held at its own tier, set from its
# readings (PERF.md §6, PR 24): the logits, BN statistics and kink and
# max inputs at "logit", the gradients at "grad"; with "witness" an
# entry beyond them is held against the float64 witness by
# BF16_WITNESS (the card within twice the CPU's own bf16 distance from
# float64 on that tensor), without it a miss fails.
#
# BF16_TIGHT, the main path and ID-GAT ws: their card-vs-CPU readings
# are at most 6.1e-5 on the logits and gradients and 4.9e-4 on a kink
# input (the largest 0.36).  A K1 that leaves its weights unrounded
# parts from the CPU by 5.2e-4 on the main path's logits (the largest
# 0.04) and by up to 7.6e-3 on a gradient (that tensor's largest
# 5.2e-2; the CPU's plain versions with and without the rounding).
# rtol holds one or two ulps of any entry, atol five times the sound
# readings; no witness, since an unrounded run lies nearer to float64
# than the CPU does.  ``planted_bf16`` shows that the tier turns the
# unrounded K1 down on the card.
BF16_TIGHT = dict(logit=dict(rtol=1e-2, atol=3e-4),
                  grad=dict(rtol=1e-2, atol=3e-4), witness=False)
# BF16_SF_MAX, design_sf_max (6 max layers at 256 with BatchNorm; its
# messages w * h, and all after them, f32): readings 1.0e-3 on the
# logits (the largest 7.2), 4.9e-4 on the gradients (tensors' largest
# 0.01 to 0.22), 1.0e-2 on a kink input and 7.8e-3 on a max output
# (atol scaled by the call's largest, up to 17): each at least three
# times under this tier.
BF16_SF_MAX = dict(logit=dict(rtol=2e-2, atol=3e-3),
                   grad=dict(rtol=2e-2, atol=2e-3), witness=False)
# BF16_V2OGB, the five-layer design_v2ogb models (edge_general, the
# molhiv cut): readings up to 4.7e-2 on the logits, 1.4e-2 on a
# gradient and 2.0 on a kink input; the CPU's own bf16 gradients part
# from float64 by a large share of the tensor's largest entry, so no
# fixed elementwise tolerance holds them (ROADMAP C: bf16), and the
# witness decides.
BF16_V2OGB = dict(logit=dict(rtol=2e-2, atol=5e-2),
                  grad=dict(rtol=5e-2, atol=5e-3), witness=True)
BF16_WITNESS = 2.0


def check_model(cfg, batch, device, random_features: bool = False,
                compute_dtype=None, bf16_tier=None) -> dict:
    """``_check_model``; with ``compute_dtype`` (cfg.tpu.dtype's) both
    sides run the mixed-precision forward (``forward``: the parameters
    and features cast, the masters and buffers f32) and are held at
    ``bf16_tier`` (BF16_TIGHT, BF16_SF_MAX or BF16_V2OGB), the kink and
    max inputs too; the float64 witness stays exact float64."""
    global LOGIT_TOL, GRAD_TOL
    if compute_dtype is None:
        return _check_model(cfg, batch, device, random_features)
    saved = LOGIT_TOL, GRAD_TOL
    LOGIT_TOL, GRAD_TOL = bf16_tier["logit"], bf16_tier["grad"]
    try:
        return dict(_check_model(cfg, batch, device, random_features,
                                 compute_dtype, bf16_tier["witness"]),
                    dtype=str(compute_dtype), logit_tol=LOGIT_TOL,
                    grad_tol=GRAD_TOL, witness=bf16_tier["witness"])
    finally:
        LOGIT_TOL, GRAD_TOL = saved


def _check_model(cfg, batch, device, random_features: bool = False,
                 compute_dtype=None, use_witness: bool = True) -> dict:
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
    the segmented max's choices; SameLive for generalsampleedgeconv's
    kept edges, which the two sides would draw from generators of
    different devices): every ReLU,
    leaky ReLU and PReLU input is held to the card's,
    and at an input within rounding of 0 the two f32 programs may take
    either side of the kink.  There the gradient steps by that row's
    whole upstream gradient (ba's 98,304-row ID-GIN batch has such
    inputs, a few millionths from 0), which is no difference of the
    programs; with the kinks shared, the gradients are held
    elementwise.

    Logits and buffers are held at LOGIT_TOL, gradients at GRAD_TOL.
    Where the two f32 programs part beyond that (a sum of cancelling
    terms, as a matmul kernel's gradient is where a 1-wide input sits
    under BatchNorm: the pre-MP layer of the ba paths; or a graph head's
    BatchNorm over a few graph slots of large pooled sums), the CPU
    reference runs once more in float64 (``f64_witness``) and decides:
    the card's entries beyond the tolerance must lie within hold_sums'
    rule of it, 1e-5 x their sum of |terms| + 1e-6, for a matmul
    kernel's gradient (``MatmulSums``), and within the same tolerance of
    it, its atol times the tensor's largest |value| (as a kink input's),
    for anything else; else the check fails.  ``witness_entries``
    counts the entries it held, ``witness_off_card_cpu`` gives the
    card's and the CPU's largest distance from float64 over them.
    tests/test_torch_graph_task.py::test_pre_mp_kernel_gradient_cancels_in_f32
    shows the cancelling gradient on the CPU at a cut size.

    With gnn.dropout > 0 the two sides would draw their masks from
    different generators, so the comparison runs at dropout 0, and the
    dropout itself is held apart (``check_dropout``).  Without
    ``use_witness`` (a bf16 tier's) an entry beyond the tolerance fails
    the check outright."""
    import contextlib

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
    sums = MatmulSums(ref)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    card_train, card_eval = CardKinks(), CardKinks()
    max_train, max_eval = CardMax(), CardMax()
    same_max = (SameMax(max_train.calls), SameMax(max_eval.calls))
    live_train, live_eval = CardLive(), CardLive()
    outs, kinks = [], []
    for m, b, train_mode, eval_mode, maxes, scales, lives in (
            (model, batch.to(device), card_train, card_eval,
             (max_train, max_eval), contextlib.nullcontext(),
             (live_train, live_eval)),
            (ref, batch.to(torch.device("cpu")),
             SameKinks(card_train.inputs), SameKinks(card_eval.inputs),
             same_max, sums,
             (SameLive(live_train.calls), SameLive(live_eval.calls)))):
        with train_mode, maxes[0], scales, lives[0]:
            pred, label, mask = forward(m, b, compute_dtype)
            loss = torch.nn.functional.cross_entropy(pred[mask].float(),
                                                     label[mask])
            loss.backward()
        m.eval()
        with torch.no_grad(), eval_mode, maxes[1], lives[1]:
            pred_eval = forward(m, b, compute_dtype)[0]
        # a parameter no loss reaches has no gradient on either side
        outs.append(dict(train=pred.detach().float().cpu(),
                         eval=pred_eval.float().cpu(),
                         **{k: (p.grad if p.grad is not None
                                else torch.zeros_like(p)).cpu()
                            for k, p in m.named_parameters()},
                         **{k: v.cpu() for k, v in m.named_buffers()}))
        kinks.append((train_mode, eval_mode))
    card, cpu = outs
    same = kinks[1]
    for mode, seen in zip(same, kinks[0]):
        if mode.calls != len(seen.inputs):
            fail(f"the CPU ran {mode.calls} ReLUs, the card "
                 f"{len(seen.inputs)}")
    for mode in same_max:
        if mode.calls != len(mode.card):
            fail(f"the CPU ran {mode.calls} maxes, the card "
                 f"{len(mode.card)}")
    witness, held, off = {}, {}, {}

    def hold(what: str, key: str, tol: dict, scale=None):
        got, want = card[key], cpu[key]
        miss = ~torch.isclose(got, want, **tol)
        if not miss.any():
            return
        if not use_witness:
            fail(f"{what}: {int(miss.sum())} entries beyond {tol} of the "
                 f"CPU, max err {(got - want).abs().max().item()}")
        if not witness:
            witness.update(f64_witness(
                cfg, state, batch, (card_train.inputs, card_eval.inputs),
                (max_train.calls, max_eval.calls),
                (live_train.calls, live_eval.calls)))
        exact = witness[key]
        if compute_dtype is not None:
            bound = BF16_WITNESS * (want.double() - exact).abs().max() \
                .item() + 1e-6
            err = (got[miss].double() - exact[miss]).abs().max().item()
            if err > bound:
                fail(f"{what}: {int(miss.sum())} entries beyond {tol} of "
                     f"the CPU, max err {(got - want).abs().max().item()}, "
                     f"and {err} from float64, beyond {BF16_WITNESS} x "
                     f"the CPU's own bf16 distance ({bound})")
        elif scale is not None:
            hold_sums(f"{what} card vs float64", got[miss], exact[miss],
                      scale[miss])
        else:
            atol = tol["atol"] * max(1.0, exact.abs().max().item())
            if not torch.allclose(got[miss].double(), exact[miss],
                                  rtol=tol["rtol"], atol=atol):
                fail(f"{what}: {int(miss.sum())} entries beyond {tol} of "
                     f"the CPU, max err "
                     f"{(got - want).abs().max().item()}, and beyond rtol "
                     f"{tol['rtol']}, atol {atol} of float64, max err "
                     f"{(got[miss].double() - exact[miss]).abs().max().item()}")
        held[key] = int(miss.sum())
        off[key] = [(v[miss].double() - exact[miss]).abs().max().item()
                    for v in (got, want)]
    buffers = [k for k, _ in ref.named_buffers()]
    for k in buffers:     # BatchNorm running statistics after the step
        hold(f"buffer {k}", k, LOGIT_TOL)
    for name in ("train", "eval"):
        hold(f"model {name}-mode logits", name, LOGIT_TOL)
    grads = [k for k, _ in ref.named_parameters()]
    for k in grads:
        hold(f"gradient {k}", k, GRAD_TOL, sums.scale.get(k))

    def err(keys):
        return max((card[k] - cpu[k]).abs().max().item() for k in keys)
    return dict(logits_max_err=err(["train"]),
                eval_logits_max_err=err(["eval"]),
                grad_max_err=err(grads), buffers=len(buffers),
                buffers_max_err=err(buffers) if buffers else 0.0,
                witness_entries=held, witness_off_card_cpu=off,
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


def planted_faults(cfg_file: str, overrides, graphs: int, device) -> dict:
    """check_model on a graph path's batch of its first ``graphs`` train
    graphs with a wrong K1 planted in its pooling on the card (the CPU
    reference keeps the plain versions): "fwd_short", the forward's walk
    one slot short of every graph slot's row (each graph's last node
    left out of its sum); "bwd_scaled", the backward's output (a row per
    node) times 1 + 2^-8, which leaves the forward as it is, so only the
    gradients move, and the float64 witness must turn them down.  Each
    must fail the check, the second by the witness; returns their
    messages."""
    cfg, loaders, _ = load_path(cfg_file, overrides)
    del loaders
    batch = first_graphs_batch(cfg_file, overrides, graphs)
    real = K.spmm_packed

    def fwd_short(pack, x):
        if x.is_cuda and pack.row_range.shape[0] < x.shape[0]:
            rr = pack.row_range.clone()
            rr[:, 1] = torch.maximum(rr[:, 0], rr[:, 1] - 1)
            pack = pack._replace(row_range=rr)
        return real(pack, x)

    def bwd_scaled(pack, x):
        out = real(pack, x)
        return (out * (1 + 2 ** -8) if x.is_cuda and out.shape[0] > x.shape[0]
                else out)
    out = {}
    for name, fault in (("fwd_short", fwd_short),
                        ("bwd_scaled", bwd_scaled)):
        K.spmm_packed, _PLANTED[0] = fault, True
        try:
            check_model(cfg, batch, device)
        except CheckFailed as exc:
            out[name] = str(exc)
        finally:
            K.spmm_packed, _PLANTED[0] = real, False
        if name not in out:
            fail(f"planted fault {name}: the model check passed")
    if "float64" not in out["bwd_scaled"]:
        fail(f"planted fault bwd_scaled: not turned down by the float64 "
             f"witness: {out['bwd_scaled']}")
    return out


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


def widest_op_inputs(fn, top: int = 5, node_rows: int = -1) -> tuple:
    """The ops of one call of fn (forward and backward) whose widest
    tensor argument has the most elements (torch.profiler with shapes),
    the longest index any index_add of the call takes, and the most
    elements of any tensor argument none of whose dimensions is
    ``node_rows`` (a batch's node rows, or their transpose in a weight
    gradient: its features, however wide, are no per-slot tensor)."""
    from torch.profiler import ProfilerActivity, profile

    def numel(shape, skip=None) -> int:
        if isinstance(shape, (list, tuple)) and shape and all(
                isinstance(x, int) for x in shape):
            return 0 if skip in shape else math.prod(shape)
        if isinstance(shape, (list, tuple)):
            return max((numel(x, skip) for x in shape), default=0)
        return 0

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) \
            as prof:
        fn()
        torch.cuda.synchronize()
    ops, index_add, off_rows = {}, 0, 0
    for ev in prof.events():
        shapes = ev.input_shapes or []
        widest = max((numel(sh) for sh in shapes), default=0)
        if widest > ops.get(ev.name, (0, None))[0]:
            ops[ev.name] = (widest, shapes)
        off_rows = max(off_rows, numel(shapes, node_rows))
        if "index_add" in ev.name and len(shapes) > 2 \
                and len(shapes[2]) == 1:   # (self, dim, index, source)
            index_add = max(index_add, shapes[2][0])
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return [dict(op=name, numel=w, shapes=str(sh)[:160])
            for name, (w, sh) in ranked], index_add, off_rows


def step_profile(trainer, batch, device, steps: int, base: int) -> dict:
    """One trainer's train step on one batch: the wall ms of step 0 and
    step 1 (on the card, eager and the capture), then over ``steps``
    more: the wall ms per step, the device time by kernel
    (torch.profiler; ``profile_holds_every_launch`` false where three
    profiles each lost records, or two kept the same records), the
    device's busy share, the host time in
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
    kept = None
    for _ in range(3):   # a profile that lost records is taken again,
        # unless it kept the records the one before kept (a kernel the
        # step launches a number of times no multiple of the steps: a
        # third profile reads the same)
        events = profile_events(lambda: trainer.train_step(batch), steps)
        whole = holds_every_launch(events, steps)
        if whole or kernel_records(events) == kept:
            break
        kept = kernel_records(events)
    by_kernel = device_ms_by_kernel(None, steps, events)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the port's own kernels (csrc/): row_walk_* runs K1 and K3,
    # segment_* K2
    own = sorted((kv for kv in by_kernel.items()
                  if any(k in kv[0] for k in ("row_walk", "packed_",
                                              "segment_vec",
                                              "segment_narrow"))),
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
    fails if an op of the step takes a tensor that large other than one
    of the batch's node rows (the input features of Cora's 1,433
    columns outgrow its pack's slots times the width), or an index_add
    an index that long (one entry per pack slot: a scatter of per-slot
    values).  The captured graph runs the eager step's ops."""
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
            widest, index_add, off_rows = widest_op_inputs(
                lambda: trainer.train_step(batch),
                node_rows=host_batch.num_nodes)
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
    if forbid_numel and off_rows >= forbid_numel:
        fail(f"an op of the train step takes a tensor of {off_rows} "
             f"elements (>= {forbid_numel}) besides the node rows; the "
             f"widest: {widest}")
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


def rmsprop(params, optim_cfg):
    """An optimizer for register.optimizer_dict that a CUDA graph cannot
    capture: torch's RMSprop on a float lr."""
    return torch.optim.RMSprop(params, lr=optim_cfg.base_lr, alpha=0.9,
                               weight_decay=optim_cfg.weight_decay)


def registered_optim(cfg, loaders, device, k1: tuple, steps: int = 3
                     ) -> dict:
    """A registered optimizer the captured step cannot take (``rmsprop``
    under register.optimizer_dict) in the trainer on the card: fails
    unless the trainer logs once that its train steps run eagerly, its
    ``steps`` train steps equal, bitwise, the same optimizer stepped
    directly on a model from the same seed on the same batch, with the
    same launches (``k1``: K1's per train step and per eval batch; no
    other kernel), the parameters and the optimizer's state stay on the
    card, and the eval step beside them is still captured."""
    import logging

    from graphgym_tpu_torch import register
    from graphgym_tpu_torch.train.loss import compute_loss
    from graphgym_tpu_torch.train.optim import capturable

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    root, lines = logging.getLogger(), Lines()
    level = root.level
    root.addHandler(lines)
    root.setLevel(logging.INFO)
    register.optimizer_dict["rmsprop"] = rmsprop
    try:
        trainer = Trainer(build_model(cfg, device), loaders, cfg, device)
    finally:
        del register.optimizer_dict["rmsprop"]
        root.removeHandler(lines)
        root.setLevel(level)
    said = [ln for ln in lines.lines if "is not capturable" in ln]
    if len(said) != 1 or f"eagerly on {device}" not in said[0]:
        fail(f"the trainer's log for a registered RMSprop: {said}")
    if capturable(trainer.optimizer):
        fail("torch's RMSprop on a float lr reads as capturable")
    host_batch, host_vbatch = (ld.batches(0)[0] for ld in loaders[:2])
    batch, vbatch = trainer._place(host_batch), trainer._place(host_vbatch)
    (losses, evals), (launches, *_) = counted(lambda: (
        [trainer.train_step(batch)[0].item() for _ in range(steps)],
        [trainer.eval_step(vbatch)[0].item() for _ in range(2)]))
    direct = build_model(cfg, device)
    opt = rmsprop(direct.parameters(), cfg.optim)

    def run_directly():
        out = []
        for _ in range(steps):
            direct.train()
            pred, label, mask = direct(batch)
            loss, _ = compute_loss(pred, label, mask, trainer.loss_opts)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            out.append(loss.item())
        return out
    want, (want_launches, *_) = counted(run_directly)
    diff = max((a.float() - b.float()).abs().max().item()
               for a, b in zip(trainer.model.state_dict().values(),
                               direct.state_dict().values()))
    state = [t for s in trainer.optimizer.state.values()
             for t in s.values() if torch.is_tensor(t) and t.dim() > 0]
    on_card = all(t.device.type == "cuda" for t in
                  [*trainer.model.parameters(), *state])
    k1_train, k1_eval = k1
    held = {name: 0 for name in launches}
    if (losses != want or diff != 0.0 or not on_card
            or trainer.train_step.captured != 0
            or trainer.eval_step.captured != 1
            or launches != dict(held, packed_spmm_cuda=k1_train * steps
                                + k1_eval * 2)
            or want_launches != dict(held,
                                     packed_spmm_cuda=k1_train * steps)):
        fail(f"registered RMSprop on the card: losses {losses} / directly "
             f"{want}, state max diff {diff}, on the card {on_card}, "
             f"captured train {trainer.train_step.captured} / eval "
             f"{trainer.eval_step.captured}, launches {launches} / "
             f"directly {want_launches}")
    return dict(optimizer="torch.optim.RMSprop (registered)", log=said[0],
                losses=losses, eval_losses=evals, launches=launches,
                direct_launches=want_launches, bitwise_equal=True,
                state_tensors_on_card=len(state))


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
    K3's launches by width, K1's rectangular launches by width: those
    on a pooling or gather pack or its transpose, and K2's launches by
    the batch pack its index came from)."""
    for k in kernels():
        k.launches = 0
    for k in by_width_kernels():
        k.launches_by_width.clear()
    K.packed_spmm_cuda.launches_rectangular.clear()
    K.packed_segment_matmul_cuda.launches_by_pack.clear()
    for k in kernels():
        k.launches_by_dtype.clear()
    result = fn()
    torch.cuda.synchronize()
    return result, ({k.__name__: k.launches for k in kernels()},
                    {k.__name__: dict(k.launches_by_width)
                     for k in by_width_kernels()},
                    dict(K.packed_spmm_cuda.launches_rectangular),
                    dict(K.packed_segment_matmul_cuda.launches_by_pack))


def by_dtype() -> dict:
    """Each kernel's launches by the dtype of its input since the last
    ``counted`` began, the kernels that launched."""
    return {k.__name__: dict(k.launches_by_dtype) for k in kernels()
            if k.launches_by_dtype}


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
               expected: dict, widths=None, rect=(0, 0),
               k2_packs=None) -> dict:
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
    measured.  ``k2_packs`` maps a batch pack kind to K2's launches on
    its index (per train step, per eval batch), held as K2's launches
    by pack (``launches_by_pack``; no K2 launch on another pack); the
    result reports those counts as measured.  With the graphs each
    step captured, and the train batches' signatures over the epochs
    and what each epoch adds (one captured program a signature)."""
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_cfg(cfg_file, overrides + ["out_dir", out])
    epochs = cfg.optim.max_epoch
    steps = epochs * len(loaders[0])
    evals = sum(ckpt.is_eval_epoch(e, cfg.train.eval_period, epochs)
                for e in range(epochs)) * sum(map(len, loaders[1:]))

    def totals(per):
        return {k.__name__: (s * steps + e * evals,
                             f"{s}/train step x {steps} + {e}/eval batch "
                             f"x {evals}") for k, (s, e) in per.items()}
    with LoaderCalls(keep=False) as calls, Captures() as captures, \
            Draws() as draws:
        result, (launches, by_width, rectangular, k2_by_pack) = counted(
            lambda: run_single(cfg, cfg.out_dir, cfg_file))
    # the epochs' train batches (the trainer's construction and its edge
    # count draw first)
    by_epoch = [c["signatures"] for c in draws.calls
                if c["train"]][-epochs:]
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
    if k2_packs is not None:
        hold_counts(f"{cfg_file}, K2 by pack",
                    {p: k2_by_pack.get(p, 0) for p in {*k2_by_pack,
                                                       *k2_packs}},
                    {p: (s * steps + e * evals,
                         f"{s}/train step x {steps} + {e}/eval batch x "
                         f"{evals}") for p, (s, e) in k2_packs.items()})
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
                k2_launches_by_pack=k2_by_pack,
                launches_per_train_step_and_eval_batch={
                    k.__name__: v for k, v in expected.items()},
                captures=dict(captures.counts),
                train_signatures=len({sig for sigs in by_epoch
                                      for sig in sigs}),
                new_signatures_by_epoch=new_by_epoch(by_epoch),
                params=cfg.params)


def load_path(cfg_file: str, overrides):
    """The config, its loaders, and the host time to build them (load,
    labels, split, ego union, collate, packs)."""
    cfg = load_cfg(cfg_file, overrides)
    t0 = time.perf_counter()
    loaders = create_loader(create_dataset(cfg), cfg)
    loaders[0].batches(0)
    return cfg, loaders, time.perf_counter() - t0


# the corpora regenerated beside the first phases, one process each:
# ba (the ba paths), the design grid's scalefree and smallworld, and the
# ID-GNN graph grid's ws500 and ba500
CORPORA = {"ba": CORPUS_DIR, "scalefree": DESIGN_CORPUS_DIR,
           "smallworld": DESIGN_CORPUS_DIR, "ws500": CORPUS500_DIR,
           "ba500": CORPUS500_DIR}


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


def corpus500_phase(procs: dict) -> dict:
    """Wait for ws500 and ba500 (256 graphs of 500 nodes asked, seed 0),
    regenerated into CORPUS500_DIR by their processes, and hold each to
    its graph count and digest (CORPUS500); their seconds there."""
    from graphgym_tpu_torch.data.loaders import load_nx

    out = {}
    for name, (count, digest) in CORPUS500.items():
        seconds = wait_corpus(procs, name)
        graphs = load_nx(name, CORPUS500_DIR)
        got = corpus_digest(graphs)
        if len(graphs) != count or got != digest:
            fail(f"{name}: {len(graphs)} graphs, digest {got}; expected "
                 f"{count}, {digest}")
        out[name] = dict(seconds=seconds, graphs=len(graphs),
                         nodes=sum(g.num_nodes for g in graphs),
                         edges=sum(g.num_edges for g in graphs))
    return dict(**out, cache=sorted(os.listdir(CORPUS500_DIR)))


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


def first_graphs(cfg, loaders, graphs: int):
    """The batch of the first ``graphs`` graphs of each split's loader
    (``first_graphs_batch`` from a path's loaded splits)."""
    return create_loader([ld.graphs[:graphs] for ld in loaders],
                         cfg)[0].batches(0)[0]


def first_graphs_batch(cfg_file: str, overrides, graphs: int):
    """The batch of a config's first ``graphs`` train graphs (its
    dataset built afresh, each split cut to that many)."""
    cfg = load_cfg(cfg_file, overrides)
    return create_loader([split[:graphs] for split in create_dataset(cfg)],
                         cfg)[0].batches(0)[0]


# a graph path's config, loaders and first train batch, kept by
# drive_path for kernel_pool
LOADED: dict = {}
# the node-task paths whose loaders bf16_models takes again
KEEP_LOADED = ("idgcn_ba", "design_sf_max")
# design_sf_max's grid point on scalefree (its overrides after the
# design config's)
DESIGN_SF_MAX = (
    "dataset.format", "nx", "dataset.task", "node", "dataset.transductive",
    "True", "dataset.name", "scalefree", "dataset.augment_feature",
    "['node_const']", "dataset.augment_label",
    "node_clustering_coefficient", "train.batch_size", "16",
    "gnn.layers_pre_mp", "1", "gnn.layers_mp", "6", "gnn.layers_post_mp",
    "3", "gnn.stage_type", "skipsum", "gnn.batchnorm", "True", "gnn.act",
    "relu", "gnn.dropout", "0.6", "gnn.agg", "max", "optim.optimizer",
    "adam", "optim.base_lr", "0.001")


def pool_phase(paths: dict, device) -> dict:
    """kernel_pool: the graph head's pooling kernels on the first train
    batch of each graph path (``paths``: tag -> config, overrides, the
    width it pools at, and a count of train graphs to cut the max's
    batch to, 0 for none), with the pooling packs of add, mean and max
    built from it (ego centers where the path pools them): K1 forward
    and backward (``check_pool_k1``) for add and mean, the segmented max
    forward and backward (``check_max_kernel`` on the rectangular packs)
    for max, which no path runs.  A path that drive_path ran brings its
    loaders and first train batch (``LOADED``)."""
    out = {}
    for tag, (cfg_file, overrides, width, max_graphs) in paths.items():
        if tag in LOADED:
            cfg, loaders, first = LOADED.pop(tag)
        else:
            cfg, loaders, _ = load_path(cfg_file, overrides)
            first = loaders[0].batches(0)[0]
        batches = {"k1": first}
        batches["max"] = (first_graphs(cfg, loaders, max_graphs)
                          if max_graphs else first)
        del loaders
        ego = cfg.dataset.transform == "ego"
        checks = {}
        for kind in POOLINGS:
            batch = batches["max" if kind == "max" else "k1"]
            n, g = batch.num_nodes, batch.num_graphs
            packs = build_pool_packs(
                batch.graph_ids, batch.node_mask, g, kind,
                batch.node_id_index if ego else None,
                batch.id_mask if ego else None)[pool_kind(kind, ego)]
            dev = tuple(K.PackedCSR(*(torch.from_numpy(a).to(device)
                                      for a in p)) for p in packs)
            checks[kind] = (check_max_kernel(dev, n, width, device)
                            if kind == "max" else
                            check_pool_k1(dev, n, width, device))
        n, g = batches["k1"].num_nodes, batches["k1"].num_graphs
        if max_graphs:
            checks["max"].update(
                n=batches["max"].num_nodes,
                graph_slots=batches["max"].num_graphs,
                checked=f"the first {max_graphs} train graphs")
        out[tag] = dict(n=n, graph_slots=g, ego=ego, width=width,
                        checked="the first train batch", **checks)
    return out


def config(tag: str) -> str:
    return os.path.join(ROOT, "configs", f"{tag}.yaml")


def edge_checks(cfg, batch, dev, n: int, d: int, device) -> dict:
    """The kernels of an edge conv's packs (graphs/packing.edge_kinds)
    held to their plain versions and timed: K2 on the 'edge' pack at
    the width d (``check_edge_kernel``); K1 on the 'edge_src' gather
    packs at the width the layer gathers (``check_gather_k1``: 2 d for
    splineconv's two projections); the segmented max on the layers'
    max packs of the real edges (``edge_max_packs``, x one row an edge)
    for agg max; the
    softmax's K3 row sums on the 'edge' pack for the attention convs
    (``check_softmax``)."""
    lt = cfg.gnn.layer_type
    checks = dict(k2=check_edge_kernel(dev.packs[EDGE], dev, n, d, device))
    checks["k1_edge_src"] = check_gather_k1(
        dev.packs[EDGE_SRC], batch.senders, batch.edge_weight != 0, n,
        2 * d if lt == "splineconv" else d, device)
    if EDGE_DST in dev.packs and cfg.gnn.agg == "max" \
            and lt in ("generaledgeconv", "generalsampleedgeconv",
                       "generalogbconv"):
        checks["max"] = check_max_kernel(
            LY.edge_max_packs(dev, dev.edge_weight != 0), batch.num_edges,
            d, device)
    if lt.startswith("generaledgeattconv"):
        checks["softmax"] = check_softmax(dev.packs[EDGE][0], n, device)
    if lt == "generalsampleedgeconv":
        checks["sample"] = check_edge_sample(cfg, batch, device)
    return checks


def check_edge_sample(cfg, batch, device, draws: int = 20) -> dict:
    """generalsampleedgeconv's kept edges on the card (the model's first
    layer, train mode, its generator): over ``draws`` calls the kept
    share of the real edges within 5 sigma of gnn.keep_edge, no padding
    edge kept, each call's mask new, the first mask again from a model
    built from the same seed, and every real edge in eval mode."""
    dev = batch.to(device)
    real = dev.edge_weight != 0
    masks = []
    for _ in range(2):
        conv = build_model(cfg, device).mp.layers[0].layer.train()
        masks.append([conv.live_edges(dev) for _ in range(draws)])
    kept = torch.stack(masks[0])
    rate, trials = cfg.gnn.keep_edge, draws * int(real.sum())
    share = kept[:, real].float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / trials)
    fresh = len({m.cpu().numpy().tobytes() for m in masks[0]}) == draws
    seeded = all(map(torch.equal, masks[0], masks[1]))
    eval_all = torch.equal(conv.eval().live_edges(dev), real)
    if abs(share - rate) > 5 * sigma or kept[:, ~real].any() \
            or not (fresh and seeded and eval_all):
        fail(f"edge sample {rate}: kept share {share} (want {rate} +- "
             f"{5 * sigma}), padding kept {bool(kept[:, ~real].any())}, "
             f"fresh {fresh}, seeded again {seeded}, eval all {eval_all}")
    return dict(rate=rate, kept_share=share, sigma=sigma, draws=draws,
                real_edges=int(real.sum()))


def drive_path(tag: str, device, overrides, expected: dict, widths=None,
               random_features: bool = False, base: str = "",
               extra=(), rect_width=None, rect=(0, 0),
               model_graphs: int = 0, pool_width: int = 0,
               model_nodes: int = 0, k2_packs=None) -> dict:
    """The phases of one more path, as the ws paths have them:
    kernel_<tag> (its kernels at the train pack's shapes: K1 at the
    model width and at each narrow width ``widths`` names, or K3, its
    softmax row sums and the SDDMM, or the segmented max forward and
    backward (a generalconv / idconv with gnn.agg max); the pack's
    longest rows),
    model_<tag> (``check_model``), train_<tag> (``train_path`` with
    ``expected``, ``widths``, ``rect`` and ``k2_packs``), profile_<tag>
    (with ``repeat_steps``;
    no op of the eager step takes a tensor of the pack's slots times the
    width, the batch's node rows aside, and no index_add an index of the
    pack's slots) and
    graphed_<tag>.  The config is configs/<base or tag>.yaml with
    ``extra`` overrides (a grid point).  On a graph task the kernel
    phase names the pooling pack's rows and slots; on a batch with a
    head's gather pack ('pairs' of the edge head, 'labels' of the node
    head where supervised nodes repeat) it holds K1 on it
    (``check_gather_k1``) at the width the head gathers (the stage's
    for pairs, dim_out for labels) and names the supervised pairs or
    nodes.  ``rect_width`` is the width of the head's rectangular packs
    where it is none of the layers' (kernel_pool and the gather check
    hold those packs' kernels, check_kernel the layers').  The model
    check runs on the first val batch, or with ``model_graphs`` on a
    batch of the first that many train graphs (where the CPU side of a
    val batch would take minutes, or its few graph slots leave the
    graph head's BatchNorm ill-conditioned); its phase names which.
    With ``model_nodes`` the model check takes the subgraph the train
    split's first that many nodes induce (a one-graph dataset whose CPU
    side would take tens of seconds), with the train supervision there.
    With ``pool_width`` the kernel phase also holds K1 on the path's own
    pooling packs at that width (``check_pool_k1``); a batch with an
    encoder's embedding pack has K2 held on it at the encoder width
    (``check_embed_kernel``); K2 reads the output gradient in place,
    so the profile's per-slot width check lets no gathered copy of it
    pass.  The profile, repeat and graphed checks take the first train
    batch (``FirstBatch``)."""
    cfg_file = config(base or tag)
    overrides = list(overrides) + list(extra)
    begin(f"kernel_{tag}")
    cfg, loaders, host_s = load_path(cfg_file, overrides)
    batch = loaders[0].batches(0)[0]
    n, d = batch.num_nodes, cfg.gnn.dim_inner
    kinds = kinds_for_cfg(cfg.gnn)
    kind = kinds[0]
    dev_batch = batch.to(device)
    dev_packs = dev_batch.packs
    packs = dev_packs[kind]
    edge_conv = cfg.gnn.layer_type in EDGE_CONVS
    if edge_conv:
        checks = edge_checks(cfg, batch, dev_batch, n, d, device)
    elif kind == "att":
        checks = dict(k3=check_attention_kernel(packs, n, d, device),
                      softmax=check_softmax(packs[0], n, device),
                      sddmm=check_sddmm_kernel(packs[0], n, d, device))
    elif cfg.gnn.layer_type in ("generalconv", "idconv", "generalconv_v2") \
            and cfg.gnn.agg == "max":
        checks = dict(max=check_max_kernel(packs, n, d, device))
    else:
        checks = {f"d{w}": check_kernel(packs, n, w, device)
                  for w in sorted({d, *(widths or {})} - {rect_width})}
    for name in EMBED_KINDS:
        if name in batch.packs:
            (pack,) = dev_packs[name]
            dims, width = {
                NODE_ENCODER: (EMBED_TABLES[cfg.dataset.node_encoder_name][0],
                               cfg.dataset.encoder_dim),
                EDGE_ENCODER: (EMBED_TABLES[cfg.dataset.edge_encoder_name][0],
                               cfg.dataset.encoder_dim),
                EDGE_BOND: (BOND_FEATURE_DIMS[:pack.rows.shape[1]], d)}[name]
            live = (batch.node_mask if name == NODE_ENCODER
                    else batch.edge_mask)
            checks[f"k2_{name}"] = check_embed_kernel(pack, sum(dims), width,
                                                      device, live)
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
        if pool_width:
            checks["pool_k1"] = check_pool_k1((fwd_pool, bwd_pool), n,
                                           pool_width, device)
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
          batches=len(loaders[0]),
          slots=int(packs[0].senders.numel()),
          fwd_rows=longest_rows(packs[0]),
          bwd_rows=None if edge_conv else longest_rows(packs[1]),
          packs=sorted(batch.packs), pool=pool, gathers=gathers,
          supervised=supervised, **checks)
    begin(f"model_{tag}")
    model_batch, checked = loaders[1].batches(0)[0], "the first val batch"
    if model_graphs:
        model_batch = first_graphs(cfg, loaders, model_graphs)
        checked = f"the first {model_graphs} train graphs"
    if model_nodes:
        from graphgym_tpu_torch.data.samplers import induced_subgraph

        model_batch = create_loader([[induced_subgraph(g, np.arange(
            min(model_nodes, g.num_nodes))) for g in loaders[0].graphs]],
            cfg)[0].batches(0)[0]
        checked = (f"the subgraph of the first {model_nodes} nodes, the "
                   "train split's supervision")
    phase(f"model_{tag}", checked=checked,
          graphs=int(np.sum(model_batch.graph_mask))
          if model_batch.graph_mask is not None else None,
          real_nodes=int(np.sum(model_batch.node_mask)),
          **check_model(cfg, model_batch, device, random_features))
    begin(f"train_{tag}")
    train = train_path(cfg_file, overrides, os.path.join(OUT, tag),
                       loaders, expected, widths, rect, k2_packs)
    phase(f"train_{tag}", **train)
    begin(f"profile_{tag}")
    slots = packs[0].senders.numel()
    # an edge conv's own per-edge rows (feat, messages; slots of the
    # 'edge' pack times 2 d + the edge columns at most) pass
    widest = slots * (2 * d + cfg.dataset.edge_dim) if edge_conv \
        else slots * d
    first = [FirstBatch(batch, len(loaders[0])), *loaders[1:]]
    # the profiler's processing pays for each host op call of the
    # eager step (1,000-4,400 on these paths, 2,500-5,000 on an edge
    # conv's): 3 steps, 2 on an edge conv, for time
    profile = profile_steps(cfg, first, device, steps=2 if edge_conv else 3,
                            forbid_numel=widest + 1,
                            forbid_index_add=slots)
    phase(f"profile_{tag}", **profile,
          repeat=repeat_steps(cfg, first, device))
    begin(f"graphed_{tag}")
    phase(f"graphed_{tag}", **graphed_check(cfg, first, device))
    if cfg.dataset.task == "graph" or tag in KEEP_LOADED:
        # kernel_pool's and bf16_models', not loaded again
        LOADED[tag] = (cfg, loaders, batch)
    return dict(width=d, pack=f"{kind}, {base or tag}", checks=checks,
                gathers=gathers, train=train, profile=profile)


def model_phase(tag: str, cfg_file: str, overrides, device, expected: dict,
                layers=None, k2_packs=None,
                random_features: bool = False) -> dict:
    """model_<tag>, a layer type checked without a training: check_model
    on the config's first val batch at full width, the launches of its
    card side (a train-mode forward and backward, then an eval-mode
    forward) counted and held to ``expected`` (kernel wrapper -> count),
    and the kernel of its layer pack (K1, or the segmented max for agg
    max) held to its plain version and timed at the width
    (``check_kernel``, ``check_max_kernel``).  ``layers`` replaces
    entries of the model's layer table while the check runs (a layer
    built with an option its layer type does not set).  ``k2_packs``
    maps a batch pack kind to K2's launches on its index, held as K2's
    launches by pack.  ``random_features``: check_model's seeded ones
    (a config whose features are constant)."""
    from unittest import mock

    cfg, loaders, _ = load_path(cfg_file, overrides)
    batch = loaders[1].batches(0)[0]
    kinds = kinds_for_cfg(cfg.gnn)
    kind = kinds[0]
    dev_batch = batch.to(device)
    packs = dev_batch.packs[kind]
    n, d = batch.num_nodes, cfg.gnn.dim_inner
    edge_conv = cfg.gnn.layer_type in EDGE_CONVS
    if edge_conv:
        checks = edge_checks(cfg, batch, dev_batch, n, d, device)
        check = checks.get("max", checks["k2"])
    else:
        agg_max = (cfg.gnn.agg == "max"
                   and cfg.gnn.layer_type == "generalconv_v2")
        check = (check_max_kernel if agg_max else check_kernel)(
            packs, n, d, device)
    with mock.patch.dict(M.LAYERS, layers or {}):
        model, (launches, by_width, _, k2_by_pack) = counted(
            lambda: check_model(cfg, batch, device, random_features))
    hold_counts(f"model_{tag}", launches,
                {k.__name__: (c, "the train step and the eval forward")
                 for k, c in expected.items()})
    if k2_packs is not None:
        hold_counts(f"model_{tag}, K2 by pack",
                    {p: k2_by_pack.get(p, 0)
                     for p in {*k2_by_pack, *k2_packs}},
                    {p: (c, "the train step and the eval forward")
                     for p, c in k2_packs.items()})
    return dict(layer_type=cfg.gnn.layer_type, pack=kind, n=n, width=d,
                real_nodes=int(np.sum(batch.node_mask)),
                edge_columns=(None if batch.edge_feat is None
                              else int(batch.edge_feat.shape[1])),
                chunks=int(packs[0].senders.shape[0]),
                slots=int(packs[0].senders.numel()),
                fwd_rows=longest_rows(packs[0]),
                bwd_rows=None if edge_conv else longest_rows(packs[1]),
                launches=launches, launches_by_width=by_width,
                k2_launches_by_pack=k2_by_pack, check=check, **model)


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


class Captures:
    """While installed, the CUDA graphs each captured step
    (train/graphed.GraphedStep) captures, by step name."""

    def __enter__(self):
        from graphgym_tpu_torch.train import graphed

        self.counts = collections.Counter()
        self.real = graphed.GraphedStep._capture

        def capture(step, prog):
            self.counts[step.name] += 1
            return self.real(step, prog)
        graphed.GraphedStep._capture = capture
        return self

    def __exit__(self, *exc):
        from graphgym_tpu_torch.train import graphed

        graphed.GraphedStep._capture = self.real


class Draws:
    """While installed, each ``batches`` call of every loader: whether
    it is the train loader's (a SamplerLoader, or a GraphLoader that
    shuffles), its seconds, its batches' signatures (train/graphed.
    signature) and, for a SamplerLoader, the nodes and edges of each
    subgraph it drew."""

    def __enter__(self):
        from graphgym_tpu_torch.data import loaders as L

        self.calls = []
        self.real = (L.GraphLoader.batches, L.SamplerLoader.batches)

        def wrap(real):
            def batches(loader, epoch=0):
                t0 = time.perf_counter()
                out = real(loader, epoch)
                seconds = time.perf_counter() - t0
                sampled = isinstance(loader, L.SamplerLoader)
                self.calls.append(dict(
                    train=sampled or loader.shuffle, seconds=seconds,
                    batches=len(out), signatures=[host_signature(b)
                                                  for b in out],
                    draws=([(g.num_nodes, g.num_edges)
                            for g in loader.graphs] if sampled else None)))
                return out
            return batches
        L.GraphLoader.batches = wrap(self.real[0])
        L.SamplerLoader.batches = wrap(self.real[1])
        return self

    def __exit__(self, *exc):
        from graphgym_tpu_torch.data import loaders as L

        L.GraphLoader.batches, L.SamplerLoader.batches = self.real


def host_signature(host_batch) -> tuple:
    """A host batch's key, equal for two batches exactly where their
    signatures (train/graphed.signature of the placed batch) are: the
    shape and dtype of every array and the pack kinds, with no copy."""
    return (tuple(sorted(host_batch.packs or {})),
            tuple((a.shape, a.dtype.str) for a in host_batch.leaves()))


class FirstBatch:
    """A train loader that hands out one host batch each epoch and has
    the length of the loader it stands for (a trainer's lr schedule
    reads it): the checks after a path's training (``profile_steps``,
    ``repeat_steps``, ``graphed_check``) take the first batch, and a
    trainer built on this collates no epoch for its draws."""

    def __init__(self, batch, length: int):
        self.batch, self.length = batch, length

    def __len__(self) -> int:
        return self.length

    def batches(self, epoch: int = 0) -> list:
        return [self.batch]


def new_by_epoch(signatures_by_epoch) -> list:
    """How many signatures each epoch adds to those of the epochs before
    it: one captured train program each, up to max_programs."""
    seen, out = set(), []
    for sigs in signatures_by_epoch:
        out.append(len(set(sigs) - seen))
        seen |= set(sigs)
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
             **pick(checks["sddmm"], row + ("floor_ms",)),
             **path_launches(sddmm, att)}]
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
             **{k: checks["sddmm"][k] for k in row + ("floor_ms",)},
             **path_launches(sddmm, train)}]
    return rows


def graph_rows(paths: dict, pools: dict, row: tuple, srcs: tuple) -> list:
    """The kernels line's rows of the graph task (``drive_path``'s and
    ``pool_phase``'s results): K1 on each graph path's layer pack (K3,
    its row sums and the SDDMM on an attention path's, as
    ``torch_path_rows`` gives them), K1's add and mean pooling (forward
    timed, the backward beside it) and the segmented max's pooling
    forward and backward on each path's pooling packs.  The launches are
    train_path's counts of the path's run: K1's rectangular ones (the
    pooling pack and its transpose) for the add pooling, the rest for
    the layers.  No path pools by mean or max: their rows launch 0."""
    k1_src, max_src = srcs[0], srcs[3]
    keys = row + ("floor_ms",)
    rows = []
    for tag, path in paths.items():
        t, pool = path["train"], pools[tag]
        count = {"layers": t["k1_layer_launches"],
                 "pool": t["k1_rect_launches"]}
        if "k3" in path["checks"]:
            rows += torch_path_rows({tag: path}, row, srcs)
        else:
            check = path["checks"][f"d{path['width']}"]
            rows.append({"name": f"packed_spmm_{tag}", **k1_src,
                         "path": tag, "pack": path["pack"],
                         "width": path["width"],
                         **{k: check[k] for k in keys},
                         "launches": count["layers"],
                         "launch_split": count})
        suffix = "_ego" if pool["ego"] else ""
        for kind in ("add", "mean"):
            rows.append({
                "name": f"packed_spmm_pool_{kind}_{tag}", **k1_src,
                "path": tag if kind == "add" else None,
                "pack": f"pool_{kind}{suffix}, {tag}",
                "checked": pool["checked"],
                "width": pool["width"],
                **{k: pool[kind]["fwd"][k] for k in keys},
                "bwd": {k: pool[kind]["bwd"][k] for k in keys},
                "launches": count["pool"] if kind == "add" else 0,
                "launch_split": count})
        rows += [{"name": f"{kernel.__name__[:-5]}_pool_{tag}", **max_src,
                  "path": None, "pack": f"pool_max{suffix}, {tag}",
                  "checked": pool["max"].get("checked", pool["checked"]),
                  "width": pool["width"],
                  **{k: pool["max"][half][k] for k in keys},
                  "launches": 0}
                 for half, kernel in (("fwd", K.packed_max_cuda),
                                      ("bwd", K.packed_max_bwd_cuda))]
    return rows


def model_rows(models: dict, row: tuple, srcs: tuple) -> list:
    """The kernels line's rows of the model-only checks
    (``model_phase``'s results): K1, or the segmented max forward and
    backward, on each one's layer pack at its width, the launches those
    of its card side."""
    k1_src, max_src = srcs[0], srcs[3]
    keys = row + ("floor_ms",)
    rows = []
    for tag, m in models.items():
        common = dict(path=f"model_{tag}", pack=f"{m['pack']}, model_{tag}",
                      width=m["width"])
        if "ties" in m["check"]:            # the segmented max's check
            rows += [{"name": f"{kernel.__name__[:-5]}_{tag}", **max_src,
                      **common, **{k: m["check"][half][k] for k in keys},
                      "launches": m["launches"][kernel.__name__]}
                     for half, kernel in (("fwd", K.packed_max_cuda),
                                          ("bwd", K.packed_max_bwd_cuda))]
        else:
            rows.append({"name": f"packed_spmm_{tag}", **k1_src, **common,
                         **{k: m["check"][k] for k in keys},
                         "launches": m["launches"][
                             K.packed_spmm_cuda.__name__]})
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


# the redesigned K2's measurements a kernels line row carries besides
# row + floor_ms (k2_yardsticks, the share of the bound)
K2_EXTRA = ("share_of_bound", "bf16_ms", "bf16_share_of_bound",
            "interleaved_ms", "interleaved_library_ms", "interleaved_k1_ms",
            "faster_every_round")


def ogb_rows(paths: dict, samplers: dict, row: tuple, k1_src: dict,
             k2_src: dict) -> list:
    """The kernels line's rows of the OGB paths (``drive_path``'s
    results): K1 on the molhiv ID point's 'gcn' pack and its add pooling
    of the ego centers at 300 (the pooling's backward beside it), K2 on
    its Atom encoder's embedding pack (the tables' gradient, one launch
    a train step), and K1 on the arxiv design point's 'plain' pack at
    256, the samplers' launches beside the path's."""
    keys = row + ("floor_ms",)
    mol, arx = paths["ogbg_molhiv_gcnid"], paths["ogbn_arxiv_design"]
    t = mol["train"]
    split = {"layers": t["k1_layer_launches"], "pool": t["k1_rect_launches"]}
    pool, k2 = mol["checks"]["pool_k1"], mol["checks"]["k2_node_encoder"]
    return [
        {"name": "packed_spmm_ogbg_molhiv_gcnid", **k1_src,
         "path": "ogbg_molhiv_gcnid", "pack": mol["pack"],
         "width": mol["width"],
         **{k: mol["checks"][f"d{mol['width']}"][k] for k in keys},
         "launches": split["layers"], "launch_split": split},
        {"name": "packed_spmm_pool_add_ogbg_molhiv_gcnid", **k1_src,
         "path": "ogbg_molhiv_gcnid",
         "pack": "pool_add_ego, ogbg_molhiv_gcnid", "width": pool["width"],
         **{k: pool["fwd"][k] for k in keys},
         "bwd": {k: pool["bwd"][k] for k in keys},
         "launches": split["pool"], "launch_split": split},
        {"name": "packed_segment_atom_encoder", **k2_src,
         "path": "ogbg_molhiv_gcnid",
         "pack": "node_encoder (Atom), ogbg_molhiv_gcnid",
         "width": k2["width"],
         **{k: k2[k] for k in keys + ("onehot_ms", "backward_ms")
            + K2_EXTRA},
         **path_launches(K.packed_segment_matmul_cuda,
                         {"ogbg_molhiv_gcnid": t})},
        {"name": "packed_spmm_ogbn_arxiv_design", **k1_src,
         "path": "ogbn_arxiv_design", "pack": arx["pack"],
         "width": arx["width"],
         **{k: arx["checks"][f"d{arx['width']}"][k] for k in keys},
         **path_launches(K.packed_spmm_cuda,
                         {"ogbn_arxiv_design": arx["train"]}),
         "samplers_arxiv_launches": {k: v["k1_launches"]
                                     for k, v in samplers.items()}},
    ]


def edge_rows(paths: dict, models: dict, row: tuple, srcs: tuple,
              k2_src: dict) -> list:
    """The kernels line's rows of the edge-feature convs (``drive_path``'s
    and ``model_phase``'s results): per path K2 on its 'edge' pack at
    300 (the sums over the receivers, with edge_sample's live in-degree
    at width 1; timed also interleaved with torch.sparse.mm under one
    timer) and K1 on its 'edge_src' gather (the forward timed, the
    backward beside it; the launches all of the path's K1, the add
    pooling's 2 / 1 among them); generalogbconv's bond tables' gradient
    (K2 on the 'edge_bond' embedding pack, one a layer a train step);
    the attention softmax's K3 row sums on edge_att's 'edge' pack (timed
    at one head, run at four); the model checks' K2 and max."""
    k1_src, k3_src, _, max_src = srcs
    k1, k2, k3 = (K.packed_spmm_cuda, K.packed_segment_matmul_cuda,
                  K.packed_segment_matmul_headed_cuda)
    keys = row + ("floor_ms",)
    extra = K2_EXTRA
    out = []
    for tag, p in paths.items():
        c, t = p["checks"], p["train"]
        by_pack = t["k2_launches_by_pack"]
        out.append({"name": f"packed_segment_{tag}", **k2_src, "path": tag,
                    "pack": f"edge, {tag}", "width": c["k2"]["width"],
                    "library": c["k2"]["library"],
                    **{k: c["k2"][k] for k in keys + extra},
                    "launches": by_pack.get(EDGE, 0)})
        if f"k2_{EDGE_BOND}" in c:
            b = c[f"k2_{EDGE_BOND}"]
            out.append({"name": f"packed_segment_bond_tables_{tag}",
                        **k2_src, "path": tag, "pack": f"edge_bond, {tag}",
                        "width": b["width"],
                        **{k: b[k] for k in keys + extra},
                        "launches": by_pack.get(EDGE_BOND, 0)})
        g = c["k1_edge_src"]
        out.append({"name": f"packed_spmm_edge_src_{tag}", **k1_src,
                    "path": tag, "pack": f"edge_src, {tag}",
                    "width": g["width"],
                    "library": "index_select (backward: index_add_)",
                    **{k: g["fwd"][k] for k in keys},
                    "bwd": {k: g["bwd"][k] for k in keys},
                    **path_launches(k1, {tag: t})})
        if "softmax" in c:
            out.append({"name": f"packed_attention_row_sums_{tag}",
                        **k3_src, "path": tag, "pack": f"edge, {tag}",
                        **{k: c["softmax"][k] for k in row},
                        "width": 1, "path_width": 4,
                        **path_launches(k3, {tag: t})})
    for tag, m in models.items():
        c = m["check"]
        if "ties" in c:
            out += [{"name": f"{kernel.__name__[:-5]}_{tag}", **max_src,
                     "path": f"model_{tag}", "pack": f"edge max, {tag}",
                     "width": c["width"], **{k: c[half][k] for k in keys},
                     "launches": m["launches"][kernel.__name__]}
                    for half, kernel in (("fwd", K.packed_max_cuda),
                                         ("bwd", K.packed_max_bwd_cuda))]
        else:
            out.append({"name": f"packed_segment_{tag}", **k2_src,
                        "path": f"model_{tag}", "pack": f"edge, {tag}",
                        "width": c["width"],
                        **{k: c[k] for k in keys + extra},
                        "launches": m["k2_launches_by_pack"].get(EDGE, 0)})
    return out


def sweep_round1_phase() -> dict:
    """sweep_round1: scripts/design/run_design_round1.sh's three steps
    through the port.  (1) gen_grid_sample_aliased samples round1 along
    SWEEP_ALIASES at SWEEP_SAMPLE_NUM, every point budget-matched to
    design_v1 (its configs' count and seconds; each kept point's
    dim_inner and parameter count beside the baseline's); (2) three nx
    points are kept: the first scalefree node point, the first
    smallworld node point with agg max and the first graph-task point;
    (3) exp/runner.run_batch runs them, one job at a time, each a
    ``python -m graphgym_tpu_torch.main --mark_done`` process on the
    card, for 3 epochs with an eval each epoch on the design corpora;
    (4) exp/agg.agg_batch aggregates the batch.  Fails unless the runner
    reports no failure, every config was renamed _done, each job's log
    names the CUDA device, every train loss is finite, every val
    accuracy lies in [0, 1] and val_best.csv holds one row a run."""
    import csv

    import yaml

    from graphgym_tpu_torch.config import get_cfg
    from graphgym_tpu_torch.exp import agg, budget, grid, runner

    out = os.path.join(OUT, "sweep_round1")
    configs, results = (os.path.join(out, d) for d in ("configs", "results"))
    shutil.rmtree(out, ignore_errors=True)
    design = config("design/design_v1")
    t0 = time.perf_counter()
    paths = grid.gen_grid_sample_aliased(
        design, os.path.join(ROOT, "grids", "design", "round1.txt"),
        configs, sample_num=SWEEP_SAMPLE_NUM, aliases=list(SWEEP_ALIASES),
        config_budget=design, results_dir=results)
    generate_s = time.perf_counter() - t0
    points = {}
    for path in paths:
        with open(path) as f:
            points[path] = yaml.safe_load(f)
    nx = [p for p in paths if points[p]["dataset"]["format"] == "nx"]

    def first(what, test):
        for p in nx:
            if test(points[p]["dataset"], points[p]["gnn"]):
                return p
        fail(f"no {what} among the {len(nx)} nx configs")
    keep = [first("scalefree node point",
                  lambda d, g: d["task"] == "node"
                  and d["name"] == "scalefree"),
            first("smallworld node point with agg max",
                  lambda d, g: d["task"] == "node"
                  and d["name"] == "smallworld" and g["agg"] == "max"),
            first("graph-task point", lambda d, g: d["task"] == "graph")]
    for p in paths:
        if p not in keep:
            os.remove(p)
    baseline = get_cfg()
    with open(design) as f:
        baseline.merge_from_dict(yaml.safe_load(f))
    target = budget.params_count(baseline)
    kept = {}
    for p in keep:
        cfg = get_cfg()
        cfg.merge_from_dict(points[p])
        kept[os.path.basename(p)[:-5]] = dict(
            dim_inner=cfg.gnn.dim_inner, params=budget.params_count(cfg),
            baseline_params=target)
    # the jobs import the package from this checkout; their logs go to
    # their run directories only
    env = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = ROOT + (os.pathsep + env if env else "")
    t0 = time.perf_counter()
    try:
        failures = runner.run_batch(
            configs, max_jobs=1, overrides=[
                "optim.max_epoch", "3", "train.eval_period", "1",
                "dataset.dir", DESIGN_CORPUS_DIR, "print", "file"])
    finally:
        if env is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env
    run_s = time.perf_counter() - t0
    if failures:
        fail(f"run_batch: {failures} of {len(keep)} configs failed")
    done = sorted(os.listdir(configs))
    if done != sorted(os.path.basename(p) + "_done" for p in keep):
        fail(f"configs not all renamed _done: {done}")
    card = torch.cuda.get_device_name(0)
    for run, row in kept.items():
        seed_dir = os.path.join(results, run, "1")
        with open(os.path.join(seed_dir, "logging.log")) as f:
            log = f.read()
        if f"device: cuda:0 ({card})" not in log:
            fail(f"{run}: its log names no CUDA device")
        losses = [s["loss"] for s in read_stats(
            os.path.join(seed_dir, "train", "stats.json"))]
        accs = [s["accuracy"] for s in read_stats(
            os.path.join(seed_dir, "val", "stats.json"))]
        if len(losses) != 3 or not all(map(math.isfinite, losses)):
            fail(f"{run}: train losses {losses}")
        if len(accs) != 3 or not all(0.0 <= a <= 1.0 for a in accs):
            fail(f"{run}: val accuracies {accs}")
        row.update(losses=losses, val_acc=accs)
    agg.agg_batch(results)
    parity.drop_checkpoints(results)
    with open(os.path.join(results, "agg", "val_best.csv")) as f:
        rows = list(csv.DictReader(f))
    if sorted(r["run"] for r in rows) != sorted(kept):
        fail(f"val_best.csv rows {[r['run'] for r in rows]}")
    for r in rows:
        kept[r["run"]]["best_val_acc"] = float(r["accuracy"])
    return dict(sample_num=SWEEP_SAMPLE_NUM, aliases=list(SWEEP_ALIASES),
                configs_written=len(paths), nx_configs=len(nx),
                generate_s=generate_s, run_s=run_s, failures=failures,
                kept=kept, val_best_rows=len(rows))


def raw_phase() -> dict:
    """raw_files: Cora's Planetoid files and ENZYMES' TU files written
    afresh into RAW_DIR (data/standins.py, seed 0, the published sizes)
    and parsed by the port's loaders, each timed; fails unless the
    parsed graphs have the published sizes (standins.CORA, ENZYMES):
    Cora's nodes, its features' width, 7 classes and every undirected
    edge of ind.cora.graph both ways; ENZYMES' 600 graphs of 2-126
    nodes, 19,580 nodes, 74,564 directed edges, 21 feature columns (18
    attributes, 3 one-hot labels), 6 classes, and at least 100 graphs of
    100 undirected edges or more, which tu_simple_filter keeps on a node
    task."""
    from graphgym_tpu_torch.data import standins as S
    from graphgym_tpu_torch.data.loaders import (load_planetoid, load_tu,
                                                 tu_simple_filter)

    shutil.rmtree(RAW_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    S.write_planetoid_standin(RAW_DIR, "cora")
    S.write_tu_standin(RAW_DIR, "ENZYMES")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (cora,) = load_planetoid("Cora", RAW_DIR)
    enz = load_tu("ENZYMES", RAW_DIR)
    parse_s = time.perf_counter() - t0
    c, e = S.CORA, S.ENZYMES
    degree = np.bincount(cora.senders, minlength=cora.num_nodes)
    sizes = np.array([g.num_nodes for g in enz])
    edges = np.array([g.num_edges for g in enz])
    simple = tu_simple_filter(enz)
    got = dict(
        cora=dict(nodes=cora.num_nodes, directed_edges=cora.num_edges,
                  features=int(cora["node_feature"].shape[1]),
                  classes=int(cora["node_label"].max()) + 1,
                  max_degree=int(degree.max()),
                  nonzeros_a_row=float(cora["node_feature"].sum(1).mean())),
        enzymes=dict(graphs=len(enz), nodes=int(sizes.sum()),
                     min_nodes=int(sizes.min()), max_nodes=int(sizes.max()),
                     directed_edges=int(edges.sum()),
                     features=int(enz[0]["node_feature"].shape[1]),
                     classes=len({int(g["graph_label"][0]) for g in enz}),
                     graphs_of_100_edges=int((edges >= 200).sum()),
                     tu_simple_kept=len(simple)))
    want = dict(
        cora=dict(nodes=c["nodes"], directed_edges=2 * c["edges"],
                  features=c["features"], classes=c["classes"]),
        enzymes=dict(graphs=e["graphs"], nodes=e["nodes"],
                     min_nodes=e["min_nodes"], max_nodes=e["max_nodes"],
                     directed_edges=2 * e["edges"],
                     features=e["attributes"] + e["node_labels"],
                     classes=e["classes"]))
    for name, keys in want.items():
        for k, v in keys.items():
            if got[name][k] != v:
                fail(f"{name} stand-in: {k} {got[name][k]}, expected {v}")
    if got["enzymes"]["graphs_of_100_edges"] < 100 \
            or min(g.num_edges for g in simple) < 200:
        fail(f"ENZYMES stand-in: {got['enzymes']['graphs_of_100_edges']} "
             "graphs of 100 undirected edges or more, 100 needed")
    return dict(write_s=write_s, parse_s=parse_s, **got,
                files=sorted(os.path.relpath(os.path.join(d, f), RAW_DIR)
                             for d, _, fs in os.walk(RAW_DIR) for f in fs))


def start_ogb_files() -> subprocess.Popen:
    """Write the OGB stand-ins into OGB_DIR (data/standins.py, seed 0:
    molhiv and arxiv at the published sizes, molhiv cut to MOLHIV_CUT
    into OGB_CUT_DIR) in a process of their own while the first phases
    run; it prints each writer's seconds as one JSON line
    (``ogb_files_phase``)."""
    shutil.rmtree(OGB_DIR, ignore_errors=True)
    code = ("import json, sys, time\n"
            "from graphgym_tpu_torch.data import standins as S\n"
            "d, cut, sizes = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])\n"
            "out = {}\n"
            "for name, write in (\n"
            "        ('molhiv_write', lambda: S.write_molhiv_standin(d)),\n"
            "        ('arxiv_write', lambda: S.write_arxiv_standin(d)),\n"
            "        ('molhiv_cut_write',\n"
            "         lambda: S.write_molhiv_standin(cut, **sizes))):\n"
            "    t0 = time.perf_counter()\n"
            "    write()\n"
            "    out[name] = time.perf_counter() - t0\n"
            "print(json.dumps(out))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, OGB_DIR, OGB_CUT_DIR,
         json.dumps(MOLHIV_CUT)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc


def ogb_files_phase(writer: subprocess.Popen) -> dict:
    """ogb_files: ogbg-molhiv's and ogbn-arxiv's raw directories as
    ``start_ogb_files``' process wrote them into OGB_DIR (the published
    sizes: standins.MOLHIV, ARXIV), each timed, and molhiv's cut to
    MOLHIV_CUT into OGB_CUT_DIR (the molhiv path's); fails unless the
    process ended well and the files hold
    the published sizes: molhiv's 41,127 graphs (raw/num-node-list and
    num-edge-list), its largest of max_nodes atoms, 9 atom and 3 bond
    columns and its scaffold split, arxiv's nodes, 1,166,243 directed
    citations (raw/edge and num-edge-list), 128 features, 40 classes
    and its time split.  The OGB loaders parse them in the paths."""
    import gzip

    from graphgym_tpu_torch.data import standins as S
    from graphgym_tpu_torch.data.ogb import _read_csv_gz

    t0 = time.perf_counter()
    out, err = writer.communicate(timeout=900)
    if writer.returncode != 0:
        fail(f"writing the OGB stand-ins: exit {writer.returncode}: "
             f"{err[-2000:]}")
    seconds = dict(json.loads(out.splitlines()[-1]),
                   waited=time.perf_counter() - t0)

    def read(name, part, dtype=np.int64):
        return _read_csv_gz(os.path.join(OGB_DIR, name, part), dtype)

    def width(name, part):          # the first row's columns
        with gzip.open(os.path.join(OGB_DIR, name, part), "rt") as f:
            return len(f.readline().split(","))

    m, a = S.MOLHIV, S.ARXIV
    nodes = read("ogbg_molhiv", "raw/num-node-list.csv.gz").reshape(-1)
    edges = read("ogbg_molhiv", "raw/num-edge-list.csv.gz").reshape(-1)

    def split(name, scheme):
        return [len(read(name, f"split/{scheme}/{p}.csv.gz"))
                for p in ("train", "valid", "test")]
    got = dict(
        molhiv=dict(graphs=len(nodes), nodes=int(nodes.sum()),
                    mean_nodes=float(nodes.mean()),
                    max_nodes=int(nodes.max()), bonds=int(edges.sum()),
                    mean_bonds=float(edges.mean()),
                    atom_columns=width("ogbg_molhiv",
                                       "raw/node-feat.csv.gz"),
                    bond_columns=width("ogbg_molhiv",
                                       "raw/edge-feat.csv.gz"),
                    positives=int(read("ogbg_molhiv",
                                       "raw/graph-label.csv.gz").sum()),
                    split=split("ogbg_molhiv", "scaffold")),
        arxiv=dict(nodes=int(read("ogbn_arxiv",
                                  "raw/num-node-list.csv.gz")[0, 0]),
                   directed_edges=len(read("ogbn_arxiv",
                                           "raw/edge.csv.gz")),
                   features=width("ogbn_arxiv", "raw/node-feat.csv.gz"),
                   classes=int(read("ogbn_arxiv",
                                    "raw/node-label.csv.gz").max()) + 1,
                   split=split("ogbn_arxiv", "time")))
    want = dict(
        molhiv=dict(graphs=m["graphs"], max_nodes=m["max_nodes"],
                    atom_columns=9, bond_columns=3, split=list(m["split"])),
        arxiv=dict(nodes=a["nodes"], directed_edges=a["edges"],
                   features=a["features"], classes=a["classes"],
                   split=list(a["split"])))
    for name, keys in want.items():
        for k, v in keys.items():
            if got[name][k] != v:
                fail(f"{name} stand-in: {k} {got[name][k]}, expected {v}")
    return dict(seconds=seconds, molhiv_cut=MOLHIV_CUT, **got)


def samplers_phase(device, overrides) -> dict:
    """samplers_arxiv: ogbn_arxiv_design's config and loaded data (the
    dataset cache of its path), one short training through the entry
    point (``run_single``) with each train.sampler (train.iter_per_epoch
    SAMPLER_ITERS) and with train.sample_node on the full batch; the
    eval splits full batch.  Per run: each train epoch's draws (nodes
    and edges of each subgraph), host seconds and signatures, what each
    epoch adds, the graphs captured by step, finite losses, and K1's
    launches held exactly (generalconv's 'plain' pack: 4 a train step,
    2 an eval batch, all at 256), the batches counted from the run's own
    loader calls (the trainer's construction and its edge count draw
    ahead of the epochs too)."""
    k1 = K.packed_spmm_cuda
    out = {}
    for kind in (*SAMPLER_ITERS, "sample_node"):
        extra = (["train.sample_node", "True"] if kind == "sample_node"
                 else ["train.sampler", kind, "train.iter_per_epoch",
                       str(SAMPLER_ITERS[kind])])
        run_dir = os.path.join(OUT, "samplers", kind)
        shutil.rmtree(run_dir, ignore_errors=True)
        cfg_file = config(ARXIV_DESIGN[0])
        cfg = load_cfg(cfg_file, overrides + extra + ["out_dir", run_dir])
        t0 = time.perf_counter()
        with Draws() as draws, Captures() as captures:
            _, (launches, by_width, *_) = counted(
                lambda: run_single(cfg, cfg.out_dir, cfg_file))
        run_s = time.perf_counter() - t0
        parity.drop_checkpoints(run_dir)
        # the trainer's construction and its edge count draw first
        train = [c for c in draws.calls if c["train"]][-cfg.optim.max_epoch:]
        evals = sum(c["batches"] for c in draws.calls if not c["train"])
        steps = sum(c["batches"] for c in train)
        hold_counts(f"samplers_arxiv {kind}", launches,
                    {k1.__name__: (4 * steps + 2 * evals,
                                   f"4/train step x {steps} + 2/eval "
                                   f"batch x {evals}")})
        hold_counts(f"samplers_arxiv {kind}, at width "
                    f"{cfg.gnn.dim_inner}",
                    at_width(by_width, cfg.gnn.dim_inner),
                    {k1.__name__: (4 * steps + 2 * evals, "all")})
        losses = [st["loss"] for st in read_stats(
            os.path.join(cfg.out_dir, "train", "stats.json"))]
        if len(losses) != cfg.optim.max_epoch \
                or not all(map(math.isfinite, losses)):
            fail(f"samplers_arxiv {kind}: train losses {losses}")
        out[kind] = dict(
            epochs=cfg.optim.max_epoch, train_steps=steps,
            eval_batches=evals, run_s=run_s,
            draws=[c["draws"] for c in train],
            host_s=[c["seconds"] for c in train],
            signatures=len({sig for c in train for sig in c["signatures"]}),
            new_signatures_by_epoch=new_by_epoch(
                [c["signatures"] for c in train]),
            captures=dict(captures.counts), losses=losses,
            k1_launches=launches[k1.__name__])
    return out


def bond_phase(device, overrides) -> dict:
    """model_bond: the Bond edge encoder and its BatchNorm on the card
    against the CPU (``model_phase``), on a TU set with edge labels
    written into OGB_DIR (data/standins.py, BOND_TU; ENZYMES has none;
    the edge paths read the same files), the ENZYMES graph point without
    the ego transform (so the edge features stay aligned with the edges)
    at generaledgeconv, whose messages read the encoded edge features:
    the Bond encoder's output, its tables' gradient and the edge
    BatchNorm's statistics held card against CPU; K1 12 (x_j of three
    layers on the 'edge_src' gather and the add pooling, forward and
    backward, then the eval forward), K2 7 (the layers' sums, train and
    eval, 6 on the 'edge' pack, and the tables' gradient, 1 on the
    encoder's embedding pack)."""
    from graphgym_tpu_torch.data import standins as S

    S.write_tu_standin(OGB_DIR, "BONDS", seed=5, **BOND_TU)
    overrides = overrides + list(IDGRAPH_ENZYMES[1]) + [
        "dataset.dir", OGB_DIR, "dataset.name", "TU_BONDS",
        "dataset.transform", "none", "gnn.layer_type", "generaledgeconv",
        "dataset.edge_encoder", "True", "dataset.edge_encoder_name", "Bond"]
    out = model_phase("bond", config(IDGRAPH_ENZYMES[0]), overrides, device,
                      {K.packed_spmm_cuda: 12,
                       K.packed_segment_matmul_cuda: 7},
                      k2_packs={EDGE: 6, EDGE_ENCODER: 1})
    if not out["buffers"] or out["edge_columns"] != 4:
        fail(f"model_bond: {out['buffers']} buffers, "
             f"{out['edge_columns']} edge feature columns")
    return out


def linkid_ba_path(device, ba_overrides) -> dict:
    """linkid_ba through drive_path: link.txt:21-34's ID point on ba at
    gatidconv (LINKID_BA), the edge-net union of 64 copies a graph.  Per
    layer K3 6 per train step (4 of them row sums at width 1: the
    softmax's two and the node scores' two gradients) and the SDDMM 1
    (dalpha), K3 2 (1) per eval batch; 5 layers.  ba's constant feature:
    seeded random ones in the model check, on the first 8 train graphs'
    union (~32 k nodes)."""
    k3_, sddmm_ = K.packed_segment_matmul_headed_cuda, K.packed_sddmm_cuda
    return drive_path("linkid_ba", device, ba_overrides, base=LINKID_BA[0],
                      extra=(*LINKID_BA[1], "optim.max_epoch", str(EPOCHS)),
                      expected={k3_: (30, 10), sddmm_: (5, 0)},
                      widths={1: {k3_: (20, 5)}, 128: {k3_: (10, 5)}},
                      random_features=True, model_graphs=8)


def same_union(a, b) -> bool:
    """Two ego-net unions equal array for array: the node count, the
    edge_index (values and dtype) and every feature."""
    return (a.num_nodes == b.num_nodes
            and a.edge_index.dtype == b.edge_index.dtype
            and np.array_equal(a.edge_index, b.edge_index)
            and sorted(a.feats) == sorted(b.feats)
            and all(np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                    and np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                    for k in b.feats))


def ego_union_phase() -> dict:
    """ego_union: the native ego-net union (data/transforms.ego_nets on
    native/graph_native.cpp's ego_sizes / ego_fill) against its numpy
    plain version (``ego_nets_plain``) on the molhiv stand-in cut to
    MOLHIV_CUT, at the molhiv point's r = 3 (its 3 MP layers): every
    union equal array for array, each version timed; the native union
    alone on all the stand-in's molecules; and the native betweenness
    on ba500's first graph against the Python loop, bitwise, each
    timed.  Fails unless all are equal and the native union takes at
    most a fifth of the numpy one's time.  Host seconds on the card
    machine's CPU."""
    from graphgym_tpu_torch.data import structure as st
    from graphgym_tpu_torch.data import transforms as T
    from graphgym_tpu_torch.data.loaders import load_nx
    from graphgym_tpu_torch.data.ogb import load_ogb_graph

    radius = 3
    cut = load_ogb_graph("ogbg-molhiv", OGB_CUT_DIR)
    t0 = time.perf_counter()
    plain = [T.ego_nets_plain(g, radius) for g in cut]
    t1 = time.perf_counter()
    fast = [T.ego_nets(g, radius) for g in cut]
    t2 = time.perf_counter()
    numpy_s, native_s = t1 - t0, t2 - t1
    bad = [i for i, (a, b) in enumerate(zip(fast, plain))
           if not same_union(a, b)]
    if bad or len(fast) != MOLHIV_CUT["graphs"]:
        fail(f"native ego union differs from the numpy one on molecules "
             f"{bad[:10]} of {len(fast)}")
    if native_s * 5 > numpy_s:
        fail(f"native ego union {native_s:.3f} s, numpy {numpy_s:.3f} s: "
             "less than 5x")
    full = load_ogb_graph("ogbg-molhiv", OGB_DIR)
    t0 = time.perf_counter()
    unions = [T.ego_nets(g, radius) for g in full]
    full_s = time.perf_counter() - t0
    (g,) = load_nx("ba500", CORPUS500_DIR)[:1]
    t0 = time.perf_counter()
    want = st.betweenness_centrality_plain(g)
    t1 = time.perf_counter()
    got = st.betweenness_centrality(g)
    t2 = time.perf_counter()
    if not np.array_equal(got, want):
        fail(f"native betweenness differs from the Python loop by up to "
             f"{np.abs(got - want).max()}")
    return dict(
        radius=radius, cut=dict(
            molecules=len(cut), union_nodes=sum(u.num_nodes for u in fast),
            union_edges=sum(u.num_edges for u in fast), numpy_s=numpy_s,
            native_s=native_s, speedup=numpy_s / native_s,
            arrays_equal=True),
        full=dict(molecules=len(full),
                  union_nodes=sum(u.num_nodes for u in unions),
                  union_edges=sum(u.num_edges for u in unions),
                  native_s=full_s),
        betweenness=dict(graph="ba500[0]", nodes=g.num_nodes,
                         edges=g.num_edges, python_s=t1 - t0,
                         native_s=t2 - t1, bitwise_equal=True))


def gin_sum_beside(device, overrides) -> dict:
    """ginconv_ba's first train batch under gin_agg sum (the 'plain'
    pack) beside gcn_noself (its 'gcn_noself' pack: the same edges,
    other weights): K1 on each fwd pack at the model width, the two
    timed in turn over three rounds (``timings``), and each config's
    captured trainer (exp/remat_cost.run without remat, 7 steps): its
    median replay wall ms.  No path's launches are counted here."""
    fwd, steps = {}, {}
    for agg in ("sum", "gcn_noself"):
        cfg, loaders, _ = load_path(config("ginconv_ba"), list(overrides)
                                    + ["gnn.gin_agg", agg])
        host_batch = loaders[0].batches(0)[0]
        fwd[agg] = host_batch.to(device).packs[gin_kind(agg)][0]
        steps[agg] = remat_cost.run(cfg, loaders, host_batch, device,
                                    False, 7)["step_wall_ms"]
    n, d = host_batch.num_nodes, cfg.gnn.dim_inner
    x = torch.randn(n, d, generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    rounds = [{agg: timings({"kernel": lambda p=pack: K.packed_spmm_cuda(
        p, x)}, pack, x, slot_bytes=8)["ms"] for agg, pack in fwd.items()}
        for _ in range(3)]
    return dict(n=n, width=d, packs={agg: dict(
        kind=gin_kind(agg), slots=int(pack.senders.numel()),
        real_slots=real_slots_of(pack)) for agg, pack in fwd.items()},
        k1_ms_rounds=rounds, replay_wall_ms=steps)


def remat_trainer(cfg, loaders, host_batch, device, remat: bool,
                  steps: int) -> dict:
    """exp/remat_cost.run's captured trainer at tpu.remat ``remat`` on
    ``host_batch`` (its losses, peak memory and median replay wall ms),
    with the launches of its steps and, after them, its gradients,
    parameters, buffers, the end state of the generators its modules
    hold, its capture seconds and graphs; fails unless every MP layer
    has the remat flag asked."""
    def state(trainer) -> dict:
        model = trainer.model
        if not all(m.remat == remat for m in model.mp.layers):
            fail(f"tpu.remat {remat}: the MP layers' remat flags differ")
        (prog,) = trainer.train_step.programs.values()
        return dict(
            grads=[p.grad.detach().clone() for p in model.parameters()],
            params=[p.detach().clone() for p in model.parameters()],
            buffers=[b.clone() for b in model.buffers()],
            generators=[g.get_state() for g in {
                id(v): v for m in model.modules() for v in vars(m).values()
                if isinstance(v, torch.Generator)}.values()],
            capture_s=prog.capture_s, graphs=trainer.train_step.captured)
    out, (launches, *_) = counted(lambda: remat_cost.run(
        cfg, loaders, host_batch, device, remat, steps, extra=state))
    return dict(out, launches=launches)


def remat_phase(device, overrides, ba500) -> dict:
    """remat: tpu.remat on design_ws's point (ginidconv, PReLU,
    skipsum, BatchNorm, dropout 0.3, full width) on its first train
    batch: three captured trainers from one seed, 5 steps each, one
    without remat and two with it; fails unless their losses,
    gradients, parameters, BN running statistics and the dropout
    generator's end state (so its masks' draws) are bitwise equal,
    unless K1 launches 6 a train step without remat and 9 with it (each
    of the 3 MP layers' forwards again in the backward) and unless each
    trainer captures one graph.  Then idgraph_ba500's train batch as
    its path loaded it (``ba500``: the cfg, loaders and host batch), a
    captured trainer without remat and, after it is freed, one with
    it, 7 steps each: the peak device memory of each above what was
    allocated before it, the capture seconds and the median wall ms of
    the replays; K1 6 and 8 a train step (the pooling's 2 beside 2 per
    layer, 2 layers); the losses bitwise equal."""
    cfg, loaders, _ = load_path(config("idgcn_ws"), overrides + [
        "gnn.layer_type", "ginidconv", *DESIGN_WS])
    host_batch = loaders[0].batches(0)[0]
    k1 = K.packed_spmm_cuda.__name__
    runs = [remat_trainer(cfg, loaders, host_batch, device, on, 5)
            for on in (False, True, True)]
    keys = ("losses", "grads", "params", "buffers", "generators")

    def equal(a, b):
        return all(all(map(torch.equal, a[k], b[k])) if k != "losses"
                   else a[k] == b[k] for k in keys)
    if not (equal(runs[0], runs[1]) and equal(runs[1], runs[2])):
        fail("design_ws with tpu.remat: the trainings differ from each "
             "other or from the one without remat: losses "
             f"{[r['losses'] for r in runs]}")
    if not runs[0]["generators"]:
        fail("design_ws: no dropout generator")
    want = [6 * 5, 9 * 5, 9 * 5]
    got = [r["launches"].get(k1, 0) for r in runs]
    if got != want or any(r["graphs"] != 1 for r in runs):
        fail(f"design_ws remat: K1 launches {got} (want {want}), graphs "
             f"{[r['graphs'] for r in runs]}")
    design = dict(losses=runs[0]["losses"], k1_launches=got,
                  bitwise_equal=True, peak_memory_bytes=[
                      r["peak_memory_bytes"] for r in runs],
                  replay_wall_ms=[r["step_wall_ms"] for r in runs])
    del runs
    cfg, loaders, host_batch = ba500
    big = {}
    for on in (False, True):
        r = remat_trainer(cfg, loaders, host_batch, device, on, 7)
        big["remat" if on else "plain"] = {
            k: r[k] for k in ("losses", "peak_memory_bytes", "capture_s",
                              "step_wall_ms", "graphs")}
        big["remat" if on else "plain"]["k1_launches"] = \
            r["launches"].get(k1, 0)
        del r
    plain, rem = big["plain"], big["remat"]
    if plain["losses"] != rem["losses"] or plain["k1_launches"] != 6 * 7 \
            or rem["k1_launches"] != 8 * 7:
        fail(f"idgraph_ba500 remat: losses {plain['losses']} / "
             f"{rem['losses']}, K1 {plain['k1_launches']} / "
             f"{rem['k1_launches']} (want 42 / 56)")
    return dict(design_ws=design, idgraph_ba500=dict(
        big, nodes=int(host_batch.num_nodes), width=cfg.gnn.dim_inner,
        layers_mp=cfg.gnn.layers_mp,
        peak_saved_bytes=plain["peak_memory_bytes"]
        - rem["peak_memory_bytes"],
        step_ms_added=rem["step_wall_ms"] - plain["step_wall_ms"]))


# ------------------------------------------------------------------------
# A14 (tpu.dtype bfloat16) and A0's COO layer route (tpu.spmm_impl xla)
# ------------------------------------------------------------------------

BF16 = torch.bfloat16


def dtype_runs(cfg, loaders, host_batch, device,
               dtypes=("float32", "bfloat16")) -> dict:
    """For each cfg.tpu.dtype of ``dtypes`` a fresh captured trainer on
    ``host_batch`` (``remat_cost.run``: STEPS steps, two to capture, the
    median wall ms of the replays, the peak device memory above what was
    allocated before it), the first freed before the next; fails unless
    the losses are finite and the master parameters, the Adam moments
    and the buffers stay f32."""
    def not_f32(trainer):
        bad = [k for k, p in trainer.model.named_parameters()
               if p.dtype != torch.float32]
        bad += [k for k, b in trainer.model.named_buffers()
                if b.is_floating_point() and b.dtype != torch.float32]
        bad += [f"adam {k}" for st in trainer.optimizer.state.values()
                for k, v in st.items() if torch.is_tensor(v)
                and v.is_floating_point() and v.dtype != torch.float32]
        return dict(not_f32=bad)
    out = {}
    for name in dtypes:
        c = cfg.clone()
        c.tpu.dtype = name
        r = remat_cost.run(c, loaders, host_batch, device, False,
                           remat_cost.STEPS, extra=not_f32)
        if r["not_f32"] or not all(map(math.isfinite, r["losses"])):
            fail(f"{cfg.gnn.layer_type} at {name}: losses {r['losses']}, "
                 f"state not f32: {r['not_f32']}")
        out[name] = {k: r[k] for k in ("losses", "step_wall_ms",
                                       "peak_memory_bytes")}
    return dict(out, steps=remat_cost.STEPS, nodes=int(host_batch.num_nodes),
                timed="median wall ms of the replays after 2 steps")


def bf16_main_phase(device, overrides) -> dict:
    """bf16_main: the main path (configs/idgcn_ws.yaml: ID-GCN Full, 3 x
    128, the Tfg head at 256) at tpu.dtype bfloat16, EPOCHS epochs
    through the captured steps (``train_path``: K1 6 a train step and 3
    an eval batch, every launch on bf16 input), two trainings bitwise
    (``repeat_steps``), eager against captured bitwise
    (``graphed_check``), card against CPU at BF16_TIGHT, no witness
    (``check_model``), that tier turning down a K1 that leaves its
    weights unrounded (``planted_bf16``), and the replay ms and peak
    memory of a train step at f32 and at bf16 on the train batch, the
    masters f32 (``dtype_runs``)."""
    ovr = overrides + ["tpu.dtype", "bfloat16"]
    cfg, loaders, _ = load_path(CFG, ovr)
    k1 = K.packed_spmm_cuda
    train = train_path(CFG, ovr, os.path.join(OUT, "idgcn_bf16"), loaders,
                       {k1: (6, 3)})
    dtypes = by_dtype()
    if dtypes != {k1.__name__: {str(BF16): train["launches"][k1.__name__]}}:
        fail(f"bf16_main: launches by input dtype {dtypes}; every K1 "
             "launch must read bf16")
    return dict(train=train, launches_by_dtype=dtypes,
                repeat=repeat_steps(cfg, loaders, device),
                graphed=graphed_check(cfg, loaders, device),
                model=check_model(cfg, loaders[1].batches(0)[0], device,
                                  compute_dtype=BF16, bf16_tier=BF16_TIGHT),
                planted=planted_bf16(cfg, loaders[1].batches(0)[0],
                                     device),
                cost=dtype_runs(cfg, loaders, loaders[0].batches(0)[0],
                                device))


def planted_bf16(cfg, batch, device) -> str:
    """check_model at BF16_TIGHT with a K1 on the card that leaves its
    weights unrounded against a bf16 x (the f32 kernel on x widened,
    its output cast back to bf16; the CPU reference keeps the rounding):
    the check must fail; returns its message."""
    real = K.spmm_packed

    def unrounded(pack, x):
        if x.is_cuda and x.dtype == BF16:
            return real(pack, x.float()).to(BF16)
        return real(pack, x)
    K.spmm_packed, _PLANTED[0] = unrounded, True
    try:
        check_model(cfg, batch, device, compute_dtype=BF16,
                    bf16_tier=BF16_TIGHT)
    except CheckFailed as exc:
        return str(exc)
    finally:
        K.spmm_packed, _PLANTED[0] = real, False
    fail("planted bf16 fault (K1's weights unrounded): the model check "
         "passed at BF16_TIGHT")


def library_or_none(fn):
    """fn where the library call runs on these inputs (a bf16 sparse
    product may not), else None."""
    try:
        fn()
        torch.cuda.synchronize()
        return fn
    except (RuntimeError, NotImplementedError):
        return None


def timed_row(calls: dict, moved: int, flops: int, err: float) -> dict:
    """A kernels-line row's numbers from ``bounded_times``: a call left
    out of ``calls`` (no library call) reads None."""
    calls = {k: f for k, f in calls.items() if f is not None}
    t = bounded_times(calls, moved, flops)
    return dict(max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["library_ms"], timed_by=t["timed_by"],
                bytes=t["bytes"])


def held(case: str, got: torch.Tensor, want: torch.Tensor,
         tol: dict) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **tol):
        fail(f"{case}: kernel vs plain max err {err} beyond {tol}")
    return err


def bf16_k1(pack: K.PackedCSR, n: int, d: int, device) -> dict:
    """K1 on bf16 x against its plain version (both round the weights to
    bf16) and its times beside the bound (x read at 2 bytes)."""
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(n, d, generator=gen, device=device).bfloat16()
    err = held("K1 bf16", K.spmm_packed(pack, x),
               K.spmm_packed_plain(pack, x), BF16_TOL)
    a = csr_of(pack, n).to(BF16)
    row = timed_row({"kernel": lambda: K.packed_spmm_cuda(pack, x),
                     "plain": lambda: K.spmm_packed_plain(pack, x),
                     "library": library_or_none(
                         lambda: torch.sparse.mm(a, x))},
                    *timings_moved(pack, x, 8), err)
    return dict(row, width=d)


def bf16_att(packs, n: int, d: int, heads: int, device) -> dict:
    """K3 on bf16 v (alpha the softmax of random logits, rounded to bf16
    by both versions) and the SDDMM on bf16 a, b at the path's 'att'
    pack, each against its plain version and timed beside its bound."""
    fwd = packs[0]
    gen = torch.Generator(device=device).manual_seed(6)
    v = torch.randn(n, d, generator=gen, device=device).bfloat16()
    alpha = K.packed_segment_softmax(torch.randn(
        fwd.senders.shape + (heads,), generator=gen, device=device), fwd)
    err = held("K3 bf16", K.packed_segment_matmul_headed_cuda(fwd, v, alpha),
               K.packed_segment_matmul_headed_plain(fwd, v, alpha), BF16_TOL)
    # one head: the library call is torch.sparse.mm of alpha's bf16 CSR
    csr = csr_of(fwd, n, alpha[..., 0]).to(BF16)
    k3 = timed_row({"kernel": lambda: K.packed_segment_matmul_headed_cuda(
        fwd, v, alpha), "plain": lambda: K.packed_segment_matmul_headed_plain(
            fwd, v, alpha), "library": library_or_none(
                lambda: torch.sparse.mm(csr, v)) if heads == 1 else None},
        *timings_moved(fwd, v, 4 + 4 * heads), err)
    a, b = (torch.randn(n, heads, d // heads, generator=gen,
                        device=device).bfloat16() for _ in range(2))
    got = K.packed_sddmm_cuda(fwd, a, b)
    want = K.packed_sddmm_plain(fwd, a, b)
    valid = valid_csr(fwd, n).to(BF16)
    a1, b1t = a[:, 0], b[:, 0].t()
    sddmm = timed_row({"kernel": lambda: K.packed_sddmm_cuda(fwd, a, b),
                       "plain": lambda: K.packed_sddmm_plain(fwd, a, b),
                       "library": library_or_none(
                           lambda: torch.sparse.sampled_addmm(
                               valid, a1, b1t, beta=0.0))
                       if heads == 1 else None},
                      *sddmm_bound(fwd, a),
                      held("SDDMM bf16", got, want, BF16_TOL))
    return dict(k3=dict(k3, width=d, heads=heads),
                sddmm=dict(sddmm, heads=heads, dh=d // heads))


def bf16_max(packs, n: int, d: int, device) -> dict:
    """The segmented max forward and backward on bf16 x against their
    plain versions (the forward bitwise: a max of w * x in f32 is
    exact; the backward at F32_TOL against the plain version on the
    CPU, which sums in slot order as ``check_max_kernel``'s), timed beside their bounds (x read at 2 bytes) and the
    library calls (``max_library``: the messages w * x, f32 as the
    kernel's, gathered from the bf16 x before the timing)."""
    fwd, bwd = packs
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(n, d, generator=gen, device=device).bfloat16()
    rows = fwd.row_range.shape[0]
    g = torch.randn(rows, d, generator=gen, device=device)
    out, cnt = K.packed_max_cuda(fwd, x)
    want, want_cnt = K.packed_max_plain(fwd, x)
    if not (torch.equal(out, want) and torch.equal(cnt, want_cnt)):
        fail(f"max bf16 d={d}: forward differs from the plain version")
    dx = K.packed_max_bwd_cuda(bwd, x, g, out, cnt)
    # the plain version on the CPU, whose index_add_ sums in slot order as
    # the kernel does (on the card its index_add_ adds in any order)
    cpu_bwd = K.PackedCSR(*(a.cpu() for a in bwd))
    want_dx = K.packed_max_bwd_plain(cpu_bwd, x.cpu(), g.cpu(), out.cpu(),
                                     cnt.cpu())
    err = held("max bwd bf16", dx.cpu(), want_dx, F32_TOL)
    library, library_bwd = max_library(fwd, x, g, out, f"max bf16 d={d}")
    rd4 = rows * d * 4
    f_slots, b_slots = real_slots_of(fwd), real_slots_of(bwd)
    fwd_row = timed_row(
        {"kernel": lambda: K.packed_max_cuda(fwd, x),
         "plain": lambda: K.packed_max_plain(fwd, x), "library": library},
        live_rows(fwd, n) * d * 2 + 2 * rd4 + f_slots * 8
        + fwd.row_range.numel() * 4, 2 * f_slots * d, 0.0)
    bwd_row = timed_row(
        {"kernel": lambda: K.packed_max_bwd_cuda(bwd, x, g, out, cnt),
         "plain": lambda: K.packed_max_bwd_plain(bwd, x, g, out, cnt),
         "library": library_bwd},
        int((bwd.row_range[:, 1] > bwd.row_range[:, 0]).sum()) * d * 2
        + 3 * rd4 + n * d * 4 + b_slots * 8 + bwd.row_range.numel() * 4,
        4 * b_slots * d, err)
    return dict(width=d, fwd=fwd_row, bwd=bwd_row)


def bf16_k2(index: K.SegmentIndex, n_src: int, d: int, device) -> dict:
    """K2 on bf16 messages [n_src, d] of ``index`` against its plain
    version on the CPU (``k2_checks``, f32 and bf16), timed beside its
    bound: each message row the summed positions name read once at 2
    bytes (an embedding pack's positions name an item's row once per id
    column), the index, the f32 output written once."""
    gen = torch.Generator(device=device).manual_seed(8)
    msg = torch.randn(n_src, d, generator=gen, device=device)
    errs = k2_checks("K2 bf16", msg, index)
    mb = msg.bfloat16()
    positions = int(index.row_ptr[-1])
    n_out = index.row_ptr.numel() - 1
    read = (positions if index.src is None
            else int(torch.unique(index.src[:positions]).numel()))
    moved = (read * d * 2 + 4 * sum(a.numel() for a in index
                                    if a is not None)
             + n_out * d * 4)
    mat = index_matrix(index, n_src).to(BF16)
    row = timed_row({"kernel": lambda: K.segment_sum_cuda(mb, index),
                     "plain": lambda: K.segment_sum_plain(mb, index),
                     "library": library_or_none(
                         lambda: torch.sparse.mm(mat, mb))},
                    moved, positions * d, errs["bf16_err"])
    return dict(row, width=d, positions=positions, rows_read=read,
                errs=errs)


def bf16_model(cfg, batch, device, random_features, tier) -> dict:
    """check_model at bf16 on one path's batch at its ``tier``, its card
    side's launches by kernel and input dtype."""
    cfg = cfg.clone()
    cfg.tpu.dtype = "bfloat16"
    model, (launches, *_) = counted(lambda: check_model(
        cfg, batch, device, random_features, compute_dtype=BF16,
        bf16_tier=tier))
    return dict(model, launches={k: v for k, v in launches.items() if v},
                launches_by_dtype=by_dtype())


BF16_TIERS = {"idgat_ws": BF16_TIGHT, "design_sf_max": BF16_SF_MAX,
              "edge_general": BF16_V2OGB, "ogbg_molhiv_gcnid": BF16_V2OGB}


def bf16_models_phase(device, paths: dict, ba) -> dict:
    """bf16_models: ``check_model`` at bf16 (a train step's logits and
    gradients and an eval forward, card against CPU, each path at its
    tier, BF16_TIERS) on ID-GAT ws, design_sf_max, edge_general and the molhiv
    cut, each path's kernels on bf16 input at its train batch's packs
    against their plain versions and timed beside their bounds (K3 and
    the SDDMM on 'att'; the max on 'plain'; K2 on 'edge'; K1 on 'gcn'
    and K2 on the Atom encoder's pack at 300), and the replay ms and
    peak memory of ID-GCN ba's train step (327,680 rows) at f32 and
    bf16.  ``paths``: tag -> (cfg, loaders, model batch,
    random_features)."""
    out = {}
    for tag, (cfg, loaders, model_batch, rf) in paths.items():
        begin(f"bf16_models {tag}")
        host = loaders[0].batches(0)[0]
        dev = host.to(device)
        n, d = host.num_nodes, cfg.gnn.dim_inner
        if tag == "idgat_ws":
            kernels = bf16_att(dev.packs["att"], n, d, cfg.gnn.att_heads,
                               device)
        elif tag == "design_sf_max":
            kernels = dict(max=bf16_max(dev.packs["plain"], n, d, device))
        elif tag == "edge_general":
            _, slots = dev.packs[EDGE]
            kernels = dict(k2=bf16_k2(edge_index(slots), host.num_edges, d,
                                      device))
        else:
            (pack,) = dev.packs[NODE_ENCODER]
            kernels = dict(k1=bf16_k1(dev.packs["gcn"][0], n, d, device),
                           k2=bf16_k2(embed_index(pack), n,
                                      cfg.dataset.encoder_dim, device))
        out[tag] = dict(model=bf16_model(cfg, model_batch, device, rf,
                                         BF16_TIERS[tag]),
                        kernels=kernels)
    begin("bf16_models idgcn_ba")
    cfg, loaders = ba
    out["idgcn_ba"] = dtype_runs(cfg, loaders, loaders[0].batches(0)[0],
                                 device)
    return out


def coo_route_phase(device, overrides, pallas_train_batch) -> dict:
    """coo_route: the main path at tpu.spmm_impl xla (the MP layers on
    the COO route, nn/coo.py), 2 epochs through the captured steps: K2
    9 a train step (per layer the degree at width 1 and the sum at 128,
    the gather's gradient in the backward) and 6 an eval batch, all on
    the 'coo_loops' entry's indexes, each role held under its own label
    (nn/coo.py ``COO_SUM``, ``COO_DEGREE``, ``COO_GRAD``), K1 none; two
    trainings bitwise;
    card against CPU at check_model's f32 tolerances; the replay ms of a
    train step beside K1's route on the same graphs; K2 on the entry's
    two indexes at 128 and 1 against its plain version and timed beside
    its bound, and the K2 ms a step beside K1's 6 launches on the 'gcn'
    packs (``pallas_train_batch``, K1's route's train batch)."""
    ovr = overrides + ["tpu.spmm_impl", "xla", "optim.max_epoch", "2"]
    cfg, loaders, _ = load_path(CFG, ovr)
    k2 = K.packed_segment_matmul_cuda
    layers = cfg.gnn.layers_mp
    train = train_path(CFG, ovr, os.path.join(OUT, "idgcn_xla"), loaders,
                       {k2: (3 * layers, 2 * layers)},
                       k2_packs={COO_SUM: (layers, layers),
                                 COO_DEGREE: (layers, layers),
                                 COO_GRAD: (layers, 0)})
    host = loaders[0].batches(0)[0]
    if set(host.packs) != {"coo_loops"}:
        fail(f"coo_route: the batch carries {sorted(host.packs)}")
    dev = host.to(device)
    (edges,) = dev.packs["coo_loops"]
    n, d, p = host.num_nodes, cfg.gnn.dim_inner, edges.senders.numel()
    recv, send = coo_recv_index(edges), coo_send_index(edges)
    k2_rows = {}
    for name, index, width in ((COO_SUM, recv, d), (COO_GRAD, send, d),
                               (COO_DEGREE, recv, 1)):
        gen = torch.Generator(device=device).manual_seed(9)
        msg = torch.randn(p, width, generator=gen, device=device)
        errs = k2_checks(f"coo {name}", msg, index)
        mat = index_matrix(index, p)
        positions = int(index.row_ptr[-1])
        moved = (positions * width * 4 + 4 * sum(
            a.numel() for a in index if a is not None) + n * width * 4)
        k2_rows[name] = dict(timed_row(
            {"kernel": lambda: K.segment_sum_cuda(msg, index),
             "plain": lambda: K.segment_sum_plain(msg, index),
             "library": lambda: torch.sparse.mm(mat, msg)},
            moved, positions * width, errs["f32_err"]), width=width,
            positions=positions,
            launches=train["k2_launches_by_pack"][name])
    fwd, bwd = pallas_train_batch.to(device).packs["gcn"]
    x = torch.randn(n, d, device=device)
    k1_ms = {name: time_calls({"kernel": lambda: K.packed_spmm_cuda(pack, x)},
                              1e-9)[0]["kernel"]
             for name, pack in (("fwd", fwd), ("bwd", bwd))}
    return dict(train=train, repeat=repeat_steps(cfg, loaders, device),
                model=check_model(cfg, loaders[1].batches(0)[0], device),
                positions=p, nodes=n, k2=k2_rows,
                k2_ms_per_step=layers * sum(r["ms"] for r in
                                            k2_rows.values()),
                k1_ms_per_step=layers * (k1_ms["fwd"] + k1_ms["bwd"]),
                k1_ms=k1_ms,
                replay=dict(
                    xla=remat_cost.run(cfg, loaders, host, device, False,
                                       remat_cost.STEPS)["step_wall_ms"],
                    pallas=remat_cost.run(
                        load_cfg(CFG, overrides), [FirstBatch(
                            pallas_train_batch, 1), *loaders[1:]],
                        pallas_train_batch, device, False,
                        remat_cost.STEPS)["step_wall_ms"]))


ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "timed_by")


def a14_rows(bf16_main: dict, bf16_models: dict, coo_route: dict,
             srcs: dict) -> list:
    """The kernels line's rows of this slice's paths: each kernel on bf16
    input at a bf16 path's packs (its launches on bf16 input in the
    path's run: bf16_main's training, or bf16_models' model check on
    the card), and K2 on the COO route's indexes (its launches under
    each role's label in coo_route's training)."""
    def bf16_launches(by_dtype: dict, kernel) -> int:
        return by_dtype.get(kernel.__name__, {}).get(str(BF16), 0)

    def row(name, src, path, numbers, launches, **extra):
        return {"name": name, **srcs[src], "path": path, "dtype": "bfloat16",
                **{k: numbers.get(k) for k in ROW_KEYS}, **extra,
                "launches": launches}
    models = {k: v["model"]["launches_by_dtype"]
              for k, v in bf16_models.items() if "model" in v}
    kern = {k: v["kernels"] for k, v in bf16_models.items() if "kernels" in v}
    rows = [
        row("packed_spmm_bf16", "k1", "idgcn_ws at bf16",
            bf16_main["kernels"]["k1"],
            bf16_launches(bf16_main["launches_by_dtype"], K.packed_spmm_cuda),
            width=bf16_main["kernels"]["k1"]["width"]),
        row("packed_spmm_bf16_molhiv", "k1", "ogbg_molhiv_gcnid at bf16",
            kern["ogbg_molhiv_gcnid"]["k1"],
            bf16_launches(models["ogbg_molhiv_gcnid"], K.packed_spmm_cuda),
            width=kern["ogbg_molhiv_gcnid"]["k1"]["width"]),
        row("packed_attention_bf16", "k3", "idgat_ws at bf16",
            kern["idgat_ws"]["k3"],
            bf16_launches(models["idgat_ws"],
                          K.packed_segment_matmul_headed_cuda),
            width=kern["idgat_ws"]["k3"]["width"]),
        row("packed_sddmm_bf16", "sddmm", "idgat_ws at bf16",
            kern["idgat_ws"]["sddmm"],
            bf16_launches(models["idgat_ws"], K.packed_sddmm_cuda)),
        *(row(f"{kernel.__name__[:-5]}_bf16", "max",
              "design_sf_max at bf16 (its messages w * h are f32)",
              kern["design_sf_max"]["max"][half],
              bf16_launches(models["design_sf_max"], kernel),
              width=kern["design_sf_max"]["max"]["width"])
          for half, kernel in (("fwd", K.packed_max_cuda),
                               ("bwd", K.packed_max_bwd_cuda))),
        row("packed_segment_bf16_edge", "k2", "edge_general at bf16",
            kern["edge_general"]["k2"],
            bf16_launches(models["edge_general"],
                          K.packed_segment_matmul_cuda),
            width=kern["edge_general"]["k2"]["width"]),
        row("packed_segment_bf16_atom", "k2", "ogbg_molhiv_gcnid at bf16",
            kern["ogbg_molhiv_gcnid"]["k2"],
            bf16_launches(models["ogbg_molhiv_gcnid"],
                          K.packed_segment_matmul_cuda),
            width=kern["ogbg_molhiv_gcnid"]["k2"]["width"]),
    ]
    for name, numbers in coo_route["k2"].items():
        rows.append(dict(row(f"packed_segment_{name}", "k2",
                             "idgcn_ws at tpu.spmm_impl xla", numbers,
                             numbers["launches"], width=numbers["width"]),
                         dtype="float32"))
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
    ogb_writer = start_ogb_files()

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
    main_batch = train_batch
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
    # a registered optimizer the captured step cannot take: eager train
    # steps on the card beside the captured eval step (gcnidconv: K1 6
    # per train step, 3 per eval batch)
    begin("registered_optim")
    cfg, loaders, _ = load_path(CFG, overrides + [
        "gnn.layer_type", "gcnidconv", "optim.optimizer", "rmsprop",
        "optim.base_lr", "0.003", "optim.weight_decay", "0.001",
        "optim.scheduler", "none"])
    phase("registered_optim", **registered_optim(cfg, loaders, device,
                                                 k1=(6, 3)))
    # ---- A14: the main path at tpu.dtype bfloat16, and A0's COO route
    # (tpu.spmm_impl xla) on it
    begin("bf16_main")
    bf16_main = bf16_main_phase(device, overrides)
    bf16_main["kernels"] = dict(k1=bf16_k1(
        main_batch.to(device).packs["gcn"][0], main_batch.num_nodes,
        d, device))
    phase("bf16_main", **bf16_main)
    begin("coo_route")
    coo_route = coo_route_phase(device, overrides, main_batch)
    phase("coo_route", **coo_route)

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
    # ---- the GIN aggregation ablation (cfg.gnn.gin_agg,
    # results/ablation_gin) on ba: Tfg-ginconv at full width
    # (configs/ginconv_ba.yaml: 3 x 128, batch 48, 2 train batches, no
    # transform, a constant 1-wide feature) with gin_agg gcn_noself, K1
    # on the 'gcn_noself' pack as ID-GIN ba on 'plain': layer 0 sums the
    # raw feature (no gradient), 1 + 2 x 2 per train step, 3 per eval
    # batch, 1 of each at D = 1; then gcn (the 'gcn' pack) and mean
    # ('wmean') card vs CPU on its val batch without a training (K1 8:
    # the train step's 5 and the eval forward's 3).  Seeded random
    # features in the model checks: under mean a constant input stays
    # the same in every row, and the MLPs' BatchNorms would normalize
    # rounding noise.
    gin_ablation = drive_path(
        "ginconv_ba_gcn_noself", device, ba_overrides, base="ginconv_ba",
        extra=("gnn.gin_agg", "gcn_noself"), expected={k1_: (5, 3)},
        widths={1: {k1_: (1, 1)}}, random_features=True)
    gin_models = {}
    for agg in ("gcn", "mean"):
        tag = f"ginconv_ba_{agg}"
        begin(f"model_{tag}")
        gin_models[tag] = model_phase(
            tag, config("ginconv_ba"), ba_overrides + ["gnn.gin_agg", agg],
            device, {k1_: 8}, random_features=True)
        phase(f"model_{tag}", **gin_models[tag])
    begin("ginconv_ba_sum_beside")
    gin_beside = gin_sum_beside(device, ba_overrides)
    phase("ginconv_ba_sum_beside", **gin_beside)
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
                                "ginidconv", *DESIGN_WS,
                                expected={k1_: (6, 3)},
                                random_features=True),
    }
    # ---- the Tfg APPNP model on ID-GCN ws's config: Dense [64, C], then
    # 10 propagations h <- 0.9 Anorm h + 0.1 h0 on the 'gcn' pack at
    # D = C = 6 (K1's narrow walk): 10 forward and 10 backward per train
    # step (the MLP's output needs a gradient), 10 per eval batch; the
    # layers' K1 at the model width is checked on the same pack too.
    # Constant ws features: seeded random ones in the model check.
    appnp = grid_point("appnp_ws", "idgcn_ws", "gnn.layer_type",
                       "Tfg-appnp", expected={k1_: (20, 10)},
                       widths={6: {k1_: (20, 10)}}, random_features=True)

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
            "design_sf_max", "design/design_v1", *DESIGN_SF_MAX, ovr=dz,
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
    # ---- grids/design/round1att.txt's synthetic chunks on scalefree at
    # 256 (configs/design/design_v1att.yaml, parity.POINTS), each a node
    # or graph batch of the whole corpus.  design_att_sf_mul (gmulconv,
    # 4 layers): per layer K3 6 per train step (forward: the softmax's row
    # sums at width 1, the aggregation; backward: dv, the softmax's row
    # sums, dq and dk of the SDDMM score, q and k the same h) and the
    # SDDMM 2 (score, dalpha), per eval batch K3 2 (1) and the SDDMM 1.
    # design_att_sf_add_graph (gaddconv = GATConv, 2 layers, skipsum,
    # dropout 0.3, add pooling at 256): per layer K3 6 per train step (4
    # row sums at width 1: the softmax's two and the node scores' two
    # gradients) and the SDDMM 1 (dalpha), K3 2 (1) per eval batch; K1
    # only the pooling's 2 and 1.
    att_paths = {
        "design_att_sf_mul": grid_point(
            "design_att_sf_mul", ATT_SF_MUL[0], *ATT_SF_MUL[1], ovr=dz,
            expected={k3_: (24, 8), sddmm_: (8, 4)},
            widths={1: {k3_: (8, 4)}, 256: {k3_: (16, 4)}}),
        "design_att_sf_add_graph": grid_point(
            "design_att_sf_add_graph", ATT_SF_ADD_GRAPH[0],
            *ATT_SF_ADD_GRAPH[1], ovr=dz,
            expected={k1_: (2, 1), k3_: (12, 4), sddmm_: (2, 0)},
            widths={1: {k3_: (8, 2)}, 256: {k1_: (2, 1), k3_: (4, 2)}},
            rect=(2, 1)),
    }
    # ---- the layer types no grid point of the repo sets, checked card
    # vs CPU without a training on design_sf's val batch at 256 (3 pre-MP
    # and 8 MP layers, so every layer's input needs a gradient): per
    # layer one forward and one backward in the train step and one
    # forward in the eval one.  generalconv_v2 with flow
    # target_to_source and the directed norm: K1 on 'rev_dir_mean' for
    # agg mean, the segmented max on 'rev_dir' for agg max;
    # sageinitconv built with normalize (make_conv's has none): K1 on
    # 'mean' at its input width.
    design_sf = config("design/design_v1")
    v2 = list(DESIGN_SF) + ["gnn.layer_type", "generalconv_v2",
                            "gnn.flow", "target_to_source",
                            "gnn.normalize_adj", "True"]
    sageinit = {"sageinitconv": lambda dim_in, dim_out, opts, gen, _:
                SAGEInitConv(dim_in, dim_out, normalize=True,
                             generator=gen)}
    models = {}
    for tag, extra, expected, layers in (
            ("v2_mean", v2 + ["gnn.agg", "mean"], {k1_: 24}, None),
            ("v2_max", v2 + ["gnn.agg", "max"], {max_: 16, max_bwd_: 8},
             None),
            ("sageinit", list(DESIGN_SF) + ["gnn.layer_type",
                                            "sageinitconv"], {k1_: 24},
             sageinit)):
        begin(f"model_{tag}")
        models[tag] = model_phase(tag, design_sf, dz + extra, device,
                                  expected, layers)
        phase(f"model_{tag}", **models[tag])
    # ---- round1's design sweep through the port: sample with budget
    # matching, run three points through the batch runner (a process
    # each), aggregate
    begin("sweep_round1")
    phase("sweep_round1", **sweep_round1_phase())
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
    # the ID link point on ba at gatidconv: K3 and the SDDMM on the
    # 64-copy edge-net union (~131 k nodes a batch of 32)
    linkid_ba = linkid_ba_path(device, ba_overrides)
    # ---- grids/IDGNN/graph.txt's synthetic chunks at their own size, on
    # the 500-node corpora regenerated beside the first phases (after the
    # link paths: on a slow host their processes outlast the sweep).
    # idgraph_ba500 (the ID chunk: gcnidconv on ba500 at 2 layers, ego at
    # r = 2, the union of the train graphs' ego nets): K1 2 per layer and
    # the pooling of each graph's 500 ego centers, forward and backward,
    # all at 128; 2 and 1 per eval batch.  graph_ws500 (the
    # plain chunk: gatconv with node_identity features on ws500, every
    # graph's 500 nodes pooled): per layer K3 6 (4 of them row sums at
    # width 1) and the SDDMM 1 per train step (dalpha; the additive
    # score needs none), K3 2 (1) per eval batch; K1 only the add
    # pooling's 2 and 1.  ba500's features are constant: seeded random
    # ones in its model check, on the first 10 train graphs' ego union
    # (its val batch has 7 graphs); ws500's on its train
    # batch (22 graphs; the val batch has 6, too few graph slots for the
    # head's BatchNorm).  Then the planted faults on ws500's model
    # batch.
    begin("corpus500")
    phase("corpus500", **corpus500_phase(corpora))
    c500 = overrides + ["dataset.dir", CORPUS500_DIR]
    graph500 = {
        "idgraph_ba500": grid_point(
            "idgraph_ba500", IDGRAPH_BA500[0], *IDGRAPH_BA500[1],
            *IDGRAPH_BA500_DEPTH, ovr=c500, expected={k1_: (6, 3)},
            widths={128: {k1_: (6, 3)}}, rect=(2, 1), random_features=True,
            model_graphs=10),
        "graph_ws500": grid_point(
            "graph_ws500", GRAPH_WS500[0], *GRAPH_WS500[1], ovr=c500,
            expected={k1_: (2, 1), k3_: (18, 6), sddmm_: (3, 0)},
            widths={1: {k3_: (12, 3)}, 128: {k1_: (2, 1), k3_: (6, 3)}},
            rect=(2, 1), model_graphs=22),
    }
    # ---- tpu.remat: design_ws bitwise with and without it, and
    # idgraph_ba500's peak memory and step with and without it
    begin("remat")
    phase("remat", **remat_phase(device, overrides,
                                 LOADED["idgraph_ba500"]))
    begin("model_planted")
    phase("model_planted", **planted_faults(
        config(GRAPH_WS500[0]), c500 + list(GRAPH_WS500[1]), 22, device))
    # ---- the ID-GNN paper's real-dataset points, from files in the
    # published formats (Planetoid, TU) at the published sizes.
    # cora_gatid: Cora's one graph, transductive, the ego union at r = 2
    # (~131 k nodes a split, 1,433 features); gatidconv at 2 layers as
    # gatid_ba: per layer K3 6 per train step (4 row sums at width 1)
    # and the SDDMM 1, K3 2 (1) per eval batch.  idgraph_enzymes: 600 TU
    # graphs, the graph task, ego at r = 3, 4 train batches of 128
    # graphs (the prefetch collates them): K1 2 per gcnidconv layer and
    # the add pooling of the ego centers, forward and backward, all at
    # 128; 3 and 1 per eval batch.  Both datasets' features are their
    # own (no random ones in the model check); ENZYMES' model check on
    # the first 32 train graphs (its val batch's CPU side took 15 s).
    begin("raw_files")
    phase("raw_files", **raw_phase())
    raw = overrides + ["dataset.dir", RAW_DIR]
    real_paths = {
        "cora_gatid": grid_point(
            "cora_gatid", CORA_GATID[0], *CORA_GATID[1], "optim.max_epoch",
            str(EPOCHS), ovr=raw, expected={k3_: (12, 4), sddmm_: (2, 0)},
            widths={1: {k3_: (8, 2)}, 128: {k3_: (4, 2)}}),
        "idgraph_enzymes": grid_point(
            "idgraph_enzymes", IDGRAPH_ENZYMES[0], *IDGRAPH_ENZYMES[1],
            "optim.max_epoch", str(EPOCHS), ovr=raw,
            expected={k1_: (8, 4)}, widths={128: {k1_: (8, 4)}},
            rect=(2, 1), model_graphs=32),
    }
    # ---- OGB raw directories (stand-ins at the published sizes):
    # graph_ogb.txt:21-33's ID point at gcnidconv on ogbg-molhiv (the
    # Atom encoder and its BN at 300, ego at r = 3; the stand-in cut to
    # MOLHIV_CUT, 33 train batches of 128 molecules: K1 2 per layer and
    # the add pooling of the ego
    # centers forward and backward, all at 300, 3 + 1 per eval batch; K2
    # 1 a train step, the encoder tables' gradient), an ogbn-arxiv design
    # point (design_v2.yaml, full batch, the time split: K1 2 per
    # generalconv layer on the 'plain' pack at 256, 2 per eval batch),
    # arxiv's samplers and node sampling, and the Bond encoder
    begin("ogb_files")
    phase("ogb_files", **ogb_files_phase(ogb_writer))
    begin("ego_union")
    phase("ego_union", **ego_union_phase())
    ogb = overrides + ["dataset.dir", OGB_DIR, *OGB_CACHE]
    k2_ = K.packed_segment_matmul_cuda
    ogb_paths = {
        "ogbg_molhiv_gcnid": grid_point(
            "ogbg_molhiv_gcnid", MOLHIV_ID[0], *MOLHIV_ID[1],
            "optim.max_epoch", str(EPOCHS),
            ovr=overrides + ["dataset.dir", OGB_CUT_DIR, *OGB_CACHE],
            expected={k1_: (8, 4), k2_: (1, 0)},
            widths={300: {k1_: (8, 4)}}, rect=(2, 1), pool_width=300),
        "ogbn_arxiv_design": grid_point(
            "ogbn_arxiv_design", ARXIV_DESIGN[0], *ARXIV_DESIGN[1],
            "optim.max_epoch", str(EPOCHS), ovr=ogb,
            expected={k1_: (4, 2)}, widths={256: {k1_: (4, 2)}},
            model_nodes=ARXIV_MODEL_NODES),
    }
    begin("samplers_arxiv")
    samplers = samplers_phase(device, ogb + list(ARXIV_DESIGN[1])
                              + ["optim.max_epoch", "2"])
    phase("samplers_arxiv", **samplers)
    begin("model_bond")
    phase("model_bond", **bond_phase(device, overrides))
    # ---- the six edge-feature convs on design_v2ogb.yaml's model, on the
    # BONDS files: one path a family, 5 MP layers at 300 (pre-MP gives
    # layer 0 an input that needs a gradient).  Per layer per train step:
    # K1 x_j on the 'edge_src' gather forward and backward (2; x_i on
    # 'edge_dst' 2 more with msg_direction both; splineconv gathers its
    # two projections at 600), K2 the sum over the receivers (1; the
    # sampling conv's live in-degree at width 1 one more;
    # generalogbconv's bond tables' gradient one more), the attention
    # softmax's K3 row sums at the 4 heads (2); per eval batch the
    # forwards.  The add pooling K1 2 / 1 at 300.  Every K1 launch is
    # rectangular (gathers and the pooling).
    edge_ovr = overrides + ["dataset.dir", OGB_DIR]

    def edge_path(tag, layer_type, *extra, **kw):
        return grid_point(tag, EDGE_MODEL, *EDGE_BONDS, "gnn.layer_type",
                          layer_type, *extra, ovr=edge_ovr, **kw)
    edge_paths = {
        "edge_general": edge_path(
            "edge_general", "generaledgeconv",
            expected={k1_: (12, 6), k2_: (5, 5)},
            widths={300: {k1_: (12, 6)}}, rect=(12, 6),
            k2_packs={EDGE: (5, 5)}),
        "edge_sample": edge_path(
            "edge_sample", "generalsampleedgeconv", "gnn.keep_edge", "0.5",
            "gnn.agg", "mean", "gnn.normalize_adj", "True",
            "gnn.msg_direction", "both",
            expected={k1_: (22, 11), k2_: (10, 10)},
            widths={300: {k1_: (22, 11)}}, rect=(22, 11),
            k2_packs={EDGE: (10, 10)}),
        "edge_spline": edge_path(
            "edge_spline", "splineconv",
            expected={k1_: (12, 6), k2_: (5, 5)},
            widths={600: {k1_: (10, 5)}, 300: {k1_: (2, 1)}}, rect=(12, 6),
            k2_packs={EDGE: (5, 5)}),
        "edge_att": edge_path(
            "edge_att", "generaledgeattconvv2", "gnn.att_heads", "4",
            "gnn.att_final_linear", "True", "gnn.att_final_linear_bn",
            "True", expected={k1_: (12, 6), k2_: (5, 5), k3_: (10, 5)},
            widths={300: {k1_: (12, 6)}, 4: {k3_: (10, 5)}}, rect=(12, 6),
            k2_packs={EDGE: (5, 5)}),
        "edge_ogb": edge_path(
            "edge_ogb", "generalogbconv",
            expected={k1_: (12, 6), k2_: (10, 5)},
            widths={300: {k1_: (12, 6)}}, rect=(12, 6),
            k2_packs={EDGE: (5, 5), EDGE_BOND: (5, 0)}),
    }
    # the other two variants without a training: generaledgeattconvv1 at
    # one head (per layer K1 3, its softmax's K3 row sums 3 at width 1,
    # K2 2) and generaledgeconv with agg max (K1 3, the max forward 2 and
    # backward 1, no K2); the add pooling's K1 3
    edge_models = {}
    for tag, extra, expected, k2_packs in (
            ("edge_att_v1", ["gnn.layer_type", "generaledgeattconvv1"],
             {k1_: 18, k3_: 15, k2_: 10}, {EDGE: 10}),
            ("edge_max", ["gnn.layer_type", "generaledgeconv", "gnn.agg",
                          "max"], {k1_: 18, max_: 10, max_bwd_: 5}, {})):
        begin(f"model_{tag}")
        edge_models[tag] = model_phase(tag, config(EDGE_MODEL),
                                       edge_ovr + list(EDGE_BONDS) + extra,
                                       device, expected, k2_packs=k2_packs)
        phase(f"model_{tag}", **edge_models[tag])
    # ---- A14 on the other kernels' paths: ID-GAT ws (K3, the SDDMM),
    # design_sf_max (the max), edge_general (K2 on 'edge'), the molhiv
    # cut (the Atom encoder's K2, K1 at 300), and ID-GCN ba's step
    begin("bf16_models")
    gat_cfg, gat_loaders, _ = load_path(CFG_ATT, overrides)
    bf16_paths = {"idgat_ws": (gat_cfg, gat_loaders,
                               gat_loaders[1].batches(0)[0], False)}
    for tag, rf in (("design_sf_max", True), ("edge_general", False),
                    ("ogbg_molhiv_gcnid", False)):
        p_cfg, p_loaders, _ = LOADED[tag]
        bf16_paths[tag] = (p_cfg, p_loaders, p_loaders[1].batches(0)[0], rf)
    bf16_models = bf16_models_phase(device, bf16_paths,
                                    LOADED["idgcn_ba"][:2])
    phase("bf16_models", **bf16_models)
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
                            dz + list(DESIGN_GRAPH_SF), 768, 0),
        "idgraph_ba": (config("idgcn_ba"), ba_overrides + list(IDGRAPH_BA),
                       128, 0),
        "design_att_sf_add_graph": (config(ATT_SF_ADD_GRAPH[0]),
                                    dz + list(ATT_SF_ADD_GRAPH[1]), 256, 0),
        # K1 on its first train batch (at 2 layers, as its path); the
        # max (no path's) on the first 3 train graphs, whose rows hold
        # 500 ego centers too: on the whole batch the plain max
        # backward's timing outlasts the run
        "idgraph_ba500": (config(IDGRAPH_BA500[0]),
                          c500 + list(IDGRAPH_BA500[1])
                          + list(IDGRAPH_BA500_DEPTH), 128, 3),
        "graph_ws500": (config(GRAPH_WS500[0]), c500 + list(GRAPH_WS500[1]),
                        128, 0),
        # the max (no path's) on the first 16 train graphs, for time
        "idgraph_enzymes": (config(IDGRAPH_ENZYMES[0]),
                            raw + list(IDGRAPH_ENZYMES[1]), 128, 16)},
        device)
    phase("kernel_pool", **pools)

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
                              "graphgym_tpu/nn/layers.py:152",
                     design="redesigned for Hopper: a run of slots an "
                            "owner, not a row")
    max_src = dict(route="cuda",
                   source="graphgym_tpu_torch/csrc/packed_max.cu",
                   replaces="graphgym_tpu/ops/segment.py:50 (XLA's "
                            "segment_max; no Pallas kernel)")
    srcs = (k1_src, k3_src, sddmm_src, max_src)
    k2_src = dict(route="cuda",
                  source="graphgym_tpu_torch/csrc/packed_segment.cu",
                  replaces="graphgym_tpu/ops/pallas/spmm_kernel.py:309",
                  design="redesigned for Hopper: positions read in place, "
                         "short rows at one owner, long rows by runs")
    a14_srcs = {"k1": k1_src, "k3": k3_src, "sddmm": sddmm_src,
                "max": max_src, "k2": k2_src}
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
        {"name": "packed_segment", **k2_src,
         "path": None, "launches": k2["launches"],
         **{k: k2[k] for k in row + ("floor_ms",) + K2_EXTRA}},
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
         **{k: sddmm[k] for k in row + ("floor_ms",)},
         **path_launches(sddmm_, {"idgat_ws": train_att})},
        {"name": "packed_sddmm_make_graph", **sddmm_src,
         "path": "bench_attention", "heads": BENCH_HEADS, "dh": BENCH_DV,
         **{k: bk["sddmm"][k] for k in row + ("floor_ms",)},
         "launches": att_launches[sddmm_.__name__]},
        *new_path_rows(fast, ba, row, srcs[:3]),
        *torch_path_rows(torch_paths, row, srcs),
        *torch_path_rows(design, row, srcs),
        *graph_rows({**graph_paths, **graph500}, pools, row, srcs),
        *torch_path_rows({"design_att_sf_mul":
                          att_paths["design_att_sf_mul"]}, row, srcs),
        *graph_rows({"design_att_sf_add_graph":
                     att_paths["design_att_sf_add_graph"]}, pools, row,
                    srcs),
        {"name": "packed_spmm_appnp_ws", **k1_src, "path": "appnp_ws",
         "pack": "gcn, appnp_ws", "width": 6,
         **{k: appnp["checks"]["d6"][k] for k in row + ("floor_ms",)},
         **path_launches(k1_, {"appnp_ws": appnp["train"]}, width=6)},
        *model_rows(models, row, srcs),
        *[dict(r, sum_beside=gin_beside) for r in torch_path_rows(
            {"ginconv_ba_gcn_noself": gin_ablation}, row, srcs)],
        *model_rows(gin_models, row, srcs),
        *link_rows(link_paths, row, k1_src),
        *torch_path_rows({"linkid_ba": linkid_ba}, row, srcs),
        *torch_path_rows({"cora_gatid": real_paths["cora_gatid"]}, row,
                         srcs),
        *graph_rows({"idgraph_enzymes": real_paths["idgraph_enzymes"]},
                    pools, row, srcs),
        *ogb_rows(ogb_paths, samplers, row, k1_src, k2_src),
        *edge_rows(edge_paths, edge_models, row, srcs, k2_src),
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
        *a14_rows(bf16_main, bf16_models, coo_route, a14_srcs),
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
