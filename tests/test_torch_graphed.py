"""The train and eval steps as one program per batch signature
(graphgym_tpu_torch/train/graphed.py), the port of the JAX Trainer's
jit programs.

On the CPU the program runs eagerly on its static buffers: it must
give the plain eager step's losses and parameters bit for bit (the
buffer copy and the step-0 / step-1 hand-over), one program for all
the batches of a multi-batch loader, and the JAX package's losses
within 2e-3.  The tensor learning rate that the captured Adam reads
is held against a float one.  The cuda-marked tests hold the captured
graphs on the card against eager steps, bit for bit, with their
launches counted per replay; they skip without a card.
"""

import os

import numpy as np
import pytest
import torch

from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data.loaders import create_dataset, create_loader
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train import checkpoint as ckpt
from graphgym_tpu_torch.train import graphed
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.train.optim import (StepSchedule, create_optimizer,
                                            make_lr_factor)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PATHS = ["idgcn_ws", "idgat_ws", "idgin_ws", "idsage_ws"]


class StepRecorder:
    """Duck-typed Logger: each step's loss and learning rate."""

    def __init__(self):
        self.losses, self.lrs = [], []

    def update_stats(self, loss, lr, **kw):
        self.losses.append(loss)
        self.lrs.append(lr)


def path_cfg(path, device="cpu", *opts):
    return load_cfg(os.path.join(ROOT, "configs", f"{path}.yaml"),
                    ["device", device, "gnn.dim_inner", "16", *opts])


def small_splits(cfg, graphs=6):
    """The first ``graphs`` graphs of each split (one batch each)."""
    return [part[:graphs] for part in create_dataset(cfg)]


def train(cfg, splits, device, steps, eager):
    """Per-step losses (host floats, read before the next step) and the
    parameters after ``steps`` train steps on the first train batch."""
    tr = Trainer(build_model(cfg, device), create_loader(splits, cfg), cfg,
                 device, eager=eager)
    batch = tr._place(tr.loaders[0].batches(0)[0])
    losses = [tr.train_step(batch)[0].item() for _ in range(steps)]
    return tr, losses, [p.detach().clone() for p in tr.model.parameters()]


def assert_same_run(a, b):
    (_, la, pa), (_, lb, pb) = a, b
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize("path", PATHS)
def test_program_matches_plain_eager_step(path):
    """Three train steps and an eval step through the program (static
    buffers, step 0 then steps 1-2) equal the plain eager steps bit for
    bit; ID-GIN's BatchNorm running statistics too."""
    cfg = path_cfg(path)
    splits = small_splits(cfg)
    prog = train(cfg, splits, CPU, 3, eager=False)
    plain = train(cfg, splits, CPU, 3, eager=True)
    assert_same_run(prog, plain)
    for (name, a), (_, b) in zip(prog[0].model.named_buffers(),
                                 plain[0].model.named_buffers()):
        assert torch.equal(a, b), name
    step = prog[0].train_step
    assert not step.eager and step.captured == 0
    (only,) = step.programs.values()
    assert only.steps == 3 and only.graph is None
    evals = [tr.eval_step(tr._place(tr.loaders[1].batches(0)[0]))
             for tr in (prog[0], plain[0])]
    for a, b in zip(*evals):
        assert torch.equal(a, b)
    assert len(prog[0].eval_step.programs) == 1


def test_multi_batch_loader_one_program():
    """ws at train.batch_size 8: three shuffled train batches an epoch,
    padded by the loader to one pack shape, so one program serves them
    all; the per-step losses and the val accuracy equal the eager
    trainer's."""
    cfg = path_cfg("idgcn_ws", "cpu", "train.batch_size", "8",
                   "gnn.layers_mp", "2")
    splits = create_dataset(cfg)
    runs = []
    for eager in (False, True):
        tr = Trainer(build_model(cfg, CPU), create_loader(splits, cfg), cfg,
                     CPU, eager=eager)
        rec = StepRecorder()
        for epoch in range(2):
            tr.train_epoch(rec, epoch)
        runs.append((tr, rec, tr.eval_epoch(None, 1)))
    (tr, rec, acc), (_, rec_e, acc_e) = runs
    assert len(tr.loaders[0]) == 3 and len(rec.losses) == 6
    assert len({graphed.signature(tr._place(b))
                for ep in range(3) for b in tr.loaders[0].batches(ep)}) == 1
    assert len(tr.train_step.programs) == 1
    (only,) = tr.train_step.programs.values()
    assert only.steps == 6
    assert rec.losses == rec_e.losses and rec.lrs == rec_e.lrs
    assert acc == acc_e


def test_program_matches_jax(monkeypatch):
    """Two epochs of ID-GCN (ws, 6 graphs a split, 2 layers, width 16,
    cos schedule, batch 2: three train batches) through the program
    against the JAX package's Trainer from the same parameters:
    per-step losses within 2e-3 and learning rates within 1e-6
    (tests/test_torch_train.py's tolerances)."""
    import jax

    import graphgym_tpu.native as jax_native
    from graphgym_tpu.config import get_cfg as jax_get_cfg
    from graphgym_tpu.data import loaders as jax_loaders
    from graphgym_tpu.nn.model import build_model as jax_build_model
    from graphgym_tpu.train.loop import Trainer as JaxTrainer
    from graphgym_tpu_torch.config import get_cfg
    from graphgym_tpu_torch.weights import params_from_jax

    monkeypatch.setattr(jax_native, "load", lambda: None)
    setup = {
        "dataset": {"format": "nx", "name": "ws", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 4, "transform": "ego"},
        "gnn": {"layers_mp": 2, "dim_inner": 16, "layer_type": "Tfg-idgcn"},
        "train": {"batch_size": 2},
        "optim": {"scheduler": "cos", "max_epoch": 2},
    }
    jcfg = jax_get_cfg()
    jcfg.merge_from_dict(setup)
    jcfg.merge_from_dict({"tpu": {"spmm_impl": "pallas"}})
    jloaders = jax_loaders.create_loader(
        [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu"})
    lds = create_loader([p[:6] for p in create_dataset(cfg)], cfg)
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.array, jtr.state.params), model))
    tr = Trainer(model, lds, cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(2):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 2 * len(tr.loaders[0])
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert len(tr.train_step.programs) == 1
    assert sum(p.steps for p in tr.train_step.programs.values()) == 6


@pytest.mark.parametrize("scheduler", ["none", "steps", "cos"])
def test_tensor_lr_adam_equals_float_lr(scheduler):
    """Adam with a 0-d float32 tensor lr, filled by the schedule after
    each step, against the port's float-lr Adam over 5 steps: the
    tensor holds each step's lr rounded to float32, and the parameters
    agree within that rounding (Adam then takes lr / bias correction in
    float32, not float64); the lr logged for step k is
    make_lr_factor(k) * base_lr."""
    cfg = path_cfg("idgcn_ws")
    cfg.optim.scheduler = scheduler
    cfg.optim.steps = [1, 2]
    cfg.optim.max_epoch = 3
    steps_per_epoch = 2
    factor = make_lr_factor(cfg.optim, steps_per_epoch)
    base = cfg.optim.base_lr
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(7, 5, generator=gen), torch.randn(5, generator=gen)]
    grads = [[torch.randn(p.shape, generator=gen) for p in init]
             for _ in range(5)]

    def run(make):
        params = [torch.nn.Parameter(p.clone()) for p in init]
        opt, sched = make(params)
        logged, used = [], []
        for gs in grads:
            logged.append(sched.lr())
            used.append(float(opt.param_groups[0]["lr"]))
            for p, g in zip(params, gs):
                p.grad = g.clone()
            opt.step()
            sched.step()
        return params, logged, used

    def tensor_adam(ps):
        opt = torch.optim.Adam(ps, lr=torch.tensor(base, dtype=torch.float32),
                               weight_decay=cfg.optim.weight_decay)
        return opt, StepSchedule(opt, factor, base)

    tensor_p, logged, used = run(tensor_adam)
    float_p, float_logged, float_used = run(lambda ps: create_optimizer(
        ps, cfg.optim, steps_per_epoch))
    want = [factor(k) * base for k in range(5)]
    assert logged == float_logged == float_used == want
    assert used == [float(np.float32(x)) for x in want]
    for a, b in zip(tensor_p, float_p):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_trainer_logs_the_schedule():
    """The Trainer logs each step's lr from the host schedule."""
    cfg = path_cfg("idgcn_ws", "cpu", "optim.scheduler", "cos",
                   "optim.max_epoch", "3", "gnn.layers_mp", "1")
    lds = create_loader(small_splits(cfg), cfg)
    tr = Trainer(build_model(cfg, CPU), lds, cfg, CPU)
    rec = StepRecorder()
    for epoch in range(3):
        tr.train_epoch(rec, epoch)
    factor = make_lr_factor(cfg.optim, len(tr.loaders[0]))
    assert rec.lrs == [factor(k) * cfg.optim.base_lr for k in range(3)]


def test_cpu_program_is_eager_because_cpu(monkeypatch):
    """On CPU tensors the program never reaches the capture path: the
    device alone decides (no CUDA graph is made, none is needed)."""
    def no_graph(*a, **k):
        raise AssertionError("a CPU step made a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    monkeypatch.setattr(graphed.GraphedStep, "_cuda_step", no_graph)
    cfg = path_cfg("idgcn_ws", "cpu", "gnn.layers_mp", "1")
    _, losses, _ = train(cfg, small_splits(cfg), CPU, 2, eager=False)
    assert all(np.isfinite(losses))


def test_signature_names_every_tensor_and_pack():
    cfg = path_cfg("idgat_ws", "cpu", "gnn.layers_mp", "1")
    batch = create_loader(small_splits(cfg), cfg)[0].batches(0)[0].to(CPU)
    sig = graphed.signature(batch)
    paths = [p for p, *_ in sig]
    assert paths[:2] == ["senders", "receivers"]
    assert {"packs.att.0.senders", "packs.att.1.row_range",
            "packs.att.2"} <= set(paths)
    text = graphed.describe(sig)
    assert "node_feat[" in text and "packs.att.2[" in text
    clone = batch.replace(node_feat=batch.node_feat.clone())
    assert graphed.signature(clone) == sig
    assert graphed.signature(batch.replace(
        node_feat=batch.node_feat[:-1])) != sig


def test_checkpoint_keeps_tensor_lr_and_forbids_load_after_capture(tmp_path):
    """A checkpoint load keeps the optimizer's own lr tensor (the one a
    captured graph reads) and sets it from the schedule; a load after a
    capture raises."""
    cfg = path_cfg("idgcn_ws", "cpu", "gnn.layers_mp", "1",
                   "optim.scheduler", "cos", "optim.max_epoch", "4")
    cfg.out_dir = str(tmp_path)
    splits = small_splits(cfg)
    tr, _, _ = train(cfg, splits, CPU, 2, eager=False)
    ckpt.save_ckpt(tr.model, tr.optimizer, tr.scheduler, cfg.out_dir, 0)

    tr2 = Trainer(build_model(cfg, CPU), create_loader(splits, cfg), cfg,
                  CPU)
    lr = torch.tensor(1.0)
    tr2.optimizer.param_groups[0]["lr"] = lr
    assert tr2.load_checkpoint() == 1
    assert tr2.optimizer.param_groups[0]["lr"] is lr
    assert tr2.scheduler.last_epoch == 2
    assert lr.item() == np.float32(tr.scheduler.lr())
    for a, b in zip(tr.optimizer.state.values(),
                    tr2.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)

    batch = tr2._place(tr2.loaders[0].batches(0)[0])
    tr2.train_step(batch)
    (prog,) = tr2.train_step.programs.values()
    prog.graph = object()           # as after a capture on the card
    with pytest.raises(RuntimeError, match="captured"):
        tr2.load_checkpoint()


def test_launch_count_snapshots():
    """The counters a capture restores and a replay adds to."""
    k1 = K.packed_spmm_cuda
    saved = K.launch_counts()
    try:
        before = K.launch_counts()
        k1.launches += 2
        k1.launches_by_width[128] += 2
        delta = K.launches_between(before, K.launch_counts())
        assert delta[k1.__name__][0] == 2
        assert delta[k1.__name__][1] == {128: 2}
        K.set_launch_counts(before)
        assert K.launch_counts() == before
        K.add_launch_counts(delta)
        K.add_launch_counts(delta)
        assert k1.launches == before[k1.__name__][0] + 4
        assert k1.launches_by_width[128] == \
            before[k1.__name__][1][128] + 4
    finally:
        K.set_launch_counts(saved)


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels "
                    "have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_cuda_captured_matches_eager(cuda_device, path):
    """Full width on the card: the captured trainer (step 0 eager, step
    1 captured and replayed, steps 2-4 replays) and the eager trainer,
    both with capturable Adam, give bitwise-equal losses, parameters
    and buffers over 5 steps and equal eval losses; the replays add the
    graphs' launches, so the counters equal the eager run's."""
    cfg = load_cfg(os.path.join(ROOT, "configs", f"{path}.yaml"),
                   ["device", "cuda"])
    loaders = create_loader(create_dataset(cfg), cfg)
    runs = []
    for eager in (False, True):
        K.set_launch_counts({k: (0, {}) for k in K.launch_counts()})
        tr = Trainer(build_model(cfg, cuda_device), loaders, cfg,
                     cuda_device, eager=eager)
        batch = tr._place(loaders[0].batches(0)[0])
        losses = [tr.train_step(batch)[0].item() for _ in range(5)]
        vbatch = tr._place(loaders[1].batches(0)[0])
        evals = [tr.eval_step(vbatch)[0].item() for _ in range(3)]
        torch.cuda.synchronize()
        runs.append((tr, losses, evals, K.launch_counts()))
    (tr, losses, evals, counts), (tr_e, losses_e, evals_e, counts_e) = runs
    assert tr.train_step.captured == 1 and tr.eval_step.captured == 1
    assert losses == losses_e and evals == evals_e
    for a, b in zip(tr.model.state_dict().values(),
                    tr_e.model.state_dict().values()):
        assert torch.equal(a, b)
    assert counts == counts_e
    assert sum(n for n, _ in counts.values()) > 0


@pytest.mark.cuda
def test_cuda_trainer_memory_goes_with_it(cuda_device):
    """A captured trainer's device memory is returned when the trainer
    goes: a second trainer's run leaves no more allocated than the
    first's (PyTorch keeps a cuBLAS workspace per stream for the life of
    the process, so the steps share one side stream)."""
    import gc

    cfg = path_cfg("idgcn_ws", "cuda")
    splits = small_splits(cfg)
    after = []
    for _ in range(3):
        train(cfg, splits, cuda_device, 3, eager=False)
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(cuda_device))
    assert after[1] == after[2], after


@pytest.mark.cuda
def test_cuda_att_dropout_draws_fresh_masks(cuda_device):
    """Att-dropout in a captured graph: the dropout generator is
    registered with the graph, so each replay draws a new mask.  With
    uniform scores (alpha = 1 / degree) and v = 1 each row's output
    times degree * (1 - p) counts its kept slots: a whole number (the
    scale is 1 / (1 - p)), about (1 - p) of the slots over all rows
    (the rate), and another count at every replay."""
    from graphgym_tpu_torch.nn.layers import packed_attention

    cfg = path_cfg("idgat_ws", "cuda")
    batch = create_loader(create_dataset(cfg), cfg)[0].batches(0)[0].to(
        cuda_device)
    n, rate = batch.num_nodes, 0.3
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    zero = torch.zeros(n, 1, device=cuda_device)
    ones = torch.ones(n, 1, 4, device=cuda_device)

    def program(b):
        out = packed_attention(b, ones, node_scores=(zero, zero),
                               dropout_rate=rate, generator=gen)
        return out, out, out, out

    step = graphed.GraphedStep("dropout", program, lambda: None,
                               generators=(gen,))
    fwd = batch.packs["att"][0]
    deg = torch.zeros(n, device=cuda_device).index_add_(
        0, K.pack_rows(fwd).reshape(-1), (fwd.weights > 0).float().reshape(
            -1))
    real = deg > 0
    kept = []
    for _ in range(4):
        out = step(batch)[0][:, 0, 0]
        k = out * deg * (1 - rate)
        assert torch.allclose(k[real], k[real].round(), atol=1e-3)
        kept.append(k[real].round())
    assert step.captured == 1
    share = torch.stack(kept).sum(1) / deg[real].sum()
    assert torch.allclose(share, torch.full_like(share, 1 - rate),
                          atol=0.01)
    for a, b in zip(kept[1:], kept[2:]):      # replays: fresh masks
        assert not torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda_device):
    """A program that reads a value back to the host cannot be captured:
    the step raises, naming the step and the batch signature, and takes
    no eager step instead."""
    cfg = path_cfg("idgcn_ws", "cuda", "gnn.layers_mp", "1")
    batch = create_loader(small_splits(cfg), cfg)[0].batches(0)[0].to(
        cuda_device)

    def program(b):
        x = b.node_feat.sum()
        float(x)                   # a device -> host read: no capture
        return x, x, x, x

    step = graphed.GraphedStep("probe", program, lambda: None)
    step(batch)                    # step 0, eager
    with pytest.raises(RuntimeError, match=r"probe step: capture at step 1 "
                       r"failed for batch signature senders\["):
        step(batch)
    assert step.captured == 0
    torch.cuda.synchronize()
