"""The epoch prefetch of ``Trainer.run`` (cfg.tpu.prefetch): a worker
collates epoch e+1's train batches while epoch e trains.

With the prefetch on and off, from one seed, over three epochs with an
eval each epoch, the batches each epoch trains on, the losses of every
step, the val curve and the loaders' Generator states after the run
must be bitwise equal: on a multi-batch shuffled loader (ID-GCN on ws),
on link_ba's resampled negatives (the plain link point on 8
regenerated ba graphs) and on a transductive link split whose eval
loaders redraw their negatives each eval epoch on the main thread
while the worker redraws the train split's.  That split hands each
loader graphs of its own (no array shared), so the worker writes
nothing another loader reads.  The worker hands back host numpy
batches only.  A worker error reaches the main thread, an error in an
epoch stops the worker, and either way no prefetch thread outlives the
run; one epoch starts no worker; the switch interval is short while
the worker runs and restored after.  On the card the same holds with the
steps captured while the worker collates.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders as L
from graphgym_tpu_torch.data import synthetic as syn
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train import loop
from graphgym_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = ["gnn.dim_inner", "8", "gnn.layers_mp", "2", "optim.max_epoch",
         "3", "train.eval_period", "1"]
LINK = ["dataset.transform", "none", "dataset.task", "link_pred",
        "dataset.augment_label", "", "gnn.layer_type", "gcnconv",
        "dataset.edge_train_mode", "disjoint", "train.batch_size", "2"]
POINTS = {
    "shuffled": ("idgcn_ws", ["train.batch_size", "3"]),
    "resampled": ("idgcn_ba", LINK + [
        "dataset.augment_feature", "['node_identity']",
        "model.edge_decoding", "concat", "dataset.resample_negative",
        "True"]),
    "transductive": ("idgcn_ws", LINK + [
        "dataset.transductive", "True", "dataset.resample_negative", "True",
        "dataset.link_eval_resample_negative", "True"]),
}
GRAPHS = 8


def point_cfg(point, tmp_dir, device="cpu", extra=()):
    base, opts = POINTS[point]
    return load_cfg(os.path.join(ROOT, "configs", f"{base}.yaml"),
                    ["device", device, "dataset.dir", str(tmp_dir),
                     "out_dir", str(tmp_dir)]
                    + opts + SMALL + list(extra))


def point_loaders(cfg):
    """The point's loaders on its corpus cut to GRAPHS graphs (ba
    regenerated at 10 graphs)."""
    with pytest.MonkeyPatch.context() as mp:
        real_gen = syn.generate_syn_graphs
        mp.setattr(syn, "generate_syn_graphs",
                   lambda kind, num_graphs, n: real_gen(
                       kind=kind, num_graphs=10, n=n))
        real = L.load_dataset
        mp.setattr(L, "load_dataset", lambda c: real(c)[:GRAPHS])
        return L.create_loader(L.create_dataset(cfg), cfg)


class Recorded:
    """Each ``batches`` call of a loader, in order, with the thread that
    made it."""

    def __init__(self, loader):
        self.calls, self.real = [], loader.batches
        loader.batches = self

    def __call__(self, epoch=0):
        out = self.real(epoch)
        self.calls.append((epoch, threading.current_thread().name, out))
        return out


def run(point, tmp_dir, prefetch, device=CPU):
    torch.manual_seed(0)
    cfg = point_cfg(point, tmp_dir, device.type,
                    ["tpu.prefetch", str(prefetch)])
    loaders = point_loaders(cfg)
    recorded = [Recorded(ld) for ld in loaders]
    tr = Trainer(build_model(cfg, device), loaders, cfg, device)
    losses, real_step = [], tr.train_step

    def step(batch):
        out = real_step(batch)
        losses.append(out[0].detach().cpu().numpy().copy())
        return out
    tr.train_step = step
    result = tr.run()
    return dict(result=result, losses=losses, recorded=recorded,
                loaders=loaders, states=[ld.rng.bit_generator.state
                                         for ld in loaders])


def batch_arrays(batch):
    """Every array of a batch by name, its packs' included (numpy on the
    host, tensors after ``to``)."""
    out = {}
    for field, value in vars(batch).items():
        if field == "packs":
            for kind, entry in (value or {}).items():
                for i, part in enumerate(entry):
                    parts = part if isinstance(part, tuple) else (part,)
                    for j, a in enumerate(parts):
                        out[f"{kind}.{i}.{j}"] = a
        elif isinstance(value, (np.ndarray, torch.Tensor)):
            out[field] = value
    return out


def assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        ax, ay = batch_arrays(x), batch_arrays(y)
        assert ax.keys() == ay.keys()
        for k in ax:
            assert ax[k].dtype == ay[k].dtype and np.array_equal(ax[k],
                                                                 ay[k]), k


@pytest.mark.parametrize("point", sorted(POINTS))
def test_prefetched_training_is_the_serial_one(point, tmp_path):
    serial = run(point, tmp_path, False)
    ahead = run(point, tmp_path, True)
    # the train loader's draws: constructor, edges_per_epoch, epochs 0-2
    calls_s, calls_p = serial["recorded"][0].calls, ahead["recorded"][0].calls
    assert [c[0] for c in calls_s] == [c[0] for c in calls_p] \
        == [0, 0, 0, 1, 2]
    assert all(c[1] == threading.main_thread().name for c in calls_s)
    assert [c[1].startswith("prefetch") for c in calls_p] == \
        [False, False, False, True, True]
    for (_, _, a), (_, _, b) in zip(calls_s, calls_p):
        assert_same_batches(a, b)
    assert len(calls_s[-1][2]) > 1           # several train batches
    for s, p in zip(serial["recorded"][1:], ahead["recorded"][1:]):
        assert len(s.calls) == len(p.calls) == 3     # an eval each epoch
        for (_, _, a), (_, _, b) in zip(s.calls, p.calls):
            assert_same_batches(a, b)
    assert len(serial["losses"]) == len(ahead["losses"]) > 3
    for a, b in zip(serial["losses"], ahead["losses"]):
        assert a.tobytes() == b.tobytes()
    assert serial["result"] == ahead["result"]
    assert serial["states"] == ahead["states"]


def test_prefetched_batches_are_host_arrays(tmp_path):
    ahead = run("resampled", tmp_path, True)
    for _, thread, batches in ahead["recorded"][0].calls:
        for b in batches:
            for v in vars(b).values():
                assert not isinstance(v, torch.Tensor)
            assert all(isinstance(a, np.ndarray)
                       for a in batch_arrays(b).values())


def test_transductive_split_shares_no_graph(tmp_path):
    """The worker rewrites the train loader's graphs (_resample): no
    graph object and no array of one is another loader's."""
    cfg = point_cfg("transductive", tmp_path)
    loaders = point_loaders(cfg)
    owner = {}
    for i, ld in enumerate(loaders):
        for g in ld.graphs:
            for obj in [g, g.edge_index, *g.feats.values()]:
                if isinstance(obj, np.ndarray) and obj.base is not None:
                    obj = obj.base
                assert owner.setdefault(id(obj), i) == i


@pytest.mark.parametrize("point", ["shuffled", "resampled"])
def test_staged_batch_is_the_direct_one(point, tmp_path):
    """A batch moved through a staging buffer (the trainer's path on the
    card, here into CPU memory) equals the one moved directly, tensor
    for tensor, dtype included; its arrays lie apart in the buffer, each
    64-byte aligned."""
    cfg = point_cfg(point, tmp_path)
    batch = point_loaders(cfg)[0].batches(0)[0]
    staging = torch.empty(batch.staging_bytes(), dtype=torch.uint8)
    got = batch_arrays(batch.to(CPU, staging))
    want = batch_arrays(batch.to(CPU))
    assert got.keys() == want.keys() and len(got) > 10
    spans = []
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
        # on the CPU a moved array is its staging slice; index arrays
        # widen into tensors of their own
        if got[k].numel() and got[k].untyped_storage().data_ptr() \
                == staging.untyped_storage().data_ptr():
            start = got[k].data_ptr() - staging.data_ptr()
            assert start % 64 == 0
            spans.append((start, start + got[k].nbytes))
    spans.sort()
    assert len(spans) > 10
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= staging.numel()


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("prefetch")]


def test_worker_error_reaches_the_main_thread(tmp_path):
    cfg = point_cfg("shuffled", tmp_path)
    loaders = point_loaders(cfg)
    real = loaders[0].batches

    def batches(epoch=0):
        if epoch == 2:
            assert threading.current_thread().name.startswith("prefetch")
            raise RuntimeError("collation failed")
        return real(epoch)
    loaders[0].batches = batches
    tr = Trainer(build_model(cfg, CPU), loaders, cfg, CPU)
    steps = []
    real_step = tr.train_step
    tr.train_step = lambda b: steps.append(1) or real_step(b)
    with pytest.raises(RuntimeError, match="collation failed"):
        tr.run()
    assert len(steps) == 2 * len(real(0))       # epochs 0 and 1 trained
    assert prefetch_threads() == []


def test_epoch_error_stops_the_worker(tmp_path):
    cfg = point_cfg("shuffled", tmp_path)
    loaders = point_loaders(cfg)
    started = threading.Event()
    real = loaders[0].batches

    def batches(epoch=0):
        if threading.current_thread().name.startswith("prefetch"):
            started.set()
        return real(epoch)
    loaders[0].batches = batches
    tr = Trainer(build_model(cfg, CPU), loaders, cfg, CPU)

    def failing_step(batch):
        started.wait(30)
        raise ValueError("step failed")
    tr.train_step = failing_step
    with pytest.raises(ValueError, match="step failed"):
        tr.run()
    assert started.is_set()
    assert prefetch_threads() == []


@pytest.mark.parametrize("prefetch", [False, True])
def test_switch_interval_while_the_worker_runs(prefetch, tmp_path):
    """The training thread gets the GIL back within PREFETCH_SWITCH_S
    while the worker runs; the interval is restored after the run."""
    before = sys.getswitchinterval()
    cfg = point_cfg("shuffled", tmp_path, extra=["tpu.prefetch",
                                                  str(prefetch)])
    tr = Trainer(build_model(cfg, CPU), point_loaders(cfg), cfg, CPU)
    seen, real_step = [], tr.train_step
    tr.train_step = lambda b: seen.append(sys.getswitchinterval()) \
        or real_step(b)
    tr.run()
    want = loop.PREFETCH_SWITCH_S if prefetch else before
    assert seen and all(s == pytest.approx(want) for s in seen)
    assert sys.getswitchinterval() == before


@pytest.mark.parametrize("epochs,prefetch,workers", [
    ("1", "True", 0), ("3", "False", 0), ("3", "True", 1)])
def test_worker_only_when_more_than_one_epoch_remains(epochs, prefetch,
                                                      workers, tmp_path,
                                                      monkeypatch):
    made = []
    real = loop.ThreadPoolExecutor

    def executor(*args, **kw):
        made.append(kw.get("thread_name_prefix"))
        return real(*args, **kw)
    monkeypatch.setattr(loop, "ThreadPoolExecutor", executor)
    cfg = point_cfg("shuffled", tmp_path, extra=["optim.max_epoch", epochs,
                                                  "tpu.prefetch", prefetch])
    loaders = point_loaders(cfg)
    Trainer(build_model(cfg, CPU), loaders, cfg, CPU).run()
    assert made == ["prefetch"] * workers


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs and the kernels "
                    "have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_trainer_places_the_direct_batch(cuda_device, tmp_path):
    """The trainer's placement (pinned staging, the copy stream) gives
    the tensors ``batch.to`` gives, on the card."""
    cfg = point_cfg("resampled", tmp_path, "cuda")
    loaders = point_loaders(cfg)
    tr = Trainer(build_model(cfg, cuda_device), loaders, cfg, cuda_device)
    for batch in loaders[0].batches(1):
        got = batch_arrays(tr._place(batch))
        want = batch_arrays(batch.to(cuda_device))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and torch.equal(
                got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("point", sorted(POINTS))
def test_cuda_prefetched_training_is_the_serial_one(cuda_device, point,
                                                    tmp_path):
    """On the card each step is captured (step 1) while the worker
    collates the next epoch: the same batches, losses and val curve as
    the serial run, and the same launches."""
    runs = []
    for prefetch in (False, True):
        K.set_launch_counts({k: (0, {}) for k in K.launch_counts()})
        out = run(point, tmp_path, prefetch, cuda_device)
        torch.cuda.synchronize()
        runs.append((out, K.launch_counts()))
    (serial, counts_s), (ahead, counts_p) = runs
    for (_, _, a), (_, _, b) in zip(serial["recorded"][0].calls,
                                    ahead["recorded"][0].calls):
        assert_same_batches(a, b)
    for a, b in zip(serial["losses"], ahead["losses"]):
        assert a.tobytes() == b.tobytes()
    assert serial["result"] == ahead["result"]
    assert counts_s == counts_p
