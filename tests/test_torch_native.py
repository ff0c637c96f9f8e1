"""The loader's native pack builder (graphgym_tpu_torch/native) against
the numpy packer it replaces.

The plain version is the numpy ``pack_csr_with_slots`` followed by
``pad_pack`` (graphgym_tpu_torch/ops/cuda/spmm_kernel.py).  The native
packs must equal it array for array, dtype and bits, with the edge
slots and row ranges: on random edge lists with repeated edges, every
group size, empty rows and empty tiles, rectangular packs and chunk
padding; on every pack kind the loader builds ('gcn', 'plain', 'mean',
'gcn_mean', 'att' with its slot map, generalconv_v2's 'dir',
'dir_mean' and the 'rev_*' kinds of the reversed edges, the graph
head's 'pool_*' packs, the heads' 'pairs' and 'labels' gather packs),
through the builders and through a loader's batches over three
epochs.  The four fields the
JAX package's PackedCSR has must equal the JAX package's numpy
``pack_csr``.  A failed build raises with the compiler's message.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import graphgym_tpu.native as jax_native
from graphgym_tpu.ops.pallas import spmm_kernel as jax_spmm
from graphgym_tpu_torch import native
from graphgym_tpu_torch.config import load_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.graphs import packing
from graphgym_tpu_torch.graphs.container import bucket_size
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = K.EDGES_PER_CHUNK


def numpy_pack(s, r, w, rows, senders, least=0, slots=False):
    """The plain version of packing._pack: the numpy packer, then its
    chunks padded to max(bucket, least)."""
    pack, slot = K.pack_csr_with_slots(s, r, w, rows, num_senders=senders)
    pack = K.pad_pack(pack, max(bucket_size(pack.senders.shape[0]), least),
                      rows, senders)
    return pack, (slot if slots else None)


def assert_packs_equal(got, want):
    for field, a, b in zip(K.PackedCSR._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


def random_edges(rng, rows, senders, e, hub=False, repeats=False):
    s = rng.integers(0, senders, e)
    r = rng.integers(0, rows, e)
    if hub and e:
        r[: e // 2] = rows // 2         # one row of ~e/2 slots
    if repeats and e:
        s[e // 2:], r[e // 2:] = s[: e - e // 2], r[: e - e // 2]
    w = rng.standard_normal(e).astype(np.float32)
    w[rng.random(e) < 0.2] = 0          # zero-weight slots end no row
    return s, r, w


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("case", ["square", "rect", "hub", "repeats",
                                  "sparse_tiles", "empty"])
def test_native_equals_numpy(group, case):
    rng = np.random.default_rng(group * 7 + len(case))
    rows, senders, e = 700, 700, 3000
    if case == "rect":
        senders = 91
    if case == "sparse_tiles":      # most tiles and rows without an edge
        rows, e = 2000, 40
    if case == "empty":
        e = 0
    s, r, w = random_edges(rng, rows, senders, e, hub=case == "hub",
                           repeats=case == "repeats")
    want, want_slot = K.pack_csr_with_slots(s, r, w, rows, group,
                                            num_senders=senders)
    got, got_slot = native.pack_csr_with_slots(s, r, w, rows, group,
                                               num_senders=senders)
    assert_packs_equal(got, want)
    assert got_slot.dtype == np.int32     # slots of a pack fit int32
    assert np.array_equal(got_slot, want_slot)


@pytest.mark.parametrize("pad", ["int", "callable", "below"])
@pytest.mark.parametrize("senders", [300, 41])
def test_pad_chunks_to_writes_the_padded_pack(pad, senders):
    rng = np.random.default_rng(3)
    s, r, w = random_edges(rng, 300, senders, 2500)
    want, _ = K.pack_csr_with_slots(s, r, w, 300, num_senders=senders)
    nc = want.senders.shape[0]
    target = {"int": nc + 3, "callable": lambda n: n + 5,
              "below": nc - 1}[pad]
    got, slot = native.pack_csr_with_slots(
        s, r, w, 300, num_senders=senders, pad_chunks_to=target,
        slots=False)
    to = {"int": nc + 3, "callable": nc + 5, "below": nc}[pad]
    assert slot is None
    assert_packs_equal(got, K.pad_pack(want, to, 300, senders))


def test_weights_default_to_one_and_ties_keep_input_order():
    # the same (receiver, sender) edge three times, weights told apart:
    # the row's slots keep the input order, as np.lexsort's stable sort
    s = np.array([4, 2, 4, 4, 1])
    r = np.array([0, 0, 0, 0, 0])
    w = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    got, slot = native.pack_csr_with_slots(s, r, w, 8)
    assert got.senders[0, :5].tolist() == [1, 2, 4, 4, 4]
    assert got.weights[0, :5].tolist() == [5.0, 2.0, 1.0, 3.0, 4.0]
    assert slot.tolist() == [2, 1, 3, 4, 0]
    ones, _ = native.pack_csr_with_slots(s, r, None, 8)
    assert ones.weights[0, :5].tolist() == [1.0] * 5


@pytest.mark.parametrize("bad", ["receiver", "negative_receiver",
                                 "negative_sender", "lengths"])
def test_bad_inputs_raise(bad):
    s, r = np.array([0, 1, 2]), np.array([0, 1, 2])
    w = np.ones(3, np.float32)
    if bad == "receiver":
        r = np.array([0, 1, 3])
    elif bad == "negative_receiver":
        r = np.array([0, -1, 2])
    elif bad == "negative_sender":
        s = np.array([0, -1, 2])
    else:
        w = np.ones(2, np.float32)
    with pytest.raises(ValueError):
        native.pack_csr_with_slots(s, r, w, 3)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("pad", [None, 40])
def test_jax_fields_equal_the_jax_numpy_packer(group, pad, monkeypatch):
    # the JAX package's native packer orders a row's repeated edges by
    # std::sort; its numpy path is the reference layout
    monkeypatch.setattr(jax_native, "pack_csr_arrays", lambda *a, **k: None)
    rng = np.random.default_rng(11)
    s, r, w = random_edges(rng, 1500, 1500, 9000, repeats=True)
    want = jax_spmm.pack_csr(s, r, w, 1500, pad_chunks_to=pad, group=group)
    got, _ = native.pack_csr_with_slots(s, r, w, 1500, group,
                                        pad_chunks_to=pad)
    for field in jax_spmm.PackedCSR._fields:
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want,
                                                                   field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def batch_arrays(seed=0, n=900, e=5000):
    rng = np.random.default_rng(seed)
    real = n - 37
    s = rng.integers(0, real, e)
    r = rng.integers(0, real, e)
    w = np.ones(e, np.float32)
    w[-50:] = 0                      # the padding edges of a batch
    s[-50:] = r[-50:] = n - 1
    return s, r, w, np.arange(n) < real, n


@pytest.mark.parametrize("kind", ["gcn", "plain", "mean", "gcn_mean",
                                  "att", "dir", "dir_mean", "rev_plain",
                                  "rev_mean", "rev_dir", "rev_dir_mean"])
@pytest.mark.parametrize("least", [(0, 0), (9, 11)])
def test_build_packs_equal_the_numpy_builder(kind, least, monkeypatch):
    s, r, w, mask, n = batch_arrays()
    got = packing.build_packs(s, r, w, mask, n, kinds=(kind,),
                              chunks={kind: least})[kind]
    monkeypatch.setattr(packing, "_pack", numpy_pack)
    want = packing.build_packs(s, r, w, mask, n, kinds=(kind,),
                               chunks={kind: least})[kind]
    assert len(got) == len(want) == (3 if kind == "att" else 2)
    assert_packs_equal(got[0], want[0])
    assert_packs_equal(got[1], want[1])
    if kind == "att":
        assert got[2].dtype == want[2].dtype
        assert np.array_equal(got[2], want[2])
    assert got[0].senders.shape[0] >= least[0]
    assert got[1].senders.shape[0] >= least[1]


@pytest.mark.parametrize("pooling", ["add", "mean", "max"])
@pytest.mark.parametrize("ego", [False, True])
def test_pool_packs_equal_the_numpy_builder(pooling, ego, monkeypatch):
    rng = np.random.default_rng(5)
    n, g = 1280, 17
    gids = np.minimum(np.arange(n) // 80, g - 1)
    mask = np.arange(n) < 1200
    id_index = id_mask = None
    if ego:
        id_index = np.sort(rng.choice(1200, 90, replace=False))
        id_index = np.concatenate([id_index, np.full(6, n - 1)])
        id_mask = np.arange(96) < 90
    args = (gids, mask, g, pooling, id_index, id_mask)
    got = packing.build_pool_packs(*args)
    monkeypatch.setattr(packing, "_pack", numpy_pack)
    want = packing.build_pool_packs(*args)
    (kind,) = got
    assert kind == packing.pool_kind(pooling, ego)
    for a, b in zip(got[kind], want[kind]):
        assert_packs_equal(a, b)


@pytest.mark.parametrize("name", [packing.PAIRS, packing.LABELS])
def test_gather_packs_equal_the_numpy_builder(name, monkeypatch):
    rng = np.random.default_rng(9)
    n = 600
    entries = 2 * 700 if name == packing.PAIRS else 1100
    index = rng.integers(0, n - 1, entries)      # nodes repeat
    mask = rng.random(entries) < 0.9
    index[~mask] = n - 1
    got = packing.build_gather_packs(index, mask, n, (3, 2))
    monkeypatch.setattr(packing, "_pack", numpy_pack)
    want = packing.build_gather_packs(index, mask, n, (3, 2))
    for a, b in zip(got, want):
        assert_packs_equal(a, b)


SMALL = ["device", "cpu", "gnn.dim_inner", "8", "gnn.layers_mp", "2"]
LOADER_POINTS = {
    "gcn": ("idgcn_ws", ["train.batch_size", "3"]),
    "plain": ("idgin_ws", ["train.batch_size", "3"]),
    "mean": ("idsage_ws", ["train.batch_size", "3"]),
    "att": ("idgat_ws", ["train.batch_size", "3"]),
    "gcn_mean": ("idgcn_ws", ["gnn.layer_type", "generalconv", "gnn.agg",
                              "mean", "gnn.normalize_adj", "True",
                              "train.batch_size", "3"]),
    "rev_dir_mean": ("idgcn_ws", ["gnn.layer_type", "generalconv_v2",
                                  "gnn.agg", "mean", "gnn.normalize_adj",
                                  "True", "gnn.flow", "target_to_source",
                                  "train.batch_size", "3"]),
    "pool_add": ("idgcn_ws", ["dataset.task", "graph",
                              "dataset.augment_label",
                              "graph_clustering_coefficient",
                              "dataset.transform", "none",
                              "gnn.layer_type", "gcnconv",
                              "train.batch_size", "3"]),
    "pool_max_ego": ("idgcn_ws", ["dataset.task", "graph",
                                  "dataset.augment_label",
                                  "graph_clustering_coefficient",
                                  "model.graph_pooling", "max",
                                  "gnn.layer_type", "gcnidconv",
                                  "train.batch_size", "3"]),
    "pairs": ("idgcn_ws", ["dataset.transform", "none", "dataset.task",
                           "link_pred", "dataset.augment_label", "",
                           "gnn.layer_type", "gcnconv",
                           "dataset.edge_train_mode", "disjoint",
                           "dataset.resample_negative", "True",
                           "train.batch_size", "3"]),
    "labels": ("idgcn_ws", ["dataset.transform", "edge", "dataset.task",
                            "edge", "dataset.augment_label", "",
                            "gnn.layer_type", "gcnidconv",
                            "train.batch_size", "2"]),
}


def point_loader(point, graphs=8):
    base, extra = LOADER_POINTS[point]
    cfg = load_cfg(os.path.join(ROOT, "configs", f"{base}.yaml"),
                   SMALL + extra)
    with pytest.MonkeyPatch.context() as mp:
        real = loaders.load_dataset
        mp.setattr(loaders, "load_dataset",
                   lambda c: real(c)[:graphs])
        return loaders.create_loader(loaders.create_dataset(cfg), cfg)[0]


def unshared_numpy_pack(s, r, w, rows, senders, least=0, slots=False):
    """The numpy packer padded to its bucket only: the loader then pads
    each batch to the shared chunk counts afterwards (pad_packs)."""
    return numpy_pack(s, r, w, rows, senders, 0, slots)


@pytest.mark.parametrize("plain", [numpy_pack, unshared_numpy_pack])
@pytest.mark.parametrize("point", sorted(LOADER_POINTS))
def test_loader_batches_equal_the_numpy_builder(point, plain, monkeypatch):
    """A multi-batch train loader's packs over three epochs (reshuffled,
    the chunk counts shared), native against numpy, kind for kind; and
    against numpy packs built at their bucket and padded to the shared
    counts only afterwards."""
    got_loader = point_loader(point)
    want_loader = point_loader(point)
    epochs = []
    for e in range(3):
        epochs.append(got_loader.batches(e))
    monkeypatch.setattr(packing, "_pack", plain)
    assert len(epochs[0]) > 1
    seen = set()
    for e, got in enumerate(epochs):
        want = want_loader.batches(e)
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            assert gb.packs.keys() == wb.packs.keys()
            seen |= set(gb.packs)
            for kind in gb.packs:
                for a, b in zip(gb.packs[kind], wb.packs[kind]):
                    if isinstance(a, K.PackedCSR):
                        assert_packs_equal(a, b)
                    else:
                        assert np.array_equal(a, b)
    assert point in seen


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" int f() { return not_declared; }\n')
    with pytest.raises(RuntimeError, match="not_declared"):
        native.build(str(bad), str(tmp_path / "build"))
    assert not any(p.suffix == ".so" or p.name.endswith(".tmp")
                   for p in (tmp_path / "build").iterdir())


def test_builds_at_once_end_with_one_library(tmp_path):
    """Processes that build at once (pytest -n) each rename their own
    output into place: one library, no temporary left, loadable."""
    code = ("import sys; from graphgym_tpu_torch import native; "
            "print(native.build(native.SOURCE, sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    paths = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(paths.pop())]


def test_concurrent_builds_equal_serial_ones():
    """More threads than cores build packs at once, with a short switch
    interval (the loader builds a batch's packs and an epoch's batches
    side by side; the packer's scratch is per thread): every pack equals
    the one built alone."""
    import threading

    rng = np.random.default_rng(21)
    cases = [random_edges(rng, 900, 900, 6000, hub=i % 2 == 0,
                          repeats=i % 3 == 0) for i in range(6)]
    want = [native.pack_csr_with_slots(s, r, w, 900) for s, r, w in cases]
    errors, done = [], []

    def worker(k):
        try:
            for rep in range(5):
                i = (k + rep) % len(cases)
                got = native.pack_csr_with_slots(*cases[i], 900)
                for a, b in zip(got[0], want[i][0]):
                    assert np.array_equal(a, b)
                assert np.array_equal(got[1], want[i][1])
            done.append(k)
        except Exception as exc:     # reported below, in the test thread
            errors.append(exc)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(done) == len(threads)
