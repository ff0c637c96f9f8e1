"""Mixed precision (cfg.tpu.dtype bfloat16, train/graphed.py) against the
JAX package's (graphgym_tpu/train/loop.py:50-104), and the kernels'
bf16 weight rounding (spmm_kernel.py:362-364, 567-568).

- The main path (configs/idgcn_ws.yaml's Tfg-idgcn, 3 layers at width
  16, 6 ws graphs a split, one batch a step) trained 3 Adam steps from
  the same parameters in the JAX package at bf16 (spmm_impl 'pallas':
  its kernels interpreted on the CPU) and in the port at bf16 and at
  f32: the port's bf16 losses within 1e-4 of the JAX package's and its
  eval scores within 8e-4, each tolerance below the port's own
  bf16-against-f32 gap that the test measures on the same run (about
  2e-4 and 1e-3 here), so the test tells a bf16 run from an f32 one.
- The ports of tests/test_train.py:128-190 (gcnconv, width 32, 8 graphs
  a split): a bf16 run learns (4 epochs, finite losses, the last below
  the first), its master parameters and the Adam moments stay f32, its
  val accuracy lies in [0, 1]; a bf16 eval forward within 5e-2 of the
  f32 one.
- The rounding: K1's plain version on a bf16 x rounds each slot weight
  to bf16 (``weight_as``), K3's each alpha: on rows of one slot each
  the output is bitwise the JAX kernel's in interpret mode (f32 weights
  that bf16 does not hold, so an unrounded weight would differ), and on
  a random pack within rtol 1e-2 (K1, a bf16 output) / rtol 1e-5, atol
  1e-5 (K3, f32).  The f32 path is unchanged (tests/test_torch_spmm.py,
  test_torch_attention.py).
- tpu.remat at bf16 (the gcnconv model above): the rematerialized
  layers' recompute reads the step's cast parameters, and the losses of
  3 steps are bitwise those without remat.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.data import loaders as jax_loaders
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.data import loaders
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train import graphed
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_spmm import pack_tensors, random_graph
from test_torch_train import StepRecorder, setup_dict

CPU = torch.device("cpu")
LOSS_TOL, SCORE_TOL = 1e-4, 8e-4


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def main_path_setup():
    setup = setup_dict("none", 128)
    setup["dataset"]["augment_label_dims"] = 10
    setup["gnn"]["layers_mp"] = 3
    setup["optim"]["max_epoch"] = 3
    return setup


def port_trainer(setup, dtype, params=None, extra=None):
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu", "tpu": {"dtype": dtype},
                         **(extra or {})})
    lds = loaders.create_loader(
        [p[:6] for p in loaders.create_dataset(cfg)], cfg)
    model = build_model(cfg, CPU)
    if params is not None:
        model.load_state_dict(params_from_jax(params, model))
    return Trainer(model, lds, cfg, CPU)


def steps_and_scores(tr, place, eval_step, loaders_, epochs=3):
    rec = StepRecorder()
    for epoch in range(epochs):
        tr.train_epoch(rec, epoch)
    batch = loaders_[1].batches(0)[0]
    _, score, _, mask = eval_step(place(batch))
    score, mask = np.asarray(score), np.asarray(mask).astype(bool)
    return np.asarray(rec.losses), score[mask]


def test_main_path_bf16_matches_jax():
    setup = main_path_setup()
    jcfg = jax_get_cfg()
    jcfg.merge_from_dict(setup)
    jcfg.merge_from_dict({"tpu": {"spmm_impl": "pallas",
                                  "dtype": "bfloat16"}})
    jloaders = jax_loaders.create_loader(
        [p[:6] for p in jax_loaders.create_dataset(jcfg)], jcfg)
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, jtr.state.params)
    want = steps_and_scores(jtr, jtr._place,
                            lambda b: jtr.eval_step(jtr.state, b), jloaders)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        tr = port_trainer(setup, dtype, params)
        runs[dtype] = steps_and_scores(tr, tr._place, tr.eval_step,
                                       tr.loaders)
    (loss16, score16), (loss32, score32) = runs["bfloat16"], runs["float32"]
    gap_loss = np.abs(loss16 - loss32).max()
    gap_score = np.abs(score16 - score32).max()
    assert gap_loss > LOSS_TOL and gap_score > SCORE_TOL, (gap_loss,
                                                           gap_score)
    np.testing.assert_allclose(loss16, want[0], rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(score16, want[1], rtol=0, atol=SCORE_TOL)


def tiny_setup():
    return {
        "dataset": {"format": "nx", "name": "ws", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 4},
        "gnn": {"layers_mp": 2, "dim_inner": 32, "layers_pre_mp": 1,
                "layers_post_mp": 1, "layer_type": "gcnconv"},
        "train": {"batch_size": 16, "eval_period": 2, "ckpt_period": 4},
        "optim": {"max_epoch": 4, "scheduler": "none"}}


def test_bf16_training_runs_and_learns():
    """tests/test_train.py:129-162 in the port."""
    tr = port_trainer(tiny_setup(), "bfloat16")
    losses = []
    for epoch in range(4):
        rec = StepRecorder()
        tr.train_epoch(rec, epoch)
        losses.append(np.mean(rec.losses))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
    for p in tr.model.parameters():
        assert p.dtype == torch.float32
    for state in tr.optimizer.state.values():
        for v in state.values():
            if torch.is_tensor(v) and v.is_floating_point():
                assert v.dtype == torch.float32
    for name, buf in tr.model.named_buffers():
        assert buf.dtype == torch.float32, name
    assert 0.0 <= tr.eval_epoch(None, 1) <= 1.0


def test_bf16_forward_close_to_f32():
    """tests/test_train.py:164-190 in the port: one eval forward."""
    tr = port_trainer(tiny_setup(), "float32")
    batch = tr._place(tr.loaders[0].batches(0)[0])
    tr.model.eval()
    with torch.no_grad():
        s32, _, m = graphed.forward(tr.model, batch)
        s16, _, _ = graphed.forward(tr.model, batch, torch.bfloat16)
    assert s16.dtype == torch.bfloat16 and s32.dtype == torch.float32
    p32, p16 = (torch.softmax(s.float(), -1) for s in (s32, s16))
    valid = m.bool()
    diff = (p32 - p16).abs()[valid].max().item()
    assert 0 < diff < 5e-2, diff


def one_slot_rows(seed, n=200):
    """A pack whose every row holds one slot, weights in f32 that bf16
    does not hold."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, n)
    r = np.arange(n)
    w = (rng.random(n) + 0.1).astype(np.float32)
    assert (torch.from_numpy(w).to(torch.bfloat16).float().numpy()
            != w).any()
    return s, r, w, n


def bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("graph", ["one_slot", "random"])
def test_k1_rounds_weights_as_the_tpu_kernel(graph):
    s, r, w, n = one_slot_rows(0) if graph == "one_slot" else \
        random_graph(4)
    pack = K.pack_csr(s, r, w, n)
    x = bf16(np.random.default_rng(1).normal(size=(n, 16)))
    want = np.asarray(JK.spmm_packed(pack, jnp.asarray(x, jnp.bfloat16), n,
                                     interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = K.spmm_packed_plain(pack_tensors(pack), xt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if graph == "one_slot":
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(bf16(w[:, None] * x[s]), want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("graph", ["one_slot", "random"])
@pytest.mark.parametrize("heads", [1, 2])
def test_k3_rounds_alpha_as_the_tpu_kernel(graph, heads):
    s, r, w, n = one_slot_rows(2) if graph == "one_slot" else \
        random_graph(5)
    pack = K.pack_csr(s, r, w, n)
    rng = np.random.default_rng(heads)
    v = bf16(rng.normal(size=(n, 8 * heads)))
    alpha = (rng.random(pack.senders.shape + (heads,)) + 0.1).astype(
        np.float32) * (pack.weights[..., None] != 0)
    num_tiles = (n + K.ROWS_PER_TILE - 1) // K.ROWS_PER_TILE
    vp = np.concatenate([v, np.zeros((1, v.shape[1]), np.float32)])
    want = np.asarray(JK.packed_segment_matmul_headed(
        jnp.asarray(vp[pack.senders], jnp.bfloat16), jnp.asarray(alpha),
        jnp.asarray(pack.local_rows), jnp.asarray(pack.tiles), num_tiles,
        heads, interpret=True)[:n])
    got = K.packed_segment_matmul_headed_plain(
        pack_tensors(pack), torch.from_numpy(v).to(torch.bfloat16),
        torch.from_numpy(alpha))
    assert got.dtype == torch.float32
    if graph == "one_slot":
        np.testing.assert_array_equal(got.numpy(), want)
        kept = K.packed_segment_matmul_headed_plain(
            pack_tensors(pack), torch.from_numpy(v), torch.from_numpy(alpha))
        assert not np.array_equal(kept.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5)


def test_remat_at_bf16_is_bitwise_the_plain_step():
    losses = []
    for remat in (False, True):
        tr = port_trainer(tiny_setup(), "bfloat16",
                          extra={"tpu": {"dtype": "bfloat16",
                                         "remat": remat}})
        assert all(layer.remat == remat for layer in tr.model.mp.layers)
        rec = StepRecorder()
        for epoch in range(3):
            tr.train_epoch(rec, epoch)
        losses.append(rec.losses)
    assert losses[0] == losses[1]
