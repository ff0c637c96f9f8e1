"""ID-GNN Fast and the regenerated synthetic corpora in the port against
the JAX package: the plain Tfg layers on Fast features (identity
diagonals of width 10 before the 1-wide node feature), eval logits from
the same variables (rtol 1e-4 / atol 1e-5); two epochs of
gcnconvFast_ws and sageconvFast_ws training and of ID-GCN Full on a
small regenerated ba corpus (ws or ba, a few graphs per split, 2
layers, width 16, as tests/test_torch_train.py): per-step losses within
2e-3; and the shapes of the configs' batches that PERF.md records. The
JAX side runs its numpy host paths and the Pallas kernel in interpret
mode."""

import hashlib
import os

import jax
import numpy as np
import pytest
import torch

import graphgym_tpu.data.loaders as jax_loaders
import graphgym_tpu.data.synthetic as jax_syn
import graphgym_tpu.native as jax_native
from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.nn.model import build_model as jax_build_model
from graphgym_tpu.train.loop import Trainer as JaxTrainer
from graphgym_tpu_torch.config import get_cfg, load_cfg
from graphgym_tpu_torch.data import loaders, synthetic as syn
from graphgym_tpu_torch.nn.model import build_model
from graphgym_tpu_torch.train.loop import Trainer
from graphgym_tpu_torch.weights import params_from_jax
from test_torch_train import StepRecorder

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_TYPES = ["Tfg-gcnconv", "Tfg-sageconv", "Tfg-ginconv", "Tfg-gatconv"]


@pytest.fixture(autouse=True)
def numpy_paths(monkeypatch):
    monkeypatch.setattr(jax_native, "load", lambda: None)


def fast_setup(layer_type, **optim):
    return {
        "dataset": {"format": "nx", "name": "ws", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_feature": ["node_identity"],
                    "augment_feature_dims": [10],
                    "augment_feature_repr": "original",
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 4, "transform": "none"},
        "gnn": {"layers_mp": 2, "dim_inner": 16, "layer_type": layer_type},
        "train": {"batch_size": 8},
        "optim": {"scheduler": "cos", "max_epoch": 2, **optim},
    }


def configs(setup):
    jcfg = jax_get_cfg()
    jcfg.merge_from_dict(setup)
    jcfg.merge_from_dict({"tpu": {"spmm_impl": "pallas"}})
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    cfg.merge_from_dict({"device": "cpu"})
    return jcfg, cfg


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@pytest.mark.parametrize("layer_type", FAST_TYPES)
def test_fast_logits_match_jax(layer_type):
    jcfg, cfg = configs(fast_setup(layer_type))
    jsplits = [p[:6] for p in jax_loaders.create_dataset(jcfg)]
    jbatch = jax_loaders.create_loader(jsplits, jcfg)[1].batches(0)[0]
    splits = [p[:6] for p in loaders.create_dataset(cfg)]
    batch = loaders.create_loader(splits, cfg)[1].batches(0)[0].to(CPU)
    assert cfg.share.dim_in == jcfg.share.dim_in == 11
    np.testing.assert_allclose(batch.node_feat.numpy(),
                               np.asarray(jbatch.node_feat), rtol=1e-5,
                               atol=1e-6)
    jmodel = jax_build_model(jcfg)
    variables = to_numpy(dict(jmodel.init(jax.random.PRNGKey(0), jbatch,
                                          False)))
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(variables, model))
    model.eval()
    want, _, _ = jmodel.apply(variables, jbatch, False)
    got, _, _ = model(batch)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def two_epochs(jcfg, cfg, graphs_per_split=6):
    jloaders = jax_loaders.create_loader(
        [p[:graphs_per_split] for p in jax_loaders.create_dataset(jcfg)],
        jcfg)
    jtr = JaxTrainer(jax_build_model(jcfg), jloaders, jcfg,
                     rng=jax.random.PRNGKey(0))
    lds = loaders.create_loader(
        [p[:graphs_per_split] for p in loaders.create_dataset(cfg)], cfg)
    model = build_model(cfg, CPU)
    model.load_state_dict(params_from_jax(to_numpy(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}),
        model))
    tr = Trainer(model, lds, cfg, CPU)
    jrec, rec = StepRecorder(), StepRecorder()
    for epoch in range(2):
        jtr.train_epoch(jrec, epoch)
        tr.train_epoch(rec, epoch)
    assert len(rec.losses) == len(jrec.losses) == 2 * len(lds[0])
    np.testing.assert_allclose(rec.losses, jrec.losses, atol=2e-3)
    np.testing.assert_allclose(rec.lrs, jrec.lrs, rtol=1e-6)
    assert abs(tr.eval_epoch(None, 1) - jtr.eval_epoch(None, 1)) < 5e-3
    return rec.losses


@pytest.mark.parametrize("layer_type", ["Tfg-gcnconv", "Tfg-sageconv"])
def test_fast_two_epochs_match_jax(layer_type):
    jcfg, cfg = configs(fast_setup(layer_type))
    losses = two_epochs(jcfg, cfg)
    assert len(losses) == 2
    assert cfg.share.dim_in == 11


def test_full_on_regenerated_ba_matches_jax(tmp_path, monkeypatch):
    """ID-GCN Full on a ba corpus each package regenerates for itself
    (8 graphs of 64 nodes from seed 0; the port without networkx)."""
    for module in (syn, jax_syn):
        real = module.generate_syn_graphs
        monkeypatch.setattr(
            module, "generate_syn_graphs",
            lambda kind, num_graphs, n, real=real: real(
                kind=kind, num_graphs=8, n=n))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(jax_loaders, "_SEARCH_DIRS", [str(jdir)])
    monkeypatch.setattr(loaders, "_REPO_DATASETS", str(pdir))
    setup = {
        "dataset": {"format": "nx", "name": "ba", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 4, "transform": "ego"},
        "gnn": {"layers_mp": 2, "dim_inner": 16, "layer_type": "Tfg-idgcn"},
        "train": {"batch_size": 8},
        "optim": {"scheduler": "cos", "max_epoch": 2},
    }
    jcfg, cfg = configs(setup)
    jcfg.merge_from_dict({"dataset": {"dir": str(jdir)}})
    cfg.merge_from_dict({"dataset": {"dir": str(pdir)}})
    two_epochs(jcfg, cfg)
    assert os.listdir(jdir) == ["ba.pkl"]
    assert os.listdir(pdir) == ["ba.torch.pkl"]


def path_shapes(config, overrides=()):
    """Per split: (batches, padded nodes, edge slots, pack chunks, slots
    of nonzero weight, longest row (slots of its row_range), rows over
    32 slots) of the config's first batch, on its pack."""
    from graphgym_tpu_torch.graphs.packing import kinds_for_layer

    cfg = load_cfg(os.path.join(ROOT, "configs", f"{config}.yaml"),
                   ["device", "cpu", *overrides])
    (kind,) = kinds_for_layer(cfg.gnn.layer_type)
    out = []
    for ld in loaders.create_loader(loaders.create_dataset(cfg), cfg):
        batches = ld.batches(0)
        b = batches[0]
        fwd = b.packs[kind][0]
        lengths = fwd.row_range[:, 1] - fwd.row_range[:, 0]
        out.append((len(batches), b.num_nodes, b.num_edges,
                    fwd.senders.shape[0], int((fwd.weights != 0).sum()),
                    int(lengths.max()), int((lengths > 32).sum())))
    return cfg, out


@pytest.mark.parametrize("config", ["gcnconvFast_ws", "sageconvFast_ws",
                                    "ginconvFast_ws", "gatconvFast_ws"])
def test_fast_path_shapes(config):
    """One batch per split with no ego transform: 22 graphs of 64 nodes
    (1,408 real, padded to 1,536), 5,632 real edges; the 'gcn' and 'att'
    packs add a self-loop a node."""
    cfg, shapes = path_shapes(config)
    assert cfg.share.dim_in == 11
    loops = config in ("gcnconvFast_ws", "gatconvFast_ws")
    assert shapes == [(1, 1536, 6144, 16, 5632 + 1408 * loops, 8 + loops, 0),
                      (1, 448, 1536, 8, 1536 + 384 * loops, 8 + loops, 0)]


@pytest.fixture(scope="module")
def ba_dir(tmp_path_factory):
    """The full ba corpus, regenerated once into a scratch directory."""
    return str(tmp_path_factory.mktemp("ba"))


@pytest.mark.parametrize("config", ["idgcn_ba", "idgin_ba"])
def test_ba_path_shapes(ba_dir, config):
    """The regenerated ba corpus (seed 0: 116 graphs, the JAX package's
    corpus edge for edge, by its digest) and its batches: ID-GCN at
    batch 128 takes all 92 train graphs in one ~312 k-node batch, ID-GIN
    at batch 48 two; both packs hold hub rows of more than 32 slots,
    which K1's narrow walk hands to a warp."""
    cfg, shapes = path_shapes(config, ["dataset.dir", ba_dir])
    graphs = loaders.load_nx("ba", ba_dir)
    digest = hashlib.sha256()
    for g in graphs:
        digest.update(np.ascontiguousarray(g.edge_index, np.int32).tobytes())
    assert len(graphs) == 116
    assert digest.hexdigest() == ("fc3beb9b7b0effd6f75f3110d5119f3d"
                                  "570e40ab93423ced0554a58984554a40")
    want = {"idgcn_ba": [(1, 327680, 1310720, 3072, 1492856, 49, 868),
                         (1, 98304, 327680, 896, 404352, 43, 371)],
            "idgin_ba": [(2, 196608, 786432, 1792, 617320, 48, 441),
                         (1, 98304, 327680, 896, 319962, 42, 371)]}
    assert shapes == want[config]
