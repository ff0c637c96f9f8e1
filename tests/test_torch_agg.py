"""The port's seed aggregation (graphgym_tpu_torch/exp/agg.py) against
the JAX package's graphgym_tpu/exp/agg.py: both aggregate copies of
the same seed directories, written by the port's entry point with
--repeat 2 on the CPU, and write the same files; the grid-batch CSVs
and run-name parsing agree as well."""

import filecmp
import importlib.util
import inspect
import json
import os
import shutil

import pytest

from graphgym_tpu.exp import agg as jax_agg
from graphgym_tpu_torch import main as port_main
from graphgym_tpu_torch.exp import agg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def seed_dirs(tmp_path_factory):
    """results/<cfg>/{1,2}/ of a 2-epoch torch-path run, 2 seeds."""
    out = tmp_path_factory.mktemp("runs")
    cfg_file = os.path.join(ROOT, "configs", "idgcn_ws.yaml")
    results = port_main.main(
        ["--cfg", cfg_file, "--repeat", "2", "device", "cpu",
         "gnn.layer_type", "gcnidconv", "gnn.dim_inner", "8",
         "optim.max_epoch", "2", "train.eval_period", "1",
         "out_dir", str(out)])
    assert len(results) == 2
    return out / "idgcn_ws"


def agg_files(parent):
    """The aggregate's files, tensorboard event files left out."""
    return sorted(os.path.relpath(os.path.join(d, f), parent)
                  for d, _, fs in os.walk(os.path.join(parent, "agg"))
                  for f in fs if not f.startswith("events.out.tfevents"))


def test_main_writes_the_aggregate(seed_dirs):
    """--repeat 2 ran seeds 1 and 2 and aggregated them: the val
    aggregate's accuracy is the mean of the seeds' best epochs; with
    cfg.tensorboard_agg (on by default) each split also holds an event
    file where tensorboardX imports."""
    assert sorted(os.listdir(seed_dirs)) == ["1", "2", "agg"]
    assert agg_files(seed_dirs) == [
        os.path.join("agg", s, f) for s in ("train", "val")
        for f in ("best.json", "stats.json")]
    tensorboard = importlib.util.find_spec("tensorboardX") is not None
    for s in ("train", "val"):
        names = os.listdir(seed_dirs / "agg" / s)
        assert any(n.startswith("events.out.tfevents")
                   for n in names) == tensorboard
    best = json.loads((seed_dirs / "agg" / "val" / "best.json").read_text())
    seeds = []
    for seed in ("1", "2"):
        lines = (seed_dirs / seed / "val" / "stats.json").read_text()
        seeds.append(max(json.loads(ln)["accuracy"]
                         for ln in lines.splitlines()))
    assert best["accuracy"] == round(sum(seeds) / 2, 4)
    assert "accuracy_std" in best


@pytest.mark.parametrize("metric,metric_agg", [("accuracy", "argmax"),
                                               ("loss", "argmin")])
def test_agg_runs_matches_jax(seed_dirs, tmp_path, metric, metric_agg):
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        shutil.copytree(seed_dirs, d, ignore=shutil.ignore_patterns("agg"))
        dirs.append(d)
    want = jax_agg.agg_runs(str(dirs[0]), metric=metric,
                            metric_agg=metric_agg)
    got = agg.agg_runs(str(dirs[1]), metric=metric, metric_agg=metric_agg)
    assert got == want and set(got) == {"train", "val"}
    files = agg_files(dirs[0])
    assert files == agg_files(dirs[1]) and len(files) == 4
    for f in files:
        assert filecmp.cmp(dirs[0] / f, dirs[1] / f, shallow=False), f


def test_agg_batch_and_names_match_jax(seed_dirs, tmp_path):
    """A grid batch of two runs named base-alias=value-...: the same
    CSVs, and name_to_dict reads the names alike."""
    batches = []
    for name in ("jax", "port"):
        batch = tmp_path / name
        for run in ("idgcn-l=3-dim=8", "idgcn-l=2-dim=8"):
            shutil.copytree(seed_dirs, batch / run,
                            ignore=shutil.ignore_patterns("agg"))
        batches.append(batch)
    jax_agg.agg_batch(str(batches[0]))
    agg.agg_batch(str(batches[1]))
    csvs = sorted(os.listdir(batches[0] / "agg"))
    assert csvs == sorted(os.listdir(batches[1] / "agg"))
    assert "val_best.csv" in csvs
    for f in csvs:
        assert filecmp.cmp(batches[0] / "agg" / f, batches[1] / "agg" / f,
                           shallow=False), f
    for name in ("idgcn-l=3-dim=8", "a-b", "x=1-y=z=2"):
        assert agg.name_to_dict(name) == jax_agg.name_to_dict(name)


def test_no_seed_dirs_and_tensorboard(tmp_path):
    """No seed directories give no aggregate, with or without the
    tensorboard copy, which agg_runs takes as the JAX package's does
    (its files: tests/test_torch_registries.py)."""
    assert agg.agg_runs(str(tmp_path / "empty")) is None
    assert agg.agg_runs(str(tmp_path), tensorboard=True) is None
    assert inspect.signature(agg.agg_runs).parameters["tensorboard"] \
        .default is False
    assert list(inspect.signature(agg.agg_runs).parameters) == list(
        inspect.signature(jax_agg.agg_runs).parameters)