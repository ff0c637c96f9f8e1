"""The port's batch runner (graphgym_tpu_torch/exp/runner.py) and the
aggregation CLI (``python -m graphgym_tpu_torch.exp.agg``) on the CPU.

A grid of two tiny points (graphgym_tpu_torch/exp/grid.gen_grid on
configs/idgcn_ws.yaml) and a config with an unknown layer type go
through ``run_batch``, which starts ``python -m graphgym_tpu_torch.main
--mark_done`` per config with the overrides ``device cpu`` and one
epoch: both points are renamed ``_done`` and write their stats, the
unknown layer type fails every round, is counted and keeps its name.
``agg_batch`` then writes one CSV row a run, and the CLI writes the
same CSVs as the JAX package's on copies of the same run dirs.
scripts/design/run_design_round1.sh's steps with the port's modules:
its SMOKE generation writes the configs of
results/design_v1_grid_round1, and a budget-matched point goes through
the generation, the runner's CLI and the aggregation's CLI.
"""

import csv
import filecmp
import glob
import json
import os
import shutil

import pytest

from graphgym_tpu.exp import agg as jax_agg
import yaml

from graphgym_tpu_torch.exp import agg, grid, runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["device", "cpu", "gnn.dim_inner", "8", "gnn.layers_mp", "1",
             "optim.max_epoch", "1", "train.eval_period", "1"]


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """The config dir and the results dir of one run_batch: two grid
    points (gcnidconv, sageidconv) and a config with an unknown layer
    type, two rounds, two jobs at a time."""
    root = tmp_path_factory.mktemp("batch")
    configs, results = root / "configs", root / "results"
    grid_file = root / "grid.txt"
    grid_file.write_text(
        "gnn.layer_type layer ['gcnidconv','sageidconv']\n")
    base = root / "idgcn_ws.yaml"
    with open(os.path.join(ROOT, "configs", "idgcn_ws.yaml")) as f:
        text = f.read()
    base.write_text(text.replace("out_dir: results",
                                 f"out_dir: {results}"))
    written = grid.gen_grid(str(base), str(grid_file), str(configs))
    with open(written[0]) as f:
        text = f.read()
    bad = configs / "idgcn_ws-layer=nosuchconv.yaml"
    bad.write_text(text.replace("gcnidconv", "nosuchconv"))
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", ROOT)
    try:
        failures = runner.run_batch(str(configs), max_jobs=2, rounds=2,
                                    overrides=OVERRIDES)
    finally:
        mp.undo()
    return configs, results, failures


def test_run_batch_marks_done_and_counts_failures(batch):
    configs, results, failures = batch
    assert failures == 1
    assert sorted(os.listdir(configs)) == [
        "idgcn_ws-layer=gcnidconv.yaml_done",
        "idgcn_ws-layer=nosuchconv.yaml",
        "idgcn_ws-layer=sageidconv.yaml_done"]
    for layer in ("gcnidconv", "sageidconv"):
        run = results / f"idgcn_ws-layer={layer}"
        with open(run / "1" / "val" / "stats.json") as f:
            (stats,) = [json.loads(line) for line in f]
        assert 0.0 <= stats["accuracy"] <= 1.0
        assert (run / "1" / "train" / "stats.json").exists()
        assert (run / "agg" / "val" / "best.json").exists()
        with open(run / "1" / "config.yaml") as f:
            text = f.read()
        assert "device: cpu" in text and f"layer_type: {layer}" in text
    assert not glob.glob(str(results / "*nosuchconv" / "1" / "val"))


def test_agg_batch_writes_a_row_a_run(batch):
    _, results, _ = batch
    out = results.parent / "agg_once"
    shutil.copytree(results, out)
    agg.agg_batch(str(out))
    with open(out / "agg" / "val_best.csv") as f:
        rows = list(csv.DictReader(f))
    assert sorted(r["layer"] for r in rows) == ["gcnidconv", "sageidconv"]
    assert all(0.0 <= float(r["accuracy"]) <= 1.0 for r in rows)


def test_agg_cli_matches_jax(batch):
    """python -m graphgym_tpu_torch.exp.agg DIR --metric accuracy and
    the JAX package's CLI on copies of the same run dirs: the same CSV
    files, byte for byte."""
    _, results, _ = batch
    dirs = []
    for name, main in (("jax", jax_agg.main), ("port", agg.main)):
        out = results.parent / f"cli_{name}"
        shutil.copytree(results, out)
        main([str(out), "--metric", "accuracy"])
        dirs.append(out / "agg")
    csvs = sorted(os.listdir(dirs[0]))
    assert csvs == sorted(os.listdir(dirs[1]))
    assert {"val_best.csv", "val.csv", "val_bestepoch.csv",
            "train_best.csv"} <= set(csvs)
    for name in csvs:
        assert filecmp.cmp(dirs[0] / name, dirs[1] / name,
                           shallow=False), name


def test_runner_cli_reports_failures(batch, monkeypatch, capsys):
    """The CLI retries what is left (the unknown layer type) and exits
    1, naming how many configs failed."""
    configs, _, _ = batch
    monkeypatch.setenv("PYTHONPATH", ROOT)
    assert runner.main([str(configs), "--rounds", "1",
                        "--overrides"] + OVERRIDES) == 1
    assert "1 configs failed after 1 rounds" in capsys.readouterr().out
    assert os.path.exists(configs / "idgcn_ws-layer=nosuchconv.yaml")


def test_smoke_generation_keeps_the_scripts_configs(tmp_path):
    """round1 sampled at the script's SMOKE scale (sample_num 6, the
    aliases of sample/dimensions.txt, no budget) and cut, as the script
    cuts it, to the first 6 nx configs in name order: the configs of
    results/design_v1_grid_round1, the same names and, but for out_dir,
    the same lines."""
    configs = tmp_path / "configs"
    written = grid.gen_grid_sample_aliased(
        os.path.join(ROOT, "configs", "design", "design_v1.yaml"),
        os.path.join(ROOT, "grids", "design", "round1.txt"), str(configs),
        sample_num=6, aliases=grid.load_alias_file(
            os.path.join(ROOT, "sample", "dimensions.txt")),
        results_dir=str(tmp_path))
    kept = 0
    for path in sorted(written):
        with open(path) as f:
            fmt = yaml.safe_load(f).get("dataset", {}).get("format")
        if fmt != "nx" or kept >= 6:
            os.remove(path)
        else:
            kept += 1
    assert len(written) > 6 and kept == 6
    ref = os.path.join(ROOT, "results", "design_v1_grid_round1", "configs")
    names = sorted(os.listdir(configs))
    assert names == sorted(n[:-len("_done")] for n in os.listdir(ref))
    for name in names:
        with open(configs / name) as f:
            got = [ln for ln in f if not ln.startswith("out_dir:")]
        with open(os.path.join(ref, name + "_done")) as f:
            want = [ln for ln in f if not ln.startswith("out_dir:")]
        assert got == want, name


def test_design_steps_run_and_aggregate(tmp_path, monkeypatch):
    """The design script's three steps on the CPU: one point of a
    one-chunk grid sampled and budget-matched to its base
    (gen_grid_sample_aliased), run by the runner's CLI and aggregated
    by the aggregation's CLI into DIR/agg."""
    grid_file = tmp_path / "grid.txt"
    grid_file.write_text("gnn.layer_type layer ['gcnidconv']\n"
                         "gnn.layers_mp l_mp [1]\n")
    out, base = tmp_path / "out", os.path.join(ROOT, "configs",
                                               "idgcn_ws.yaml")
    (path,) = grid.gen_grid_sample_aliased(
        base, str(grid_file), str(out / "configs"), sample_num=1,
        aliases=["layer"], config_budget=base, results_dir=str(out))
    monkeypatch.setenv("PYTHONPATH", ROOT)
    assert runner.main([str(out / "configs"), "--repeat", "1",
                        "--overrides"] + OVERRIDES) == 0
    (done,) = os.listdir(out / "configs")
    assert done == os.path.basename(path) + "_done"
    assert "layer=gcnidconv" in done
    agg.main([str(out)])
    with open(out / "agg" / "val_best.csv") as f:
        (row,) = list(csv.DictReader(f))
    assert row["layer"] == "gcnidconv"
