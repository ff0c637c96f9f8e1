"""The port's parity tool (graphgym_tpu_torch/exp/parity.py).

Its pass rule is PARITY.md's (``pass_2sigma`` of tools/run_parity.py,
held value for value); it reads the reference's and the JAX package's
numbers from results/parity/parity.json and link_parity.json and never
writes them; its table, built from a fake seed aggregate written by the
port's ``exp/agg.py``, judges a row against the reference, or against
the JAX package where the JAX package's own row misses the reference;
the command line trains a config through ``main`` on the CPU and
writes parity.md and parity.json under --out only.
"""

import hashlib
import json
import os
import sys

import pytest

from graphgym_tpu_torch.exp import agg, parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import run_parity  # noqa: E402  (the JAX tool: only its pure rule)


@pytest.mark.parametrize("delta,sigma_ref,sigma_ours", [
    (0.0, 0.0, 0.0), (0.03, 0.0, 0.0), (0.0301, 0.0, 0.0),
    (-0.0301, 0.001, 0.001), (0.05, 0.02, 0.01), (-0.05, 0.02, 0.01),
    (0.0448, 0.02, 0.01), (0.1033, 0.0273, 0.0194), (0.12, 0.05, 0.03),
    (0.2483, 0.0153, None)])
def test_pass_rule_is_the_jax_tools(delta, sigma_ref, sigma_ours):
    passes, limit = parity.pass_rule(delta, sigma_ref, sigma_ours)
    assert passes == run_parity.pass_2sigma(delta, sigma_ref, sigma_ours)
    assert limit == pytest.approx(max(
        2 * ((sigma_ref or 0) ** 2 + (sigma_ours or 0) ** 2) ** 0.5, 0.03))


def test_reads_parity_json_without_writing_it():
    digests = {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
               for p in (parity.PARITY_JSON, parity.LINK_PARITY_JSON)}
    row = parity.reference("idgcn", "ws")
    assert row["reference"] == pytest.approx(0.99375, abs=1e-5)
    assert row["ours"] == 0.9937 and row["pass_2sigma"]
    gin = parity.reference("idgin", "ba")
    assert (gin["reference"], gin["reference_std"]) == pytest.approx(
        (0.6596, 0.0297), abs=1e-4)
    link = parity.link_reference("gcnidconv", "ws")
    assert (link["ours"], link["ours_std"]) == (0.6949, 0.0194)
    assert (link["reference"], link["reference_std"]) == (0.7982, 0.0273)
    with pytest.raises(KeyError):
        parity.reference("idgcn", "Cora")
    assert digests == {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
                       for p in digests}


@pytest.mark.parametrize("cfg_file,key", [
    ("configs/idgin_ba.yaml", ("idgin", "ba")),
    ("configs/gcnconvFast_ws.yaml", ("gcnconvFast", "ws")),
    ("/x/idgcn_smallworld.yaml", ("idgcn", "smallworld"))])
def test_config_key(cfg_file, key):
    assert parity.config_key(cfg_file) == key


def fake_runs(parent, accs, epochs=3):
    """Seed directories with train and val stats (val accuracy ``accs``
    per seed, best at the last epoch), aggregated by exp/agg.py."""
    for seed, acc in enumerate(accs, 1):
        for split in ("train", "val"):
            d = os.path.join(parent, str(seed), split)
            os.makedirs(d)
            with open(os.path.join(d, "stats.json"), "w") as f:
                for e in range(epochs):
                    f.write(json.dumps(dict(
                        epoch=e, loss=1.0 / (e + 1), time_iter=0.01 * seed,
                        accuracy=acc * (e + 1) / epochs)) + "\n")
    agg.agg_runs(parent)


@pytest.mark.parametrize("cfg,accs,judged,passes", [
    ("idgin_ba.yaml", [0.66, 0.67, 0.65], "reference", True),
    ("idgin_ba.yaml", [0.76, 0.77, 0.75], "reference", False),
    # the JAX package's own row misses the reference (0.6927 against
    # 0.5708): the port is held to the JAX package's result
    ("gcnconvFast_ws.yaml", [0.69, 0.70, 0.68], "jax", True),
    ("gcnconvFast_ws.yaml", [0.57, 0.58, 0.56], "jax", False)])
def test_table_from_a_fake_aggregate(cfg, accs, judged, passes, tmp_path):
    parent = str(tmp_path / "runs" / cfg[:-5])
    fake_runs(parent, accs)
    summary = parity.summarize(parent, [1.5, 1.25, 1.0])
    assert summary["seeds"] == 3 and summary["epochs"] == [3, 3, 3]
    assert summary["best_val_acc_per_seed"] == pytest.approx(accs)
    assert summary["mean"] == pytest.approx(sum(accs) / 3, abs=1e-4)
    assert summary["time_iter_median_s"] == pytest.approx(0.02)
    row = parity.parity_row(cfg, summary)
    ref = parity.reference(*parity.config_key(cfg))
    assert row["judged_against"] == judged and row["passes"] == passes
    assert row["jax"] == ref["ours"] and row["reference"] == ref["reference"]
    want, limit = parity.pass_rule(
        summary["mean"] - (ref["ours"] if judged == "jax"
                           else ref["reference"]),
        ref["ours_std"] if judged == "jax" else ref["reference_std"],
        summary["std"])
    assert (want, limit) == (passes, row["limit_jax" if judged == "jax"
                                         else "limit"])
    out = tmp_path / "table"
    parity.write([row], str(out))
    assert sorted(os.listdir(out)) == ["parity.json", "parity.md"]
    md = (out / "parity.md").read_text().splitlines()
    assert len(md) == 3 and md[2].startswith(f"| {cfg} |")
    assert f"| {judged} | {passes} |" in md[2]
    assert json.loads((out / "parity.json").read_text()) == [row]


def test_command_line_trains_through_main(tmp_path):
    """Two seeds of gcnconvFast ws for two epochs at width 8 on the CPU:
    the row, and files only under --out."""
    out = tmp_path / "out"
    rows = parity.main([
        "--configs", os.path.join(ROOT, "configs", "gcnconvFast_ws.yaml"),
        "--repeat", "2", "--out", str(out), "--opts", "device", "cpu",
        "optim.max_epoch", "2", "gnn.dim_inner", "8"])
    (row,) = rows
    assert row["config"] == "gcnconvFast_ws.yaml" and row["seeds"] == 2
    assert len(row["seconds_per_run"]) == 2
    assert 0.0 <= row["port"] <= 1.0
    assert sorted(os.listdir(out)) == ["parity.json", "parity.md", "runs"]
    runs = out / "runs" / "gcnconvFast_ws"
    assert sorted(os.listdir(runs)) == ["1", "2", "agg"]
    assert not any("ckpt" in dirs for _, dirs, _ in os.walk(out))
