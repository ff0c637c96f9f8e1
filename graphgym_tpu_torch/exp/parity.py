"""The port's parity tool: the reference's configs trained for their
full length through the port, against the reference's numbers.

    python -m graphgym_tpu_torch.exp.parity \\
        --configs configs/idgin_ws.yaml configs/idgat_ws.yaml \\
        --repeat 3 --out DIR [--opts dataset.dir D ...]

For each config it runs ``graphgym_tpu_torch.main --cfg C --repeat N``
(in this process, each seed timed), reads the seed aggregate the entry
point writes (``exp/agg.py``: ``DIR/runs/<config>/agg/val/best.json``)
and holds its mean best val accuracy to PARITY.md's pass rule
(results/parity/PARITY.md:1, ``pass_2sigma`` of tools/run_parity.py):
|delta| <= max(2 sqrt(sigma_ref^2 + sigma_ours^2), 0.03).  The
reference's mean and sigma, and the JAX package's own result beside
them, come from results/parity/parity.json, which this tool reads and
never writes.  Where the JAX package's own row misses the reference
(the reference's failing rows, ROADMAP "C"), the port is held to the
JAX package's result instead, and the row says so.  The table is
written as DIR/parity.md and DIR/parity.json, and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PARITY_JSON = os.path.join(ROOT, "results", "parity", "parity.json")
LINK_PARITY_JSON = os.path.join(ROOT, "results", "parity",
                                "link_parity.json")
FLOOR = 0.03    # PARITY.md's floor on the band


def pass_rule(delta: float, sigma_ref: float,
              sigma_ours: float) -> Tuple[bool, float]:
    """(passes, limit): PARITY.md's rule, |delta| <= limit =
    max(2 sqrt(sigma_ref^2 + sigma_ours^2), 0.03)."""
    limit = max(2 * math.sqrt((sigma_ref or 0.0) ** 2
                              + (sigma_ours or 0.0) ** 2), FLOOR)
    return bool(abs(delta) <= limit), limit


def read_rows(path: str = PARITY_JSON) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def reference(model: str, dataset: str, path: str = PARITY_JSON) -> Dict:
    """parity.json's row of ``model`` on ``dataset``: the reference's
    mean and sigma (``reference``, ``reference_std``) and the JAX
    package's (``ours``, ``ours_std``, ``seeds``, ``pass_2sigma``)."""
    rows = [r for r in read_rows(path)
            if r["model"] == model and r["dataset"] == dataset]
    if len(rows) != 1:
        raise KeyError(f"{path}: {len(rows)} rows for {model} on {dataset}")
    return rows[0]


def link_reference(layer: str, dataset: str, feature: str = "",
                   path: str = LINK_PARITY_JSON) -> Dict:
    """link_parity.json's row of ``layer`` on ``dataset`` with node
    feature ``feature`` ('' for none)."""
    rows = [r for r in read_rows(path) if r["layer"] == layer
            and r["dataset"] == dataset and r["feature"] == feature]
    if len(rows) != 1:
        raise KeyError(f"{path}: {len(rows)} rows for {layer} on "
                       f"{dataset} ({feature!r})")
    return rows[0]


def config_key(cfg_file: str) -> Tuple[str, str]:
    """(model, dataset) of a config named <model>_<dataset>.yaml, as
    parity.json names its rows (idgin_ba.yaml: idgin, ba)."""
    stem = os.path.splitext(os.path.basename(cfg_file))[0]
    model, _, dataset = stem.rpartition("_")
    return model, dataset


def _read_stats(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summarize(parent: str, seconds: Sequence[float] = ()) -> Dict:
    """The summary of the seed runs under ``parent`` (main's
    <out_dir>/<config>): each seed's best val accuracy and epochs, the
    aggregate's mean and std (agg/val/best.json), ``seconds`` (each
    seed's run) and the median ``time_iter`` of every train step."""
    with open(os.path.join(parent, "agg", "val", "best.json")) as f:
        best = json.loads(f.readline())
    per_seed, time_iter, epochs = [], [], []
    for seed in sorted(d for d in os.listdir(parent) if d.isdigit()):
        val = _read_stats(os.path.join(parent, seed, "val", "stats.json"))
        train = _read_stats(os.path.join(parent, seed, "train",
                                         "stats.json"))
        per_seed.append(max(s["accuracy"] for s in val))
        time_iter += [s["time_iter"] for s in train]
        epochs.append(len(train))
    return dict(seeds=len(per_seed), epochs=epochs,
                best_val_acc_per_seed=per_seed, mean=best["accuracy"],
                std=best.get("accuracy_std", 0.0),
                seconds_per_run=list(seconds),
                time_iter_median_s=float(np.median(time_iter)))


def run_config(cfg_file: str, repeat: int, out_dir: str,
               overrides: Sequence[str] = ()) -> Tuple[list, Dict]:
    """Train ``cfg_file`` through graphgym_tpu_torch.main with ``repeat``
    seeds into ``out_dir`` (its earlier runs of the config removed), each
    seed's run (data, model, training) timed; (main's results,
    ``summarize``'s summary)."""
    from graphgym_tpu_torch import main as port_main

    parent = os.path.join(
        out_dir, os.path.splitext(os.path.basename(cfg_file))[0])
    shutil.rmtree(parent, ignore_errors=True)   # stats.json appends
    seconds, real = [], port_main.run_single

    def timed(*args):
        t0 = time.perf_counter()
        result = real(*args)
        seconds.append(time.perf_counter() - t0)
        return result
    port_main.run_single = timed
    try:
        results = port_main.main(["--cfg", cfg_file, "--repeat", str(repeat)]
                                 + list(overrides) + ["out_dir", out_dir])
    finally:
        port_main.run_single = real
    return results, summarize(parent, seconds)


def parity_row(cfg_file: str, summary: Dict,
               path: str = PARITY_JSON) -> Dict:
    """One row of the table: the port's summary (``run_config``) beside
    parity.json's row for the config, judged by ``pass_rule`` against
    the reference, or against the JAX package where the JAX package's
    own row misses the reference."""
    model, dataset = config_key(cfg_file)
    ref = reference(model, dataset, path)
    mean, std = summary["mean"], summary["std"]
    passes_ref, limit_ref = pass_rule(mean - ref["reference"],
                                      ref["reference_std"], std)
    row = dict(config=os.path.basename(cfg_file), model=model,
               dataset=dataset, port=mean, port_std=std,
               seeds=summary["seeds"],
               seconds_per_run=summary["seconds_per_run"],
               time_iter_median_s=summary["time_iter_median_s"],
               jax=ref["ours"], jax_std=ref["ours_std"],
               jax_seeds=ref["seeds"], jax_passes=ref["pass_2sigma"],
               reference=ref["reference"],
               reference_std=ref["reference_std"],
               delta=mean - ref["reference"], limit=limit_ref,
               passes_reference=passes_ref, judged_against="reference",
               passes=passes_ref, note=ref.get("note", ""))
    if not ref["pass_2sigma"]:
        passes, limit = pass_rule(mean - ref["ours"], ref["ours_std"], std)
        row.update(judged_against="jax", delta_jax=mean - ref["ours"],
                   limit_jax=limit, passes=passes)
    return row


def _pm(mean: float, std: float) -> str:
    return f"{mean:.4f}±{std:.4f}"


def table(rows: Sequence[Dict]) -> str:
    """The markdown table of ``parity_row``'s rows."""
    out = ["| config | port (±σ, seeds) | JAX package (±σ, seeds) | "
           "reference (±σ) | delta | limit | judged against | passes | "
           "s per run | median time_iter ms |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        delta, limit = ((r["delta_jax"], r["limit_jax"])
                        if r["judged_against"] == "jax"
                        else (r["delta"], r["limit"]))
        runs = ", ".join(f"{s:.1f}" for s in r["seconds_per_run"])
        out.append(
            f"| {r['config']} | {_pm(r['port'], r['port_std'])} "
            f"({r['seeds']}) | {_pm(r['jax'], r['jax_std'])} "
            f"({r['jax_seeds']}) | "
            f"{_pm(r['reference'], r['reference_std'])} | {delta:+.4f} | "
            f"{limit:.4f} | {r['judged_against']} | {r['passes']} | "
            f"{runs} | {1e3 * r['time_iter_median_s']:.2f} |")
    return "\n".join(out) + "\n"


def write(rows: Sequence[Dict], out: str) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "parity.json"), "w") as f:
        json.dump(list(rows), f, indent=1)
    with open(os.path.join(out, "parity.md"), "w") as f:
        f.write(table(rows))


def drop_checkpoints(root: str) -> None:
    """Remove the runs' checkpoint directories (the aggregate and the
    stats stay)."""
    for parent, dirs, _ in os.walk(root):
        if "ckpt" in dirs:
            shutil.rmtree(os.path.join(parent, "ckpt"))
            dirs.remove("ckpt")


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    parser = argparse.ArgumentParser(
        description="full-length runs of configs through the port, "
                    "against results/parity/parity.json")
    parser.add_argument("--configs", nargs="+", required=True)
    parser.add_argument("--repeat", type=int, default=3)
    parser.add_argument("--out", required=True)
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=[],
                        help="config overrides for every run (last)")
    args = parser.parse_args(argv)
    rows = []
    for cfg_file in args.configs:
        runs = os.path.join(args.out, "runs")
        _, summary = run_config(cfg_file, args.repeat, runs, args.opts)
        drop_checkpoints(runs)
        rows.append(parity_row(cfg_file, summary))
        write(rows, args.out)
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
