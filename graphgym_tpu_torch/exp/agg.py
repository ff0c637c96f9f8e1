"""Results aggregation (the port's copy of graphgym_tpu/exp/agg.py;
reference graphgym/utils/agg_runs.py:70-205 and run/agg_batch.py).

``agg_runs``: across seed dirs results/<cfg>/<seed>/, average per-epoch
stats (mean +/- std) per split, pick the best epoch by the val metric,
write agg/{split}/stats.json and agg/{split}/best.json.

``agg_batch``: across grid-search run dirs named base-alias=val-..., emit
{split}.csv / {split}_best.csv / {split}_bestepoch.csv.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np


def _read_stats(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _agg_dict_list(dict_list: List[Dict], round_digits: int = 4) -> Dict:
    """Mean +/- std over a list of stat dicts (reference
    agg_dict_list, agg_runs.py:42-50)."""
    out: Dict = {}
    keys = dict_list[0].keys()
    for k in keys:
        vals = [d[k] for d in dict_list if k in d]
        if not vals or not isinstance(vals[0], (int, float)):
            out[k] = vals[0]
            continue
        if k == "epoch":
            out[k] = vals[0]
            continue
        arr = np.asarray(vals, np.float64)
        out[k] = round(float(arr.mean()), round_digits)
        if len(arr) > 1:
            out[f"{k}_std"] = round(float(arr.std()), round_digits)
    return out


def agg_runs(parent_dir: str, metric: str = "accuracy",
             metric_agg: str = "argmax",
             tensorboard: bool = False) -> Optional[Dict]:
    """Aggregate over seed subdirectories of parent_dir.  With
    ``tensorboard`` each aggregated epoch is also written through
    tensorboardX into agg/{split}/, where that package imports; without
    it nothing more is written."""
    seed_dirs = [d for d in sorted(os.listdir(parent_dir))
                 if d.isdigit() and
                 os.path.isdir(os.path.join(parent_dir, d))] \
        if os.path.isdir(parent_dir) else []
    if not seed_dirs:
        logging.warning("agg_runs: no seed dirs under %s", parent_dir)
        return None

    splits = ["train", "val", "test"]
    # per split: list over seeds of list over epochs of stats
    per_split: Dict[str, List[List[Dict]]] = {s: [] for s in splits}
    best_per_seed: Dict[str, List[Dict]] = {s: [] for s in splits}
    for sd in seed_dirs:
        stats_by_split = {
            s: _read_stats(os.path.join(parent_dir, sd, s, "stats.json"))
            for s in splits}
        if not stats_by_split["val"]:
            continue
        vals = [d.get(metric, 0.0) for d in stats_by_split["val"]]
        best_i = int(np.argmax(vals)) if metric_agg == "argmax" \
            else int(np.argmin(vals))
        best_epoch = stats_by_split["val"][best_i]["epoch"]
        for s in splits:
            if stats_by_split[s]:
                per_split[s].append(stats_by_split[s])
                match = [d for d in stats_by_split[s]
                         if d["epoch"] == best_epoch]
                if match:
                    best_per_seed[s].append(match[0])

    agg_dir = os.path.join(parent_dir, "agg")
    results = {}
    for s in splits:
        if not per_split[s]:
            continue
        os.makedirs(os.path.join(agg_dir, s), exist_ok=True)
        # align epochs across seeds
        num_epochs = min(len(run) for run in per_split[s])
        tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
                tb = SummaryWriter(os.path.join(agg_dir, s))
            except Exception:   # missing or broken: the copy is optional
                tb = None
        with open(os.path.join(agg_dir, s, "stats.json"), "w") as f:
            for ei in range(num_epochs):
                agg = _agg_dict_list([run[ei] for run in per_split[s]])
                f.write(json.dumps(agg) + "\n")
                if tb is not None:
                    for k, v in agg.items():
                        if isinstance(v, (int, float)) and k != "epoch":
                            tb.add_scalar(k, v, agg.get("epoch", ei))
        if tb is not None:
            tb.close()
        if best_per_seed[s]:
            best = _agg_dict_list(best_per_seed[s])
            with open(os.path.join(agg_dir, s, "best.json"), "w") as f:
                f.write(json.dumps(best) + "\n")
            results[s] = best
    logging.info("Results aggregated across %d runs: %s",
                 len(seed_dirs), results.get("val"))
    return results


def tag_runs(parent_dir: str, tags: Dict) -> None:
    """Write ``tags`` into every line of the aggregate under parent_dir
    (agg/<split>/stats.json and best.json): main names a
    mixed-precision run's tpu.dtype there, so its aggregate cannot be
    read as an f32 run's."""
    agg_dir = os.path.join(parent_dir, "agg")
    for split in sorted(os.listdir(agg_dir)) if os.path.isdir(agg_dir) \
            else ():
        for name in ("stats.json", "best.json"):
            path = os.path.join(agg_dir, split, name)
            if os.path.exists(path):
                lines = [{**d, **tags} for d in _read_stats(path)]
                with open(path, "w") as f:
                    f.writelines(json.dumps(d) + "\n" for d in lines)


def name_to_dict(run_name: str) -> Dict[str, str]:
    """Parse 'base-alias=val-alias2=val2' grid run names (reference
    name_to_dict, agg_runs.py:52-62)."""
    out = {}
    for part in run_name.split("-"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def agg_batch(batch_dir: str, metric: str = "accuracy") -> None:
    """Aggregate a grid-search batch directory into CSVs (reference
    agg_batch, agg_runs.py:132-205): {split}_best.csv (at the best val
    epoch), {split}.csv (final epoch), {split}_bestepoch.csv (each
    run's own best epoch on that split)."""
    run_dirs = [d for d in sorted(os.listdir(batch_dir))
                if os.path.isdir(os.path.join(batch_dir, d))
                and d != "agg"]
    rows_best: Dict[str, List[Dict]] = {}
    rows_final: Dict[str, List[Dict]] = {}
    rows_bestepoch: Dict[str, List[Dict]] = {}
    for rd in run_dirs:
        agg = agg_runs(os.path.join(batch_dir, rd), metric=metric)
        if not agg:
            continue
        params = name_to_dict(rd)
        for split, best in agg.items():
            rows_best.setdefault(split, []).append(
                {**params, **best, "run": rd})
            stats = _read_stats(os.path.join(
                batch_dir, rd, "agg", split, "stats.json"))
            if stats:
                rows_final.setdefault(split, []).append(
                    {**params, **stats[-1], "run": rd})
                vals = [d.get(metric, 0.0) for d in stats]
                rows_bestepoch.setdefault(split, []).append(
                    {**params, **stats[int(np.argmax(vals))],
                     "run": rd})
    agg_dir = os.path.join(batch_dir, "agg")
    os.makedirs(agg_dir, exist_ok=True)

    def write_csv(fname, rows):
        if not rows:
            return
        keys = sorted({k for r in rows for k in r})
        with open(os.path.join(agg_dir, fname), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for r in rows:
                w.writerow(r)

    for split in rows_best:
        write_csv(f"{split}_best.csv", rows_best.get(split, []))
        write_csv(f"{split}.csv", rows_final.get(split, []))
        write_csv(f"{split}_bestepoch.csv",
                  rows_bestepoch.get(split, []))
    logging.info("agg_batch: wrote CSVs for %d runs to %s",
                 len(run_dirs), agg_dir)


def main(argv=None):
    """CLI (reference run/agg_batch.py): aggregate a batch directory,
    ``python -m graphgym_tpu_torch.exp.agg <dir> [--metric accuracy]``."""
    import argparse

    p = argparse.ArgumentParser(description="aggregate batch results")
    p.add_argument("dir", help="batch results directory")
    p.add_argument("--metric", default="accuracy")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    agg_batch(args.dir, metric=args.metric)


if __name__ == "__main__":
    main()
