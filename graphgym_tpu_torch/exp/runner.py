"""Parallel experiment runner (the port's copy of
graphgym_tpu/exp/runner.py; reference run/parallel.sh:1-21 +
run_batch.sh): fan out independent config jobs with bounded
concurrency; finished configs are renamed *_done so re-running the
batch retries only failures (crude elastic recovery,
reference run/main.py:62-63, run_batch.sh:17-21).

Each job is ``python -m graphgym_tpu_torch.main``, which runs on the
CUDA card unless its config or the overrides say ``device cpu``; jobs
run one at a time by default (one process holds the card), CPU-only
sweeps can fan out wider.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from typing import List


def run_batch(config_dir: str, *, repeat: int = 1, max_jobs: int = 1,
              rounds: int = 3, mark_done: bool = True,
              overrides: List[str] = (),
              python: str = sys.executable) -> int:
    """Run every *.yaml in config_dir; returns number of failures after
    all retry rounds.  `overrides` are dotted cfg overrides appended to
    every job (e.g. smoke sweeps: optim.max_epoch 3)."""
    for _ in range(rounds):
        configs = sorted(glob.glob(os.path.join(config_dir, "*.yaml")))
        configs = [c for c in configs if not c.endswith("_done")]
        if not configs:
            break
        procs: List[subprocess.Popen] = []
        for cfg_path in configs:
            while len(procs) >= max_jobs:
                procs = [p for p in procs if p.poll() is None]
                time.sleep(1)
            cmd = [python, "-m", "graphgym_tpu_torch.main", "--cfg",
                   cfg_path, "--repeat", str(repeat)]
            if mark_done:
                cmd.append("--mark_done")
            cmd.extend(overrides)
            procs.append(subprocess.Popen(cmd))
        for p in procs:
            p.wait()
    remaining = [c for c in glob.glob(os.path.join(config_dir, "*.yaml"))
                 if not c.endswith("_done")]
    return len(remaining)


def main(argv=None):
    p = argparse.ArgumentParser(description="batch experiment runner")
    p.add_argument("config_dir")
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--max_jobs", type=int, default=1)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--overrides", nargs=argparse.REMAINDER, default=[],
                   help="dotted cfg overrides appended to every job")
    args = p.parse_args(argv)
    failures = run_batch(args.config_dir, repeat=args.repeat,
                         max_jobs=args.max_jobs, rounds=args.rounds,
                         overrides=args.overrides)
    if failures:
        print(f"{failures} configs failed after {args.rounds} rounds")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
