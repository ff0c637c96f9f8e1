"""Seconds of a synthetic corpus's rejection loop (data/synthetic.py).

    python -m graphgym_tpu_torch.exp.corpus_time --name ws500 \\
        [--statistics native|numpy] [--attempts N]

Regenerates the corpus a config names (``loaders._REGENERABLE``: 256
graphs asked, seed 0) in this process and prints one JSON line: its
name, the generator and graph size, which statistics ran (``native``:
the BFS and triangle counts of graphgym_tpu_torch/native, as the
loader runs them; ``numpy``: their plain versions in data/structure.py,
the loop before the native ones), the seconds and the seconds an
attempt.  A whole loop (num_graphs x 200 = 51,200 attempts where the
corpus stays short) also gives the graphs kept and their digest
(``corpus_digest``, which chip_smoke.py holds its corpora to).  The
numpy loop at 500 nodes takes about an hour, so ``--attempts`` stops it
after its first N attempts, for the seconds an attempt.  Nothing is
written.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import time
import types
from typing import Optional, Sequence

import numpy as np

from graphgym_tpu_torch.data import structure as st
from graphgym_tpu_torch.data import synthetic as syn
from graphgym_tpu_torch.data.loaders import _REGEN_GRAPHS, _REGENERABLE


def corpus_digest(graphs) -> str:
    """sha256 over the graphs' edge lists (int32), in order."""
    digest = hashlib.sha256()
    for g in graphs:
        digest.update(np.ascontiguousarray(g.edge_index, np.int32).tobytes())
    return digest.hexdigest()


class _Stop(Exception):
    """The loop's attempts ran out (``--attempts``)."""


def time_corpus(name: str, statistics: str = "native",
                attempts: Optional[int] = None) -> dict:
    kind, n = _REGENERABLE[name]
    real = st.bfs_from_sources, st.triangle_counts, syn.random
    made = [0]

    def generator(seed):   # one an attempt, drawn after its p
        if made[0] == attempts:
            raise _Stop
        made[0] += 1
        return random.Random(seed)
    if statistics == "numpy":
        st.bfs_from_sources = st.bfs_from_sources_plain
        st.triangle_counts = st.triangle_counts_plain
    syn.random = types.SimpleNamespace(Random=generator)
    graphs = None
    try:
        t0 = time.perf_counter()
        graphs = syn.generate_syn_graphs(kind, _REGEN_GRAPHS, n)
    except _Stop:
        pass
    finally:
        seconds = time.perf_counter() - t0
        st.bfs_from_sources, st.triangle_counts, syn.random = real
    whole = graphs is not None and len(graphs) < _REGEN_GRAPHS
    return dict(name=name, kind=kind, nodes=n, statistics=statistics,
                attempts=made[0], graphs=None if graphs is None
                else len(graphs),
                digest=None if graphs is None else corpus_digest(graphs),
                seconds=seconds, seconds_per_attempt=seconds / made[0]
                if whole or graphs is None else None)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="time a synthetic corpus's rejection loop")
    parser.add_argument("--name", required=True, choices=sorted(_REGENERABLE))
    parser.add_argument("--statistics", default="native",
                        choices=["native", "numpy"])
    parser.add_argument("--attempts", type=int, default=None)
    args = parser.parse_args(argv)
    row = time_corpus(args.name, args.statistics, args.attempts)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
