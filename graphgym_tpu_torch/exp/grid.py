"""Grid-search config generation (the port's copy of
graphgym_tpu/exp/grid.py; reference run/configs_gen.py:144-267).

Grid text DSL: each line is ``cfg.key alias [value1,value2,...]``;
blank-line-separated chunks are unioned (each chunk is its own grid).
``gen_grid`` emits the full cartesian product as one YAML per point,
named ``<base>-<alias>=<val>-...``; ``gen_grid_sample`` random-samples
around one perturbed dimension at a time.  The budget hooks
(``config_budget``) match each point on the port's own config and
parameter count (``exp/budget``); the draws, names and YAML are the JAX
package's, byte for byte.
"""

from __future__ import annotations

import copy
import itertools
import os
import random
from typing import Any, Dict, List, Tuple

import yaml


def load_search_file(path: str) -> List[List[Tuple[str, str, List[Any]]]]:
    """Parse the grid DSL (reference load_search_file,
    configs_gen.py:110-129): returns chunks of (key, alias, values)."""
    chunks: List[List[Tuple[str, str, List[Any]]]] = [[]]
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                if chunks[-1]:
                    chunks.append([])
                continue
            if line.startswith("#"):
                continue
            parts = line.split(maxsplit=2)
            assert len(parts) == 3, f"Bad grid line: {raw!r}"
            key, alias, vals = parts
            values = yaml.safe_load(vals)
            if not isinstance(values, list):
                values = [values]
            chunks[-1].append((key, alias, values))
    return [c for c in chunks if c]


def grid2list(grid: List[Tuple[str, str, List[Any]]]
              ) -> List[List[Tuple[str, str, Any]]]:
    """Cartesian product (reference grid2list, configs_gen.py:71-79)."""
    keys = [(k, a) for k, a, _ in grid]
    prods = itertools.product(*[v for _, _, v in grid])
    return [[(k, a, val) for (k, a), val in zip(keys, combo)]
            for combo in prods]


def _apply_point(cfg_dict: Dict, point) -> Dict:
    out = copy.deepcopy(cfg_dict)
    for key, _, val in point:
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _point_name(base_name: str, point) -> str:
    suffix = "-".join(f"{alias}={_fmt(val)}" for _, alias, val in point)
    return f"{base_name}-{suffix}" if suffix else base_name


def _fmt(val: Any) -> str:
    if isinstance(val, list):
        return "[" + ",".join(map(str, val)) + "]"
    return str(val)


def gen_grid(base_cfg_path: str, grid_path: str, out_dir: str,
             *, config_budget: str | None = None) -> List[str]:
    """Write one YAML per grid point (reference gen_grid,
    configs_gen.py:144-179).  With config_budget set to a baseline
    YAML, dim_inner is adjusted per point to match its parameter count
    (reference --config_budget flag)."""
    with open(base_cfg_path) as f:
        base = yaml.safe_load(f) or {}
    base_name = os.path.splitext(os.path.basename(base_cfg_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for chunk in load_search_file(grid_path):
        for point in grid2list(chunk):
            cfg_dict = _apply_point(base, point)
            name = _point_name(base_name, point)
            if config_budget:
                from graphgym_tpu_torch.config import get_cfg
                from graphgym_tpu_torch.exp.budget import (
                    dict_match_baseline)
                cfg = get_cfg()
                cfg.merge_from_dict(cfg_dict)
                baseline = get_cfg()
                with open(config_budget) as f:
                    baseline.merge_from_dict(yaml.safe_load(f) or {})
                dict_match_baseline(cfg, baseline)
                cfg_dict = _nested_update(cfg_dict,
                                          {"gnn": {"dim_inner":
                                                   cfg.gnn.dim_inner}})
            path = os.path.join(out_dir, name + ".yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg_dict, f, sort_keys=False)
            written.append(path)
    return written


def gen_grid_sample(base_cfg_path: str, grid_path: str, out_dir: str,
                    *, sample_num: int = 10, seed: int = 0
                    ) -> List[str]:
    """Random sampling around one perturbed dimension at a time
    (reference gen_grid_sample, configs_gen.py:184-257): for each grid
    dimension, fix the others to random choices and sweep that
    dimension's values."""
    rng = random.Random(seed)
    with open(base_cfg_path) as f:
        base = yaml.safe_load(f) or {}
    base_name = os.path.splitext(os.path.basename(base_cfg_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for chunk in load_search_file(grid_path):
        for dim_i, (key, alias, values) in enumerate(chunk):
            for _ in range(max(sample_num // max(len(chunk), 1), 1)):
                fixed = [(k, a, rng.choice(v))
                         for j, (k, a, v) in enumerate(chunk)
                         if j != dim_i]
                for val in values:
                    point = fixed + [(key, alias, val)]
                    point.sort(key=lambda t: t[1])
                    cfg_dict = _apply_point(base, point)
                    name = _point_name(base_name, point)
                    path = os.path.join(out_dir, name + ".yaml")
                    if path in written:
                        continue
                    with open(path, "w") as f:
                        yaml.safe_dump(cfg_dict, f, sort_keys=False)
                    written.append(path)
    return written


def _nested_update(d: Dict, u: Dict) -> Dict:
    for k, v in u.items():
        if isinstance(v, dict):
            d[k] = _nested_update(d.get(k, {}), v)
        else:
            d[k] = v
    return d


def load_alias_file(path: str) -> List[str]:
    """Whitespace-separated design-dimension aliases (reference
    load_alias_file via run/sample/dimensions.txt)."""
    with open(path) as f:
        return f.read().split()


def gen_grid_sample_aliased(base_cfg_path: str, grid_path: str,
                            out_dir: str, *, sample_num: int,
                            aliases: List[str],
                            config_budget: str | None = None,
                            results_dir: str | None = None,
                            seed: int = 0) -> List[str]:
    """The reference's design-space sampler (gen_grid_sample,
    configs_gen.py:184-257, driven by --sample_alias/--sample_num in
    run/scripts/design/*.sh):

    - sample_num is split across grid chunks proportionally to each
      chunk's cartesian size;
    - for each chunk and each alias in `aliases`, draw that many
      random points, then expand the alias dimension to ALL its values
      for every draw — controlled comparisons along one design
      dimension at a time, named '<base>-sample=<alias>-...'.
    """
    rng = random.Random(seed)
    with open(base_cfg_path) as f:
        base = yaml.safe_load(f) or {}
    if results_dir is not None:
        # reference behavior: every generated config routes its runs
        # into the batch's results dir (configs_gen.py:190-191)
        base["out_dir"] = results_dir
    base_name = os.path.splitext(os.path.basename(base_cfg_path))[0]
    os.makedirs(out_dir, exist_ok=True)
    chunks = load_search_file(grid_path)
    sizes = []
    for chunk in chunks:
        n = 1
        for _, _, values in chunk:
            n *= len(values)
        sizes.append(n)
    total = float(sum(sizes))
    counts = [round(sample_num * s / total) for s in sizes]
    counts[0] += sample_num - sum(counts)

    baseline = None
    if config_budget:
        from graphgym_tpu_torch.config import get_cfg
        baseline = get_cfg()
        with open(config_budget) as f:
            baseline.merge_from_dict(yaml.safe_load(f) or {})

    written: List[str] = []
    for chunk, count in zip(chunks, counts):
        chunk_aliases = [a for _, a, _ in chunk]
        for alias in aliases:
            if alias not in chunk_aliases:
                continue
            ai = chunk_aliases.index(alias)
            for _ in range(max(int(count), 0)):
                draw = [(k, a, rng.choice(v)) for k, a, v in chunk]
                for val in chunk[ai][2]:
                    point = list(draw)
                    point[ai] = (chunk[ai][0], alias, val)
                    cfg_dict = _apply_point(base, point)
                    name = (_point_name(f"{base_name}-sample={alias}",
                                        point))
                    if baseline is not None:
                        from graphgym_tpu_torch.config import get_cfg
                        from graphgym_tpu_torch.exp.budget import (
                            dict_match_baseline)
                        cfg = get_cfg()
                        cfg.merge_from_dict(cfg_dict)
                        dict_match_baseline(cfg, baseline)
                        cfg_dict = _nested_update(
                            cfg_dict,
                            {"gnn": {"dim_inner": cfg.gnn.dim_inner}})
                    path = os.path.join(out_dir, name + ".yaml")
                    if path not in written:
                        with open(path, "w") as f:
                            yaml.safe_dump(cfg_dict, f,
                                           sort_keys=False)
                        written.append(path)
    return written
