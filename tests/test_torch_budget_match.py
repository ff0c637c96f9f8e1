"""Budget matching in the port (graphgym_tpu_torch/exp/budget.py
``match_computation`` / ``dict_match_baseline``, and the budget hook of
exp/grid.py) against the JAX package's.

For one drawn point of each synthetic (nx) chunk of
grids/design/round1.txt, matched against configs/design/design_v1.yaml,
both packages pick the same dim_inner and reach the same parameter
count (match_upper on and off).  ``gen_grid_sample_aliased`` with
``config_budget`` (round1 along 'act' at sample_num 3: twelve points of
the four chunks that draw) writes the same files, byte for byte, as the
JAX package's.  The JAX side initialises a flax model per count, so
these are few points.
"""

import copy
import filecmp
import os
import random

import pytest
import yaml

from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.exp import budget as jax_budget
from graphgym_tpu.exp import grid as jax_grid
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.exp import budget, grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGN_V1 = os.path.join(ROOT, "configs", "design", "design_v1.yaml")
ROUND1 = os.path.join(ROOT, "grids", "design", "round1.txt")


def nx_points(seed=0):
    """One random point (a cfg dict on design_v1) of each nx chunk of
    round1."""
    with open(DESIGN_V1) as f:
        base = yaml.safe_load(f)
    rng = random.Random(seed)
    points = []
    for chunk in grid.load_search_file(ROUND1):
        if dict((k, v) for k, _, v in chunk)["dataset.format"] != ["nx"]:
            continue
        point = [(k, a, rng.choice(v)) for k, a, v in chunk]
        points.append(grid._apply_point(copy.deepcopy(base), point))
    return points


POINTS = nx_points()


@pytest.mark.parametrize("index,match_upper", [(0, True), (1, True),
                                               (2, True), (0, False)])
def test_match_computation_picks_jax_dim(index, match_upper):
    """dict_match_baseline on one point of each nx chunk (node with the
    clustering label, node with the pagerank label, graph) against
    design_v1: the same dim_inner, the same count."""
    point = POINTS[index]
    with open(DESIGN_V1) as f:
        base = yaml.safe_load(f)
    results = []
    for make, match in ((jax_get_cfg, jax_budget.dict_match_baseline),
                        (get_cfg, budget.dict_match_baseline)):
        cfg, baseline = make(), make()
        cfg.merge_from_dict(point)
        cfg.model.match_upper = match_upper
        baseline.merge_from_dict(base)
        count = match(cfg, baseline)
        results.append((cfg.gnn.dim_inner, count))
    assert results[0] == results[1]
    target = budget.params_count(baseline)
    assert abs(results[1][1] - target) <= 0.1 * target


def test_budgeted_generation_matches_jax(tmp_path):
    """gen_grid_sample_aliased with config_budget: the same twelve
    files, their dim_inner matched, byte for byte."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(sample_num=3, aliases=["act"], config_budget=DESIGN_V1,
              results_dir=str(tmp_path / "results"), seed=0)
    want = jax_grid.gen_grid_sample_aliased(DESIGN_V1, ROUND1, jdir, **kw)
    got = grid.gen_grid_sample_aliased(DESIGN_V1, ROUND1, pdir, **kw)
    assert len(got) == 12
    assert [os.path.basename(p) for p in want] == \
        [os.path.basename(p) for p in got]
    dims = set()
    for jp, p in zip(want, got):
        assert filecmp.cmp(jp, p, shallow=False), os.path.basename(p)
        with open(p) as f:
            dims.add(yaml.safe_load(f)["gnn"]["dim_inner"])
    assert len(dims) > 1 and 256 not in dims
