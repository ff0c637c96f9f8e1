"""The port's grid generator (graphgym_tpu_torch/exp/grid.py) against the
JAX package's (graphgym_tpu/exp/grid.py).

``load_search_file`` parses every grid file of the repository into the
same chunks; ``gen_grid``, ``gen_grid_sample`` and
``gen_grid_sample_aliased`` (round1 along sample/dimensions.txt, two
seeds, several alias sets, no budget) draw in the same order, so they
write the same file names with the same bytes.  The budget hooks are
held in tests/test_torch_budget_match.py.
"""

import filecmp
import glob
import math
import os

import pytest

from graphgym_tpu.exp import grid as jax_grid
from graphgym_tpu_torch.exp import grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = sorted(glob.glob(os.path.join(ROOT, "grids", "**", "*.txt"),
                         recursive=True))
DESIGN_V1 = os.path.join(ROOT, "configs", "design", "design_v1.yaml")
ROUND1 = os.path.join(ROOT, "grids", "design", "round1.txt")
DIMENSIONS = os.path.join(ROOT, "sample", "dimensions.txt")


def assert_same_files(jax_paths, paths, jdir, pdir):
    """The same names in the same order, and the same bytes."""
    assert [os.path.relpath(p, jdir) for p in jax_paths] == \
        [os.path.relpath(p, pdir) for p in paths]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for jp, p in zip(jax_paths, paths):
        assert filecmp.cmp(jp, p, shallow=False), os.path.basename(p)


@pytest.mark.parametrize("path", GRIDS,
                         ids=[os.path.relpath(p, ROOT) for p in GRIDS])
def test_load_search_file_matches_jax(path):
    """Every grid under grids/ parses into the same chunks of (key,
    alias, values); the cartesian product of a chunk of up to 5,000
    points lists them alike (the design grids' chunks hold millions)."""
    chunks = grid.load_search_file(path)
    assert chunks and chunks == jax_grid.load_search_file(path)
    for chunk in chunks:
        if math.prod(len(values) for _, _, values in chunk) <= 5000:
            assert grid.grid2list(chunk) == jax_grid.grid2list(chunk)


def test_load_alias_file_matches_jax():
    aliases = grid.load_alias_file(DIMENSIONS)
    assert aliases == jax_grid.load_alias_file(DIMENSIONS)
    assert "act" in aliases and "epoch" in aliases


@pytest.mark.parametrize("base", ["design/design_v1", "idgcn_ws"])
def test_gen_grid_matches_jax(base, tmp_path):
    """The full cartesian product of grids/example.txt (27 points) on a
    base config: one YAML per point, named and written alike."""
    cfg = os.path.join(ROOT, "configs", f"{base}.yaml")
    example = os.path.join(ROOT, "grids", "example.txt")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_grid.gen_grid(cfg, example, jdir)
    got = grid.gen_grid(cfg, example, pdir)
    assert len(got) == 27
    assert_same_files(want, got, jdir, pdir)


@pytest.mark.parametrize("seed", [0, 1])
def test_gen_grid_sample_matches_jax(seed, tmp_path):
    """Random points around one perturbed dimension at a time, from the
    same seed: the same draws, files and bytes."""
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_grid.gen_grid_sample(DESIGN_V1, ROUND1, jdir, sample_num=36,
                                    seed=seed)
    got = grid.gen_grid_sample(DESIGN_V1, ROUND1, pdir, sample_num=36,
                               seed=seed)
    assert len(got) > 36
    assert_same_files(want, got, jdir, pdir)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("aliases,sample_num", [
    ("dimensions", 6), ("dimensions", 24), (["act"], 3),
    (["agg", "l_mp", "stage"], 12), (["lr", "optim", "nosuch"], 8)])
def test_gen_grid_sample_aliased_matches_jax(aliases, sample_num, seed,
                                             tmp_path):
    """round1 sampled along sample/dimensions.txt (and along other alias
    sets, one of them naming no grid dimension) without a budget, the
    batch's results dir written into every config: the same files in
    the same order, byte for byte."""
    if aliases == "dimensions":
        aliases = grid.load_alias_file(DIMENSIONS)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    results = str(tmp_path / "results")
    want = jax_grid.gen_grid_sample_aliased(
        DESIGN_V1, ROUND1, jdir, sample_num=sample_num, aliases=aliases,
        results_dir=results, seed=seed)
    got = grid.gen_grid_sample_aliased(
        DESIGN_V1, ROUND1, pdir, sample_num=sample_num, aliases=aliases,
        results_dir=results, seed=seed)
    assert got
    assert all(os.path.basename(p).startswith("design_v1-sample=")
               for p in got)
    assert_same_files(want, got, jdir, pdir)
