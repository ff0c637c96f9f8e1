"""The port's config system against the JAX package's: every YAML under
configs/ merges to the same tree in both (each package's contrib
registers the 'example' group), and the port's own options behave."""

import glob
import os

import pytest

from graphgym_tpu.config import load_cfg as jax_load_cfg
from graphgym_tpu_torch.config import get_cfg, load_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", CONFIGS)
def test_config_merges_like_jax(path):
    want = jax_load_cfg(os.path.join(ROOT, path)).to_dict()
    got = load_cfg(os.path.join(ROOT, path)).to_dict()
    assert got == want


def test_device_option():
    cfg = get_cfg()
    assert cfg.device == "auto"
    for ok in ("cuda", "cpu"):
        cfg.merge_from_list(["device", ok])
    cfg.device = "tpu"
    from graphgym_tpu_torch.config import assert_cfg
    with pytest.raises(ValueError, match="device"):
        assert_cfg(cfg)


def test_dotted_overrides_coerce():
    cfg = load_cfg(os.path.join(ROOT, "configs", "idgcn_ws.yaml"),
                   ["optim.max_epoch", "5", "gnn.dim_inner", "64",
                    "optim.base_lr", "1"])
    assert cfg.optim.max_epoch == 5 and cfg.gnn.dim_inner == 64
    assert cfg.optim.base_lr == 1.0 and isinstance(cfg.optim.base_lr, float)
    with pytest.raises(TypeError, match="gnn.dim_inner"):
        cfg.merge_from_list(["gnn.dim_inner", "wide"])
