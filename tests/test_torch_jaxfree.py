"""The torch port imports neither jax, flax, optax nor the JAX package.

Checked in a subprocess: tests/conftest.py imports jax into this one.
The probe imports every module of the package (pkgutil.walk_packages),
so a module that imports JAX fails it even when no entry point reaches
that module.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
import graphgym_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    graphgym_tpu_torch.__path__, "graphgym_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("MODULES:" + ",".join(names))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "graphgym_tpu"))
print("BAD:" + ",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BAD:")]
    assert line == ["BAD:"], out.stdout
    (mods,) = [ln[len("MODULES:"):].split(",") for ln in
               out.stdout.splitlines() if ln.startswith("MODULES:")]
    for name in ("graphgym_tpu_torch.main", "graphgym_tpu_torch.ops.segment",
                 "graphgym_tpu_torch.nn.act", "graphgym_tpu_torch.nn.norm",
                 "graphgym_tpu_torch.ops.cuda.spmm_kernel"):
        assert name in mods


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's imports (it exits before main() without a card)."""
    probe = PROBE.replace("import graphgym_tpu_torch\n",
                          "import graphgym_tpu_torch\nimport torch; "
                          "torch.cuda.is_available = lambda: True; "
                          "import chip_smoke\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BAD:")]
    assert line == ["BAD:"], out.stdout


def test_chip_smoke_without_card_fails_silently():
    """Without a CUDA device chip_smoke.py exits non-zero and prints no
    result line."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
