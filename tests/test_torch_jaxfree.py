"""The torch port imports neither jax, flax, optax, networkx nor the JAX
package.

Checked in a subprocess: tests/conftest.py imports jax into this one.
The probe imports every module of the package (pkgutil.walk_packages),
so a module that imports JAX fails it even when no entry point reaches
that module.
"""

import json
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
                                    "networkx", "graphgym_tpu"))
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
    for name in ("graphgym_tpu_torch.main", "graphgym_tpu_torch.bench",
                 "graphgym_tpu_torch.ops.segment",
                 "graphgym_tpu_torch.nn.act", "graphgym_tpu_torch.nn.norm",
                 "graphgym_tpu_torch.ops.cuda.spmm_kernel",
                 "graphgym_tpu_torch.train.graphed",
                 "graphgym_tpu_torch.data.synthetic",
                 "graphgym_tpu_torch.ops.identity",
                 "graphgym_tpu_torch.exp.agg",
                 "graphgym_tpu_torch.nn.heads",
                 "graphgym_tpu_torch.contrib",
                 "graphgym_tpu_torch.contrib.example",
                 "graphgym_tpu_torch.nn.att_layers",
                 "graphgym_tpu_torch.native",
                 "graphgym_tpu_torch.exp.parity"):
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
    result line, only its reason as one JSON line on stdout."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    (line,) = out.stdout.strip().splitlines()
    reason = json.loads(line)
    assert reason["phase"] == "device" and "CUDA" in reason["error"]


def test_chip_smoke_alone_names_its_failure(tmp_path):
    """chip_smoke.py copied into a directory that holds nothing else of
    the repository fails (it cannot import the port), naming the reason
    on stdout (a card made to look present, so the import is reached)."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    probe = ("import sys, runpy, torch; "
             "torch.cuda.is_available = lambda: True; "
             "sys.path[0] = sys.argv[1]; "
             "runpy.run_path('chip_smoke.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1
    assert '"ok"' not in out.stdout
    reason = json.loads(out.stdout.strip().splitlines()[-1])
    assert reason["phase"] == "import"
    assert "graphgym_tpu_torch" in reason["error"]


def test_packs_load_the_ports_own_native_build():
    """The loader's pack builder loads the library g++ built from the
    port's own graph_native.cpp (csrc/build/), never the JAX package's
    build of graphgym_tpu/native."""
    probe = (
        "import numpy as np\n"
        "from graphgym_tpu_torch.graphs import packing\n"
        "packing.build_packs(np.array([0, 1]), np.array([1, 0]),\n"
        "                    np.ones(2, np.float32), np.ones(3, bool), 3,\n"
        "                    kinds=('gcn', 'att'))\n"
        "print('MAPS:' + ','.join(sorted({ln.split()[-1] for ln in\n"
        "      open('/proc/self/maps') if 'graph_native' in ln})))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    (line,) = [ln for ln in out.stdout.splitlines()
               if ln.startswith("MAPS:")]
    (lib,) = line[len("MAPS:"):].split(",")
    assert lib.startswith(os.path.join(ROOT, "graphgym_tpu_torch", "csrc",
                                       "build", "libgraph_native_"))
