"""``tpu.profile``: a torch.profiler trace of the first
``tpu.profile_epochs`` epochs under ``{out_dir}/profile``, the
counterpart of the JAX package's jax.profiler trace
(graphgym_tpu/train/loop.py:399-402,425-426).

Through the entry point on the CPU: the trace is written (Chrome trace
format, holding the steps' operators), and every loss, the val curve
and the parameters equal those of the run with the key off, bit for
bit; a trace asked for more epochs than the run has ends with the run.
On the card the same holds with the steps captured.
"""

import json
import os

import numpy as np
import pytest
import torch

from graphgym_tpu_torch import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "idgcn_ws.yaml")
SMALL = ["gnn.dim_inner", "8", "gnn.layers_mp", "2", "optim.max_epoch",
         "3", "train.eval_period", "1", "train.batch_size", "8"]


def run(out_dir, device, *extra):
    """One seed of idgcn_ws through main; its train losses, val curve,
    final checkpoint's parameters and the trace path it would have."""
    (result,) = port_main.main(
        ["--cfg", CFG, "device", device, "train.ckpt_clean", "False",
         "out_dir", str(out_dir)] + SMALL + list(extra))
    run_dir = os.path.join(str(out_dir), "idgcn_ws", "1")
    with open(os.path.join(run_dir, "train", "stats.json")) as f:
        losses = [json.loads(line)["loss"] for line in f if line.strip()]
    state = torch.load(os.path.join(run_dir, "ckpt", "2.ckpt"),
                       map_location="cpu", weights_only=False)
    return (losses, result["val_curve"], state,
            os.path.join(run_dir, "profile", "trace.json"))


def assert_same_run(a, b):
    assert a[0] == b[0]
    assert a[1] == b[1]
    pa, pb = a[2]["model"], b[2]["model"]
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def trace_ops(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


@pytest.mark.parametrize("epochs", [1, 5])
def test_profile_writes_a_trace_and_changes_no_loss(tmp_path, epochs):
    off = run(tmp_path / "off", "cpu")
    on = run(tmp_path / "on", "cpu", "tpu.profile", "True",
             "tpu.profile_epochs", str(epochs))
    assert not os.path.exists(off[3])
    assert os.path.getsize(on[3]) > 0
    assert any(name.startswith("aten::") for name in trace_ops(on[3]))
    assert len(on[0]) == 3 and all(map(np.isfinite, on[0]))
    assert_same_run(on, off)


@pytest.mark.cuda
def test_cuda_profile_keeps_the_captured_steps(tmp_path):
    """On the card the traced epochs capture and replay their steps as
    untraced ones do: the same losses, val curve and parameters, bit
    for bit, and the trace holds device kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    off = run(tmp_path / "off", "cuda")
    on = run(tmp_path / "on", "cuda", "tpu.profile", "True",
             "tpu.profile_epochs", "2")
    with open(on[3]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert_same_run(on, off)
