"""The port's benchmark and the COO entries it brings, against the JAX
package's.

At N = 2,048 nodes and E = 32,768 edges, so that make_graph's row 0
still gets ~720 slots.  make_graph equals the root bench.py's bit for
bit; pack_bidir equals the JAX one array for array; spmm_bidir and its
gradient match the JAX spmm_bidir run through the Pallas kernel in
interpret mode on bf16-exact inputs (only the f32 summation order
differs: rtol 1e-4 / atol 1e-5, as in test_torch_spmm.py); the COO spmm
matches graphgym_tpu/ops/sparse.py's at rtol 1e-5 / atol 1e-6 (sums in
another order).  The bench_* functions run on the CPU at tiny sizes and
return the documented structure; ``main`` prints one JSON line.  The
kernel runs under the ``cuda`` marker on a card.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.ops import sparse as JSP
from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu_torch import bench as B
from graphgym_tpu_torch.graphs.container import build_graph_batch
from graphgym_tpu_torch.ops import sparse as SP
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from test_torch_spmm import (FIELDS, jax_numpy_packer,  # noqa: F401
                             two_planes)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E = 2048, 32768


def root_bench():
    """The root bench.py as a module (its JAX imports are inside its
    functions)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_graph_matches_root_bench(seed):
    want = root_bench().make_graph(N, E, 16, seed)
    got = B.make_graph(N, E, 16, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    lengths = np.bincount(got[1], minlength=N)
    assert lengths[0] == lengths.max() > 600     # the hub row


def test_pack_bidir_matches_jax(jax_numpy_packer):
    s, r, w, _ = B.make_graph(N, E, 8)
    got = K.pack_bidir(s, r, w, N)
    want = JK.pack_bidir(s, r, w, N)
    for got_p, want_p in ((got.fwd, want.fwd), (got.bwd, want.bwd)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got_p, f),
                                          getattr(want_p, f), f)
    np.testing.assert_array_equal(got.senders, want.senders)
    np.testing.assert_array_equal(got.receivers, want.receivers)
    # no bucketing: the packs hold just the chunks their tiles need
    plain = K.pack_csr(s, r, w, N)
    assert got.fwd.senders.shape == plain.senders.shape


@pytest.mark.parametrize("d", [1, 8])
def test_spmm_bidir_matches_jax(jax_numpy_packer, d):
    """Forward and gradient in x; x has num_nodes rows (no padding row):
    the JAX spmm_packed appends one, the port's plain version reads the
    padding sender as a zero row."""
    s, r, w, _ = B.make_graph(N, E, d)
    w = bf16_exact(w)
    rng = np.random.default_rng(d)
    x = two_planes(rng.normal(size=(N, d)))
    g = two_planes(rng.normal(size=(N, d)))
    jpack = JK.pack_bidir(s, r, w, N)
    want, vjp = jax.vjp(lambda xx: JK.spmm_bidir(jpack, xx, N),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    pack = K.pack_bidir(s, r, w, N).to("cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    out = K.spmm_bidir(pack, xt, N)
    out.backward(torch.from_numpy(g))
    assert out.shape == (N, d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="rows"):
        K.spmm_bidir(pack, torch.zeros(N + 1, d), N)


def coo_inputs(seed=3, d=4):
    s, r, w, _ = B.make_graph(N, E, d, seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d)).astype(np.float32)
    mask = rng.random(E) > 0.3
    return s.astype(np.int64), r.astype(np.int64), w, x, mask


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_coo_spmm_matches_jax(reduce):
    s, r, w, x, mask = coo_inputs()
    want = JSP.spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                    jnp.asarray(x), N, reduce=reduce,
                    edge_mask=jnp.asarray(mask))
    got = SP.spmm(torch.from_numpy(s), torch.from_numpy(r),
                  torch.from_numpy(w), torch.from_numpy(x), N,
                  reduce=reduce, edge_mask=torch.from_numpy(mask))
    assert got.shape == (N, x.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("padding_row", [False, True])
def test_coo_spmm_pallas_route(padding_row):
    """implementation='pallas' takes a sum through spmm_pallas (a host
    pack, then K1, whose plain version runs on the CPU); x may carry the
    padding row, which only weight-0 slots read."""
    s, r, w, x, _ = coo_inputs(4)
    want = JSP.spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                    jnp.asarray(x), N)
    xt = torch.from_numpy(x)
    if padding_row:
        xt = torch.cat([xt, torch.full((1, x.shape[1]), 7.0)])
    before = K.packed_spmm_cuda.launches
    got = SP.spmm(torch.from_numpy(s), torch.from_numpy(r),
                  torch.from_numpy(w), xt, N, implementation="pallas")
    assert K.packed_spmm_cuda.launches == before
    assert got.shape == (N, x.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        K.spmm_pallas(s, r, w, torch.zeros(N + 2, 4), N)


def test_count_real_edges_matches_jax():
    s, r, _, _, _ = coo_inputs(5)
    feat = np.zeros((N, 1), np.float32)
    jb = jax_container.build_graph_batch(s, r, feat, pad_edges_to=E + 100)
    b = build_graph_batch(s, r, feat, pad_edges_to=E + 100)
    assert b.count_real_edges() == int(jb.count_real_edges()) == E
    assert b.to(torch.device("cpu")).count_real_edges() == E


def spmm_scale(pack, x):
    """2 A^T A |x|: what the gradient of sum((A x)^2) sums, in absolute
    values (the weights are >= 0)."""
    fwd = K.spmm_packed_plain(pack.fwd, x.abs())
    return 2 * K.spmm_packed_plain(pack.bwd, fwd)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_spmm_step_matches_root_bench(impl):
    """One fwd_bwd step of the port's benchmark against the root
    bench.py's XLA step (exact f32 products): within 1e-5 of each row's
    sum of |terms| (two f32 sums of up to ~720 terms)."""
    want_step, x = root_bench()._spmm_step(N, E, 8, "xla", "float32",
                                           "fwd_bwd")
    want = np.asarray(want_step(x))
    step, x0 = B.spmm_step(N, E, 8, impl, "float32", "fwd_bwd", "cpu")
    np.testing.assert_array_equal(x0.numpy(), np.asarray(x))
    got = step(x0)
    scale = spmm_scale(B.bidir_graph(N, E, 8)[4].to("cpu"), x0)
    assert (np.abs(got.numpy() - want) <= 1e-5 * scale.numpy()
            + 1e-6).all()
    fwd_step, _ = B.spmm_step(N, E, 8, impl, "float32", "fwd", "cpu")
    s, r, w, _ = B.make_graph(N, E, 8)
    np.testing.assert_allclose(
        fwd_step(x0).numpy(),
        np.asarray(JSP.spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                            jnp.asarray(x), N)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl,dtype,mode", [
    ("pallas", "float32", "fwd_bwd"), ("pallas", "float32", "fwd"),
    ("pallas", "bfloat16", "fwd_bwd"), ("xla", "float32", "fwd_bwd")])
def test_bench_spmm_runs_on_cpu(impl, dtype, mode):
    before = K.packed_spmm_cuda.launches
    rates = B.bench_spmm(N, E, 8, iters=2, impl=impl, dtype=dtype,
                         mode=mode, repeats=3, device="cpu")
    assert K.packed_spmm_cuda.launches == before
    assert len(rates) == 3 and all(r > 0 for r in rates)


def test_bench_attention_runs_on_cpu():
    rate = B.bench_attention(N, E, heads=2, dv=4, iters=2, device="cpu")
    assert isinstance(rate, float) and rate > 0
    step, (h, s_dst, s_src) = B.attention_step(N, E, 2, 4, "cpu")
    assert h.shape == (N + 1, 2, 4) and s_dst.shape == (N + 1, 2)
    grads = step(h, s_dst, s_src)
    assert [g.shape for g in grads] == [h.shape, s_dst.shape, s_src.shape]
    assert all(torch.isfinite(g).all() for g in grads)


def test_bench_train_epoch_runs_on_cpu():
    dt, eps = B.bench_train_epoch("Tfg-idgcn", epochs=1,
                                  device=torch.device("cpu"), dim_inner=8)
    assert dt > 0 and eps > 0
    with pytest.raises(NotImplementedError, match="A0"):
        B.bench_train_epoch("Tfg-idgcn", impl="xla", device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        B.bench_train_epoch("Tfg-idgcn", dtype="bfloat16", device="cpu",
                            dim_inner=8)


def test_main_prints_one_json_line(capsys):
    line = B.main(["--nodes", str(N), "--edges", str(E), "--dim", "8",
                   "--iters", "2", "--repeats", "3", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert "vs_baseline" not in line
    assert line["metric"] == "spmm_fwd_bwd_edges_per_s_per_chip"
    assert line["value"] == line["median"] > 0 and line["n"] == 3
    for k in ("iqr", "fwd_only_median", "fwd_only_iqr",
              "xla_fwd_bwd_median", "xla_fwd_bwd_iqr"):
        assert line[k] >= 0
    assert line["device"] == "cpu"


def test_run_suite_writes_details(tmp_path):
    out = tmp_path / "details.json"
    details = B.run_suite(str(out), "cpu", (N, E, 8), iters=1, epochs=1,
                          dim_inner=8)
    assert json.loads(out.read_text()) == details
    for name in ("idgcn", "idgat", "idgin", "idsage"):
        assert details[f"{name}_ws_epoch_s_pallas"] > 0
    for k in ("spmm_fwd_bwd_xla_edges_per_s",
              "spmm_fwd_bwd_pallas_edges_per_s",
              "spmm_fwd_bwd_pallas_bf16_edges_per_s",
              "attention_fwd_bwd_edges_per_s"):
        assert details[k] > 0
    for k in ("idgcn_ws_epoch_s_xla", "idgcn_ws_epoch_s_pallas_bf16",
              "tu_enzymes_epoch_s_pallas"):
        assert details[k] is None and details["null_reasons"][k]
    assert B.DEFAULT_OUT.startswith(os.path.join(ROOT, "chiprun_out"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_spmm_bidir_matches_cpu(cuda_device, dtype):
    """K1 through spmm_bidir on make_graph's packs (a hub row of ~720
    slots, x without the padding row): forward and gradient against the
    plain version on the CPU, within 1e-5 (bf16: 1e-2) of each row's sum
    of |terms|; bitwise-repeatable; 2 launches a step."""
    s, r, w, x = B.make_graph(N, E, 128)
    host = K.pack_bidir(s, r, w, N)
    pack = host.to(cuda_device)
    xc = torch.from_numpy(x).to(cuda_device).to(dtype)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    before = K.packed_spmm_cuda.launches
    xg = xc.clone().requires_grad_(True)
    out = K.spmm_bidir(pack, xg, N)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert K.packed_spmm_cuda.launches == before + 2
    cpu = host.to("cpu")
    xh = xc.cpu().float()
    want = K.spmm_packed_plain(cpu.fwd, xh)
    scale = K.spmm_packed_plain(cpu.fwd, xh.abs())
    assert ((out.float().cpu() - want).abs() <= rel * scale + 1e-6).all()
    g = torch.ones(N, 128)
    want_dx = K.spmm_packed_plain(cpu.bwd, g)
    assert ((xg.grad.float().cpu() - want_dx).abs()
            <= rel * want_dx + 1e-6).all()
    assert torch.equal(K.spmm_bidir(pack, xc, N), K.spmm_bidir(pack, xc, N))
