"""The port's packed SpMM against the JAX package's.

Packs: the port's pack_csr / build_packs equal the JAX numpy packer's
arrays exactly.  Values and gradients: SpmmPackFn (plain version on the
CPU) against spmm_pack_vjp run through the Pallas kernel in interpret
mode, rtol 1e-4 / atol 1e-5.  The TPU kernel keeps each operand as two
bf16 planes (about 16 significant bits) and drops the lo*lo product
(spmm_kernel.py:343-347); the inputs here are ones it represents
exactly (bf16 weights, x and g equal to their own hi + lo planes), so
what is left to differ is the f32 summation order.  The
CUDA kernel's reading rule (each row's row_range, in slot order) is
emulated in numpy here; the kernel itself runs under the ``cuda``
marker on a card.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.graphs import packing as jax_packing
from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu_torch.graphs import packing
from graphgym_tpu_torch.graphs.container import bucket_size
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K

FIELDS = ("senders", "weights", "local_rows", "tiles")


@pytest.fixture
def jax_numpy_packer(monkeypatch):
    """The JAX side packs with its numpy fallback: the native packer
    orders the slots of a row differently (native/__init__.py:190)."""
    def no_native(*a, **k):
        raise RuntimeError("native packer disabled in this test")
    monkeypatch.setattr(jax_native, "pack_csr_arrays", no_native)


def random_graph(seed, n_real=300, pad_nodes=384, e=3000, hot=1500):
    """Random COO over n_real nodes padded to pad_nodes: `hot` edges
    into rows 0..127 (a tile of several chunks), weight-0 padded edges
    at the padding node pad_nodes - 1."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_real, e)
    r = np.concatenate([rng.integers(0, 128, hot),
                        rng.integers(0, n_real, e - hot)])
    w = rng.random(e).astype(np.float32) + 0.1
    pad = np.full(200, pad_nodes - 1)
    return (np.concatenate([s, pad]), np.concatenate([r, pad]),
            np.concatenate([w, np.zeros(200, np.float32)]), pad_nodes)


@pytest.mark.parametrize("seed,pad_to", [(0, None), (1, 40), (2, 64)])
def test_pack_csr_matches_jax(jax_numpy_packer, seed, pad_to):
    s, r, w, n = random_graph(seed)
    want = JK.pack_csr(s, r, w, n, pad_chunks_to=pad_to)
    got = K.pack_csr(s, r, w, n, pad_chunks_to=pad_to)
    assert got.senders.shape[0] >= (pad_to or 0)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_build_packs_matches_jax(jax_numpy_packer):
    s, r, w, n = random_graph(3)
    mask = np.arange(n) < 300
    want = jax_packing.build_packs(s, r, w, mask, n, kinds=("gcn",))
    got = packing.build_packs(s, r, w, mask, n, kinds=("gcn",))
    for want_p, got_p in zip(want["gcn"], got["gcn"]):
        assert got_p.senders.shape[0] == bucket_size(got_p.senders.shape[0])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got_p, f),
                                          getattr(want_p, f), f)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_range_holds_every_nonzero_slot(seed):
    """The kernel reads only row_range: each row's range holds slots of
    that row alone, and every slot outside the ranges has weight 0."""
    s, r, w, n = random_graph(seed)
    pack = K.pack_csr(s, r, w, n, pad_chunks_to=64)
    rows = (pack.tiles[:, None] * K.ROWS_PER_TILE
            + pack.local_rows).reshape(-1)
    inside = np.zeros(pack.senders.size, bool)
    for row, (lo, hi) in enumerate(pack.row_range):
        assert lo <= hi
        assert (rows[lo:hi] == row).all()
        assert not inside[lo:hi].any()
        inside[lo:hi] = True
    # here every edge but the padding node's has weight > 0, and those
    # zero-weight edges are the whole of their row: the kernel reads
    # exactly the nonzero slots
    np.testing.assert_array_equal(inside, pack.weights.reshape(-1) != 0)
    lo, hi = pack.row_range[n - 1]
    assert lo == hi


def hub_graph(seed, hub=2500):
    """random_graph with `hub` more edges into row 0: a row far longer
    than the narrow walk gives one thread (row_walk.cuh: kLongRow)."""
    s, r, w, n = random_graph(seed)
    rng = np.random.default_rng(seed + 100)
    return (np.concatenate([s, rng.integers(0, 300, hub)]),
            np.concatenate([r, np.zeros(hub, np.int64)]),
            np.concatenate([w, rng.random(hub).astype(np.float32) + 0.1]),
            n)


# row_walk.cuh: a row of more than LONG_ROW (kLongRow) slots is a hub row
# of the narrow walk, which its warp takes HUB_TRIP (kHubBatches * 32)
# slots a trip
LONG_ROW, HUB_TRIP = 32, 128


def kernel_emulation(pack: K.PackedCSR, x: np.ndarray) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy: per row, its row_range in
    slot order, f32 products rounded then summed.  A hub row of the
    narrow walk forms each trip's products at once, one slot a lane, and
    adds them in slot order: the same order, the same bits."""
    n, d = x.shape
    out = np.zeros((n, d), np.float32)
    s = pack.senders.reshape(-1)
    w = pack.weights.reshape(-1)
    for row, (lo, hi) in enumerate(pack.row_range):
        if d <= 8 and hi - lo > LONG_ROW:
            for k0 in range(lo, hi, HUB_TRIP):
                ks = np.arange(k0, min(k0 + HUB_TRIP, hi))
                ks = ks[(s[ks] >= 0) & (s[ks] < n)]
                for p in w[ks, None] * x[s[ks]]:
                    out[row] += p
            continue
        for k in range(lo, hi):
            if 0 <= s[k] < n:
                out[row] += np.float32(w[k]) * x[s[k]]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_emulation_matches_plain(seed):
    s, r, w, n = random_graph(seed, e=1200, hot=600)
    pack = K.pack_csr(s, r, w, n, pad_chunks_to=8)
    x = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
    want = K.spmm_packed_plain(pack_tensors(pack), torch.from_numpy(x))
    np.testing.assert_allclose(kernel_emulation(pack, x), want.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [1, 3, 8])
def test_kernel_emulation_with_hub_matches_plain(d):
    """The narrow walk's order, hub row included, against the plain
    version on the CPU (whose index_add_ adds in slot order too)."""
    s, r, w, n = hub_graph(7)
    fwd = K.pack_csr(s, r, w, n, pad_chunks_to=40)
    bwd = K.pack_csr(r, s, w, n, pad_chunks_to=40)
    lengths = np.diff(fwd.row_range, axis=1)
    assert lengths.max() > 2000 and lengths[0, 0] == lengths.max()
    x = np.random.default_rng(d).normal(size=(n, d)).astype(np.float32)
    for pack in (fwd, bwd):
        want = K.spmm_packed_plain(pack_tensors(pack), torch.from_numpy(x))
        np.testing.assert_array_equal(kernel_emulation(pack, x),
                                      want.numpy())


def pack_tensors(pack: K.PackedCSR, device="cpu") -> K.PackedCSR:
    return K.PackedCSR(*(torch.from_numpy(np.asarray(a)).to(device)
                         for a in pack))


def two_planes(a: np.ndarray) -> np.ndarray:
    """a rounded to what the TPU kernel's bf16 hi/lo split keeps."""
    hi, lo = JK._split_hi_lo(jnp.asarray(a, jnp.float32))
    return np.array(hi.astype(jnp.float32) + lo.astype(jnp.float32))


@pytest.mark.parametrize("seed,d", [(0, 16), (1, 128), (2, 1), (3, 3)])
def test_spmm_pack_vjp_matches_jax(jax_numpy_packer, seed, d):
    s, r, w, n = random_graph(seed)
    w = np.array(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    fwd = K.pack_csr(s, r, w, n, pad_chunks_to=40)
    bwd = K.pack_csr(r, s, w, n, pad_chunks_to=40)
    jfwd = JK.pack_csr(s, r, w, n, pad_chunks_to=40)
    jbwd = JK.pack_csr(r, s, w, n, pad_chunks_to=40)
    rng = np.random.default_rng(seed + 10)
    x = two_planes(rng.normal(size=(n, d)))
    g = two_planes(rng.normal(size=(n, d)))

    def jax_fn(xx):
        return JK.spmm_pack_vjp(jfwd, jbwd, xx)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = K.spmm_pack_vjp(pack_tensors(fwd), pack_tensors(bwd), xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-5)


def test_cpu_tensor_takes_plain_version():
    s, r, w, n = random_graph(4, e=500, hot=100)
    pack = pack_tensors(K.pack_csr(s, r, w, n))
    x = torch.randn(n, 4)
    before = K.packed_spmm_cuda.launches
    out = K.spmm_packed(pack, x)
    assert K.packed_spmm_cuda.launches == before
    torch.testing.assert_close(out, K.spmm_packed_plain(pack, x))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.packed_spmm_cuda(pack, x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 64, 128, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda_device, dtype, d):
    """K1's walks by width (row_walk.cuh): a thread per row with a warp
    per hub row (D <= 8), row groups with 16-byte loads (64, 128, and
    256, two passes a row, the design grid's width), a warp per row
    (130); fwd and bwd packs of a graph with a hub row.  The
    reference is the plain version on the CPU, which sums each row in
    slot order as the kernel does (on the card its index_add_ sums with
    atomics, in no fixed order)."""
    s, r, w, n = hub_graph(5)
    fwd_h = K.pack_csr(s, r, w, n, pad_chunks_to=64)
    bwd_h = K.pack_csr(r, s, w, n, pad_chunks_to=64)
    fwd, bwd = (pack_tensors(p, cuda_device) for p in (fwd_h, bwd_h))
    x = torch.randn(n, d, device=cuda_device).to(dtype)
    g = torch.randn(n, d, device=cuda_device).to(dtype)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    before = K.packed_spmm_cuda.launches
    before_d = K.packed_spmm_cuda.launches_by_width[d]
    xg = x.clone().requires_grad_(True)
    out = K.spmm_pack_vjp(fwd, bwd, xg)
    out.backward(g)
    torch.cuda.synchronize()
    assert K.packed_spmm_cuda.launches == before + 2
    assert K.packed_spmm_cuda.launches_by_width[d] == before_d + 2
    torch.testing.assert_close(
        out.cpu(), K.spmm_packed_plain(pack_tensors(fwd_h), x.cpu()), **tol)
    torch.testing.assert_close(
        xg.grad.cpu(), K.spmm_packed_plain(pack_tensors(bwd_h), g.cpu()),
        **tol)
    for pack in (fwd, bwd):
        assert torch.equal(K.packed_spmm_cuda(pack, x),
                           K.packed_spmm_cuda(pack, x))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_equals_headed_one_head(cuda_device, dtype, d):
    """K1 is K3's walk at one head with alpha = the pack's weights: the
    two libraries give the same bits."""
    s, r, w, n = hub_graph(6)
    for pack in (K.pack_csr(s, r, w, n), K.pack_csr(r, s, w, n)):
        pack = pack_tensors(pack, cuda_device)
        x = torch.randn(n, d, device=cuda_device).to(dtype)
        assert torch.equal(
            K.packed_spmm_cuda(pack, x),
            K.packed_segment_matmul_headed_cuda(pack, x,
                                                pack.weights[..., None]))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 128, 130, 768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,ego", [("add", False), ("mean", False),
                                      ("add", True)])
def test_cuda_pool_kernel_matches_plain(cuda_device, kind, ego, dtype, d):
    """Graph add / mean pooling on the card: K1 on a rectangular pooling
    pack (13 graph slots from 896 node rows; rows of 30-70 slots, the
    vector walk's and at D <= 8 the narrow walk's hub rows) and on its
    transpose (896 rows from 13) through SpmmPackFn, against the plain
    version on the CPU; the padding sender is the input's row count, so
    padding nodes, centers and slots add nothing; 2 launches at D, both
    counted as rectangular."""
    from test_torch_max import pool_packs

    fwd, bwd, g, n = pool_packs(kind, ego)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(d))
    cot = torch.randn(g, d, generator=torch.Generator().manual_seed(1))
    x, cot = x.to(dtype), cot.to(dtype)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    dfwd, dbwd = (pack_tensors(p, cuda_device) for p in (fwd, bwd))
    before = K.packed_spmm_cuda.launches_by_width[d]
    rect = K.packed_spmm_cuda.launches_rectangular[d]
    xg = x.to(cuda_device).requires_grad_(True)
    out = K.spmm_pack_vjp(dfwd, dbwd, xg)
    out.backward(cot.to(cuda_device))
    torch.cuda.synchronize()
    assert K.packed_spmm_cuda.launches_by_width[d] == before + 2
    assert out.shape == (g, d) and xg.grad.shape == (n, d)
    torch.testing.assert_close(out.cpu(), K.spmm_packed_plain(fwd, x),
                               **tol)
    torch.testing.assert_close(xg.grad.cpu(),
                               K.spmm_packed_plain(bwd, cot), **tol)
    assert K.packed_spmm_cuda.launches_rectangular[d] == rect + 2
    assert torch.equal(K.packed_spmm_cuda(dfwd, xg.detach()),
                       K.packed_spmm_cuda(dfwd, xg.detach()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [5, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_kernel_matches_plain(cuda_device, dtype, d):
    """A head's gather of node rows at an index with repeats (the edge
    head's pairs, the edge task's supervised nodes) on the card: K1 on
    the rectangular gather pack (600 entries from 257 node rows, one
    node named 60 times, 40 padding entries at the padding node) and on
    its transpose through SpmmPackFn, against the plain version on the
    CPU; the forward is x's rows exactly (zero at padding entries), the
    backward each node's entries summed; 2 launches at D, both counted
    as rectangular."""
    rng = np.random.default_rng(d)
    n = 257
    index = np.concatenate([rng.integers(0, n - 1, 500), np.full(60, 7),
                            np.full(40, n - 1)])
    mask = np.arange(len(index)) < 560
    fwd, bwd = packing.build_gather_packs(index, mask, n)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(d))
    cot = torch.randn(len(index), d,
                      generator=torch.Generator().manual_seed(1))
    x, cot = x.to(dtype), cot.to(dtype)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    dfwd, dbwd = (pack_tensors(p, cuda_device) for p in (fwd, bwd))
    rect = K.packed_spmm_cuda.launches_rectangular[d]
    xg = x.to(cuda_device).requires_grad_(True)
    out = K.spmm_pack_vjp(dfwd, dbwd, xg)
    out.backward(cot.to(cuda_device))
    torch.cuda.synchronize()
    want = K.spmm_packed_plain(pack_tensors(fwd), x)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(want[~torch.from_numpy(mask)],
                       torch.zeros(40, d, dtype=dtype))
    torch.testing.assert_close(
        xg.grad.cpu(), K.spmm_packed_plain(pack_tensors(bwd), cot), **tol)
    assert K.packed_spmm_cuda.launches_rectangular[d] == rect + 2
    assert torch.equal(K.packed_spmm_cuda(dbwd, cot.to(cuda_device)),
                       K.packed_spmm_cuda(dbwd, cot.to(cuda_device)))


def test_library_hash_covers_sources_and_headers(tmp_path, monkeypatch):
    """A library's name changes with its source, with any csrc header
    and with the flags, so an edit never loads a stale build."""
    import shutil

    for name in K.SOURCES:
        shutil.copy(os.path.join(K._CSRC, f"{name}.cu"), tmp_path)
    shutil.copy(os.path.join(K._CSRC, "common.cuh"), tmp_path)
    monkeypatch.setattr(K, "_CSRC", str(tmp_path))
    src = str(tmp_path / "packed_attention.cu")
    base = K._digest(src)
    assert base != K._digest(str(tmp_path / "packed_spmm.cu"))
    (tmp_path / "common.cuh").write_text(
        (tmp_path / "common.cuh").read_text() + "\n// edit\n")
    edited_header = K._digest(src)
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    new_header = K._digest(src)
    with open(src, "a") as f:
        f.write("\n// edit\n")
    edited_source = K._digest(src)
    monkeypatch.setattr(K, "NVCC_FLAGS", K.NVCC_FLAGS + ["-lineinfo"])
    assert len({base, edited_header, new_header, edited_source,
                K._digest(src)}) == 5
