"""The port's unweighted packed segmented sum (K2) and the pack group
against the JAX package's.

Packs: ``pack_csr(group=G)`` equals the JAX numpy packer's arrays for
G in {1, 2, 4}.  Values: ``packed_segment_matmul`` (the plain version
on the CPU) against JAX ``packed_segment_matmul(weights=None,
group=G)`` run through the Pallas kernel in interpret mode, with a
random message on every slot, padding slots included.  f32 messages
are multiples of 1/16 in [-8, 8): bf16 holds them exactly, and the
kernel's hi/lo planes (spmm_kernel.py:238-239) hold their group sums,
so only the f32 summation order differs: rtol 1e-5 / atol 1e-6.  bf16
messages: the TPU kernel rounds each group sum to bf16 before its
matmul (:324-325) and the port sums in f32, so each row may differ by
one bf16 rounding of its messages' magnitudes: |got - want| <= 2^-8 *
sum|msg| over the row.  Gradient: ``segment_matmul_vjp`` against
``jax.vjp`` of the JAX one at a node count that is not a multiple of
128, so the clamp of :526 acts.  The CUDA kernel's reading rule (the
pack's index, owner rows and runs) is emulated in numpy here; the
kernel itself runs under the ``cuda`` marker on a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import graphgym_tpu.native as jax_native
from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from test_torch_spmm import FIELDS, pack_tensors, random_graph

R = K.ROWS_PER_TILE


@pytest.fixture
def jax_numpy_packer(monkeypatch):
    """The JAX side packs with its numpy path (the native packer orders
    the slots of a row differently)."""
    monkeypatch.setattr(jax_native, "load", lambda: None)


def bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def random_msg(seed, pack, d):
    """A random message on every slot of ``pack``: multiples of 1/16 in
    [-8, 8), which bf16 holds exactly, as the hi/lo planes hold the f32
    sums of any group of them."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, pack.senders.shape + (d,))
            / 16).astype(np.float32)


def assert_sums_close(got, want, abs_sum, rel):
    """|got - want| <= rel * abs_sum + 1e-6, row by row and column by
    column: the error of summing messages of magnitude sum abs_sum with
    relative rounding rel."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    excess = np.abs(got - want) - (rel * np.asarray(abs_sum) + 1e-6)
    assert excess.max() <= 0, f"max excess {excess.max()}"


def num_tiles(n):
    return (n + R - 1) // R


def f64_sums(msg, pack, n):
    """The segmented sum in float64, and the same of |msg|."""
    rows = K.slot_rows(pack.local_rows, pack.tiles).reshape(-1)
    flat = msg.reshape(-1, msg.shape[-1]).double()
    out = [torch.zeros(num_tiles(n) * R, flat.shape[1], dtype=torch.float64,
                       device=msg.device).index_add_(0, rows, m)
           for m in (flat, flat.abs())]
    return out[0], out[1]


# --------------------------------------------------------------- packs


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("pad_to", [None, 48])
def test_pack_csr_group_matches_jax(jax_numpy_packer, group, pad_to):
    s, r, w, n = random_graph(group)
    want = JK.pack_csr(s, r, w, n, pad_chunks_to=pad_to, group=group)
    got = K.pack_csr(s, r, w, n, pad_chunks_to=pad_to, group=group)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    # every aligned group of G slots belongs to one row, and the
    # row_range of each row still holds exactly its nonzero slots
    rows = (got.tiles[:, None] * R + got.local_rows).reshape(-1, group)
    assert (rows == rows[:, :1]).all()
    inside = np.zeros(got.senders.size, bool)
    for lo, hi in got.row_range:
        inside[lo:hi] = True
    np.testing.assert_array_equal(inside, got.weights.reshape(-1) != 0)


def test_group_must_divide_the_chunk():
    s, r, w, n = random_graph(0, e=300, hot=100)
    with pytest.raises(ValueError, match="group 3"):
        K.pack_csr(s, r, w, n, group=3)
    pack = pack_tensors(K.pack_csr(s, r, w, n))
    msg = torch.zeros(pack.senders.shape + (2,))
    with pytest.raises(ValueError, match="group 3"):
        K.packed_segment_matmul(msg, pack.local_rows, pack.tiles,
                                num_tiles(n), group=3)


# ------------------------------------------------------------ kernel K2


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_plain_matches_jax(jax_numpy_packer, group, dtype):
    s, r, w, n = random_graph(10 + group)
    pack = K.pack_csr(s, r, w, n, pad_chunks_to=40, group=group)
    msg = random_msg(group, pack, 16)
    jmsg = jnp.asarray(msg, dtype)
    want = JK.packed_segment_matmul(jmsg, jnp.asarray(pack.local_rows),
                                    jnp.asarray(pack.tiles), num_tiles(n),
                                    group=group)
    p = pack_tensors(pack)
    got = K.packed_segment_matmul(
        torch.from_numpy(msg).to(getattr(torch, dtype)), p.local_rows,
        p.tiles, num_tiles(n), group=group)
    assert got.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    else:
        abs_sum = K.packed_segment_matmul_plain(
            torch.from_numpy(np.abs(msg)), p.local_rows, p.tiles,
            num_tiles(n))
        assert_sums_close(got.numpy(), want, abs_sum.numpy(), 2.0 ** -8)
    # padding slots count: each adds its message to local row 0 of its
    # chunk's tile (or to the row whose group it pads)
    real = torch.from_numpy(pack.senders < n)[..., None]
    assert not torch.equal(got, K.packed_segment_matmul(
        torch.from_numpy(msg) * real, p.local_rows, p.tiles, num_tiles(n)))


@pytest.mark.parametrize("num_nodes", [300, 383])
def test_segment_matmul_vjp_matches_jax(num_nodes):
    s, r, w, n = random_graph(20)
    pack = K.pack_csr(s, r, w, n, pad_chunks_to=8)
    msg = random_msg(21, pack, 8)
    g = bf16_exact(np.random.default_rng(22).normal(size=(num_nodes, 8)))
    local, tiles = jnp.asarray(pack.local_rows), jnp.asarray(pack.tiles)

    def jax_fn(m):
        return JK.segment_matmul_vjp(m, local, tiles, num_nodes)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(msg))
    (want_dmsg,) = vjp(jnp.asarray(g))
    p = pack_tensors(pack)
    mt = torch.from_numpy(msg).requires_grad_(True)
    out = K.segment_matmul_vjp(mt, p.local_rows, p.tiles, num_nodes)
    out.backward(torch.from_numpy(g))
    assert out.shape == (num_nodes, 8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(mt.grad.numpy(), np.asarray(want_dmsg))
    # slots whose row lies past num_nodes read the last row of g
    rows = (pack.tiles[:, None] * R + pack.local_rows)
    past = rows >= num_nodes
    assert past.any()
    np.testing.assert_array_equal(mt.grad.numpy()[past],
                                  np.broadcast_to(g[-1], (past.sum(), 8)))


def kernel_emulation(index: K.SegmentIndex, msg: np.ndarray) -> np.ndarray:
    """K2 in numpy (csrc/packed_segment.cu): a row with no run summed by
    its owner in position order (f32); a longer row by runs of run_len
    positions into partials, the partials then added in run order
    GROUP_RUNS at a time, and those group sums in order."""
    flat = msg.reshape(-1, msg.shape[-1])
    src = (np.arange(index.row_ptr[-1]) if index.src is None
           else index.src)
    n_out = len(index.row_ptr) - 1
    out = np.full((n_out, flat.shape[1]), np.nan, np.float32)

    def walk(lo, hi):
        acc = np.zeros(flat.shape[1], np.float32)
        for p in range(lo, hi):
            acc += flat[src[p]]
        return acc

    long_rows = set(index.run_row[index.run_row >= 0].tolist())
    for r in range(n_out):
        if r not in long_rows:
            out[r] = walk(index.row_ptr[r], index.row_ptr[r + 1])
    partial = {}
    for j, row in enumerate(index.run_row):
        if row < 0:
            continue
        n = index.run_len[j]
        lo = index.row_ptr[row] + (j - index.run_first[j]) * n
        partial[j] = walk(lo, min(lo + n, index.row_ptr[row + 1]))
    g = K.GROUP_RUNS
    for j, row in enumerate(index.run_row):
        if row >= 0 and index.run_first[j] == j:
            assert np.isnan(out[row]).all()
            runs = -(-(index.row_ptr[row + 1] - index.row_ptr[row])
                     // index.run_len[j])
            acc = np.zeros(flat.shape[1], np.float32)
            for g0 in range(j, j + runs, g):
                group = np.zeros(flat.shape[1], np.float32)
                for p in range(g0, min(g0 + g, j + runs)):
                    group += partial[p]
                acc += group
            out[row] = acc
    return out


@pytest.mark.parametrize("seed,group,pad_to", [(0, 1, 64), (1, 2, None),
                                                (2, 1, None)])
def test_segment_runs_cover_every_slot(seed, group, pad_to):
    """A pack's index (the TPU contract): every slot once, sorted by row
    and in slot order within a row; runs only for the rows longer than
    OWNER_SLOTS positions, in row and run order; and the kernel's order
    in numpy equals the plain version."""
    s, r, w, n = random_graph(seed, e=2500, hot=2000)
    pack = K.pack_csr(s, r, w, n, pad_chunks_to=pad_to, group=group)
    index = K.pack_segment_index_host(pack.local_rows, pack.tiles,
                                      num_tiles(n))
    rows = (pack.tiles[:, None] * R + pack.local_rows).reshape(-1)
    src = index.src
    assert src is not None            # the tiles' padding slots come last
    assert sorted(src) == list(range(rows.size))
    assert (np.diff(rows[src]) >= 0).all()
    for row in np.unique(rows):       # slot order within a row
        assert (np.diff(src[rows[src] == row]) > 0).all()
    np.testing.assert_array_equal(np.diff(index.row_ptr),
                                  np.bincount(rows, minlength=len(
                                      index.row_ptr) - 1))
    runs = index.run_row[index.run_row >= 0]
    counts = np.diff(index.row_ptr)
    long_rows = np.flatnonzero(counts > K.OWNER_SLOTS)
    # a hot row spans several chunks, and the padding chunks pile on
    # row 0 of the last tile: some rows are cut into runs
    assert len(long_rows) > 0
    long = counts[long_rows]
    np.testing.assert_array_equal(
        runs, np.repeat(long_rows, -(-long // K.run_length(long,
                                                            long.sum()))))
    assert len(index.run_row) == K.segment_runs_bound(rows.size)
    msg = random_msg(seed, pack, 4)
    want = K.packed_segment_matmul_plain(
        torch.from_numpy(msg), *pack_tensors(pack)[2:4], num_tiles(n))
    np.testing.assert_allclose(kernel_emulation(index, msg), want.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_segment_runs_cached_per_pack():
    s, r, w, n = random_graph(3, e=400, hot=100)
    p = pack_tensors(K.pack_csr(s, r, w, n))
    first = K.segment_index(p.local_rows, p.tiles, num_tiles(n))
    assert K.segment_index(p.local_rows, p.tiles, num_tiles(n)) is first
    p.local_rows[0, 0] += 0        # an in-place write: built anew
    assert K.segment_index(p.local_rows, p.tiles, num_tiles(n)) is not first
    with pytest.raises(ValueError, match="outside"):
        K.pack_segment_index_host(p.local_rows.numpy(), p.tiles.numpy(), 1)


def test_segment_cpu_tensor_takes_plain_version():
    s, r, w, n = random_graph(4, e=500, hot=100)
    p = pack_tensors(K.pack_csr(s, r, w, n))
    msg = torch.randn(p.senders.shape + (4,))
    before = K.packed_segment_matmul_cuda.launches
    out = K.packed_segment_matmul(msg, p.local_rows, p.tiles, num_tiles(n))
    assert K.packed_segment_matmul_cuda.launches == before
    torch.testing.assert_close(out, K.packed_segment_matmul_plain(
        msg, p.local_rows, p.tiles, num_tiles(n)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.packed_segment_matmul_cuda(msg, p.local_rows, p.tiles,
                                     num_tiles(n))


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2])
def test_cuda_segment_kernel_matches_plain(cuda_device, dtype, group):
    s, r, w, n = random_graph(5)
    pack = pack_tensors(K.pack_csr(s, r, w, n, pad_chunks_to=64,
                                   group=group), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(group)
    msg = torch.randn(pack.senders.shape + (128,), generator=gen,
                      device=cuda_device).to(dtype)
    before = K.packed_segment_matmul_cuda.launches
    got = K.packed_segment_matmul(msg, pack.local_rows, pack.tiles,
                                  num_tiles(n), group=group)
    torch.cuda.synchronize()
    assert K.packed_segment_matmul_cuda.launches == before + 1
    want, abs_sum = f64_sums(msg, pack, n)
    assert_sums_close(got.cpu(), want.cpu(), abs_sum.cpu(), 1e-5)
    assert torch.equal(got, K.packed_segment_matmul(
        msg, pack.local_rows, pack.tiles, num_tiles(n), group=group))


@pytest.mark.cuda
def test_cuda_segment_wrapper_rejects_bad_inputs(cuda_device):
    s, r, w, n = random_graph(6, e=500, hot=100)
    p = pack_tensors(K.pack_csr(s, r, w, n), cuda_device)
    msg = torch.randn(p.senders.shape + (8,), device=cuda_device)
    bad = [(msg.half(), p.local_rows, p.tiles, "dtype"),
           (msg[0], p.local_rows, p.tiles, "3-D"),
           (msg[:, :-1], p.local_rows, p.tiles, "local_rows"),
           (msg, p.local_rows.long(), p.tiles, "int32"),
           (msg, p.local_rows, p.tiles.cpu(), "int32")]
    for m, local, tiles, text in bad:
        with pytest.raises(ValueError, match=text):
            K.packed_segment_matmul_cuda(m, local, tiles, num_tiles(n))
