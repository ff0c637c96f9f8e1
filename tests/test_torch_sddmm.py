"""The packed SDDMM and the scaled dot-product score on the packs
against the JAX package's gathered score.

packed_sddmm_plain against the JAX score score_fn(take_padded(q, rows),
take_padded(k, senders)) (graphgym_tpu/nn/layers.py:152-156 with
TfgGATConv's score, :454-457) on the slots of nonzero pack weight, and
exact 0 on the others; packed_scaled_dot's dq and dk (K3 on the fwd and
bwd packs) against jax.vjp of that expression under a cotangent that is
0 on the weight-0 slots.  Inputs are bf16-valued, so products are exact
in f32 and only the summation order differs: rtol 1e-4 / atol 1e-5.
packed_attention with a ScaledDot score against the JAX one (output
rtol 1e-4 / atol 1e-5, gradients rtol 1e-3), with the route checked by
counting calls of the plain SDDMM.  The kernel's reading rule (each
row's row_range in slot order, 0 elsewhere) is emulated in numpy; the
kernel itself runs under the ``cuda`` marker on a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from graphgym_tpu.ops.pallas import spmm_kernel as JK
from graphgym_tpu_torch.nn import layers
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from test_torch_attention import (att_graphs, att_packs,  # noqa: F401
                                  bf16_exact)
from test_torch_spmm import pack_tensors


def jax_score(fwd, dh):
    """The JAX package's packed score as a function of q and k [N, H, dh]
    (its take_padded gathers and TfgGATConv's scaled dot)."""
    rows = np.asarray(JK.pack_rows(fwd))
    scale = jnp.sqrt(jnp.asarray(dh, jnp.float32))

    def take_padded(arr, idx):
        padded = jnp.concatenate(
            [arr, jnp.zeros((1,) + arr.shape[1:], arr.dtype)])
        return jnp.take(padded, idx.reshape(-1), axis=0).reshape(
            idx.shape + arr.shape[1:])

    def score(q, k):
        return jnp.sum(take_padded(q, rows) * take_padded(k, fwd.senders),
                       axis=-1) / scale
    return score, float(scale)


def qk(seed, n, heads, dh=8):
    rng = np.random.default_rng(seed)
    return (bf16_exact(rng.normal(size=(n, heads, dh))),
            bf16_exact(rng.normal(size=(n, heads, dh))), rng)


@pytest.mark.parametrize("heads", [1, 4])
def test_sddmm_plain_matches_jax_score(heads):
    *_, n, _, (fwd, _, _), (jfwd, _) = att_packs(30 + heads)
    q, k, _ = qk(heads, n, heads)
    score, scale = jax_score(jfwd, 8)
    want = np.asarray(score(jnp.asarray(q), jnp.asarray(k)))
    got = K.packed_sddmm_plain(pack_tensors(fwd), torch.from_numpy(q),
                               torch.from_numpy(k)).numpy() / scale
    assert got.shape == fwd.senders.shape + (heads,)
    live = fwd.weights > 0
    # weight-0 slots with a real sender: the JAX score is not 0 there
    zero_w = ~live & (fwd.senders < n)
    assert zero_w.any() and (want[zero_w] != 0).any()
    np.testing.assert_allclose(got[live], want[live], rtol=1e-4, atol=1e-5)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("heads", [1, 4])
def test_packed_scaled_dot_vjp_matches_jax(heads):
    *_, n, _, (fwd, bwd, slot_map), (jfwd, _) = att_packs(40 + heads)
    q, k, rng = qk(heads + 1, n, heads)
    score, scale = jax_score(jfwd, 8)
    live = (fwd.weights > 0)[..., None]
    cot = bf16_exact(rng.normal(size=fwd.senders.shape + (heads,))) * live
    want, vjp = jax.vjp(score, jnp.asarray(q), jnp.asarray(k))
    want_dq, want_dk = vjp(jnp.asarray(cot))

    qt = torch.from_numpy(q).requires_grad_(True)
    kt = torch.from_numpy(k).requires_grad_(True)
    got = K.packed_scaled_dot(qt, kt, pack_tensors(fwd), pack_tensors(bwd),
                              torch.from_numpy(slot_map), scale)
    got.backward(torch.from_numpy(cot))
    live = np.broadcast_to(live, got.shape)
    np.testing.assert_allclose(got.detach().numpy()[live],
                               np.asarray(want)[live], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want_dq),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(want_dk),
                               rtol=1e-4, atol=1e-5)


def sddmm_emulation(pack, a, b):
    """The function by rows, in numpy: per row, its row_range in slot
    order, the per-head dot product of each slot of nonzero weight;
    every other slot 0 (the row ranges hold every slot of nonzero
    weight).  The kernel's own split, runs of slots, is emulated in
    test_torch_sddmm_runs.py."""
    n, heads, _ = a.shape
    s = pack.senders.reshape(-1)
    w = pack.weights.reshape(-1)
    out = np.zeros((s.size, heads), np.float32)
    for row, (lo, hi) in enumerate(pack.row_range):
        for slot in range(lo, hi):
            if 0 <= s[slot] < n and w[slot] != 0:
                out[slot] = (a[row] * b[s[slot]]).sum(-1)
    return out.reshape(pack.senders.shape + (heads,))


@pytest.mark.parametrize("heads", [1, 4])
def test_sddmm_row_range_reading_matches_plain(heads):
    *_, n, _, (fwd, _, _), _ = att_packs(50 + heads, e=1200, hot=600)
    rng = np.random.default_rng(heads)
    a = rng.normal(size=(n, heads, 4)).astype(np.float32)
    b = rng.normal(size=(n, heads, 4)).astype(np.float32)
    want = K.packed_sddmm_plain(pack_tensors(fwd), torch.from_numpy(a),
                                torch.from_numpy(b))
    np.testing.assert_allclose(sddmm_emulation(fwd, a, b), want.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sddmm_cpu_tensor_takes_plain_version():
    *_, n, _, (fwd, _, _), _ = att_packs(4, e=500, hot=100)
    pack = pack_tensors(fwd)
    a, b = torch.randn(n, 2, 4), torch.randn(n, 2, 4)
    before = K.packed_sddmm_cuda.launches
    out = K.packed_sddmm(pack, a, b)
    assert K.packed_sddmm_cuda.launches == before
    torch.testing.assert_close(out, K.packed_sddmm_plain(pack, a, b))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.packed_sddmm_cuda(pack, a, b)


@pytest.fixture
def count_plain_sddmm(monkeypatch):
    calls = []
    plain = K.packed_sddmm_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)
    monkeypatch.setattr(K, "packed_sddmm_plain", counted)
    return calls


@pytest.mark.parametrize("heads", [1, 2])
def test_packed_attention_scaled_dot_route_matches_jax(att_graphs,
                                                       count_plain_sddmm,
                                                       heads):
    from graphgym_tpu.nn import layers as jax_layers

    jb, b = att_graphs
    n, d = b.num_nodes, 4
    rng = np.random.default_rng(10 + heads)
    q, k, v = (rng.normal(size=(n, heads, d)).astype(np.float32)
               for _ in range(3))
    cot = rng.normal(size=(n, heads, d)).astype(np.float32)

    def jax_fn(qq, kk, vv):
        return jax_layers.packed_attention(
            jb, qq, lambda q_i, k_j: jnp.sum(q_i * k_j, axis=-1)
            / jnp.sqrt(jnp.float32(d)), values=vv, keys=kk)

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(cot))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = layers.packed_attention(b, xs[0], layers.scaled_dot(d,
                                                              torch.float32),
                                  values=xs[2], keys=xs[1])
    # the score went through the SDDMM, not through gathered q and k
    assert len(count_plain_sddmm) == 1
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    for name, x, wg in zip("qkv", xs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_plain_score_fn_takes_gather_route(att_graphs, count_plain_sddmm):
    _, b = att_graphs
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b.num_nodes, 2, 4)).astype(np.float32))
    score = layers.scaled_dot(4, torch.float32)
    seen = []

    def plain_score(q_i, k_j):
        seen.append(q_i.shape)
        return score(q_i, k_j)

    out = layers.packed_attention(b, x, plain_score)
    assert count_plain_sddmm == [] and len(seen) == 1
    assert seen[0] == b.packs["att"][0].senders.shape + (2, 4)
    torch.testing.assert_close(out, layers.packed_attention(b, x, score),
                               rtol=1e-5, atol=1e-6)


def test_scaled_dot_scale_rounds_to_dtype():
    s = layers.scaled_dot(3, torch.bfloat16)
    assert isinstance(s, layers.ScaledDot)
    assert s.scale == torch.sqrt(torch.tensor(3.0, dtype=torch.bfloat16)).item()
    q, k = torch.randn(5, 2, 3), torch.randn(5, 2, 3)
    torch.testing.assert_close(s(q, k), (q * k).sum(-1) / s.scale)


# ------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 4])
def test_cuda_sddmm_kernel_matches_plain(cuda_device, dtype, heads):
    *_, n, _, (fwd, _, _), _ = att_packs(5)
    pack = pack_tensors(fwd, cuda_device)
    # the vector path with the lanes per row the kernel picks (D = 128:
    # a warp in f32, a half-warp in bf16; D = 64: a half-warp, or at
    # H = 4 in bf16 the scalar path) and the scalar path (each head's
    # width not a multiple of 16 bytes)
    for dh in (128 // heads, 64 // heads, 9):
        a = torch.randn(n, heads, dh, device=cuda_device).to(dtype)
        b = torch.randn(n, heads, dh, device=cuda_device).to(dtype)
        before = K.packed_sddmm_cuda.launches
        got = K.packed_sddmm(pack, a, b)
        torch.cuda.synchronize()
        assert K.packed_sddmm_cuda.launches == before + 1
        want = K.packed_sddmm_plain(pack, a, b)
        scale = K.packed_sddmm_plain(pack, a.float().abs(), b.float().abs())
        assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
        assert (got[(pack.weights == 0)] == 0).all()
        assert torch.equal(got, K.packed_sddmm(pack, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sddmm_hub_pack_matches_emulation(cuda_device, dtype):
    """A hub row of 2,500 slots over many runs, runs that start
    mid-row, bucket-padding chunks, H = 8, dh = 16 (the vector path in
    f32, the scalar path in bf16): bitwise the numpy emulation of the
    kernel, within 1e-5 of each slot's sum of |a * b| of the plain
    version, 0 on every slot of weight 0, bitwise repeats, one launch a
    call."""
    from test_torch_sddmm_runs import emulate, hub_pack
    pack = hub_pack(11)
    n = pack.row_range.shape[0]
    rng = np.random.default_rng(12)
    a, b = (rng.normal(size=(n, 8, 16)).astype(np.float32)
            for _ in range(2))
    dev = pack_tensors(pack, cuda_device)
    at, bt = (torch.from_numpy(x).to(cuda_device, dtype) for x in (a, b))
    before = K.packed_sddmm_cuda.launches
    got = K.packed_sddmm(dev, at, bt)
    torch.cuda.synchronize()
    assert K.packed_sddmm_cuda.launches == before + 1
    a32, b32 = (x.float().cpu().numpy() for x in (at, bt))
    emu = emulate(pack, a32, b32, itemsize=at.element_size())
    np.testing.assert_array_equal(got.cpu().numpy(), emu["out"])
    want = K.packed_sddmm_plain(dev, at, bt)
    scale = K.packed_sddmm_plain(dev, at.float().abs(), bt.float().abs())
    assert ((got - want).abs() <= 1e-5 * scale + 1e-6).all()
    assert (got[dev.weights == 0] == 0).all()
    assert torch.equal(got, K.packed_sddmm(dev, at, bt))
    assert K.packed_sddmm_cuda.launches == before + 2


@pytest.mark.cuda
def test_cuda_sddmm_wrapper_rejects_bad_inputs(cuda_device):
    *_, n, _, (fwd, _, _), _ = att_packs(6)
    pack = pack_tensors(fwd, cuda_device)
    a = torch.randn(n, 2, 4, device=cuda_device)
    bad = [(a.half(), a.half(), "dtype"),
           (a, a.bfloat16(), "match"),
           (a[:-1], a[:-1], "row_range"),
           (a, a[:, :1], "heads"),
           (a.reshape(n, 8), a.reshape(n, 8), "heads"),
           (a, a.cpu(), "match"),
           (a.cpu(), a.cpu(), "CUDA tensor")]
    for aa, bb, msg in bad:
        with pytest.raises(ValueError, match=msg):
            K.packed_sddmm_cuda(pack, aa, bb)
    # the rows come from the pack's tiles and local_rows
    bad = [(pack._replace(tiles=pack.tiles[:-1]), "tiles"),
           (pack._replace(local_rows=pack.local_rows.long()), "local_rows"),
           (pack._replace(tiles=pack.tiles.cpu()), "tiles")]
    for pk, msg in bad:
        with pytest.raises(ValueError, match=msg):
            K.packed_sddmm_cuda(pk, a, a)
