"""Benchmark of the port: SpMM fwd+bwd throughput (edges/s on one card).

    python -m graphgym_tpu_torch.bench [--nodes 131072] [--edges 2000000]
        [--dim 128] [--iters 20] [--repeats 5] [--impl pallas|xla]
        [--suite] [--out chiprun_out/bench/BENCH_DETAILS.json]
        [--device auto|cuda|cpu]

The port of the root ``bench.py``, the same workloads and methodology:
each timed run is a chain of ``iters`` steps, each taking the previous
step's output (or gradient), ended by a device-to-host copy; runs of
the paths are interleaved, ``repeats`` of each, and reported as median
and IQR.  Prints ONE JSON line:

  {"metric": "spmm_fwd_bwd_edges_per_s_per_chip", "value": median,
   "unit": "edges/s", "median", "iqr", "n", "fwd_only_median", ...,
   "device": ...}

``--impl pallas`` keeps the JAX package's name for the packed path: here
it runs the hand-written Hopper kernel K1 (``spmm_bidir``); ``xla`` is
the port's COO ``spmm`` (gather, weight, index_add).  The run is on the
first CUDA card unless ``--device cpu`` is given.  ``--suite`` also
times the attention and train-epoch workloads and writes them to
``--out``.  Unlike the root script there is no ``vs_baseline``: its
baseline is a TPU measurement.

The chained fwd_bwd iterate is the gradient of sum(out^2), 2 A^T A x:
on ``make_graph``'s graph its norm grows each step and reaches inf
after about ten steps, in both packages.  The chain is kept as it is,
so that the same work is timed; correctness is checked on unchained
calls (``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "bench",
                           "BENCH_DETAILS.json")
TRAIN_LAYERS = ("Tfg-idgcn", "Tfg-idgat", "Tfg-idgin", "Tfg-idsage")


def make_graph(num_nodes: int, num_edges: int, dim: int, seed: int = 0):
    """Power-law-ish synthetic graph: endpoints biased to low ids (a copy
    of the root bench.py's, the same numpy draws)."""
    rng = np.random.default_rng(seed)
    # Zipf-flavored endpoints via squaring uniforms (hub structure)
    senders = (rng.random(num_edges) ** 2 * num_nodes).astype(np.int32)
    receivers = (rng.random(num_edges) ** 2 * num_nodes).astype(np.int32)
    senders = np.minimum(senders, num_nodes - 1)
    receivers = np.minimum(receivers, num_nodes - 1)
    x = rng.normal(size=(num_nodes, dim)).astype(np.float32)
    w = rng.random(num_edges).astype(np.float32)
    return senders, receivers, w, x


@functools.lru_cache(maxsize=2)
def bidir_graph(num_nodes: int, num_edges: int, dim: int):
    """make_graph's arrays and their host packs, built once per size
    (the paths of one run share them)."""
    from graphgym_tpu_torch.ops.cuda.spmm_kernel import pack_bidir

    s, r, w, x = make_graph(num_nodes, num_edges, dim)
    return s, r, w, x, pack_bidir(s, r, w, num_nodes)


def _device(device) -> torch.device:
    from graphgym_tpu_torch.device import resolve_device

    return device if isinstance(device, torch.device) else \
        resolve_device(device)


def spmm_step(num_nodes, num_edges, dim, impl="pallas", dtype="float32",
              mode="fwd_bwd", device="auto"):
    """The step of one (impl, dtype, mode) path and its first input:
    'fwd' maps x to A x, 'fwd_bwd' to the gradient of sum((A x)^2) in
    x.  'pallas' runs spmm_bidir (K1 forward on the fwd pack, backward
    on the bwd pack), 'xla' the COO spmm."""
    from graphgym_tpu_torch.ops import sparse as sp
    from graphgym_tpu_torch.ops.cuda.spmm_kernel import spmm_bidir

    if impl not in ("pallas", "xla") or mode not in ("fwd", "fwd_bwd"):
        raise ValueError(f"impl {impl!r} / mode {mode!r}")
    device = _device(device)
    s, r, w, x, pack = bidir_graph(num_nodes, num_edges, dim)
    x0 = torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))
    if impl == "pallas":
        pack = pack.to(device)

        def fwd(x_):
            return spmm_bidir(pack, x_, num_nodes)
    else:
        s, r = (torch.from_numpy(a).to(device).long() for a in (s, r))
        w = torch.from_numpy(w).to(device)

        def fwd(x_):
            return sp.spmm(s, r, w, x_, num_nodes, implementation="xla")
    if mode == "fwd":
        def step(x_):
            with torch.no_grad():
                return fwd(x_).to(x_.dtype)
        return step, x0

    def step(x_):
        x_ = x_.detach().requires_grad_(True)
        loss = (fwd(x_).float() ** 2).sum()
        (g,) = torch.autograd.grad(loss, x_)
        return g
    return step, x0


def _time_chain(step, x0, iters: int, num_edges: int) -> float:
    """One timed chained run -> edges/s: iters steps, each on the last
    one's output, then a device-to-host copy of one row."""
    t0 = time.perf_counter()
    g = x0
    for _ in range(iters):
        g = step(g)
    g[:1].cpu()
    return num_edges * iters / (time.perf_counter() - t0)


def bench_spmm(num_nodes=131072, num_edges=2_000_000, dim=128, iters=20,
               impl="pallas", dtype="float32", mode="fwd_bwd", repeats=1,
               device="auto"):
    """Chained-iteration SpMM benchmark (the root bench.py:99-122): one
    warm-up step, then ``repeats`` timed chains of ``iters`` steps.
    Returns the list of edges/s rates."""
    step, x0 = spmm_step(num_nodes, num_edges, dim, impl, dtype, mode,
                         device)
    g0 = step(x0)
    g0[:1].cpu()      # build the kernels, warm up
    return [_time_chain(step, g0, iters, num_edges)
            for _ in range(repeats)]


@functools.lru_cache(maxsize=2)
def attention_graph(num_nodes: int, num_edges: int, heads: int, dv: int):
    """make_graph's edges as a host GraphBatch with its 'att' packs (the
    real edges plus a self-loop on each real node), and the inputs h,
    s_dst and s_src, drawn as the root bench.py draws them."""
    from graphgym_tpu_torch.graphs.container import build_graph_batch
    from graphgym_tpu_torch.graphs.packing import build_packs

    s, r, w, _ = make_graph(num_nodes, num_edges, dv)
    rng = np.random.default_rng(1)
    batch = build_graph_batch(s, r, rng.normal(
        size=(num_nodes, heads * dv)).astype(np.float32))
    batch = batch.replace(packs=build_packs(
        batch.senders, batch.receivers, batch.edge_weight,
        batch.node_mask, batch.num_nodes, kinds=("att",)))
    n = batch.num_nodes
    h = rng.normal(size=(n, heads, dv)).astype(np.float32)
    s_dst = rng.normal(size=(n, heads)).astype(np.float32)
    s_src = rng.normal(size=(n, heads)).astype(np.float32)
    return batch, h, s_dst, s_src


def attention_step(num_nodes=131072, num_edges=2_000_000, heads=8, dv=16,
                   device="auto"):
    """The attention step and its inputs (h, s_dst, s_src) on the
    device: packed_attention's node_scores branch with leaky_relu(0.2)
    scores, mapped to the gradients of sum(out^2) in (h, s_dst,
    s_src)."""
    from graphgym_tpu_torch.nn.layers import packed_attention

    device = _device(device)
    batch, *arrays = attention_graph(num_nodes, num_edges, heads, dv)
    batch = batch.to(device)

    def step(h, s_dst, s_src):
        xs = [t.detach().requires_grad_(True) for t in (h, s_dst, s_src)]
        out = packed_attention(
            batch, xs[0], None, node_scores=(xs[1], xs[2]),
            score_transform=lambda a: torch.nn.functional.leaky_relu(
                a, 0.2))
        return torch.autograd.grad((out ** 2).sum(), xs)
    return step, [torch.from_numpy(a).to(device) for a in arrays]


def bench_attention(num_nodes=131072, num_edges=2_000_000, heads=8, dv=16,
                    iters=20, device="auto"):
    """Packed multi-head attention fwd+bwd (the root bench.py:161-207):
    additive node scores through the softmax and K3; the gradient in h
    is chained into the next step's h.  Returns edges/s, counting the
    'att' pack's self-loops as edges."""
    step, (h, s_dst, s_src) = attention_step(num_nodes, num_edges, heads,
                                             dv, device)
    step(h, s_dst, s_src)[0][:1].cpu()     # build the kernels, warm up
    t0 = time.perf_counter()
    hh = h
    for _ in range(iters):
        hh = step(hh, s_dst, s_src)[0]
    hh[:1].cpu()
    return (num_edges + num_nodes) * iters / (time.perf_counter() - t0)


def bench_train_epoch(layer="Tfg-idgcn", impl="pallas", epochs=5,
                      dtype="float32", device="auto", dim_inner=128):
    """Steady-state train epoch time on the ID-GNN / ws workload (the
    root bench.py:125-158): two epochs of warm-up (one step each on ws:
    on the card the eager step 0 and the capture of step 1), then
    ``epochs`` timed, replays of the captured step.
    Returns (seconds per epoch, real edges per second).  The port's
    layers run the packs (the hand-written kernels) only: impl 'xla',
    the JAX package's COO layer path, is not ported (ROADMAP A0), and
    dtype bfloat16 raises in the loader (A14)."""
    from graphgym_tpu_torch.config import get_cfg
    from graphgym_tpu_torch.data.loaders import create_dataset, create_loader
    from graphgym_tpu_torch.nn.model import build_model
    from graphgym_tpu_torch.train.logger import Logger
    from graphgym_tpu_torch.train.loop import Trainer

    if impl not in ("pallas", "auto"):
        raise NotImplementedError(
            f"impl {impl!r}: the port's layers run the packed kernels "
            "only; the COO layer path is not ported yet (ROADMAP A0)")
    if isinstance(device, torch.device):    # cfg.device is a name
        device = device.type
    cfg = get_cfg()     # the root bench.py's ID-GNN / ws config, :137-146
    cfg.merge_from_dict({
        "dataset": {"format": "nx", "name": "ws", "task": "node",
                    "transductive": False, "split": [0.8, 0.2],
                    "augment_label": "node_clustering_coefficient",
                    "augment_label_dims": 10, "transform": "ego",
                    "dir": os.path.join(ROOT, "datasets")},
        "gnn": {"layers_mp": 3, "dim_inner": dim_inner,
                "layer_type": layer},
        "train": {"batch_size": 128},
        "tpu": {"spmm_impl": impl, "dtype": dtype},
        "optim": {"scheduler": "none"},
        "device": device})
    np.random.seed(1)
    loaders = create_loader(create_dataset(cfg), cfg)
    device = _device(cfg.device)
    tr = Trainer(build_model(cfg, device), loaders, cfg, device)
    edges = sum(int(b.count_real_edges()) for b in loaders[0].batches(0))
    for ep in range(2):
        tr.train_epoch(Logger("warmup"), ep)
    t0 = time.perf_counter()
    for ep in range(epochs):
        tr.train_epoch(Logger("t"), ep)
    dt = (time.perf_counter() - t0) / epochs
    return dt, edges / dt


def _stats(rates, ndigits=1):
    """Median, IQR and count of ``rates``, rounded to ``ndigits``
    (None: unrounded)."""
    v = sorted(rates)
    q1, med, q3 = (float(np.percentile(v, q)) for q in (25, 50, 75))
    out = {"median": med, "iqr": q3 - q1}
    if ndigits is not None:
        out = {k: round(x, ndigits) for k, x in out.items()}
    return {**out, "n": len(v)}


def device_name(device) -> str:
    device = _device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def run_suite(out_path=DEFAULT_OUT, device="auto", dims=None, iters=20,
              epochs=5, dim_inner=128):
    """The extended suite (the root bench.py:210-236) -> ``out_path``:
    SpMM fwd+bwd (COO and packed, f32; packed bf16), attention, and a
    train epoch of each of the four ID-GNN / ws paths.  Keys the port
    cannot fill are null, with the reason under 'null_reasons'."""
    dims = dims or (131072, 2_000_000, 128)
    n, e, d = dims
    details = {"device": device_name(device), "null_reasons": {}}
    for impl in ("xla", "pallas"):
        details[f"spmm_fwd_bwd_{impl}_edges_per_s"] = round(bench_spmm(
            n, e, d, iters, impl=impl, device=device)[0], 1)
    details["spmm_fwd_bwd_pallas_bf16_edges_per_s"] = round(bench_spmm(
        n, e, d, iters, impl="pallas", dtype="bfloat16",
        device=device)[0], 1)
    details["attention_fwd_bwd_edges_per_s"] = round(bench_attention(
        n, e, iters=iters, device=device), 1)
    reasons = details["null_reasons"]
    for layer in TRAIN_LAYERS:
        name = layer.replace("Tfg-", "")
        dt, eps = bench_train_epoch(layer, "pallas", epochs,
                                    device=device, dim_inner=dim_inner)
        details[f"{name}_ws_epoch_s_pallas"] = round(dt, 4)
        details[f"{name}_ws_train_edges_per_s_pallas"] = round(eps, 1)
    for key, why in (
            ("idgcn_ws_epoch_s_xla", "the COO layer path is not ported "
             "(ROADMAP A0)"),
            ("idgcn_ws_epoch_s_pallas_bf16", "tpu.dtype bfloat16 is not "
             "ported (ROADMAP A14)"),
            ("tu_enzymes_epoch_s_xla", "graph tasks and the TU loader are "
             "not ported (ROADMAP A13b)"),
            ("tu_enzymes_epoch_s_pallas", "graph tasks and the TU loader "
             "are not ported (ROADMAP A13b)")):
        details[key] = None
        reasons[key] = why
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(details, f, indent=1)
    return details


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=131072)
    p.add_argument("--edges", type=int, default=2_000_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    p.add_argument("--suite", action="store_true",
                   help="also run the extended suite -> --out")
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="where --suite writes its details")
    p.add_argument("--device", default="auto",
                   choices=["auto", "cuda", "cpu"])
    args = p.parse_args(argv)
    dims = (args.nodes, args.edges, args.dim)

    if args.suite:
        run_suite(args.out, args.device, dims, args.iters)
        print(f"bench: suite details in {args.out}", file=sys.stderr)

    # paired repeats per path, interleaved round-robin off warmed-up
    # steps, so drift of the host or the card shifts every path together
    # and shows up as IQR
    paths = {
        "main": spmm_step(*dims, args.impl, "float32", "fwd_bwd",
                          args.device),
        "fwd_only": spmm_step(*dims, args.impl, "float32", "fwd",
                              args.device),
        "xla_fwd_bwd": spmm_step(*dims, "xla", "float32", "fwd_bwd",
                                 args.device),
    }
    warm = {k: step(x0) for k, (step, x0) in paths.items()}
    for g in warm.values():
        g[:1].cpu()
    rates = {k: [] for k in paths}
    for _ in range(max(args.repeats, 1)):
        for k, (step, _) in paths.items():
            rates[k].append(_time_chain(step, warm[k], args.iters,
                                        args.edges))
    st = {k: _stats(v) for k, v in rates.items()}
    med = st["main"]["median"]
    line = {"metric": "spmm_fwd_bwd_edges_per_s_per_chip", "value": med,
            "unit": "edges/s", "median": med, "iqr": st["main"]["iqr"],
            "n": st["main"]["n"]}
    for k in ("fwd_only", "xla_fwd_bwd"):
        line[f"{k}_median"] = st[k]["median"]
        line[f"{k}_iqr"] = st[k]["iqr"]
    line["device"] = device_name(args.device)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
