"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device   — nvidia-smi name and power limit;
  2. build    — nvcc builds the kernels, one library per source
                (csrc/packed_spmm.cu, csrc/packed_segment.cu,
                csrc/packed_attention.cu, csrc/packed_sddmm.cu), side by
                side;
  ID-GCN Full / ws (configs/idgcn_ws.yaml), kernel K1:
  3. kernel   — at the shapes of the train batch (the real 'gcn' packs
                from the port's loader, D = 128): kernel vs its plain
                PyTorch version on the fwd and bwd packs, in float32 and
                bfloat16, bitwise-repeatable launches, the same bits as
                K3 at one head with alpha = the pack's weights (the row
                walk both run), and on both packs times of the kernel,
                the plain version, one library call (torch.sparse.mm on
                a CSR tensor of the same matrix) and the launch floor (an
                empty kernel over K1's grid) beside the bound, and of the
                kernel in bfloat16 on the fwd pack;
  4. model    — the full-width model's logits and gradients on the card
                against the same model on the CPU (plain versions), and
                then its eval-mode logits;
  5. train    — the config through graphgym_tpu_torch.main for a few
                epochs at full width (3 x 128, head 256): finite losses,
                6 K1 launches per train step plus 3 per eval batch, none
                at D = 1, no launch of another kernel;
  6. profile  — torch.profiler over a few more train steps: device time
                by kernel (and of the port's own kernels), the device's
                idle share, the peak of device memory and the widest
                tensor any op of a step takes.
  ID-GAT Full / ws (configs/idgat_ws.yaml), kernels K3 and the SDDMM:
  7. kernel_att  — at the real train 'att' pack (D = 128, H = 1) with a
                   softmax'd random alpha: kernel vs plain on the fwd
                   pack and, alpha carried by the slot map, the bwd pack,
                   in float32 (a warp a row) and bfloat16 (a half-warp),
                   and at H = 4 (dv = 32); bitwise-repeatable launches;
                   kernel, plain and library (torch.sparse.mm, CSR of
                   alpha) times beside the bound at H = 1 and 4;
  8. kernel_sddmm — at the real train 'att' fwd pack, D = 128: the SDDMM
                   against its plain version in float32 and bfloat16, at
                   H = 1 and 4, exact 0 on every slot of pack weight 0,
                   bitwise-repeatable launches; kernel, plain and library
                   (torch.sparse.sampled_addmm on a CSR of the valid
                   slots, H = 1) times beside the bound;
  9. model_att   — as 4, for the full-width Tfg-idgat model;
 10. train_att   — as 5: 12 K3 launches (forward, dv, dq, dk per layer)
                   and 6 SDDMM launches (score, dalpha) per train step,
                   3 of each per eval batch, no K1 or K2 launch;
 11. profile_att — as 6, no op taking a tensor as wide as [E, D] (E the
                   pack's slots), and whether two train steps from the
                   same state give bitwise-equal losses and parameters.
  ID-GIN Full / ws (configs/idgin_ws.yaml), kernel K1 on the 'plain'
  pack:
 12. kernel_gin  — as 3, at the train 'plain' packs, D = 128 and D = 1
                   (layer 0 aggregates the raw 1-wide features: K1's
                   narrow walk, a thread a row);
 13. model_gin   — as 4 (the GIN MLP's BatchNorm in train mode), the
                   running statistics after it and the eval-mode logits
                   that use them, on seeded random features (see
                   check_model);
 14. train_gin   — as 5: 5 K1 launches per train step (layer 0's input
                   needs no gradient) plus 3 per eval batch, one of each
                   at D = 1, no other;
 15. profile_gin — as 6.
  ID-SAGE Full / ws (configs/idsage_ws.yaml), K1 on the 'mean' pack:
 16. kernel_sage — as 3, at the train 'mean' packs, D = 1;
 17. model_sage, 18. train_sage, 19. profile_sage — as 13, 14 and 15.
  Kernel K2, which no path runs:
 20. kernel_seg  — at the train 'plain' fwd pack of ID-GIN, D = 128: K2
                   against its plain version with a random message on
                   every slot (padding slots included), against K1 with
                   msg = x[senders] * w, in bfloat16, on a pack built
                   with group G = 2; bitwise-repeatable launches;
                   segment_matmul_vjp's gradient against the plain
                   version's; kernel, plain and library (index_add_,
                   torch.sparse.mm of the 0/1 slot matrix) times beside
                   the bound.
Then the kernel table as one JSON line (K1 twice: D = 128 and D = 1),
and last the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
             "False); this script runs the port on the card only")

from graphgym_tpu_torch.config import load_cfg  # noqa: E402
from graphgym_tpu_torch.data.loaders import (create_dataset,  # noqa: E402
                                             create_loader)
from graphgym_tpu_torch.device import resolve_device  # noqa: E402
from graphgym_tpu_torch.main import run_single  # noqa: E402
from graphgym_tpu_torch.nn.model import build_model  # noqa: E402
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K  # noqa: E402
from graphgym_tpu_torch.ops.segment import segment_softmax  # noqa: E402
from graphgym_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from graphgym_tpu_torch.train.loop import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "configs", "idgcn_ws.yaml")
CFG_ATT = os.path.join(ROOT, "configs", "idgat_ws.yaml")
CFG_GIN = os.path.join(ROOT, "configs", "idgin_ws.yaml")
CFG_SAGE = os.path.join(ROOT, "configs", "idsage_ws.yaml")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
EPOCHS = 5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
F32_TOL = dict(rtol=1e-5, atol=1e-6)    # only the sum order differs
BF16_TOL = dict(rtol=1e-2, atol=1e-3)   # one bf16 ulp after the f32 sum
# K2 sums up to 41,286 messages into one row: two f32 sums in different
# orders differ by a share of the row's sum of |msg|, not of its value
SEG_REL, SEG_ATOL = 1e-5, 1e-6


def fail(msg: str) -> None:
    sys.exit(f"chip_smoke: FAILED: {msg}")


def phase(name: str, **kw) -> None:
    print(json.dumps({"phase": name, **kw}), flush=True)


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Wall time per call of a loop of calls, by CUDA events: the device
    time, or the host's launch time where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def profile_events(fn, iters: int = 20):
    """torch.profiler's per-name averages over iters calls of fn, after
    three calls of warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def device_ms_by_kernel(fn, iters: int = 20, events=None) -> dict:
    """Device time per call of each kernel fn launches (torch.profiler;
    annotation ranges excluded, they would count their kernels twice)."""
    events = events if events is not None else profile_events(fn, iters)
    return {ev.key: ev.self_device_time_total / iters / 1e3
            for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)}


def host_ms_by_op(events, iters: int) -> dict:
    """Host time per call of fn in each operator's own code (self CPU
    time, torch.profiler), and its calls per call of fn."""
    return {ev.key: (ev.self_cpu_time_total / iters / 1e3, ev.count / iters)
            for ev in events
            if ev.device_type == torch.autograd.DeviceType.CPU
            and not getattr(ev, "is_user_annotation", False)}


def device_ms(fn, iters: int = 20) -> float:
    return sum(device_ms_by_kernel(fn, iters).values())


def time_calls(calls: dict, bound_ms: float):
    """Device ms per call of each fn (torch.profiler), its CUDA-event
    loop time, and which of the two the device ms is.  Where the
    profiler's time is below ``bound_ms``, the least time the card could
    take for the call's work, it missed some of the call's kernels (it
    records none of some calls, and part of torch.sparse.mm's), and the
    device ms is the loop time."""
    loop = {k: call_ms(f) for k, f in calls.items()}
    ms, timed_by = {}, {}
    for k, f in calls.items():
        t = device_ms(f)
        ms[k], timed_by[k] = ((t, "profiler") if t >= bound_ms
                              else (loop[k], "events"))
    return ms, loop, timed_by


def csr_of(pack: K.PackedCSR, n: int, values=None) -> torch.Tensor:
    """The pack's matrix (or, given per-slot values, that matrix) as a
    torch CSR tensor (padding slots dropped)."""
    rows = K.pack_rows(pack).reshape(-1)
    cols = pack.senders.long().reshape(-1)
    vals = (pack.weights if values is None else values).reshape(-1)
    keep = cols < n
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep], (n, n)).coalesce()
    return coo.to_sparse_csr()


def k1_floor(pack: K.PackedCSR, x: torch.Tensor, out: torch.Tensor):
    """The launch floor under K1 (csrc/packed_spmm.cu,
    packed_spmm_floor_*): an empty kernel over the grid K1 takes for
    these arguments, launched as its wrapper launches K1.  Counts no
    launch of K1."""
    suffix = "f32" if x.dtype == torch.float32 else "bf16"
    fn = getattr(K.library("packed_spmm"), f"packed_spmm_floor_{suffix}")
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    args = (x.data_ptr(), x.shape[0], x.shape[1], pack.senders.data_ptr(),
            pack.weights.data_ptr(), pack.row_range.data_ptr(),
            out.data_ptr())

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            fail(f"K1 floor launch: CUDA error {err}")
    return launch


def check_kernel(packs, n: int, d: int, device) -> dict:
    """K1 against its plain version on the fwd and bwd packs, f32 and
    bf16; bitwise-repeatable launches; the same bits as K3 at one head
    with alpha = the pack's weights (the walk both run); times of the
    kernel, the plain version, the library call and the launch floor on
    both packs, and of the kernel in bf16 on the fwd pack."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, d, generator=gen, device=device)
    fwd, bwd = packs
    errs = {}
    for name, pack in (("fwd", fwd), ("bwd", bwd)):
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            xin = x.to(dtype)
            got = K.spmm_packed(pack, xin)
            want = K.spmm_packed_plain(pack, xin)
            torch.cuda.synchronize()
            if got.shape != (n, d) or not torch.isfinite(got).all():
                fail(f"{name}/{dtype}: bad output {tuple(got.shape)}")
            if not torch.allclose(got.float(), want.float(), **tol):
                err = (got.float() - want.float()).abs().max().item()
                fail(f"{name}/{dtype}: kernel vs plain max err {err} "
                     f"beyond {tol}")
            errs[f"{name}_{str(dtype)[6:]}"] = (
                got.float() - want.float()).abs().max().item()
            again = K.spmm_packed(pack, xin)
            if not torch.equal(got, again):
                fail(f"{name}/{dtype}: two launches differ")
            if not torch.equal(K.packed_spmm_cuda(pack, xin),
                               K.packed_segment_matmul_headed_cuda(
                                   pack, xin, pack.weights[..., None])):
                fail(f"{name}/{dtype}: K1 differs from K3 at one head "
                     "with alpha = the pack's weights")
    out = {}
    for name, pack in (("fwd", fwd), ("bwd", bwd)):
        a = csr_of(pack, n)
        lib_err = (torch.sparse.mm(a, x)
                   - K.spmm_packed(pack, x)).abs().max().item()
        calls = {"kernel": lambda: K.packed_spmm_cuda(pack, x),
                 "plain": lambda: K.spmm_packed_plain(pack, x),
                 "library": lambda: torch.sparse.mm(a, x)}
        out[name] = dict(library_err=lib_err,
                         **timings(calls, pack, x, slot_bytes=8),
                         **floor_timings(pack, x))
    xb = x.bfloat16()
    bf16 = timings({"kernel": lambda: K.packed_spmm_cuda(fwd, xb)}, fwd,
                   xb, slot_bytes=8)
    return dict(width=d,
                max_abs_err=max(errs["fwd_float32"], errs["bwd_float32"]),
                errs=errs, **out["fwd"], bwd=out["bwd"],
                bf16={k: bf16[k] for k in ("ms", "call_ms", "timed_by",
                                           "bound_ms", "bytes")})


def floor_timings(pack: K.PackedCSR, x: torch.Tensor) -> dict:
    """The launch floor's device ms per call (the profiler; its CUDA-event
    loop time where the profiler records none) and its loop time."""
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    ms, loop_ms, timed_by = time_calls({"floor": k1_floor(pack, x, out)},
                                       bound_ms=1e-9)
    return dict(floor_ms=ms["floor"], floor_call_ms=loop_ms["floor"],
                floor_timed_by=timed_by["floor"])


def timings(calls: dict, pack: K.PackedCSR, x: torch.Tensor,
            slot_bytes: int) -> dict:
    """Device ms per call of the kernel and, where given, the plain
    version and the library call, their CUDA-event loop times, and the
    bound: each input read once (x, the pack's slot_bytes on each slot
    the kernel reads, row_range), the f32 output written once, over the
    card's memory rate, against 2 flops per slot and column over its f32
    rate."""
    n, d = x.shape
    ranges = pack.row_range.long()
    real_slots = int((ranges[:, 1] - ranges[:, 0]).sum().item())
    moved = (x.numel() * x.element_size()        # x read once
             + real_slots * slot_bytes
             + pack.row_range.numel() * 4
             + n * d * 4)                         # out written once
    flops = 2 * real_slots * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    ms, loop_ms, timed_by = time_calls(calls, bound_ms)
    return dict(ms=ms["kernel"], plain_ms=ms.get("plain"),
                library_ms=ms.get("library"), call_ms=loop_ms,
                timed_by=timed_by, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved, flops=flops, slots=pack.senders.numel(),
                real_slots=real_slots)


def check_attention_kernel(packs, n: int, d: int, device) -> dict:
    """K3 against its plain version at the train 'att' pack: alpha is a
    segment softmax of random logits over the valid slots, as the layer
    makes it; the bwd pack takes it through the slot map."""
    fwd, bwd, slot_map = packs
    gen = torch.Generator(device=device).manual_seed(1)
    v = torch.randn(n, d, generator=gen, device=device)
    rows = K.pack_rows(fwd).reshape(-1)
    valid = (fwd.weights > 0).reshape(-1, 1)

    def softmax_alpha(heads):
        logits = torch.randn(rows.numel(), heads, generator=gen,
                             device=device)
        alpha = segment_softmax(logits, rows, n,
                                mask=valid.expand(-1, heads))
        return alpha.view(fwd.senders.shape + (heads,))

    k3 = K.packed_segment_matmul_headed_cuda
    alphas = {heads: softmax_alpha(heads) for heads in (1, 4)}
    errs = {}
    for heads, alpha in alphas.items():
        for name, pack, a in (("fwd", fwd, alpha),
                              ("bwd", bwd, K.alpha_to_bwd(alpha,
                                                          slot_map))):
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                vin = v.to(dtype)
                got = K.packed_segment_matmul_headed(pack, vin, a)
                want = K.packed_segment_matmul_headed_plain(pack, vin, a)
                torch.cuda.synchronize()
                case = f"{name}_h{heads}_{str(dtype)[6:]}"
                if got.shape != (n, d) or not torch.isfinite(got).all():
                    fail(f"K3 {case}: bad output {tuple(got.shape)}")
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, **tol):
                    fail(f"K3 {case}: kernel vs plain max err {err} "
                         f"beyond {tol}")
                errs[case] = err
                if not torch.equal(
                        got, K.packed_segment_matmul_headed(pack, vin, a)):
                    fail(f"K3 {case}: two launches differ")
    alpha1 = alphas[1]
    a = csr_of(fwd, n, alpha1[..., 0])
    lib_err = (torch.sparse.mm(a, v)
               - K.packed_segment_matmul_headed(fwd, v, alpha1)).abs().max()
    calls = {
        "kernel": lambda: k3(fwd, v, alpha1),
        "plain": lambda: K.packed_segment_matmul_headed_plain(fwd, v,
                                                              alpha1),
        "library": lambda: torch.sparse.mm(a, v)}
    alpha4 = alphas[4]
    calls4 = {
        "kernel": lambda: k3(fwd, v, alpha4),
        "plain": lambda: K.packed_segment_matmul_headed_plain(fwd, v,
                                                              alpha4)}
    return dict(max_abs_err=max(e for k, e in errs.items()
                                if k.endswith("float32")),
                errs=errs, library_err=lib_err.item(),
                **timings(calls, fwd, v, slot_bytes=8),  # sender, alpha
                h4=timings(calls4, fwd, v, slot_bytes=4 + 4 * 4))


def check_sddmm_kernel(pack: K.PackedCSR, n: int, d: int, device) -> dict:
    """The SDDMM at the train 'att' fwd pack against its plain version:
    f32 and bf16, H = 1 and 4, within SEG_REL of the slot's sum of
    |a * b| products (two f32 sums of 128 products in different orders),
    exact 0 on every slot of pack weight 0, bitwise repeats; times at
    H = 1 and 4 and, at H = 1, torch.sparse.sampled_addmm on a CSR of the
    valid slots."""
    gen = torch.Generator(device=device).manual_seed(4)
    sddmm = K.packed_sddmm_cuda
    zero_w = pack.weights == 0
    errs, inputs = {}, {}
    for heads in (1, 4):
        a, b = (torch.randn(n, heads, d // heads, generator=gen,
                            device=device) for _ in range(2))
        inputs[heads] = (a, b)
        for dtype in (torch.float32, torch.bfloat16):
            case = f"h{heads}_{str(dtype)[6:]}"
            ai, bi = a.to(dtype), b.to(dtype)
            got = K.packed_sddmm(pack, ai, bi)
            want = K.packed_sddmm_plain(pack, ai, bi)
            scale = K.packed_sddmm_plain(pack, ai.float().abs(),
                                         bi.float().abs())
            torch.cuda.synchronize()
            if got.shape != pack.senders.shape + (heads,) \
                    or not torch.isfinite(got).all():
                fail(f"SDDMM {case}: bad output {tuple(got.shape)}")
            err = (got - want).abs()
            if (err > SEG_REL * scale + SEG_ATOL).any():
                fail(f"SDDMM {case}: max err {err.max().item()} beyond "
                     f"{SEG_REL} x sum|a*b| + {SEG_ATOL}")
            if (got[zero_w] != 0).any():
                fail(f"SDDMM {case}: a slot of pack weight 0 is not 0")
            errs[case] = err.max().item()
            if not torch.equal(got, K.packed_sddmm(pack, ai, bi)):
                fail(f"SDDMM {case}: two launches differ")

    def bound(heads, real_slots):
        moved = (2 * n * d * 4                      # a and b read once
                 + real_slots * 8                   # sender, weight
                 + pack.row_range.numel() * 4
                 + pack.senders.numel() * heads * 4)  # out written once
        flops = 2 * real_slots * d
        t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=moved, flops=flops)

    ranges = pack.row_range.long()
    real_slots = int((ranges[:, 1] - ranges[:, 0]).sum().item())
    # the library call: the valid slots as a CSR pattern, H = 1
    live = (pack.weights > 0).reshape(-1)
    rows = K.pack_rows(pack).reshape(-1)[live]
    cols = pack.senders.reshape(-1)[live].long()
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), torch.ones(rows.numel(), device=device),
        (n, n)).coalesce().to_sparse_csr()
    a1, b1 = (t[:, 0] for t in inputs[1])
    b1t = b1.t()

    def library():
        return torch.sparse.sampled_addmm(csr, a1, b1t, beta=0.0)

    lib = library().values()
    kern = K.packed_sddmm(pack, *inputs[1]).reshape(-1)[live]
    # the CSR holds the valid slots in slot order (rows, then senders,
    # ascending) unless an edge repeats
    lib_err = ((lib - kern).abs().max().item()
               if lib.numel() == kern.numel() else None)
    out = {}
    for heads in (1, 4):
        a, b = inputs[heads]
        calls = {"kernel": lambda: sddmm(pack, a, b),
                 "plain": lambda: K.packed_sddmm_plain(pack, a, b)}
        if heads == 1:
            calls["library"] = library
        bd = bound(heads, real_slots)
        ms, loop_ms, timed_by = time_calls(calls, bd["bound_ms"])
        out[f"h{heads}"] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                                library_ms=ms.get("library"),
                                call_ms=loop_ms, timed_by=timed_by, **bd)
    return dict(max_abs_err=max(e for k, e in errs.items()
                                if k.endswith("float32")),
                errs=errs, library_err=lib_err, slots=pack.senders.numel(),
                real_slots=real_slots, csr_nnz=csr.values().numel(),
                **out["h1"], h4=out["h4"])


def hold_sums(case: str, got: torch.Tensor, want: torch.Tensor,
              scale: torch.Tensor) -> float:
    """K2 against a reference sum of the same messages:
    |got - want| <= SEG_REL * (the row's sum of |msg|) + SEG_ATOL."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"K2 {case}: bad output {tuple(got.shape)}")
    err = (got - want).abs()
    excess = (err - SEG_REL * scale - SEG_ATOL).max().item()
    if excess > 0:
        fail(f"K2 {case}: max err {err.max().item()} beyond "
             f"{SEG_REL} x sum|msg| + {SEG_ATOL} (by {excess})")
    return err.max().item()


def check_segment_kernel(host_batch, pack: K.PackedCSR, n: int, d: int,
                         device) -> dict:
    """K2 at the train 'plain' fwd pack: against its plain version with
    a random message on every slot, against K1 with msg = x[senders] *
    w, in bf16, on a pack built with G = 2; bitwise repeats; the vjp's
    gradient; times.  Returns the launches of the checks (the timing
    loops not counted)."""
    K.packed_segment_matmul_cuda.launches = 0
    gen = torch.Generator(device=device).manual_seed(2)
    local, tiles = pack.local_rows, pack.tiles
    nt = K.num_tiles_of(n)
    t0 = time.perf_counter()
    runs = K.segment_runs_host(local.cpu().numpy(), tiles.cpu().numpy(), nt)
    index_s = time.perf_counter() - t0

    def seg(m, loc=local, til=tiles, group=1):
        return K.packed_segment_matmul(m, loc, til, nt, group=group)

    def plain(m, loc=local, til=tiles):
        return K.packed_segment_matmul_plain(m, loc, til, nt)

    errs = {}
    msg = torch.randn(pack.senders.shape + (d,), generator=gen,
                      device=device)
    scale = plain(msg.abs())
    got = seg(msg)
    errs["random_f32"] = hold_sums("random f32", got, plain(msg), scale)
    if not torch.equal(got, seg(msg)):
        fail("K2 f32: two launches differ")
    # every slot counts: zeroing the padding slots' messages changes rows
    real = (pack.senders < n)[..., None]
    if torch.equal(got, seg(msg * real)):
        fail("K2: the padding slots' messages were not summed")
    # against K1 on the same pack: msg = x[senders] * w
    x = torch.randn(n, d, generator=gen, device=device)
    xp = torch.cat([x, x.new_zeros(1, d)])
    wmsg = (xp.index_select(0, pack.senders.reshape(-1).long())
            .view(msg.shape) * pack.weights[..., None])
    errs["vs_k1"] = hold_sums("vs K1", seg(wmsg)[:n], K.spmm_packed(pack, x),
                              plain(wmsg.abs())[:n])
    # bf16 messages, f32 sums
    mb = msg.bfloat16()
    got = seg(mb)
    errs["random_bf16"] = hold_sums("random bf16", got, plain(mb),
                                    plain(mb.float().abs()))
    if not torch.equal(got, seg(mb)):
        fail("K2 bf16: two launches differ")
    # a pack built with group G = 2 from the same edges ('plain': raw A)
    p2 = K.pack_csr(host_batch.senders, host_batch.receivers,
                    host_batch.edge_weight, n, group=2)
    loc2, til2 = (torch.from_numpy(a).to(device)
                  for a in (p2.local_rows, p2.tiles))
    m2 = torch.randn(p2.senders.shape + (d,), generator=gen, device=device)
    got = seg(m2, loc2, til2, group=2)
    errs["group2_f32"] = hold_sums("G = 2", got, plain(m2, loc2, til2),
                                   plain(m2.abs(), loc2, til2))
    if not torch.equal(got, seg(m2, loc2, til2, group=2)):
        fail("K2 G = 2: two launches differ")
    # segment_matmul_vjp: forward by K2, d_msg = g[rows]; the plain
    # version's autograd gives the same gather (n is a whole number of
    # tiles here, so the clamp does not act)
    g = torch.randn(n, d, generator=gen, device=device)
    grads = []
    for fn in (lambda m: K.segment_matmul_vjp(m, local, tiles, n),
               lambda m: plain(m)[:n]):
        mr = msg.clone().requires_grad_(True)
        out = fn(mr)
        out.backward(g)
        grads.append((out.detach(), mr.grad))
    (out_k, d_k), (out_p, d_p) = grads
    errs["vjp_fwd"] = hold_sums("vjp forward", out_k, out_p, scale[:n])
    if not torch.equal(d_k, d_p):
        fail(f"K2 vjp: d_msg differs from the plain version's by "
             f"{(d_k - d_p).abs().max().item()}")
    torch.cuda.synchronize()
    launches = K.packed_segment_matmul_cuda.launches

    # times at f32: kernel, plain, and two library calls for the same
    # function (atomic index_add_; a 0/1 CSR [rows, slots] times msg)
    rows = K.slot_rows(local, tiles).reshape(-1)
    flat = msg.view(-1, d)
    out_lib = torch.zeros(nt * K.ROWS_PER_TILE, d, device=device)
    ones = torch.sparse_coo_tensor(
        torch.stack([rows, torch.arange(rows.numel(), device=device)]),
        torch.ones(rows.numel(), device=device),
        (nt * K.ROWS_PER_TILE, rows.numel())).coalesce().to_sparse_csr()
    lib_err = (torch.sparse.mm(ones, flat) - seg(msg)).abs().max().item()
    calls = {"kernel": lambda: K.packed_segment_matmul_cuda(msg, local,
                                                            tiles, nt),
             "plain": lambda: plain(msg),
             "index_add": lambda: out_lib.index_add_(0, rows, flat),
             "sparse_mm": lambda: torch.sparse.mm(ones, flat)}
    moved = (msg.numel() * msg.element_size()        # every slot once
             + (local.numel() + tiles.numel()) * 4     # the pack ints
             + nt * K.ROWS_PER_TILE * d * 4)           # out written once
    flops = msg.numel()                                # one add each
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    ms, loop_ms, timed_by = time_calls(calls, max(t_bytes, t_ops) * 1e3)
    library = min(("index_add", "sparse_mm"), key=ms.get)
    return dict(max_abs_err=errs["random_f32"], errs=errs, launches=launches,
                library_err=lib_err, ms=ms["kernel"], plain_ms=ms["plain"],
                library_ms=ms[library], library=library,
                index_add_ms=ms["index_add"], sparse_mm_ms=ms["sparse_mm"],
                call_ms=loop_ms, timed_by=timed_by,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=moved, flops=flops, slots=rows.numel(),
                runs=len(runs.run_out), partials=runs.num_partials,
                combined_rows=len(runs.comb_rows),
                longest_row_slots=int(np.bincount(
                    rows.cpu().numpy()).max()),
                index_build_s=index_s)


def check_model(cfg, batch, device, random_features: bool = False
                ) -> dict:
    """Full-width logits, gradients and BatchNorm running statistics,
    card (kernel) vs CPU (plain), and then the eval-mode logits (which
    read those running statistics).  ``random_features`` replaces the
    batch's features with seeded normal ones: ws's are a constant 1, on
    which ID-GIN's layer-0 id MLP sees nearly the same row at every ego
    center, so its BatchNorm normalizes rounding noise and its gradients
    differ between any two f32 summation orders (on the CPU, f32 against
    float64 by more than their own size); with random features every
    gradient holds at the tolerance below."""
    if random_features:
        gen = torch.Generator().manual_seed(3)
        batch = batch.replace(node_feat=torch.randn(
            batch.node_feat.shape, generator=gen).numpy()
            * batch.node_mask[:, None])
    model = build_model(cfg, device)
    ref = build_model(cfg, torch.device("cpu"))
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    outs = []
    for m, b in ((model, batch.to(device)),
                 (ref, batch.to(torch.device("cpu")))):
        pred, label, mask = m(b)
        loss = torch.nn.functional.cross_entropy(pred[mask], label[mask])
        loss.backward()
        m.eval()
        with torch.no_grad():
            pred_eval = m(b)[0]
        outs.append((pred.detach().cpu(),
                     {k: p.grad.cpu() for k, p in m.named_parameters()},
                     {k: v.cpu() for k, v in m.named_buffers()},
                     pred_eval.cpu()))
    (p_gpu, g_gpu, b_gpu, e_gpu), (p_cpu, g_cpu, b_cpu, e_cpu) = outs
    buf_err = 0.0
    for k in b_cpu:       # BatchNorm running statistics after the step
        if not torch.allclose(b_gpu[k], b_cpu[k], rtol=1e-4, atol=1e-5):
            fail(f"buffer {k} card vs CPU: max err "
                 f"{(b_gpu[k] - b_cpu[k]).abs().max().item()}")
        buf_err = max(buf_err, (b_gpu[k] - b_cpu[k]).abs().max().item())
    for name, got, want in (("train", p_gpu, p_cpu), ("eval", e_gpu, e_cpu)):
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            fail(f"model {name}-mode logits card vs CPU: max err "
                 f"{(got - want).abs().max().item()}")
    worst = 0.0
    for k in g_cpu:
        if not torch.allclose(g_gpu[k], g_cpu[k], rtol=1e-3, atol=1e-5):
            fail(f"gradient {k} card vs CPU: max err "
                 f"{(g_gpu[k] - g_cpu[k]).abs().max().item()}")
        worst = max(worst, (g_gpu[k] - g_cpu[k]).abs().max().item())
    return dict(logits_max_err=(p_gpu - p_cpu).abs().max().item(),
                eval_logits_max_err=(e_gpu - e_cpu).abs().max().item(),
                grad_max_err=worst, buffers=len(b_cpu),
                buffers_max_err=buf_err)


def widest_op_inputs(fn, top: int = 5) -> list:
    """The ops of one call of fn (forward and backward) whose widest
    tensor argument has the most elements (torch.profiler with shapes)."""
    from torch.profiler import ProfilerActivity, profile

    def numel(shape) -> int:
        if isinstance(shape, (list, tuple)) and shape and all(
                isinstance(x, int) for x in shape):
            return math.prod(shape)
        if isinstance(shape, (list, tuple)):
            return max((numel(x) for x in shape), default=0)
        return 0

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) \
            as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for ev in prof.events():
        widest = max((numel(sh) for sh in ev.input_shapes or []), default=0)
        if widest > ops.get(ev.name, (0, None))[0]:
            ops[ev.name] = (widest, ev.input_shapes)
    ranked = sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]
    return [dict(op=name, numel=w, shapes=str(sh)[:160])
            for name, (w, sh) in ranked]


def profile_steps(cfg, loaders, device, steps: int = 5,
                  forbid_numel: int = 0) -> dict:
    """Device time by kernel over a few train steps (torch.profiler),
    the device's busy share of the step's wall time, the peak of device
    memory over the steps, the host time in operators' own code (the
    rest of the host's step is Python and the launch path), and the ops
    with the widest tensor arguments; with ``forbid_numel``, fails if an
    op takes a tensor that large."""
    trainer = Trainer(build_model(cfg, device), loaders, cfg, device)
    batch = trainer._place(loaders[0].batches(0)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(device)
    events = profile_events(lambda: trainer.train_step(batch), steps)
    by_kernel = device_ms_by_kernel(None, steps, events)
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the port's own kernels (csrc/): row_walk_* runs K1 and K3
    own = sorted((kv for kv in by_kernel.items()
                  if "row_walk" in kv[0] or "packed_" in kv[0]),
                 key=lambda kv: -kv[1])
    by_op = host_ms_by_op(events, steps)
    host_top = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:8]
    widest = widest_op_inputs(lambda: trainer.train_step(batch))
    if forbid_numel and widest[0]["numel"] >= forbid_numel:
        fail(f"an op of the train step takes a tensor of "
             f"{widest[0]['numel']} elements (>= {forbid_numel}): "
             f"{widest[0]}")
    return dict(step_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
                peak_memory_bytes=peak,
                top=[dict(name=k[:80], ms_per_step=v) for k, v in top],
                port_kernels=[dict(name=k[:80], ms_per_step=v)
                              for k, v in own],
                host_ops_ms=sum(ms for ms, _ in by_op.values()),
                host_op_calls=sum(c for _, c in by_op.values()),
                host_top=[dict(name=k[:60], ms_per_step=ms,
                               calls_per_step=c)
                          for k, (ms, c) in host_top],
                widest_op_inputs=widest)


def repeat_steps(cfg, loaders, device, steps: int = 3) -> dict:
    """Two trainers from the same seed on the same batch: are their
    losses, step for step, and their parameters after the last step
    bitwise equal?  (The kernels are; index_add_ on the card adds with
    atomics in no fixed order.)"""
    runs = []
    for _ in range(2):
        trainer = Trainer(build_model(cfg, device), loaders, cfg, device)
        batch = trainer._place(loaders[0].batches(0)[0])
        losses = [trainer.train_step(batch)[0].item() for _ in range(steps)]
        runs.append((losses, [p.detach().clone()
                              for p in trainer.model.parameters()]))
    (l0, p0), (l1, p1) = runs
    return dict(losses=[l0, l1], losses_bitwise_equal=l0 == l1,
                params_bitwise_equal=all(map(torch.equal, p0, p1)),
                params_max_abs_diff=max((a - b).abs().max().item()
                                        for a, b in zip(p0, p1)))


def ptxas_report(log: str) -> list:
    """Registers and spills of each kernel from nvcc's -Xptxas -v output:
    one line per entry function, its (mangled) name first."""
    out, fn = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln.strip()
        elif fn and "spill" in ln:
            out.append(f"{fn}: {ln.strip()}")
        elif fn and "registers" in ln and out:
            out[-1] += "; " + ln.split(":", 1)[-1].strip()
    return out


def read_stats(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def kernels() -> tuple:
    """Every kernel wrapper of the port (each counts its launches)."""
    return (K.packed_spmm_cuda, K.packed_segment_matmul_cuda,
            K.packed_segment_matmul_headed_cuda, K.packed_sddmm_cuda)


def train_path(cfg_file: str, overrides, out: str, loaders,
               expected: dict, k1_narrow=(0, 0)) -> dict:
    """Drive graphgym_tpu_torch.main's run_single on one config, loaded
    afresh (its data pipeline writes label bins into the cfg): every
    launch count set to 0 just before, read just after.  ``expected``
    maps a kernel wrapper to its launches (per train step, per eval
    batch), ``loaders`` give the batch counts; every other kernel must
    not launch.  ``k1_narrow`` is the share of K1's launches at D = 1
    (its narrow walk), per train step and per eval batch."""
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_cfg(cfg_file, overrides + ["out_dir", out])
    epochs = cfg.optim.max_epoch
    steps = epochs * len(loaders[0])
    evals = sum(ckpt.is_eval_epoch(e, cfg.train.eval_period, epochs)
                for e in range(epochs)) * len(loaders[1])
    want = {k.__name__: expected.get(k, (0, 0)) for k in kernels()}
    for k in kernels():
        k.launches = 0
    K.packed_spmm_cuda.launches_by_width.clear()
    result = run_single(cfg, cfg.out_dir, cfg_file)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels()}
    k1_by_width = dict(K.packed_spmm_cuda.launches_by_width)
    train = read_stats(os.path.join(cfg.out_dir, "train", "stats.json"))
    val = read_stats(os.path.join(cfg.out_dir, "val", "stats.json"))
    losses = [s["loss"] for s in train]
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        fail(f"{cfg_file}: train losses {losses}")
    for name, (per_step, per_eval) in want.items():
        total = per_step * steps + per_eval * evals
        if launches[name] != total:
            fail(f"{cfg_file}: {name} launches {launches[name]}, expected "
                 f"{total} ({per_step}/train step x {steps} + "
                 f"{per_eval}/eval batch x {evals})")
    narrow = k1_narrow[0] * steps + k1_narrow[1] * evals
    if k1_by_width.get(1, 0) != narrow:
        fail(f"{cfg_file}: K1 launches at D = 1 {k1_by_width.get(1, 0)}, "
             f"expected {narrow} ({k1_narrow[0]}/train step, "
             f"{k1_narrow[1]}/eval batch)")
    accs = [s["accuracy"] for s in val]
    if not all(0.0 <= a <= 1.0 for a in accs):
        fail(f"{cfg_file}: val accuracies {accs}")
    step_s = [s["time_iter"] for s in train]
    return dict(epochs=epochs, losses=losses, val_acc=accs,
                best_val_acc=result["best_val_acc"], step_s=step_s,
                step_s_median_after_first=float(np.median(step_s[1:])),
                launches=launches, k1_launches_by_width=k1_by_width,
                launches_per_train_step_and_eval_batch=want,
                params=cfg.params)


def load_path(cfg_file: str, overrides):
    """The config, its loaders, and the host time to build them (load,
    labels, split, ego union, collate, packs)."""
    cfg = load_cfg(cfg_file, overrides)
    t0 = time.perf_counter()
    loaders = create_loader(create_dataset(cfg), cfg)
    loaders[0].batches(0)
    return cfg, loaders, time.perf_counter() - t0


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    phase("device", kind=kind, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    info = K.build()
    for name in K.SOURCES:
        K.library(name)
    phase("build", seconds=max(b.seconds for b in info.values()),
          ptxas={name: ptxas_report(b.log) for name, b in info.items()})

    overrides = ["device", "cuda", "optim.max_epoch", str(EPOCHS),
                 "train.eval_period", "1"]

    k1_, k3_, sddmm_ = (K.packed_spmm_cuda,
                        K.packed_segment_matmul_headed_cuda,
                        K.packed_sddmm_cuda)

    # ---- ID-GCN Full / ws: kernel K1
    cfg, loaders, host_s = load_path(CFG, overrides)
    train_batch = loaders[0].batches(0)[0]
    n, d = train_batch.num_nodes, cfg.gnn.dim_inner
    dev_batch = train_batch.to(device)
    k1 = check_kernel(dev_batch.packs["gcn"], n, d, device)
    phase("kernel", n=n, d=d, chunks=int(dev_batch.packs["gcn"][0]
                                         .senders.shape[0]),
          host_data_s=host_s, **k1)
    phase("model", **check_model(cfg, loaders[1].batches(0)[0], device))
    # every layer's SpMM input (x W) needs a gradient: 2 per layer
    train = train_path(CFG, overrides, os.path.join(OUT, "idgcn"), loaders,
                       {k1_: (6, 3)})
    phase("train", **train)
    phase("profile", **profile_steps(cfg, loaders, device))

    # ---- ID-GAT Full / ws: kernels K3 and the SDDMM
    cfg, loaders, host_s = load_path(CFG_ATT, overrides)
    train_batch = loaders[0].batches(0)[0]
    n, d = train_batch.num_nodes, cfg.gnn.dim_inner
    dev_batch = train_batch.to(device)
    att_packs = dev_batch.packs["att"]
    k3 = check_attention_kernel(att_packs, n, d, device)
    phase("kernel_att", n=n, d=d, heads=cfg.gnn.att_heads,
          chunks=int(att_packs[0].senders.shape[0]), host_data_s=host_s,
          **k3)
    sddmm = check_sddmm_kernel(att_packs[0], n, d, device)
    phase("kernel_sddmm", n=n, d=d, **sddmm)
    phase("model_att", **check_model(cfg, loaders[1].batches(0)[0],
                                     device))
    # per layer: K3 forward, dv, dq, dk; SDDMM score, dalpha (layer 0's
    # Wq, Wk, Wv train too); an eval batch runs the forwards
    train_att = train_path(CFG_ATT, overrides, os.path.join(OUT, "idgat"),
                           loaders, {k3_: (12, 3), sddmm_: (6, 3)})
    phase("train_att", **train_att)
    phase("profile_att", **profile_steps(
        cfg, loaders, device, forbid_numel=att_packs[0].senders.numel() * d),
        repeat=repeat_steps(cfg, loaders, device))

    # ---- ID-GIN Full / ws: kernel K1 on the 'plain' pack
    cfg, loaders, host_s = load_path(CFG_GIN, overrides)
    gin_batch = loaders[0].batches(0)[0]
    n, d = gin_batch.num_nodes, cfg.gnn.dim_inner
    plain_packs = gin_batch.to(device).packs["plain"]
    d_in = gin_batch.node_feat.shape[1]
    k1_gin = {f"d{dd}": check_kernel(plain_packs, n, dd, device)
              for dd in (d, d_in)}
    phase("kernel_gin", n=n, chunks=int(plain_packs[0].senders.shape[0]),
          host_data_s=host_s, **k1_gin)
    phase("model_gin", **check_model(cfg, loaders[1].batches(0)[0],
                                     device, random_features=True))
    # layer 0 aggregates the raw 1-wide features, which need no
    # gradient: 1 + 2 x 2 per train step, one of them at D = 1
    train_gin = train_path(CFG_GIN, overrides, os.path.join(OUT, "idgin"),
                           loaders, {k1_: (5, 3)}, k1_narrow=(1, 1))
    phase("train_gin", **train_gin)
    phase("profile_gin", **profile_steps(cfg, loaders, device))

    # ---- ID-SAGE Full / ws: kernel K1 on the 'mean' pack
    cfg, loaders, host_s = load_path(CFG_SAGE, overrides)
    sage_batch = loaders[0].batches(0)[0]
    mean_packs = sage_batch.to(device).packs["mean"]
    phase("kernel_sage", n=sage_batch.num_nodes, d=d_in,
          chunks=int(mean_packs[0].senders.shape[0]),
          **check_kernel(mean_packs, sage_batch.num_nodes, d_in, device))
    phase("model_sage", host_data_s=host_s,
          **check_model(cfg, loaders[1].batches(0)[0], device,
                        random_features=True))
    train_sage = train_path(CFG_SAGE, overrides,
                            os.path.join(OUT, "idsage"), loaders,
                            {k1_: (5, 3)}, k1_narrow=(1, 1))
    phase("train_sage", **train_sage)
    phase("profile_sage", **profile_steps(cfg, loaders, device))

    # ---- kernel K2, at the train 'plain' fwd pack of ID-GIN
    k2 = check_segment_kernel(gin_batch, plain_packs[0], gin_batch.num_nodes,
                              d, device)
    phase("kernel_seg", n=gin_batch.num_nodes, d=d, **k2)

    row = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
           "library_ms")
    k1_paths = {"idgcn_ws": train, "idgin_ws": train_gin,
                "idsage_ws": train_sage}

    def path_launches(kernel, paths):
        by_path = {p: t["launches"][kernel.__name__]
                   for p, t in paths.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    def k1_launches(width):
        by_path = {p: t["k1_launches_by_width"].get(width, 0)
                   for p, t in k1_paths.items()}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    # K1's rows: D = 128 at the ID-GCN 'gcn' fwd pack (its narrow walk's
    # D = 1 at the ID-GIN 'plain' fwd pack); launches at that width
    k1_d1 = k1_gin[f"d{d_in}"]
    print(json.dumps({"kernels": [
        {"name": "packed_spmm", "route": "cuda",
         "source": "graphgym_tpu_torch/csrc/packed_spmm.cu",
         "replaces": "graphgym_tpu/ops/pallas/spmm_kernel.py:334",
         "path": ", ".join(k1_paths), "width": k1["width"],
         **{k: k1[k] for k in row + ("floor_ms",)},
         **k1_launches(k1["width"])},
        {"name": "packed_spmm_d1", "route": "cuda",
         "source": "graphgym_tpu_torch/csrc/packed_spmm.cu",
         "replaces": "graphgym_tpu/ops/pallas/spmm_kernel.py:334",
         "path": "idgin_ws, idsage_ws", "width": k1_d1["width"],
         **{k: k1_d1[k] for k in row + ("floor_ms",)},
         **k1_launches(k1_d1["width"])},
        {"name": "packed_segment", "route": "cuda",
         "source": "graphgym_tpu_torch/csrc/packed_segment.cu",
         "replaces": "graphgym_tpu/ops/pallas/spmm_kernel.py:309",
         "path": None, "launches": k2["launches"],
         **{k: k2[k] for k in row}},
        {"name": "packed_attention", "route": "cuda",
         "source": "graphgym_tpu_torch/csrc/packed_attention.cu",
         "replaces": "graphgym_tpu/ops/pallas/spmm_kernel.py:537",
         "path": "idgat_ws", **{k: k3[k] for k in row},
         **path_launches(k3_, {"idgat_ws": train_att})},
        {"name": "packed_sddmm", "route": "cuda",
         "source": "graphgym_tpu_torch/csrc/packed_sddmm.cu",
         "replaces": "graphgym_tpu/ops/pallas/spmm_kernel.py:655, "
                     "graphgym_tpu/nn/layers.py:152",
         "path": "idgat_ws", **{k: sddmm[k] for k in row},
         **path_launches(sddmm_, {"idgat_ws": train_att})},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
