"""The train and eval steps as one program each (the port of
``make_train_step`` and ``make_eval_step``, graphgym_tpu/train/loop.py:
69-107).

The JAX Trainer runs a step as one jit program per batch shape:
forward, loss, backward and the Adam update.  Here a step is one
replay of a captured ``torch.cuda.CUDAGraph``, one graph per batch
signature: the shape and dtype of every tensor field of the placed
batch, and which packs it carries.  On the CPU the same program runs
eagerly on the same static buffers.

For each signature a program holds:

  * static input buffers, copies of the batch made outside any capture
    (never the placed batch's own tensors: ``Trainer._place`` frees
    what its LRU evicts, and the kernels read raw pointers).  A step
    copies its batch into them only when it is another batch than the
    one they hold;
  * step 0, run eagerly on a side stream.  It is a real step.  It
    builds the kernels, initialises Adam's state and warms the
    allocator;
  * from step 1 on, the graph.  It is captured at step 1 and replayed
    at once, and that replay is step 1.

Capture runs nothing, so the kernel wrappers' launch counters are
restored after it.  Each graph keeps the launches its capture counted
and adds them to the counters on every replay.  A capture or replay
that fails raises, naming the step and the signature.  There is no
eager fallback on the card; ``eager=True`` asks for eager steps on any
device, for comparisons against the captured ones.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
import warnings
import weakref
from typing import Callable, Optional, Tuple

import torch

from graphgym_tpu_torch.graphs.container import GraphBatch
from graphgym_tpu_torch.ops.cuda import spmm_kernel as K
from graphgym_tpu_torch.train.loss import LossOptions, compute_loss, kernel_l2

StepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _map(a, fn):
    """``a`` (a GraphBatch, its packs or a leaf) with ``fn`` applied to
    every tensor, pack kinds in sorted order."""
    if isinstance(a, torch.Tensor):
        return fn(a)
    if isinstance(a, GraphBatch):
        return a.replace(**{f.name: _map(getattr(a, f.name), fn)
                            for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: _map(a[k], fn) for k in sorted(a)}
    if hasattr(a, "_fields"):                       # PackedCSR
        return type(a)(*(_map(x, fn) for x in a))
    if isinstance(a, tuple):                        # a kind's packs
        return tuple(_map(x, fn) for x in a)
    return a


def _tensors(a, path: str = ""):
    """(path, tensor) of every tensor of ``a``, in ``_map``'s order:
    "node_feat", "packs.gcn.0.senders", "packs.att.2" (the slot map)."""
    if isinstance(a, torch.Tensor):
        yield path, a
        return
    if isinstance(a, GraphBatch):
        items = [(f.name, getattr(a, f.name)) for f in dataclasses.fields(a)]
    elif isinstance(a, dict):
        items = [(k, a[k]) for k in sorted(a)]
    elif hasattr(a, "_fields"):
        items = list(zip(a._fields, a))
    elif isinstance(a, tuple):
        items = [(str(i), x) for i, x in enumerate(a)]
    else:
        return
    for name, x in items:
        yield from _tensors(x, f"{path}.{name}" if path else name)


def signature(batch: GraphBatch) -> tuple:
    """The key of a batch's program: the shape and dtype of every
    tensor field and pack array, by path, so also which packs the batch
    carries (kind, fwd and bwd, the 'att' slot map).  Int fields are
    left out: the port's models read none of them."""
    return tuple((path, tuple(t.shape), t.dtype, t.device.type)
                 for path, t in _tensors(batch))


def describe(sig: tuple) -> str:
    """A signature on one line: path[shape]dtype for each tensor."""
    return " ".join(f"{path}{list(shape)}{str(dtype).replace('torch.', '')}"
                    for path, shape, dtype, _ in sig)


class _Program:
    """One signature's static buffers, graph and counts."""

    def __init__(self, key: tuple, batch: GraphBatch):
        self.key = key
        self.static = _map(batch, torch.clone)
        self.holds = weakref.ref(batch)
        self.steps = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[StepOut] = None
        self.launches: Optional[K.LaunchCounts] = None
        self.keep: tuple = ()
        self.capture_s = 0.0

    def load(self, batch: GraphBatch) -> None:
        if self.holds() is batch:
            return
        for (_, dst), (_, src) in zip(_tensors(self.static),
                                      _tensors(batch)):
            dst.copy_(src)
        self.holds = weakref.ref(batch)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of a device that every step 0 runs on:
    PyTorch keeps a cuBLAS workspace for each stream it has used (32 MiB
    and more on an H100) for the life of the process, so a new stream
    per step callable would hold that much more per trainer."""
    return torch.cuda.Stream(device)


def _cuda_generators(model: torch.nn.Module) -> tuple:
    """The CUDA generators the model's modules hold (dropout and
    att-dropout)."""
    found = {}
    for mod in model.modules():
        for v in vars(mod).values():
            if isinstance(v, torch.Generator) and v.device.type == "cuda":
                found[id(v)] = v
    return tuple(found.values())


class GraphedStep:
    """A step callable: ``step(batch) -> (loss, score, label, mask)``.

    ``program(batch)`` is the step's work on a batch; ``mode`` puts the
    model in train or eval mode before it runs (outside any graph);
    ``after`` runs after each step (the train step's lr schedule).  On a
    CUDA batch each signature's program is captured once and replayed
    (module docstring); on a CPU batch it runs eagerly on the static
    buffers.  The returned tensors of a replay are the graph's own
    outputs: read them before the next step.  At most ``max_programs``
    signatures are kept, least recently used dropped first."""

    def __init__(self, name: str, program: Callable[[GraphBatch], StepOut],
                 mode: Callable[[], object], *,
                 after: Optional[Callable[[], None]] = None,
                 before_capture: Optional[Callable[[], None]] = None,
                 params: tuple = (), generators: tuple = (),
                 max_programs: int = 8, pool=None, eager: bool = False):
        self.name = name
        self.program = program
        self.mode = mode
        self.after = after
        self.before_capture = before_capture
        self.params = params
        self.generators = generators
        self.max_programs = max_programs
        self.pool = pool
        self.eager = eager
        self.programs: "collections.OrderedDict[tuple, _Program]" = \
            collections.OrderedDict()

    @property
    def captured(self) -> int:
        """How many of the kept programs hold a captured graph."""
        return sum(p.graph is not None for p in self.programs.values())

    def __call__(self, batch: GraphBatch) -> StepOut:
        self.mode()
        if self.eager:
            out = self.program(batch)
        else:
            prog = self._program(batch)
            if prog.static.node_feat.is_cuda:
                out = self._cuda_step(prog)
            else:
                out = self.program(prog.static)
            prog.steps += 1
        if self.after is not None:
            self.after()
        return out

    def _program(self, batch: GraphBatch) -> _Program:
        key = signature(batch)
        prog = self.programs.get(key)
        if prog is None:
            while len(self.programs) >= self.max_programs:
                self.programs.popitem(last=False)
            prog = self.programs[key] = _Program(key, batch)
        else:
            self.programs.move_to_end(key)
            prog.load(batch)
        return prog

    def _cuda_step(self, prog: _Program) -> StepOut:
        if prog.steps == 0:
            return self._warm(prog)
        if prog.graph is None:
            self._capture(prog)
        try:
            prog.graph.replay()
        except Exception as exc:
            raise RuntimeError(
                f"{self.name} step: replay of step {prog.steps} failed for "
                f"batch signature {describe(prog.key)}: {exc}") from exc
        K.add_launch_counts(prog.launches)
        return prog.out

    def _warm(self, prog: _Program) -> StepOut:
        """Step 0: the program run eagerly on a side stream."""
        device = prog.static.node_feat.device
        current = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.program(prog.static)
        current.wait_stream(side)
        return out

    def _capture(self, prog: _Program) -> None:
        """Capture the program on the static buffers.  The kernels are
        built first: nvcc must never run inside a capture."""
        t0 = time.perf_counter()
        for name in K.SOURCES:
            K.library(name)
        if self.before_capture is not None:
            self.before_capture()
        before = K.launch_counts()
        try:
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.program(prog.static)
        except Exception as exc:
            raise RuntimeError(
                f"{self.name} step: capture at step {prog.steps} failed for "
                f"batch signature {describe(prog.key)}: {exc}") from exc
        finally:
            after = K.launch_counts()
            K.set_launch_counts(before)
        prog.launches = K.launches_between(before, after)
        prog.graph, prog.out = graph, out
        # the graph writes the gradients and reads them back: keep them
        # allocated, so no later capture in the shared pool takes them
        prog.keep = tuple(p.grad for p in self.params)
        prog.capture_s = time.perf_counter() - t0


def _quiet_capturable(fn):
    """Run fn without the warning that a capturable Adam steps outside a
    capture (step 0, and the eager comparisons, do so by design)."""
    def run(*args):
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message=".*capturable=True.*")
            return fn(*args)
    return run


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_opts: LossOptions, scheduler=None, *,
                    max_programs: int = 8, pool=None,
                    eager: bool = False) -> GraphedStep:
    """The train step: forward, masked loss (+ kernel L2 on the Tfg
    path), backward and the Adam update (BatchNorm running statistics
    updated in place) as one program; the lr schedule steps after it,
    on the host."""
    @_quiet_capturable
    def program(batch: GraphBatch) -> StepOut:
        pred, label, mask = model(batch)
        loss, score = compute_loss(pred, label, mask, loss_opts)
        if loss_opts.l2_kernel:                 # the Tfg path's term
            loss = loss + kernel_l2(model, loss_opts.l2_kernel)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), score.detach(), label, mask

    return GraphedStep(
        "train", program, model.train,
        after=scheduler.step if scheduler is not None else None,
        before_capture=lambda: optimizer.zero_grad(set_to_none=True),
        params=tuple(model.parameters()),
        generators=_cuda_generators(model), max_programs=max_programs,
        pool=pool, eager=eager)


def make_eval_step(model: torch.nn.Module, loss_opts: LossOptions, *,
                   max_programs: int = 8, pool=None,
                   eager: bool = False) -> GraphedStep:
    """The eval step: the forward in eval mode and the loss, no
    gradient."""
    @torch.no_grad()
    def program(batch: GraphBatch) -> StepOut:
        pred, label, mask = model(batch)
        loss, score = compute_loss(pred, label, mask, loss_opts)
        return loss, score, label, mask

    return GraphedStep("eval", program, model.eval,
                       max_programs=max_programs, pool=pool, eager=eager)
