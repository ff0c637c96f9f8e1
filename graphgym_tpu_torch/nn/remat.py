"""Rematerialized MP layers (cfg.tpu.remat; the JAX package wraps each MP
GeneralLayer in ``nn.remat``, graphgym_tpu/nn/model.py:165-177).

``checkpoint(module, graph)`` runs a layer under
``torch.utils.checkpoint``: its activations are dropped after the
forward and recomputed in the backward.  The recompute must be the same
function as the forward to the bit, and must not move the model's state
a second time.  Two things in the port's layers would otherwise differ:

  * dropout and attention-dropout masks and the sampled edges are drawn
    from the model's own device generator, which checkpoint's
    ``preserve_rng_state`` does not cover (it saves the default
    generators);
  * the masked BatchNorm moves its running statistics in place in its
    forward.

So a layer runs inside a ``Remat`` tape: the forward draws its keep
masks (``keep_draw``) and keeps them, and moves the statistics; the
recompute reads the forward's masks back in order, draws nothing and
leaves the statistics alone (``recomputing``).  Nothing here touches a
generator's state, so a captured step (train/graphed.py) captures the
recompute as it captures any other kernel.  The kept masks are bool, the
tensors a dropout keeps for its backward anyway.

The layer's parameters go into the checkpoint as inputs, and the
recompute reads them back (``torch.func.functional_call``): under mixed
precision (train/graphed.py) they are the step's compute-dtype copies,
which live only while the forward runs; in f32 they are the
``nn.Parameter`` masters themselves, and the recompute does the same
arithmetic.
"""

from __future__ import annotations

import contextvars
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

_TAPE: contextvars.ContextVar[Optional["Remat"]] = contextvars.ContextVar(
    "remat_tape", default=None)


class Remat:
    """One call of a rematerialized layer: its first run (the forward)
    records the keep masks it draws; every later run (the recompute)
    replays them."""

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.replay = False
        self.pos = 0

    def run(self, fn: Callable, *args):
        token = _TAPE.set(self)
        self.pos = 0
        try:
            return fn(*args)
        finally:
            _TAPE.reset(token)
            self.replay = True

    def draw(self, shape, prob: float, generator: torch.Generator,
             device) -> torch.Tensor:
        if not self.replay:
            mask = torch.rand(shape, generator=generator, device=device) \
                < prob
            self.masks.append(mask)
            return mask
        mask = self.masks[self.pos]
        if tuple(mask.shape) != tuple(shape):
            raise RuntimeError(f"recompute draws {tuple(shape)} where the "
                               f"forward drew {tuple(mask.shape)}")
        self.pos += 1
        return mask


def keep_draw(shape, prob: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """``torch.rand(shape, generator) < prob``: the entries a dropout (or
    an edge sample) keeps; in a rematerialized layer's recompute, the
    forward's mask."""
    tape = _TAPE.get()
    if tape is None:
        return torch.rand(shape, generator=generator, device=device) < prob
    return tape.draw(shape, prob, generator, device)


def recomputing() -> bool:
    """Whether a rematerialized layer's recompute is running (the
    BatchNorm then leaves its running statistics as they are)."""
    tape = _TAPE.get()
    return tape is not None and tape.replay


class _Bound(torch.nn.Module):
    """``fn``, a method of ``layer``, as a module's forward, so that
    ``torch.func.functional_call`` can give it the layer's parameters."""

    def __init__(self, layer: torch.nn.Module, fn: Callable):
        super().__init__()
        self.layer = layer
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def checkpoint(layer: torch.nn.Module, fn: Callable, *args):
    """``fn(*args)``, a method of ``layer``, with its activations
    recomputed in the backward (non-reentrant ``torch.utils.checkpoint``,
    the default generators not saved: the port draws from its own),
    inside a ``Remat`` tape, the layer's parameters inputs of the
    checkpoint."""
    params = dict(layer.named_parameters())
    bound = _Bound(layer, fn)
    names = [f"layer.{name}" for name in params]
    n = len(args)

    def swapped(*flat):
        return torch.func.functional_call(
            bound, dict(zip(names, flat[n:])), flat[:n])
    return _checkpoint(Remat().run, swapped, *args, *params.values(),
                       use_reentrant=False, preserve_rng_state=False)
