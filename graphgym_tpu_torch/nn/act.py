"""Activation table (the port of graphgym_tpu/nn/act.py; reference
graphgym/models/act.py:6-16).

Every entry is a function.  The learnable ``PReLU`` is a module with
its own parameter, which ``GeneralLayer`` builds for act ``prelu``; the
table's ``prelu`` is the JAX package's function fallback, a leaky ReLU
of slope 0.25, which the skip stage applies after its merge
(graphgym_tpu/nn/model.py:204,220).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from graphgym_tpu_torch import register


def _lrelu(slope: float):
    return functools.partial(F.leaky_relu, negative_slope=slope)


class PReLU(nn.Module):
    """Learnable-slope PReLU (graphgym_tpu/nn/act.py:19-29; torch
    nn.PReLU semantics): one shared slope, initialised to 0.25, the
    parameter ``slope`` of shape [1] (flax ``PReLU_0/slope``).

    x > 0 gives x, else slope * x: the JAX layer's values and slope
    gradient.  At x == 0 exactly its input gradient is slope times the
    upstream one, where the JAX ``where(x >= 0, ...)`` passes it whole;
    where dropout zeroed an entry, its upstream gradient is 0 too."""

    def __init__(self):
        super().__init__()
        self.slope = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.slope)


class _ActDict(dict):
    """Falls back to the plugin registry (register.register_act) so
    contrib activations resolve by name."""

    def __missing__(self, key):
        if key in register.act_dict:
            return register.act_dict[key]
        raise KeyError(key)

    def __contains__(self, key):
        return dict.__contains__(self, key) or key in register.act_dict


act_dict = _ActDict({
    "relu": torch.relu,
    "selu": F.selu,
    "elu": F.elu,
    "lrelu_01": _lrelu(0.1),
    "lrelu_025": _lrelu(0.25),
    "lrelu_05": _lrelu(0.5),
    "prelu": _lrelu(0.25),
    "identity": lambda x: x,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
})
