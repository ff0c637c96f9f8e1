"""Activation table (the port of graphgym_tpu/nn/act.py; reference
graphgym/models/act.py:6-16).

Every entry is a function.  The learnable PReLU is a module with its
own parameter and is not ported yet (ROADMAP A11); ``prelu`` here is the
JAX package's function fallback, a leaky ReLU of slope 0.25.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from graphgym_tpu_torch import register


def _lrelu(slope: float):
    return functools.partial(F.leaky_relu, negative_slope=slope)


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
