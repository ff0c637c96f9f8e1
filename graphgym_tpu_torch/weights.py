"""Carry flax variables of the JAX package into the port's model.

``params_from_jax`` maps the flax params tree of a Tfg GNN (numpy
leaves), and its batch_stats tree where the model has BatchNorm, onto
the port's state_dict names:

    mp/<Layer>_<i>/<path>   ->  mp.layers.<i>.layer.<path with dots>
    post_mp/<leaf>          ->  post_mp.<leaf>

for example ``mp/GINIDConv_0/mlp_bn/scale`` (a parameter) and
``mp/GINIDConv_0/mlp_bn/mean`` (a batch statistic, a buffer here) ->
``mp.layers.0.layer.mlp_bn.scale`` / ``.mean``.  Flax names a conv
after its class and creation index inside the stage (the GeneralLayer
wrapper holds no parameters), so the i-th layer's conv is
``<Layer>_<i>``.  Every leaf of either side must be matched.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _torch_name(path: str) -> str:
    m = re.fullmatch(r"mp/[A-Za-z]+_(\d+)/(\w+(?:/\w+)*)", path)
    if m:
        return (f"mp.layers.{m.group(1)}.layer."
                f"{m.group(2).replace('/', '.')}")
    m = re.fullmatch(r"post_mp/(\w+)", path)
    if m:
        return f"post_mp.{m.group(1)}"
    raise KeyError(f"no port parameter for flax path {path!r}")


def params_from_jax(flax_params: Mapping,
                    model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A state_dict for ``model`` holding the flax variables: a params
    tree (dict of numpy arrays), or {'params': ..., 'batch_stats': ...}
    with batch_stats optional.  With batch_stats every parameter and buffer of
    the model must get a leaf; without, every parameter (a gradient tree
    has no batch_stats).  Raises on a leaf left over on either side or a
    shape mismatch."""
    trees = [flax_params]
    if "params" in flax_params and set(flax_params) <= {"params",
                                                        "batch_stats"}:
        trees = [flax_params[k] for k in ("params", "batch_stats")
                 if k in flax_params]
    want = (model.state_dict() if len(trees) == 2
            else dict(model.named_parameters()))
    out = {}
    for path, arr in (kv for t in trees for kv in _flatten(t).items()):
        name = _torch_name(path)
        if name not in want:
            raise KeyError(f"flax leaf {path!r} maps to {name!r}, which "
                           "the model does not have")
        if tuple(want[name].shape) != arr.shape:
            raise ValueError(f"{path}: flax shape {arr.shape} vs model "
                             f"shape {tuple(want[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr)).to(
            want[name].dtype)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"model parameters with no flax leaf: {missing}")
    return out
