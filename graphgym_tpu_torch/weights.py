"""Carry flax variables of the JAX package into the port's model.

``params_from_jax`` maps the flax params tree of a GNN (numpy leaves),
and its batch_stats tree where the model has BatchNorm, onto the port's
state_dict names.  Flax names a module after its class and creation
index in the scope that created it; a module passed to a GeneralLayer
is created in the enclosing scope, so a layer's conv and its wrapper
are siblings:

    mp/<Conv>_<i>/<path>               ->  mp.layers.<i>.layer.<path>
    mp/GeneralLayer_<i>/MaskedBatchNorm_0/<leaf>
                                       ->  mp.layers.<i>.bn.<leaf>
    mp/GeneralLayer_<i>/PReLU_0/slope  ->  mp.layers.<i>.act.slope
    Linear_<i>/kernel (pre-MP, in GNN's scope)
                                       ->  pre_mp.<i>.layer.kernel
    pre_mp_<i>/<wrapper path>          ->  pre_mp.<i>.<bn|act>...
    post_mp/MLP_0/<as a stage>         ->  post_mp.mlp.layers...
    post_mp/<leaf> (the Tfg head)      ->  post_mp.<leaf>

A conv's own leaves keep their flax names: ``kernel``, ``self_kernel``
(GeneralConv with self_msg 'concat'), ``id_kernel`` (the ID convs,
GeneralIDConv among them) and ``bias``, e.g.
``mp/GeneralConv_2/self_kernel`` -> ``mp.layers.2.layer.self_kernel``.
A conv that is itself an MLP (layer type 'mlp') nests a stage:
``mp/MLP_<i>/Linear_<j>/...`` -> ``mp.layers.<i>.layer.layers.<j>.
layer...``.  Inside a conv the path keeps its names with dots, for
example ``mp/GINIDConv_0/mlp_bn/mean`` (a batch statistic, a buffer
here) -> ``mp.layers.0.layer.mlp_bn.mean``.  Every leaf of either side
must be matched.
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


_WRAPPED = {"MaskedBatchNorm_0": "bn", "PReLU_0": "act"}


def _wrapper(segs: list, path: str) -> str:
    """A GeneralLayer's own variables: its BN and its PReLU."""
    if not segs or segs[0] not in _WRAPPED:
        raise KeyError(f"no port parameter for flax path {path!r}")
    return ".".join([_WRAPPED[segs[0]]] + segs[1:])


def _in_stage(segs: list, prefix: str, path: str) -> str:
    """A module of a stage (``mp``, an MLP) whose layers live in the
    ModuleList ``prefix``: GeneralLayer_<i> is layer i's wrapper, any
    other <Class>_<i> its conv (an MLP nests another stage)."""
    m = re.fullmatch(r"([A-Za-z]+)_(\d+)", segs[0]) if segs else None
    if m is None or len(segs) < 2:
        raise KeyError(f"no port parameter for flax path {path!r}")
    cls, i, rest = m.group(1), m.group(2), segs[1:]
    if cls == "GeneralLayer":
        return f"{prefix}.{i}.{_wrapper(rest, path)}"
    if cls == "MLP":
        return _in_stage(rest, f"{prefix}.{i}.layer.layers", path)
    return f"{prefix}.{i}.layer." + ".".join(rest)


def _torch_name(path: str) -> str:
    segs = path.split("/")
    head = segs[0]
    if head == "mp":
        return _in_stage(segs[1:], "mp.layers", path)
    if head == "post_mp":
        if len(segs) == 2:                      # the Tfg head's leaves
            return f"post_mp.{segs[1]}"
        if segs[1] == "MLP_0":
            return _in_stage(segs[2:], "post_mp.mlp.layers", path)
    m = re.fullmatch(r"Linear_(\d+)", head)
    if m and len(segs) == 2:
        return f"pre_mp.{m.group(1)}.layer.{segs[1]}"
    m = re.fullmatch(r"pre_mp_(\d+)", head)
    if m:
        return f"pre_mp.{m.group(1)}.{_wrapper(segs[1:], path)}"
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
