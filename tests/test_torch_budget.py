"""The port's parameter count (graphgym_tpu_torch/exp/budget.py
``params_count``) against the JAX package's, leaf for leaf.

The JAX count initialises its flax model on a 16-node batch and sums
the leaves of ``params``; the port builds its model on the CPU and sums
``parameters()``.  Each case runs the JAX package's own
``params_count``, keeps the variables it summed, carries them onto the
port's model through ``params_from_jax`` (which raises on a leaf left
over on either side or a shape that differs) and then compares the
totals: every layer type of the port's table with the Tfg types and
Tfg-appnp; every stage type x BatchNorm x activation at two pre- /
post-MP depths; the graph head with each pooling, the link head with
dot, cosine and concat decoding, and the edge task.  The width comes
from the cfg's share.dim_in / dim_out (``max(dim_in, 1)``), never from
data.  The edge-feature layer types count their edge columns at
dataset.edge_dim, the width of the JAX count's edge features; the JAX
count gives splineconv and generalogbconv none (it gives them only to a
layer type named '...edge...' or a model with an edge encoder), so for
those two the JAX count's batch carries them (``forced_edge_feat``).
"""

import itertools

import numpy as np
import pytest
import torch

import jax

from graphgym_tpu.config import get_cfg as jax_get_cfg
from graphgym_tpu.exp import budget as jax_budget
from graphgym_tpu.graphs import container as jax_container
from graphgym_tpu.nn import model as jax_model
from graphgym_tpu_torch.config import get_cfg
from graphgym_tpu_torch.exp import budget
from graphgym_tpu_torch.nn.act import act_dict
from graphgym_tpu_torch.nn.model import APPNP_TYPE, LAYERS, build_model
from graphgym_tpu_torch.weights import params_from_jax

SMALL = {"gnn": {"dim_inner": 8, "layers_mp": 2, "layers_pre_mp": 1,
                 "layers_post_mp": 2},
         "share": {"dim_in": 3, "dim_out": 4}}


def merged(*parts):
    out = {}
    for part in parts:
        for group, kv in part.items():
            out.setdefault(group, {}).update(kv)
    return out


def jax_count(setup, forced_edge_feat: bool = False):
    """The JAX package's params_count on ``setup``, and the flax params
    it summed; with ``forced_edge_feat`` its batch carries edge features
    of dataset.edge_dim columns whatever the layer type."""
    cfg = jax_get_cfg()
    cfg.merge_from_dict(setup)
    seen = {}
    real = jax_model.build_model

    class Spy:
        def __init__(self, model):
            self.model = model

        def init(self, *args, **kw):
            seen["variables"] = self.model.init(*args, **kw)
            return seen["variables"]

    build_batch = jax_container.build_graph_batch

    def with_edge_feat(s, r, x, **kw):
        if kw.get("edge_feat") is None:
            kw["edge_feat"] = np.random.default_rng(0).normal(size=(
                len(s), cfg.dataset.edge_dim)).astype(np.float32)
        return build_batch(s, r, x, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "build_model", lambda c: Spy(real(c)))
        if forced_edge_feat:
            mp.setattr(jax_container, "build_graph_batch", with_edge_feat)
        count = jax_budget.params_count(cfg)
    params = jax.tree_util.tree_map(np.asarray, seen["variables"]["params"])
    return count, params


def assert_counts_match(setup, forced_edge_feat: bool = False):
    """params_count equal in both packages, each flax leaf a port
    parameter of its shape and every port parameter a flax leaf."""
    want, params = jax_count(setup, forced_edge_feat)
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    got = budget.params_count(cfg)
    cfg.share.dim_in = max(cfg.share.dim_in, 1)
    model = build_model(cfg, torch.device("cpu"))
    state = params_from_jax(params, model)
    assert set(state) == {n for n, _ in model.named_parameters()}
    leaves = sum(int(np.prod(a.shape))
                 for a in jax.tree_util.tree_leaves(params))
    assert got == want == leaves == sum(p.numel()
                                        for p in model.parameters())
    return got


# the layer types the JAX count gives no edge features
NO_EDGE_FEAT_IN_JAX_COUNT = ("splineconv", "generalogbconv")


@pytest.mark.parametrize("layer_type", sorted(
    set(LAYERS) - set(NO_EDGE_FEAT_IN_JAX_COUNT)) + [APPNP_TYPE])
def test_every_layer_type_counts_as_jax(layer_type):
    """Each layer type of the port's table, the Tfg types and the Tfg
    APPNP model, on the node task (splineconv and generalogbconv in
    test_edge_feature_layer_raises)."""
    assert assert_counts_match(merged(SMALL, {"gnn": {
        "layer_type": layer_type}})) > 0


@pytest.mark.parametrize("l_pre,l_post", [(1, 1), (2, 3)])
@pytest.mark.parametrize("stage,batchnorm,act", list(itertools.product(
    ["stack", "skipsum", "skipconcat"], [True, False], sorted(act_dict))))
def test_design_options_count_as_jax(stage, batchnorm, act, l_pre, l_post):
    """Every stage type x BatchNorm x activation of the design space on
    GraphGym's generalconv (PReLU's slopes, skipconcat's widening, the
    BN wrapper's scale and bias, the bias a conv takes without BN), at
    two pre- / post-MP depths (pre-MP hands the stage dim_inner columns,
    as skipsum needs)."""
    setup = merged(SMALL, {"gnn": {
        "layer_type": "generalconv", "stage_type": stage,
        "batchnorm": batchnorm, "act": act, "layers_pre_mp": l_pre,
        "layers_post_mp": l_post}})
    assert_counts_match(setup)


@pytest.mark.parametrize("task,extra", [
    ("graph", {"model": {"graph_pooling": "add"}}),
    ("graph", {"model": {"graph_pooling": "mean"}}),
    ("graph", {"model": {"graph_pooling": "max"},
               "gnn": {"stage_type": "skipconcat"}}),
    ("graph", {"dataset": {"transform": "ego"},
               "gnn": {"layer_type": "gcnidconv"}}),
    ("link_pred", {"model": {"edge_decoding": "dot"}}),
    ("link_pred", {"model": {"edge_decoding": "cosine_similarity"}}),
    ("link_pred", {"model": {"edge_decoding": "concat"}}),
    ("link_pred", {"model": {"edge_decoding": "concat"},
                   "gnn": {"layers_post_mp": 3, "act": "prelu"}}),
    ("edge", {"model": {"edge_decoding": "concat"}}),
    ("edge", {"gnn": {"layer_type": "gatconv"}})])
def test_heads_count_as_jax(task, extra):
    """The graph head (add, mean, max pooling; the ego centers), the
    link head's three decodings (concat widens the head's first layer)
    and the edge task."""
    assert_counts_match(merged(SMALL, {"dataset": {"task": task}}, extra))


@pytest.mark.parametrize("dim_in,dim_out", [(0, 1), (1, 2), (7, 5)])
def test_widths_come_from_the_cfg(dim_in, dim_out):
    """The input width is max(share.dim_in, 1) and the head's
    share.dim_out, as the cfg holds them; the cfg is not changed."""
    setup = merged(SMALL, {"share": {"dim_in": dim_in,
                                     "dim_out": dim_out}})
    assert_counts_match(setup)
    cfg = get_cfg()
    cfg.merge_from_dict(setup)
    budget.params_count(cfg)
    assert cfg.share.dim_in == dim_in


@pytest.mark.parametrize("layer_type", ["generaledgeconv", "splineconv",
                                        "generaledgeattconvv1",
                                        "generalogbconv"])
def test_edge_feature_layer_raises(layer_type):
    """The edge-feature convs, once refused here, count as the JAX
    package's leaf for leaf, their edge columns at dataset.edge_dim (a
    JAX count given edge features for the two layer types its own count
    gives none: there its layer asserts); generaledgeconv's also at
    another edge_dim and msg_direction 'both'."""
    setup = merged(SMALL, {"gnn": {"layer_type": layer_type}})
    forced = layer_type in NO_EDGE_FEAT_IN_JAX_COUNT
    if forced:
        with pytest.raises(AssertionError, match="edge"):
            jax_count(setup)
    assert assert_counts_match(setup, forced) > 0
    if layer_type == "generaledgeconv":
        assert_counts_match(merged(setup, {
            "dataset": {"edge_dim": 5},
            "gnn": {"msg_direction": "both"}}))
