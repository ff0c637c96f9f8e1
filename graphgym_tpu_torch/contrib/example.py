"""Contrib extension example, the template users copy (the port of
graphgym_tpu/contrib/example.py; reference contrib/config/example.py:
6-26, contrib/act/example.py, contrib/feature_augment/example.py).

Registers a config group, an activation, a feature augment and a
layer, one of each extension point."""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from graphgym_tpu_torch import register


# ---- config extension (reference contrib/config/example.py) ----------
def set_cfg_example(cfg):
    from graphgym_tpu_torch.config import CfgNode

    cfg.example = CfgNode()
    cfg.example.sample_arg = 10


register.register_config("example", set_cfg_example)


# ---- activation ------------------------------------------------------
register.register_act("swish", F.silu)


# ---- feature augment (reference contrib/feature_augment/example.py:
# example node degree clone) -------------------------------------------
def example_node_degree(graph, **kwargs):
    deg = np.zeros(graph.num_nodes, np.float64)
    np.add.at(deg, graph.senders, 1.0)
    return deg


register.register_feature_augment("node_degree_example",
                                  example_node_degree)


# ---- layer -----------------------------------------------------------
def _make_example_layer(dim_in, dim_out, use_bias=False, opts=None, *,
                        generator):
    from graphgym_tpu_torch.nn.att_layers import ExampleConv

    return ExampleConv(dim_in, dim_out, use_bias=use_bias,
                       generator=generator)


register.register_layer("contrib_example", _make_example_layer)
