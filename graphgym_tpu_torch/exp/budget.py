"""Computational-budget matching (the port's copy of
graphgym_tpu/exp/budget.py; reference graphgym/utils/comp_budget.py:
10-79): adjust gnn.dim_inner so every design variant has ~the same
parameter count as a baseline config."""

from __future__ import annotations


def params_count(cfg) -> int:
    """Parameter count of the model cfg describes (reference
    comp_budget.py:10-17): the port's model built on the CPU at the
    widths the cfg holds (input width ``max(share.dim_in, 1)``, as the
    JAX package's count feeds its model; an edge-feature conv's edge
    columns at dataset.edge_dim, as that count's edge features), its
    parameters summed.
    BatchNorm's running statistics are buffers and not counted, as the
    JAX count leaves out ``batch_stats``.  Nothing runs on a device."""
    import torch

    from graphgym_tpu_torch.nn.model import build_model

    cfg = cfg.clone()
    cfg.share.dim_in = max(cfg.share.dim_in, 1)
    model = build_model(cfg, torch.device("cpu"))
    return int(sum(p.numel() for p in model.parameters()))


def match_computation(cfg, target_params: int, *, max_steps: int = 100
                      ) -> int:
    """Adjust cfg.gnn.dim_inner until params ~= target (reference
    match_computation, comp_budget.py:20-53: sqrt-scaling phase then
    +/-1 fine-tune)."""
    import math

    current = params_count(cfg)
    # sqrt scaling phase
    for _ in range(10):
        if current == 0:
            break
        ratio = target_params / current
        if 0.9 < ratio < 1.1:
            break
        new_dim = max(int(cfg.gnn.dim_inner * math.sqrt(ratio)), 1)
        if new_dim == cfg.gnn.dim_inner:
            break
        cfg.gnn.dim_inner = new_dim
        current = params_count(cfg)
    # fine-tune phase
    step = 1 if current < target_params else -1
    for _ in range(max_steps):
        nxt = cfg.gnn.dim_inner + step
        if nxt < 1:
            break
        old = cfg.gnn.dim_inner
        cfg.gnn.dim_inner = nxt
        new_params = params_count(cfg)
        if step > 0 and new_params > target_params:
            # keep whichever is closer (match_upper keeps the upper)
            if not cfg.model.match_upper and \
                    abs(current - target_params) <= \
                    abs(new_params - target_params):
                cfg.gnn.dim_inner = old
                new_params = current
            current = new_params
            break
        if step < 0 and new_params <= target_params:
            if cfg.model.match_upper and \
                    abs(current - target_params) <= \
                    abs(new_params - target_params):
                cfg.gnn.dim_inner = old
                new_params = current
            current = new_params
            break
        current = new_params
    return current


def dict_match_baseline(cfg, baseline_cfg) -> int:
    """Match cfg's budget to baseline_cfg's (reference
    dict_match_baseline, comp_budget.py:65-79)."""
    target = params_count(baseline_cfg)
    return match_computation(cfg, target)
