"""ID-GNN Fast identity features: diagonals of normalized-adjacency
powers.

The port of graphgym_tpu/ops/identity.py:25-44 (reference
graphgym/contrib/transform/identity.py:25-35, ``compute_identity``):
GCN-normalize the adjacency with self loops, densify it, and take
diag(Â^1..Â^k).  diag(Â^k)[v] is the weighted count of closed k-walks
at v.  Dense [N, N] products, as in the JAX package, on the device of
the given tensors (the card, with TF32 off, unless the config asks for
the CPU): the corpus graphs have tens of nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from graphgym_tpu_torch.ops import sparse as sp


def compute_identity(senders: torch.Tensor, receivers: torch.Tensor,
                     num_nodes: int, k: int) -> torch.Tensor:
    """[N, k] float32: column j-1 = diag(Â^j), Â = D^-1/2 (A+I) D^-1/2."""
    s, r, w = sp.gcn_norm(senders, receivers, num_nodes)
    adj = torch.zeros((num_nodes, num_nodes), dtype=torch.float32,
                      device=senders.device)
    adj.index_put_((r.long(), s.long()), w, accumulate=True)
    diags, p = [], adj
    for j in range(k):
        diags.append(torch.diagonal(p))
        if j + 1 < k:
            p = torch.matmul(p, adj)
    return torch.stack(diags, dim=1)


def compute_identity_host(edge_index: np.ndarray, num_nodes: int, k: int,
                          device: torch.device) -> np.ndarray:
    """compute_identity on ``device`` from a host [2, E] edge index, back
    as numpy (the data pipeline's form)."""
    ei = torch.as_tensor(np.asarray(edge_index, np.int64), device=device)
    return compute_identity(ei[0], ei[1], num_nodes, k).cpu().numpy()
