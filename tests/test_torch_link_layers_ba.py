"""grids/IDGNN/link.txt's other layer types on ba against the JAX
package: three Adam steps of the plain chunk (link.txt:5-18) at
sageconv, gatconv and ginconv and of the ID chunk (link.txt:21-34, the
edge-net transform) at sageidconv, gatidconv and ginidconv, from the
same parameters on the same seeded features, per-step losses within
2e-3 (two layers of width 16 on the first 5 of 10 regenerated ba
graphs; tests/test_torch_link_layers.py has ws and the edge task).
"""

import pytest

from test_torch_link_layers import (  # noqa: F401 (the fixtures)
    ID_TYPES, PLAIN_TYPES, assert_three_steps_match, corpus_dirs,
    layer_data, numpy_paths)


@pytest.mark.parametrize("chunk,layer_type", [
    *(("link", t) for t in PLAIN_TYPES), *(("linkid", t) for t in ID_TYPES)])
def test_three_steps_match_jax_ba(chunk, layer_type, corpus_dirs):
    """The plain chunk (dot decoding of the pairs) and the ID chunk (the
    node head on the edge-net union of 64 copies a graph) on ba."""
    jcfg, cfg, jlds, lds = layer_data("idgcn_ba", chunk, layer_type,
                                      *corpus_dirs)
    assert cfg.dataset.task == jcfg.dataset.task == (
        "link_pred" if chunk == "link" else "node")
    assert_three_steps_match(jcfg, cfg, jlds, lds)
