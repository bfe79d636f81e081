"""Graph layers.

``GCNConv`` reproduces the math of the reference's PyG ``GCNConv`` layers
(models_gnn.py:118-184): linear transform + symmetric-normalized sparse
aggregation ``D^{-1/2} Â D^{-1/2} X W + b``. The linear transform is a dense
matmul and the aggregation dispatches through ``gwen.ops.aggregate`` (dense
adjacency, XLA segment-sum, or the diagonal-window kernel depending on the
graph container).

Order of operations: transform *then* aggregate when fan-out shrinks
(d_out < d_in), aggregate-then-transform otherwise — both are mathematically
identical because aggregation is linear; picking the cheaper side halves
bandwidth on wide layers.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from gwen.nn import core
from gwen.ops.aggregate import aggregate

Array = jnp.ndarray

# Checkpoint tag on aggregation outputs: with EncodeProcessDecode's
# ``remat="save_agg"`` policy the backward recomputes only the cheap
# elementwise/matmul ops and never re-runs the sparse aggregation.
AGG_CKPT_NAME = "gnn_agg"


def gcn_init(key, d_in: int, d_out: int, dtype=jnp.float32) -> core.Params:
    return core.linear_init(key, d_in, d_out, dtype)


def gcn_apply(
    params: core.Params, graph, x: Array, backend: str = "auto"
) -> Array:
    d_in = params["w"].shape[0]
    d_out = params["w"].shape[1]
    w = params["w"].astype(x.dtype)
    b = params["b"].astype(x.dtype)
    if d_out <= d_in:
        h = jnp.dot(x, w, preferred_element_type=x.dtype)
        h = aggregate(graph, h, backend=backend)
    else:
        h = aggregate(graph, x, backend=backend)
        h = jnp.dot(h, w, preferred_element_type=x.dtype)
    h = checkpoint_name(h, AGG_CKPT_NAME)
    return h + b
