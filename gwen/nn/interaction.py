"""Interaction-network (edge-MLP) message passing — MeshGraphNets-style.

Extends the model family beyond GCN: messages are computed per edge by an MLP
over [sender, receiver] features and sum-aggregated, followed by a node-update
MLP with residual. Runs on the COO/segment path (per-edge MLPs are gather +
dense matmul + scatter); padding edges are gated out by the zero weights of
the padded :class:`~gwen.graph.graph.Graph`.

The reference has no such layer (GCNConv only, models_gnn.py:118-184); this
is a north-star model-family extension. For mesh-scale runs note the cost:
per-edge MLPs touch E × latent activations — use the GCN processor when
throughput dominates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gwen.graph.graph import Graph
from gwen.nn import core

Array = jnp.ndarray


def interaction_init(key, latent: int, mlp_layers: int = 2) -> core.Params:
    k_edge, k_node = jax.random.split(key)
    edge_dims = [2 * latent] + [latent] * mlp_layers
    node_dims = [2 * latent] + [latent] * mlp_layers
    return {
        "edge_mlp": core.mlp_init(k_edge, edge_dims),
        "node_mlp": core.mlp_init(k_node, node_dims),
        "norm": core.layer_norm_init(latent),
    }


def interaction_apply(params: core.Params, graph: Graph, x: Array) -> Array:
    """One interaction step: residual node update from edge-MLP messages."""
    if not isinstance(graph, Graph):
        raise TypeError(
            "interaction processor needs a COO Graph (segment path); got "
            f"{type(graph).__name__}"
        )
    gate = (graph.weights != 0).astype(x.dtype)  # padding edges contribute 0
    src = jnp.take(x, graph.senders, axis=-2)
    dst = jnp.take(x, graph.receivers, axis=-2)
    msgs = core.mlp_apply(params["edge_mlp"], jnp.concatenate([src, dst], axis=-1))
    msgs = msgs * gate.reshape((-1, 1))
    # Scatter-sum messages to receivers (node axis moved to front).
    mm = jnp.moveaxis(msgs, -2, 0)
    agg = jax.ops.segment_sum(mm, graph.receivers, num_segments=graph.num_nodes)
    agg = jnp.moveaxis(agg, 0, -2)
    upd = core.mlp_apply(params["node_mlp"], jnp.concatenate([x, agg], axis=-1))
    upd = core.layer_norm_apply(params["norm"], upd)
    return x + upd
