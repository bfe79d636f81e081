"""Windowed graph-attention processor (graph-transformer model family).

Extends the model family beyond the reference's GCNConv stack
(models_gnn.py:118-184) and the interaction network: messages are attention-
weighted over each node's in-window mesh neighbourhood
(:mod:`gwen.ops.attention`). This is the GenCast-style direction —
learned, data-dependent edge weights instead of fixed GCN normalization —
with scores as dense ``(128, window)`` tiles per destination block, never as
per-edge gather/scatter.

The processor is windowed by definition (out-of-window escape edges are
excluded, ~2 % at the default window on KD-ordered meshes) — the attention
analog of sliding-window attention. Requires a
:class:`~gwen.graph.graph.DiagWindowGraph`; the gradient comes from
autodiff.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gwen.graph.graph import DiagWindowGraph
from gwen.nn import core
from gwen.ops.attention import windowed_attention

Array = jnp.ndarray


def graph_attention_init(key, latent: int, heads: int = 2) -> core.Params:
    if latent % heads:
        raise ValueError(f"latent {latent} not divisible by heads {heads}")
    kq, kk, kv, ko = jax.random.split(key, 4)
    return {
        "wq": core.linear_init(kq, latent, latent),
        "wk": core.linear_init(kk, latent, latent),
        "wv": core.linear_init(kv, latent, latent),
        "wo": core.linear_init(ko, latent, latent),
    }


def graph_attention_apply(params: core.Params, graph, x: Array,
                          heads: int = 2) -> Array:
    """Multi-head windowed attention over mesh neighbourhoods.

    ``x`` is ``(..., N, latent)``; each head attends over the in-window
    neighbourhood with its ``latent/heads``-wide slice, heads are
    concatenated and mixed by the output projection.
    """
    from gwen.parallel.halo import HaloDiagGraph, attend_halo

    if isinstance(graph, HaloDiagGraph):
        attend = attend_halo
    elif isinstance(graph, DiagWindowGraph):
        attend = windowed_attention
    else:
        raise TypeError(
            "attention processor needs a DiagWindowGraph (diag-window "
            "layout) or a partitioned HaloDiagGraph; "
            f"got {type(graph).__name__}"
        )
    latent = x.shape[-1]
    dh = latent // heads

    # Heads live on the LEADING axis, so one call attends all heads under
    # the shared mask (and on the partitioned path K/V are halo-exchanged
    # once per tensor, not once per head). The projections emit
    # (H, ..., N, dh) directly via head-sliced einsums — no
    # project-then-moveaxis relayout of the activations.
    def proj(p):
        w = p["w"].astype(x.dtype).reshape(latent, heads, dh)
        b = p["b"].astype(x.dtype).reshape((heads,) + (1,) * (x.ndim - 1)
                                           + (dh,))
        return jnp.einsum("...nf,fhd->h...nd", x, w,
                          preferred_element_type=x.dtype) + b

    oh = attend(graph, proj(params["wq"]), proj(params["wk"]),
                proj(params["wv"]))
    wo = params["wo"]
    wo_w = wo["w"].astype(x.dtype).reshape(heads, dh, latent)
    out = jnp.einsum("h...nd,hdf->...nf", oh, wo_w,
                     preferred_element_type=x.dtype)
    return out + wo["b"].astype(x.dtype)
