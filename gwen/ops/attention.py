"""Windowed graph attention over the diagonal-window layout (plain XLA).

Masked softmax attention over each node's in-window mesh neighbourhood::

    out[i] = Σ_j P[i, j] v[j],   P = softmax_j(q[i] · k[j] · scale)

over the graph neighbours ``j`` of ``i`` that fall inside the window of
``i``'s 128-row destination block (the mask is ``S != 0`` — structure only,
the GCN weights are ignored). Out-of-window escape edges (~2 % at the
default window on KD-ordered meshes) are excluded by definition: windowed
attention in the sliding-window-attention sense, the model and not an
approximation of another one.

One vectorised implementation serves the global layout and the
halo-extended partitions (:func:`gwen.parallel.halo.attend_halo`): per
destination block, the ``(..., 128, dh)`` queries attend to the
``(..., W, dh)`` keys and values gathered by index, under the block's
``(128, W)`` mask. Scores and the softmax run in float32; the gradient
comes from autodiff. ``impl="cudnn"`` runs the same blocks through
``jax.nn.dot_product_attention(implementation="cudnn")`` (GPU, 16-bit
inputs), the platform's choice on the GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gwen.ops.aggregate import gather_windows, window_starts

Array = jnp.ndarray

_NEG = -1e30  # masked logit (finite: fully masked rows give 0, not NaN)


def _pad_rows(x: Array, rows: int) -> Array:
    n = x.shape[-2]
    if n >= rows:
        return x[..., :rows, :]
    pad = [(0, 0)] * (x.ndim - 2) + [(0, rows - n), (0, 0)]
    return jnp.pad(x, pad)


def window_attention_core(xbase, offsets, s_mat, q: Array, k: Array,
                          v: Array, *, superblock: int, src_rows: int,
                          scale: float, impl: str = "xla") -> Array:
    """Attention of every destination block over its window.

    ``q`` ``(..., Rq, dh)`` (padded or cropped to S rows), ``k``/``v``
    ``(..., Rk, dh)`` (padded to ``src_rows``). Returns ``(..., S rows,
    dh)`` in ``v``'s dtype."""
    n_rows, window = s_mat.shape
    block = n_rows // jnp.asarray(offsets).shape[0]
    nb = n_rows // block
    starts = window_starts(xbase, offsets, superblock)
    qb = _pad_rows(q, n_rows).reshape(q.shape[:-2] + (nb, block, q.shape[-1]))
    kw = gather_windows(_pad_rows(k, src_rows), starts, window)
    vw = gather_windows(_pad_rows(v, src_rows), starts, window)
    mask = (jnp.asarray(s_mat) != 0).reshape(nb, block, window)
    if impl == "cudnn":
        out = _cudnn_blocks(qb, kw, vw, mask, scale)
    else:
        scores = jnp.einsum("...kbd,...kwd->...kbw", qb, kw,
                            preferred_element_type=jnp.float32)
        logits = jnp.where(mask, scores * jnp.float32(scale),
                           jnp.float32(_NEG))
        mx = jnp.max(logits, axis=-1, keepdims=True)
        p = jnp.exp(logits - mx) * mask
        den = jnp.sum(p, axis=-1, keepdims=True)
        p = p / jnp.where(den == 0, 1.0, den)
        out = jnp.einsum("...kbw,...kwd->...kbd", p.astype(v.dtype), vw,
                         preferred_element_type=jnp.float32)
    return out.reshape(q.shape[:-2] + (n_rows, q.shape[-1])).astype(v.dtype)


def _cudnn_blocks(qb, kw, vw, mask, scale):
    """The same blocks through cuDNN's fused attention: every (leading,
    block) pair is one batch entry with one head. Rows without any
    neighbour (padding) are zeroed, matching the XLA form."""
    lead = qb.shape[:-3]
    nb, block, dh = qb.shape[-3:]
    window = kw.shape[-2]
    q4 = qb.reshape((-1, block, 1, dh))
    k4 = kw.reshape((-1, window, 1, dh))
    v4 = vw.reshape((-1, window, 1, dh))
    m4 = jnp.broadcast_to(mask, lead + mask.shape).reshape(
        (-1, 1, block, window))
    out = jax.nn.dot_product_attention(q4, k4, v4, mask=m4, scale=scale,
                                       implementation="cudnn")
    out = out.reshape(lead + (nb, block, dh))
    has_nbr = jnp.any(mask, axis=-1, keepdims=True)
    return jnp.where(has_nbr, out, jnp.zeros((), out.dtype))


def windowed_attention(graph, q: Array, k: Array, v: Array, *,
                       scale: "float | None" = None,
                       impl: "str | None" = None) -> Array:
    """Windowed attention over a :class:`DiagWindowGraph`.

    ``q``/``k``/``v`` are ``(..., N, dh)`` with ``N`` the graph's node count
    (or its padded row count); leading dims (heads, batch) are independent
    attention problems under the shared mask. Fully differentiable in
    ``q``/``k``/``v``; ``scale`` defaults to ``1/sqrt(dh)``; ``impl``
    defaults to the platform's choice
    (:func:`gwen.ops.platform.attention_impl`)."""
    from gwen.ops.platform import attention_impl

    n, f = q.shape[-2:]
    if scale is None:
        scale = 1.0 / (f ** 0.5)
    if impl is None:
        impl = attention_impl(q.dtype)
    out = window_attention_core(
        graph.xbase, graph.offsets, graph.s_mat, q, k, v,
        superblock=graph.superblock, src_rows=graph.num_src_rows,
        scale=float(scale), impl=impl)
    return out[..., :n, :]


def window_edges(graph) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ``(senders, receivers)`` of the in-window edges of a
    :class:`DiagWindowGraph` (the attention neighbourhood), receiver-sorted,
    restricted to real nodes."""
    s_mat = np.asarray(jax.device_get(graph.s_mat))
    rows, cols = np.nonzero(s_mat)
    starts = np.asarray(window_starts(graph.xbase, graph.offsets,
                                      graph.superblock))
    senders = starts[rows // graph.block_size] + cols
    keep = (rows < graph.num_nodes) & (senders < graph.num_nodes)
    return senders[keep].astype(np.int32), rows[keep].astype(np.int32)


def edge_attention_reference(senders, receivers, q: Array, k: Array,
                             v: Array, num_nodes: int, *,
                             scale: "float | None" = None) -> Array:
    """Edge-list masked-softmax attention in float32 (``segment_max`` /
    ``segment_sum`` over the receivers): the same semantics as
    :func:`windowed_attention` without the window layout, for goldens at
    mesh scale where a dense ``(N, N)`` reference does not fit."""
    f = q.shape[-1]
    if scale is None:
        scale = 1.0 / (f ** 0.5)
    q32, k32, v32 = (jnp.moveaxis(a.astype(jnp.float32), -2, 0)
                     for a in (q, k, v))  # (N, ..., d)
    logits = jnp.sum(q32[receivers] * k32[senders], axis=-1) * scale
    mx = jax.ops.segment_max(logits, receivers, num_segments=num_nodes,
                             indices_are_sorted=True)
    p = jnp.exp(logits - mx[receivers])
    den = jax.ops.segment_sum(p, receivers, num_segments=num_nodes,
                              indices_are_sorted=True)
    out = jax.ops.segment_sum(p[..., None] * v32[senders], receivers,
                              num_segments=num_nodes, indices_are_sorted=True)
    out = out / jnp.where(den == 0, 1.0, den)[..., None]
    return jnp.moveaxis(out, 0, -2)
