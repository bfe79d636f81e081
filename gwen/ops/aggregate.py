"""Sparse neighborhood aggregation — the framework's core op.

This replaces the torch-scatter / torch-sparse / pyg-lib CUDA kernels behind
the reference's ``GCNConv`` (SURVEY §2.2). Semantics for every backend::

    out[..., r, :] = sum over edges e with receivers[e] == r
                     of weights[e] * x[..., senders[e], :]

All backends accept ``(..., N, F)`` — aggregation is node-wise linear, so
leading batch dims are free.

Backends:

* ``segment``  — pure XLA: gather + ``jax.ops.segment_sum`` (receivers
  sorted at build time). Correctness baseline; the golden path for tests.
* ``dense``    — ``adj @ x`` for :class:`DenseGraph` (the reference's
  ~125-node fully-connected member graph densifies for free).
* ``pallas``   — the diagonal-window Triton kernel for mesh-scale graphs
  (:mod:`gwen.ops.spmm_pallas`); ``einsum`` is its plain-XLA form.

``aggregate`` dispatches on the graph container type (including
:class:`gwen.parallel.halo.HaloGraph` for partitioned meshes); for the
diagonal-window layout, :func:`gwen.ops.platform.diag_impl` picks the
implementation for the platform. The other window layouts (block-ELL,
block tiles, streamed/sliding S, bit-packed) are served by their jnp
references on every platform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gwen.graph.graph import (
    BlockEllGraph,
    BlockTileGraph,
    DenseGraph,
    DiagWindowGraph,
    Graph,
    MultiLevelGraph,
    SlidingDenseGraph,
    SlidingPackedGraph,
    SlidingRank1Graph,
    WindowedDenseGraph,
)

Array = jnp.ndarray


def aggregate_segment(graph: Graph, x: Array) -> Array:
    """Gather-scale-scatter via XLA ``segment_sum`` (static shapes, jit-safe).
    Graphs from :func:`gwen.graph.graph.build_graph` carry
    receiver-sorted edges, which the scatter is told."""
    if x.shape[-2] != graph.num_nodes:
        raise ValueError(
            f"x has {x.shape[-2]} node rows, graph has {graph.num_nodes} nodes"
        )
    # Move the node axis to the front so segment_sum sees it as leading.
    xm = jnp.moveaxis(x, -2, 0)  # (N, ..., F)
    w = graph.weights.astype(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    msgs = xm[graph.senders] * w
    out = jax.ops.segment_sum(
        msgs, graph.receivers, num_segments=graph.num_nodes,
        indices_are_sorted=graph.receivers_sorted,
    )
    return jnp.moveaxis(out, 0, -2)


# ----------------------------------------------------- escape composite
#
# The few out-of-window edges of the window layouts (``EscapeFixup``, ~2 %
# under the KD-patch ordering): gather ``x[nbr]`` per unique receiver,
# contract with the ELL weights, and place the rows with one sorted
# unique-index scatter-add. The escape set is symmetrised at build time
# (Eᵀ = E), so the backward is the same composite applied to the cotangent.


def _escape_rows_fix(nbr, w, x: Array) -> Array:
    """Escape contributions per unique receiver: ``x[nbr]`` + ELL
    contraction. Shapes: nbr/w (U_pad, deg), x (..., N, F) → (..., U_pad, F)."""
    gathered = jnp.take(x, nbr, axis=-2)  # (..., U_pad, deg, F)
    return jnp.einsum("ud,...udf->...uf", w.astype(x.dtype), gathered)


def _escape_place(rows, fix, out: Array) -> Array:
    """``out.at[..., rows, :].add(fix)`` — ``rows`` is strictly increasing
    with unique in-bounds entries (padding entries are out of bounds and
    dropped), so the scatter is told it is sorted and unique."""
    fix = fix.astype(out.dtype)
    lead = (slice(None),) * (out.ndim - 2)
    return out.at[lead + (rows,)].add(
        fix, indices_are_sorted=True, unique_indices=True, mode="drop"
    )


@jax.custom_vjp
def _escape_add_diff(nbr, w, rows, x, out):
    """``out + E @ x``; the placement rides inside this custom-VJP boundary
    so autodiff never transposes the gathers/scatters individually."""
    return _escape_place(rows, _escape_rows_fix(nbr, w, x), out)


def _escape_add_fwd(nbr, w, rows, x, out):
    return (
        _escape_add_diff(nbr, w, rows, x, out),
        (nbr, w, rows, jax.ShapeDtypeStruct(x.shape, x.dtype)),
    )


def _escape_add_bwd(res, g):
    # Eᵀ = E: the x-cotangent is the same operator applied to g (gathers
    # only touch rows < N, the scatter rows are < N); out-cotangent is g.
    nbr, w, rows, x_sds = res
    gx = _escape_place(
        rows,
        _escape_rows_fix(nbr, w, g),
        jnp.zeros(x_sds.shape, x_sds.dtype),
    )
    return (None, None, None, gx, g)


_escape_add_diff.defvjp(_escape_add_fwd, _escape_add_bwd)


def escape_add(graph, x: Array, out: Array) -> Array:
    """Add the graph's escape edges (``graph.escape``, an
    :class:`~gwen.graph.graph.EscapeFixup`) on top of ``out``."""
    esc = getattr(graph, "escape", None)
    if esc is None:
        return out
    return _escape_add_diff(esc.nbr, esc.w, esc.rows, x, out)


def aggregate_dense(graph: DenseGraph, x: Array) -> Array:
    """Dense normalized-adjacency matmul (small graphs).

    ``jnp.matmul`` broadcasts over leading batch dims: (N,N) @ (...,N,F).
    """
    return jnp.matmul(graph.adj.astype(x.dtype), x)


def aggregate_block_ell_reference(graph: BlockEllGraph, x: Array) -> Array:
    """jnp aggregation for the blocked-ELL layout;
    mathematically identical to :func:`aggregate_segment`."""
    leading = x.shape[:-2]
    n, f = x.shape[-2], x.shape[-1]
    xp = jnp.zeros(leading + (graph.src_rows, f), x.dtype)
    xp = xp.at[..., :n, :].set(x)
    # Absolute source index per (node, slot): window-relative + block window.
    win = jnp.repeat(graph.window_start, graph.block_size)  # (N_pad,)
    abs_idx = graph.nbr + win[:, None]
    gathered = jnp.take(xp, abs_idx, axis=-2)  # (..., N_pad, D, F)
    out = jnp.einsum("nd,...ndf->...nf", graph.nbr_weight.astype(x.dtype), gathered)
    out_rows = n if graph.src_rows == graph.num_padded_nodes else graph.num_padded_nodes
    return out[..., :out_rows, :]


def aggregate_block_tiles_reference(graph: BlockTileGraph, x: Array) -> Array:
    """jnp aggregation for the block-tile (BSR) layout; mathematically
    identical to :func:`aggregate_segment`."""
    leading = x.shape[:-2]
    n, f = x.shape[-2], x.shape[-1]
    xp = jnp.zeros(leading + (graph.num_src_rows, f), x.dtype)
    xp = xp.at[..., :n, :].set(x)
    n_pad = graph.num_padded_nodes
    bs = graph.block_size
    dt = graph.tile_degree
    # Absolute source index per (node, flat slot): tile base + within-tile.
    flat = graph.tnbr.shape[1]
    slot_tile = (jnp.arange(flat) // dt).clip(0, graph.tiles_max - 1)  # (flat,)
    node_block = jnp.arange(n_pad) // bs  # (N_pad,)
    tile_of_slot = graph.tile_idx[node_block[:, None], slot_tile[None, :]]
    abs_idx = tile_of_slot * bs + graph.tnbr
    gathered = jnp.take(xp, abs_idx, axis=-2)  # (..., N_pad, flat, f)
    out = jnp.einsum("nk,...nkf->...nf", graph.tw.astype(x.dtype), gathered)
    out_rows = n if graph.num_src_rows == n_pad else n_pad
    return out[..., :out_rows, :]


def aggregate_windowed_dense_reference(graph: WindowedDenseGraph, x: Array) -> Array:
    """jnp aggregation for the streamed-S layout."""
    n, f = x.shape[-2], x.shape[-1]
    leading = x.shape[:-2]
    xp = jnp.zeros(leading + (graph.num_src_rows, f), x.dtype)
    xp = xp.at[..., :n, :].set(x)
    bs = graph.block_size
    nblocks = graph.num_blocks

    def one_block(s_blk, start):
        win = jax.lax.dynamic_slice_in_dim(xp, start, graph.window_size, axis=-2)
        return jnp.einsum("bw,...wf->...bf", s_blk.astype(x.dtype), win)

    s_blocks = graph.s_mat.reshape(nblocks, bs, graph.window_size)
    outs = [one_block(s_blocks[b], graph.window_start[b]) for b in range(nblocks)]
    out = jnp.concatenate(outs, axis=-2)
    out_rows = n if graph.num_src_rows == graph.num_padded_nodes else graph.num_padded_nodes
    return out[..., :out_rows, :]


def aggregate_sliding_dense_reference(graph: SlidingDenseGraph, x: Array) -> Array:
    """jnp aggregation for the sliding-ring layout (escape edges included)."""
    n, f = x.shape[-2], x.shape[-1]
    leading = x.shape[:-2]
    src_alloc = ((graph.num_src_rows + graph.block_size - 1)
                 // graph.block_size) * graph.block_size
    xp = jnp.zeros(leading + (src_alloc, f), x.dtype)
    xp = xp.at[..., :n, :].set(x)
    bs = graph.block_size
    ring = graph.ring_rows
    w = graph.window_size
    s_blocks = graph.s_mat.reshape(graph.num_blocks, bs, ring)
    outs = []
    for b in range(graph.num_blocks):
        start = graph.window_start[b]
        win = jax.lax.dynamic_slice_in_dim(xp, start, w, axis=-2)
        cols = (start + jnp.arange(w)) % ring  # ring-layout columns
        s_win = jnp.take(s_blocks[b].astype(x.dtype), cols, axis=1)  # (bs, w)
        outs.append(jnp.einsum("bw,...wf->...bf", s_win, win))
    out = jnp.concatenate(outs, axis=-2)
    n_pad = graph.num_padded_nodes
    out_rows = n if graph.num_src_rows == n_pad else n_pad
    out = out[..., :out_rows, :]
    return escape_add(graph, x, out)


def window_starts(xbase, offsets, superblock: int) -> Array:
    """Window start row of every destination block of a diagonal-window
    layout: ``xbase[b // superblock] + offsets[b]``."""
    offsets = jnp.asarray(offsets)
    nb = offsets.shape[0]
    return jnp.take(jnp.asarray(xbase), jnp.arange(nb) // superblock) + offsets


def gather_windows(x: Array, starts: Array, window: int) -> Array:
    """``(..., R, d)`` → ``(..., num_blocks, W, d)``: rows
    ``starts[b] + w`` (one gather, built from the tables with an iota add —
    no Python loop over blocks)."""
    idx = starts[:, None] + jnp.arange(window)[None, :]
    out = jnp.take(x, idx.reshape(-1), axis=-2)
    return out.reshape(x.shape[:-2] + idx.shape + (x.shape[-1],))


def diag_window_core_einsum(graph, x: Array, src_rows: int) -> Array:
    """Plain-XLA in-window aggregation: gather every block's window
    ``(..., num_blocks, W, F)`` and contract it with the block's S tile.
    Output rows = ``num_padded_nodes`` (S rows)."""
    rows, f = x.shape[-2:]
    if rows < src_rows:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, src_rows - rows), (0, 0)]
        x = jnp.pad(x, pad)
    starts = window_starts(graph.xbase, graph.offsets, graph.superblock)
    win = gather_windows(x, starts, graph.window_size)
    nb, w = starts.shape[0], graph.window_size
    s = jnp.asarray(graph.s_mat).reshape(nb, graph.block_size, w)
    out = jnp.einsum("kbw,...kwf->...kbf", s.astype(x.dtype), win,
                     preferred_element_type=jnp.float32)
    return out.reshape(x.shape[:-2] + (nb * graph.block_size, f)).astype(
        x.dtype)


def aggregate_diag_window_reference(graph: DiagWindowGraph, x: Array) -> Array:
    """Plain-XLA diagonal-window aggregation (gathered-window einsum plus
    the escape composite); the same semantics as the Triton kernel
    (:func:`gwen.ops.spmm_pallas.spmm_diag_window`) and as
    :func:`aggregate_segment` on the source graph."""
    n = x.shape[-2]
    n_pad = graph.num_padded_nodes
    src_rows = graph.num_src_rows
    out = diag_window_core_einsum(graph, x, src_rows)
    # Pre-padded callers (EncodeProcessDecode keeps the chain at n_pad
    # rows) get their row count back; everyone else gets num_nodes.
    out_rows = n if n in (n_pad, src_rows) else graph.num_nodes
    return escape_add(graph, x, out[..., :out_rows, :])


def aggregate_sliding_packed_reference(graph: SlidingPackedGraph, x: Array) -> Array:
    """jnp aggregation for the bit-packed rank-1 layout."""
    from gwen.graph.graph import _packed_row_bit

    n = x.shape[-2]
    # Tile-order unpack: global row i = bit pbit[i] of packed row prow[i].
    prow, pbit = _packed_row_bit(graph.num_padded_nodes, graph.block_size)
    s01 = (
        (graph.packed[prow] >> jnp.asarray(pbit[:, None], jnp.uint8)) & 1
    ).astype(x.dtype)
    core = SlidingDenseGraph(
        s_mat=s01,
        window_start=graph.window_start,
        delta_blocks=graph.delta_blocks,
        num_nodes=graph.num_nodes,
        num_edges=graph.num_edges,
        block_size=graph.block_size,
        window_size=graph.window_size,
        max_delta_blocks=graph.max_delta_blocks,
        num_src_rows=graph.num_src_rows,
    )
    xs = x * graph.col_scale[:n, None].astype(x.dtype)
    out = aggregate_sliding_dense_reference(core, xs)
    return out * graph.row_scale[: out.shape[-2], None].astype(out.dtype)


def aggregate(graph, x: Array, backend: str = "auto") -> Array:
    """Dispatch aggregation by graph container type.

    ``backend`` matters for the diagonal-window layout only: ``"auto"``
    takes the platform's choice (:func:`gwen.ops.platform.diag_impl`),
    ``"pallas"`` forces the Triton kernel, any other value (``"einsum"``,
    ``"segment"``, ``"reference"``) the plain-XLA form."""
    # Late import: parallel depends on ops for local aggregation.
    from gwen.parallel.halo import HaloDiagGraph, HaloGraph, aggregate_halo

    if isinstance(graph, MultiLevelGraph):
        out = aggregate(graph.subgraphs[0], x, backend=backend)
        for sub in graph.subgraphs[1:]:
            out = out + aggregate(sub, x, backend=backend)
        return out
    if isinstance(graph, DenseGraph):
        return aggregate_dense(graph, x)
    if isinstance(graph, (HaloGraph, HaloDiagGraph)):
        return aggregate_halo(graph, x, backend=backend)
    if isinstance(graph, DiagWindowGraph):
        from gwen.ops.platform import diag_impl

        if diag_impl(backend) == "pallas":
            from gwen.ops.spmm_pallas import spmm_diag_window

            return spmm_diag_window(graph, x)
        return aggregate_diag_window_reference(graph, x)
    if isinstance(graph, WindowedDenseGraph):
        return aggregate_windowed_dense_reference(graph, x)
    if isinstance(graph, SlidingPackedGraph):
        return aggregate_sliding_packed_reference(graph, x)
    if isinstance(graph, SlidingRank1Graph):
        n = x.shape[-2]
        xs = x * graph.col_scale[:n, None].astype(x.dtype)
        out = aggregate_sliding_dense_reference(graph.core, xs)
        return out * graph.row_scale[: out.shape[-2], None].astype(out.dtype)
    if isinstance(graph, SlidingDenseGraph):
        return aggregate_sliding_dense_reference(graph, x)
    if isinstance(graph, BlockTileGraph):
        return aggregate_block_tiles_reference(graph, x)
    if isinstance(graph, BlockEllGraph):
        return aggregate_block_ell_reference(graph, x)
    if isinstance(graph, Graph):
        return aggregate_segment(graph, x)
    raise TypeError(f"Unknown graph type: {type(graph)!r}")
