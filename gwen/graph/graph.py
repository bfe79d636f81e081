"""Static-shape graph containers for the aggregation ops.

The reference leans on PyTorch-Geometric: ``edge_index`` COO tensors consumed by
``GCNConv``'s torch-scatter/torch-sparse CUDA kernels (SURVEY §2.2). Under
``jit`` everything must have static shapes, so graphs are immutable pytree
dataclasses with host-side (numpy) construction and padding:

* :class:`Graph` — COO edge list with precomputed normalized edge coefficients,
  padded to a static edge count and sorted by receiver. Aggregation =
  ``segment_sum`` (XLA scatter-add).
* :class:`DenseGraph` — dense normalized adjacency, for small graphs such as the
  reference's fully-connected ensemble-member graph (~125 nodes,
  ``erdos_renyi_graph(nodes, edge_prob=1)``, utils.py:176). A dense ``adj @ x``
  beats any sparse path at this size.
* :class:`DiagWindowGraph` — the mesh-scale layout: per 128-row destination
  block, a dense weight tile over one contiguous source window (the Triton
  kernel in :mod:`gwen.ops.spmm_pallas`), plus the few out-of-window
  edges as an :class:`EscapeFixup`.
* :class:`BlockEllGraph`, :class:`BlockTileGraph`, :class:`WindowedDenseGraph`,
  :class:`SlidingDenseGraph`, :class:`SlidingRank1Graph`,
  :class:`SlidingPackedGraph` — older window layouts, served by their jnp
  aggregations (:mod:`gwen.ops.aggregate`).

All normalization (GCN symmetric norm, self loops) is precomputed on the host at
construction; device code only ever multiplies and accumulates.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from gwen import struct

Array = jnp.ndarray


@struct.dataclass
class Graph:
    """COO graph, padded to static shapes.

    ``out[receivers[e]] += weights[e] * x[senders[e]]`` defines aggregation.
    Padding edges have ``weights == 0``, so they are numerically inert
    without any masking in the hot path. ``receivers_sorted`` says the edge
    list (padding included) is nondecreasing in ``receivers``, which
    :func:`build_graph` guarantees and the scatter is then told.
    """

    senders: Array  # (E_pad,) int32
    receivers: Array  # (E_pad,) int32
    weights: Array  # (E_pad,) float32 — normalized coefficients, 0 on padding
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)  # actual edges (<= E_pad)
    receivers_sorted: bool = struct.field(pytree_node=False, default=False)

    @property
    def num_padded_edges(self) -> int:
        return int(self.senders.shape[0])


@struct.dataclass
class DenseGraph:
    """Dense normalized adjacency; aggregation is ``adj @ x``."""

    adj: Array  # (N, N) float32; row r holds the coefficients feeding node r
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)


@struct.dataclass
class BlockEllGraph:
    """Blocked-ELL layout (padded per-node neighbour lists per block).

    Nodes are grouped into blocks of ``block_size`` destination rows. Each node
    has its neighbor list padded to ``max_degree``. For every destination block
    ``b``, all neighbor indices fall inside the source window
    ``[window_start[b], window_start[b] + window_size)`` — guaranteed by the
    host-side bandwidth-reducing reordering (``gwen.graph.reorder``).
    ``nbr`` stores indices *relative to the block's window start*.
    """

    nbr: Array  # (N_pad, max_degree) int32, window-relative source indices
    nbr_weight: Array  # (N_pad, max_degree) float32, 0 on padding
    window_start: Array  # (num_blocks,) int32 into the padded source-row axis
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    window_size: int = struct.field(pytree_node=False)
    # Rows of the source feature array; == destination rows for a plain graph,
    # larger for halo-extended local partitions (gwen.parallel).
    num_src_rows: int = struct.field(pytree_node=False, default=-1)

    @property
    def num_padded_nodes(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def src_rows(self) -> int:
        return self.num_src_rows if self.num_src_rows > 0 else self.num_padded_nodes

    @property
    def max_degree(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def num_blocks(self) -> int:
        return int(self.window_start.shape[0])


@struct.dataclass
class BlockTileGraph:
    """Block-sparse-row layout (per-block active source tiles).

    Destinations are grouped in ``block_size``-row blocks; each block lists
    its *active* source tiles (``block_size``-row chunks that contain at
    least one neighbor). Per destination node and tile slot, neighbor indices
    are within-tile (0..block_size-1) in a flattened padded list of
    ``tiles_max * tile_degree`` slots. Inactive tile slots have zero weights
    and are skipped in-kernel via ``n_active``.
    """

    tile_idx: Array  # (num_blocks, tiles_max) int32 — source tile ids
    n_active: Array  # (num_blocks,) int32 — active tiles per block
    tnbr: Array  # (N_pad, tiles_max * tile_degree) int32, within-tile idx
    tw: Array  # (N_pad, tiles_max * tile_degree) float32, 0 on padding
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    tiles_max: int = struct.field(pytree_node=False)
    tile_degree: int = struct.field(pytree_node=False)
    num_src_rows: int = struct.field(pytree_node=False)

    @property
    def num_padded_nodes(self) -> int:
        return int(self.tnbr.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.tile_idx.shape[0])


# ------------------------------------------------------------------ builders


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gcn_normalize(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    self_loops: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric GCN normalization, computed host-side.

    Matches the math inside PyG's ``GCNConv`` (used at models_gnn.py:118-184):
    with self loops, ``w_e = 1/sqrt(d̂(s) d̂(r))`` where ``d̂(i) = deg(i) + 1``
    and the appended self-loop edge ``(i, i)`` gets ``1/d̂(i)``. Degree is the
    in-degree of the (directed) edge list; for the symmetric graphs used
    throughout this is the usual GCN norm.

    Returns the possibly-extended ``(senders, receivers, weights)`` arrays.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    deg = np.bincount(receivers, minlength=num_nodes).astype(np.float64)
    if self_loops:
        deg = deg + 1.0
    inv_sqrt = np.zeros_like(deg)
    nz = deg > 0
    inv_sqrt[nz] = 1.0 / np.sqrt(deg[nz])
    weights = inv_sqrt[senders] * inv_sqrt[receivers]
    if self_loops:
        loops = np.arange(num_nodes, dtype=np.int64)
        senders = np.concatenate([senders, loops])
        receivers = np.concatenate([receivers, loops])
        weights = np.concatenate([weights, inv_sqrt[loops] ** 2])
    return senders, receivers, weights.astype(np.float32)


def build_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    self_loops: bool = True,
    normalize: bool = True,
    weights: Optional[np.ndarray] = None,
    edge_pad_multiple: int = 512,
) -> Graph:
    """Build a padded COO :class:`Graph` from raw (host) edge arrays."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if senders.shape != receivers.shape:
        raise ValueError("senders/receivers must have matching shapes")
    if senders.size and (senders.max() >= num_nodes or receivers.max() >= num_nodes):
        raise ValueError("edge index out of range")
    if normalize:
        if weights is not None:
            raise ValueError("pass either normalize=True or explicit weights")
        senders, receivers, w = gcn_normalize(senders, receivers, num_nodes, self_loops)
    else:
        w = (
            np.ones(senders.shape[0], np.float32)
            if weights is None
            else np.asarray(weights, np.float32)
        )
    e = senders.shape[0]
    e_pad = max(_round_up(e, edge_pad_multiple), edge_pad_multiple)
    # Receiver-sorted (then sender) edge order; padding edges point at the
    # last node, so the padded list stays sorted for the scatter.
    order = np.lexsort((senders, receivers))
    last = max(int(num_nodes) - 1, 0)
    s = np.full(e_pad, last, np.int32)
    r = np.full(e_pad, last, np.int32)
    ww = np.zeros(e_pad, np.float32)
    s[:e] = senders[order]
    r[:e] = receivers[order]
    ww[:e] = np.asarray(w, np.float32)[order]
    # Containers keep NUMPY leaves: layout converters and partitioners read
    # them host-side, and device placement happens lazily at first jit use
    # (or explicitly via jax.device_put where the graph enters a hot loop).
    # Eager device arrays would round-trip hundreds of MB through the
    # host<->device link at ICON-mesh scale.
    return Graph(
        senders=s,
        receivers=r,
        weights=ww,
        num_nodes=int(num_nodes),
        num_edges=int(e),
        receivers_sorted=True,
    )


def to_dense(graph: Graph) -> DenseGraph:
    """Densify a (small) graph into a normalized adjacency matrix."""
    n = graph.num_nodes
    s = np.asarray(graph.senders)
    r = np.asarray(graph.receivers)
    w = np.asarray(graph.weights)
    adj = np.zeros((n, n), np.float32)
    np.add.at(adj, (r, s), w)
    return DenseGraph(adj=adj, num_nodes=n, num_edges=graph.num_edges)


def ell_tables(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_dst: int,
    num_src: int,
    *,
    block_size: int = 128,
    window_size: Optional[int] = None,
    lane_multiple: int = 8,
    max_degree: Optional[int] = None,
    forced_window_start: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Build blocked-ELL tables from COO (host-side).

    Destination and source index spaces may differ (halo-extended partitions).
    Returns ``(nbr_rel, nbr_weight, window_start, window_size, src_rows)``
    where ``nbr_rel`` indices are relative to each destination block's
    128-aligned source window and ``src_rows`` is the padded source-row count
    every window stays within.

    ``forced_window_start`` (block-aligned, one per destination block)
    overrides the per-block min-source placement — used by the escape-window
    sliding layout, where window positions are chosen by edge density and
    out-of-window edges were already split off. Every remaining edge must fit
    ``[start, start + window_size)`` or a ``ValueError`` is raised.
    """
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    w = np.asarray(weights, np.float32)
    e = s.shape[0]

    n_pad = _round_up(max(num_dst, 1), block_size)
    src_pad = _round_up(max(num_src, 1), block_size)
    order = np.argsort(r, kind="stable")
    s, r, w = s[order], r[order], w[order]
    counts = np.bincount(r, minlength=n_pad)
    deg = int(counts.max()) if e else 1
    deg = max(_round_up(deg, lane_multiple), lane_multiple)
    if max_degree is not None:
        if deg > max_degree:
            raise ValueError(f"max degree {deg} exceeds requested {max_degree}")
        deg = max_degree

    nbr = np.zeros((n_pad, deg), np.int32)
    nbr_w = np.zeros((n_pad, deg), np.float32)
    starts = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(e) - starts[r]
    nbr[r, slot] = s
    nbr_w[r, slot] = w

    num_blocks = n_pad // block_size
    blk = r // block_size
    if forced_window_start is not None:
        lo = np.asarray(forced_window_start, np.int64)
        if lo.shape != (num_blocks,):
            raise ValueError(
                f"forced_window_start has shape {lo.shape}, "
                f"expected ({num_blocks},)"
            )
        if (lo % block_size).any():
            raise ValueError("forced_window_start must be block-aligned")
        if window_size is None:
            raise ValueError("forced_window_start requires window_size")
        rel_chk = s - lo[blk]
        if e and (rel_chk.min() < 0 or rel_chk.max() >= int(window_size)):
            raise ValueError(
                "edges escape the forced windows; split escapes first"
            )
        max_span = int(rel_chk.max()) + 1 if e else 1
    else:
        lo = np.full(num_blocks, src_pad, np.int64)
        hi = np.zeros(num_blocks, np.int64)
        np.minimum.at(lo, blk, s)
        np.maximum.at(hi, blk, s + 1)
        empty = lo > hi
        lo[empty], hi[empty] = 0, 1
        # Align window starts down to the block size (clean DMA alignment for
        # the kernels); spans are measured from the aligned start.
        lo = (lo // block_size) * block_size
        spans = hi - lo
        max_span = int(spans.max()) if num_blocks else 1
    if window_size is None:
        window_size = max(_round_up(max_span, block_size), block_size)
    # Round user-supplied windows up to a block multiple — window starts must
    # stay block-aligned (the kernels rely on block-aligned window starts).
    window_size = _round_up(int(window_size), block_size)
    window_size = min(window_size, src_pad)
    if max_span > window_size:
        raise ValueError(
            f"graph bandwidth {max_span} exceeds window_size {window_size}; "
            "apply rcm_order() first or increase window_size"
        )
    # Clamp the window inside the padded source axis (stays block-aligned
    # because src_pad and window_size are both block multiples).
    win_start = np.minimum(lo, src_pad - window_size)
    win_start = np.maximum(win_start, 0).astype(np.int32)
    nbr_rel = nbr - win_start.repeat(block_size)[:, None]
    # Padding slots keep weight 0; point them at offset 0 of the window.
    nbr_rel = np.where(nbr_w != 0, nbr_rel, 0).astype(np.int32)
    return nbr_rel, nbr_w, win_start, int(window_size), src_pad


def to_block_ell(
    graph: Graph,
    *,
    block_size: int = 128,
    window_size: Optional[int] = None,
    lane_multiple: int = 8,
) -> BlockEllGraph:
    """Convert a COO graph to the blocked-ELL layout.

    Requires a locality-preserving node ordering (see
    ``gwen.graph.reorder.rcm_order``): for each 128-row destination block,
    every source index must fit in a window of ``window_size`` consecutive
    nodes. Raises ``ValueError`` if the ordering is too scattered — reorder
    first or increase ``window_size``.
    """
    n = graph.num_nodes
    e = graph.num_edges
    nbr, nbr_w, win_start, window, src_pad = ell_tables(
        np.asarray(graph.senders)[:e],
        np.asarray(graph.receivers)[:e],
        np.asarray(graph.weights)[:e],
        num_dst=n,
        num_src=n,
        block_size=block_size,
        window_size=window_size,
        lane_multiple=lane_multiple,
    )
    return BlockEllGraph(
        nbr=nbr,
        nbr_weight=nbr_w,
        window_start=win_start,
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        window_size=window,
        num_src_rows=src_pad,
    )


def to_block_tiles(
    graph: Graph,
    *,
    block_size: int = 128,
    lane_multiple: int = 8,
    num_src: Optional[int] = None,
) -> BlockTileGraph:
    """Convert a COO graph to the block-tile (BSR) layout.

    Unlike :func:`to_block_ell`, bandwidth only affects how many *tiles* a
    destination block touches (``tiles_max``), not a contiguous window — so
    memory traffic and matmul work scale with the number of active tiles
    (~mean degree of the block graph), not the bandwidth. RCM ordering still helps
    by keeping ``tiles_max`` small.
    """
    n = graph.num_nodes
    e = graph.num_edges
    s = np.asarray(graph.senders)[:e].astype(np.int64)
    r = np.asarray(graph.receivers)[:e].astype(np.int64)
    w = np.asarray(graph.weights)[:e].astype(np.float32)
    n_src = int(num_src) if num_src is not None else n
    n_pad = _round_up(max(n, 1), block_size)
    src_pad = _round_up(max(n_src, 1), block_size)
    num_blocks = n_pad // block_size

    order = np.lexsort((s, r))
    s, r, w = s[order], r[order], w[order]
    blk = r // block_size
    tile = s // block_size

    # Active tile list per destination block.
    pair_key = blk * (src_pad // block_size + 1) + tile
    uniq_pairs = np.unique(pair_key)
    u_blk = uniq_pairs // (src_pad // block_size + 1)
    u_tile = uniq_pairs % (src_pad // block_size + 1)
    counts = np.bincount(u_blk, minlength=num_blocks)
    tiles_max = int(counts.max()) if e else 1
    tile_idx = np.zeros((num_blocks, tiles_max), np.int32)
    n_active = counts.astype(np.int32)
    starts = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_of_pair = np.arange(len(u_blk)) - starts[u_blk]
    tile_idx[u_blk, slot_of_pair] = u_tile
    # Map each edge to its block-local tile slot.
    pair_pos = np.searchsorted(uniq_pairs, pair_key)
    e_slot = slot_of_pair[pair_pos]

    # Per (node, tile-slot) sub-lists.
    key2 = r * tiles_max + e_slot
    counts2 = np.bincount(key2, minlength=n_pad * tiles_max)
    tile_degree = int(counts2.max()) if e else 1
    tile_degree = max(_round_up(tile_degree, lane_multiple), lane_multiple)
    starts2 = np.zeros(n_pad * tiles_max + 1, np.int64)
    np.cumsum(counts2, out=starts2[1:])
    order2 = np.argsort(key2, kind="stable")
    d_slot = np.empty(e, np.int64)
    d_slot[order2] = np.arange(e) - starts2[key2[order2]]

    tnbr = np.zeros((n_pad, tiles_max * tile_degree), np.int32)
    tw = np.zeros((n_pad, tiles_max * tile_degree), np.float32)
    col = e_slot * tile_degree + d_slot
    tnbr[r, col] = (s % block_size).astype(np.int32)
    tw[r, col] = w

    # Pad the flattened slot axis to a multiple of 128.
    flat = tiles_max * tile_degree
    flat_pad = _round_up(flat, 128)
    if flat_pad != flat:
        tnbr = np.pad(tnbr, ((0, 0), (0, flat_pad - flat)))
        tw = np.pad(tw, ((0, 0), (0, flat_pad - flat)))

    return BlockTileGraph(
        tile_idx=tile_idx,
        n_active=n_active,
        tnbr=tnbr,
        tw=tw,
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        tiles_max=tiles_max,
        tile_degree=tile_degree,
        num_src_rows=src_pad,
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _expand_s_device(cols: Array, weights: Array, width: int, dtype) -> Array:
    """Expand compact per-row ``(col, weight)`` slot tables into the dense
    ``(N_pad, width)`` scatter matrix *on device*.

    The compact tables are O(edges) (~tens of MB at ICON-mesh scale) while the
    dense S is O(N × window) (hundreds of MB at L8) — building S on device
    keeps the big array off the host→device link and out of host memory. XLA
    fuses the per-degree-slot compare+selects into a single pass over the
    output.

    Duplicate ``(row, col)`` slots accumulate, matching ``np.add.at``.
    """
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (cols.shape[0], width), 1)
    s = jnp.zeros((cols.shape[0], width), dtype)
    for d in range(cols.shape[1]):
        s = s + jnp.where(
            col_iota == cols[:, d : d + 1],
            weights[:, d : d + 1].astype(dtype),
            jnp.zeros((), dtype),
        )
    return s


@struct.dataclass
class WindowedDenseGraph:
    """Precomputed dense scatter-matrix layout (streamed S): per destination
    block, the one-hot × weight scatter matrix over its source window is
    materialized, so aggregation is one matmul per (block, f-tile).

    Memory: ``N_pad × window × itemsize`` (e.g. L7 icosphere, window 1664:
    0.55 GB bf16) — the fast, memory-hungry option; BlockEllGraph is the
    compact one.
    """

    s_mat: Array  # (N_pad, window) — scatter matrix rows, window-relative cols
    window_start: Array  # (num_blocks,) int32, block-aligned
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    num_src_rows: int = struct.field(pytree_node=False)

    @property
    def num_padded_nodes(self) -> int:
        return int(self.s_mat.shape[0])

    @property
    def window_size(self) -> int:
        return int(self.s_mat.shape[1])

    @property
    def num_blocks(self) -> int:
        return int(self.window_start.shape[0])


def to_windowed_dense(
    graph: Graph,
    *,
    block_size: int = 128,
    window_size: Optional[int] = None,
    dtype=np.float32,
    device_build: bool = False,
) -> WindowedDenseGraph:
    """Materialize per-block scatter matrices for the streamed-S kernel.
    Requires RCM ordering like :func:`to_block_ell`.

    ``device_build=True`` expands S on device from the compact ELL tables
    (see :func:`_expand_s_device`) — use it when S is large (L8+ meshes):
    only O(edges) bytes cross the host↔device link. The returned container
    then holds a *device* array leaf for ``s_mat``; partition it first if a
    host-side view is needed.
    """
    e = graph.num_edges
    n = graph.num_nodes
    nbr, nbr_w, win_start, window, src_pad = ell_tables(
        np.asarray(graph.senders)[:e],
        np.asarray(graph.receivers)[:e],
        np.asarray(graph.weights)[:e],
        num_dst=n,
        num_src=n,
        block_size=block_size,
        window_size=window_size,
    )
    n_pad = nbr.shape[0]
    if device_build:
        s_mat = _expand_s_device(
            jnp.asarray(nbr), jnp.asarray(nbr_w), window, np.dtype(dtype)
        )
    else:
        s_mat = np.zeros((n_pad, window), dtype)
        rows = np.repeat(np.arange(n_pad), nbr.shape[1])
        cols = nbr.ravel()
        np.add.at(s_mat, (rows, cols), nbr_w.ravel().astype(dtype))
    # Padding slots all point at col 0 with weight 0 — harmless in the add.
    return WindowedDenseGraph(
        s_mat=s_mat,
        window_start=win_start,
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        num_src_rows=src_pad,
    )


@struct.dataclass
class SlidingDenseGraph:
    """Streamed-S + sliding-window layout.

    Like :class:`WindowedDenseGraph` but source rows are addressed as a
    *ring buffer*: scatter-matrix columns are ``absolute_src_row %
    ring_rows``, and per destination block only the *delta* rows its window
    adds over the previous block's are new (graph bandwidth ⇒ deltas are a
    few 128-row chunks). Window starts are made monotonically nondecreasing
    at build time; the ring holds ``window + max_delta`` rows.
    """

    s_mat: Array  # (N_pad, ring_rows) — scatter rows, ring-layout columns
    window_start: Array  # (num_blocks,) int32, block-aligned, nondecreasing
    delta_blocks: Array  # (num_blocks,) int32 — 128-row chunks to fetch at i
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    window_size: int = struct.field(pytree_node=False)
    max_delta_blocks: int = struct.field(pytree_node=False)
    num_src_rows: int = struct.field(pytree_node=False)
    # Escape-window layout (``to_sliding_dense(window_size=...)`` +
    # ``kd_patch_order``): the few edges that do not fit the narrowed window.
    # The escape set is symmetrized at build time so the in-window part of S
    # stays symmetric — which is what keeps the kernel's
    # backward-reuses-forward custom VJP exact (and the fixup's own).
    escape: Optional["EscapeFixup"] = None

    @property
    def num_padded_nodes(self) -> int:
        return int(self.s_mat.shape[0])

    @property
    def ring_rows(self) -> int:
        return int(self.s_mat.shape[1])

    @property
    def num_blocks(self) -> int:
        return int(self.window_start.shape[0])


@struct.dataclass
class EscapeFixup:
    """Gather-only fixup for out-of-window edges of the escape-window layout.

    The fixup is formulated with gathers and one sorted, unique-index
    scatter of the U escape rows:

    * ``nbr``/``w``: ELL lists over the *unique* escape receivers — gather
      ``x[nbr]`` and contract with ``w`` (``deg`` is the max escapes per
      receiver, ~node degree).
    * ``rows``: ELL row → its unique destination row (out of bounds on
      padding rows, whose weights are all-zero), so placing the fixup into
      the full
      output is ``out.at[rows].add(fix)`` — a *sorted unique-index*
      scatter-add that touches only the U escape rows (an
      inverse-permutation gather would touch all N output rows).

    The escape edge set is symmetric (build-time symmetrization), so the
    fixup operator E satisfies Eᵀ = E and its backward is itself — the fast
    path never runs a gather-transpose scatter even under autodiff.

    ``senders``/``receivers``/``weights`` keep the raw COO list (receiver-
    sorted, zero-weight padding) for tests and the segment-sum reference.
    """

    senders: Array  # (E_pad,) int32
    receivers: Array  # (E_pad,) int32
    weights: Array  # (E_pad,) float32 — 0 on padding
    nbr: Array  # (U_pad, deg) int32 — escape sources per unique receiver
    w: Array  # (U_pad, deg) float32 — 0 on padding; trailing rows all-zero
    num_edges: int = struct.field(pytree_node=False)
    num_nodes: int = struct.field(pytree_node=False)
    rows: Optional[Array] = None  # (U_pad,) int32 — ELL row → dst row;
    #   strictly increasing, padding out of bounds (dropped by the scatter)


@struct.dataclass
class DiagWindowGraph:
    """Diagonal-window layout (the Triton kernel's input).

    * Window starts are *implicitly diagonal*: ``ws[i] = clip(i·block − c,
      0, src − W)`` for one global offset ``c`` — locality orderings put the
      densest windows on the matrix diagonal anyway (forcing the diagonal
      costs ~no extra escapes on KD+RCM meshes). They are stored as
      ``xbase[i // superblock] + offsets[i]``, which the kernel reads from
      its two scalar tables.
    * S is stored *relative* to each block's window: exactly ``(N_pad, W)``
      with no slack columns, so S bytes and matmul flops are minimal.

    Out-of-window edges go to the shared :class:`EscapeFixup`, added outside
    the kernel by a gather and one sorted scatter-add
    (:func:`gwen.ops.aggregate.escape_add`).

    ``esc2_*`` (built on request, for the partitioned layout): the escape
    graph compacted to its U unique endpoints (receivers == senders, the
    set is symmetric) as a receiver-sorted COO :class:`Graph` in compact
    space, ``esc2_src`` the node row of every compact row and
    ``esc2_back`` the compact row of every fix row.
    """

    s_mat: Array  # (N_pad, W) — scatter rows, window-relative columns
    offsets: Array  # (num_blocks,) int32 — ws[i] − xbase[i // T]
    xbase: Array  # (num_super,) int32 — superblock start row
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    window_size: int = struct.field(pytree_node=False)
    superblock: int = struct.field(pytree_node=False)
    num_src_rows: int = struct.field(pytree_node=False)
    escape: Optional[EscapeFixup] = None
    esc2_graph: Optional["Graph"] = None
    esc2_src: Optional[Array] = None  # (U,) int32 — node row per c2 row
    esc2_back: Optional[Array] = None  # (U_pad,) int32 — c2 row per fix row

    @property
    def num_padded_nodes(self) -> int:
        return int(self.s_mat.shape[0])

    @property
    def num_super(self) -> int:
        return int(self.xbase.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.offsets.shape[0])


def to_diag_window(
    graph: Graph,
    *,
    window_size: int,
    block_size: int = 128,
    superblock: int = 8,
    dtype=np.float32,
    device_build: bool = False,
    escape_pad_multiple: int = 1024,
    n_pad: Optional[int] = None,
    compact_escapes: bool = False,
) -> DiagWindowGraph:
    """Build the diagonal-window layout (see :class:`DiagWindowGraph`).
    Requires a locality ordering (:func:`gwen.graph.reorder.
    kd_patch_order` for narrow windows with ~2 % escapes, or plain RCM with
    ``window_size`` ≥ the full band for zero escapes — RCM bands are
    symmetric around the diagonal, so the global-diagonal constraint costs
    ~nothing either way).

    ``device_build=True`` expands S on device from the O(edges) tables.
    ``compact_escapes=True`` also builds the compact escape graph
    (``esc2_*``) the partitioned layout needs."""
    e = graph.num_edges
    n = graph.num_nodes
    s_np = np.asarray(graph.senders)[:e].astype(np.int64)
    r_np = np.asarray(graph.receivers)[:e].astype(np.int64)
    w_np = np.asarray(graph.weights)[:e]

    block = block_size
    # Block-aligned (window starts are block-aligned, and ell_tables rounds
    # the window to a block multiple internally).
    W = _round_up(int(window_size), block)
    t_sb = max(int(superblock), 1)
    src_alloc = _round_up(max(n, 1), block)
    W = min(W, src_alloc)
    while W + (t_sb - 1) * block > src_alloc and t_sb > 1:
        t_sb -= 1  # tiny graphs: shrink the superblock
    buf = W + (t_sb - 1) * block
    if n_pad is None:
        n_pad = _round_up(max(n, 1), block * t_sb)
    elif n_pad < n or n_pad % (block * t_sb):
        raise ValueError(
            f"n_pad {n_pad} must be >= {n} and a multiple of "
            f"block_size*superblock = {block * t_sb}"
        )
    num_blocks = n_pad // block
    num_super = num_blocks // t_sb

    # Choose the global diagonal offset c minimizing escapes, over a small
    # set of block-aligned candidates derived from the densest starts.
    dense_ws = _densest_window_starts(s_np, r_np, num_blocks, W, block)
    diag = np.arange(num_blocks, dtype=np.int64) * block
    cands = np.unique(
        np.clip(
            (np.percentile(diag - dense_ws, [10, 25, 50, 75, 90]) // block)
            * block,
            0,
            W - block,
        ).astype(np.int64)
    )
    blk = r_np // block
    best_c, best_esc = 0, None
    for c in cands:
        ws_c = np.clip(diag - c, 0, max(src_alloc - W, 0))
        esc_c = int(((s_np < ws_c[blk]) | (s_np >= ws_c[blk] + W)).sum())
        if best_esc is None or esc_c < best_esc:
            best_c, best_esc = int(c), esc_c
    ws = np.clip(diag - best_c, 0, max(src_alloc - W, 0))

    out_of_win = (s_np < ws[blk]) | (s_np >= ws[blk] + W)
    esc_mask = _symmetric_escape_mask(s_np, r_np, out_of_win, n)
    escape = None
    esc2_graph = esc2_src = esc2_back = None
    n_esc = int(esc_mask.sum())
    if n_esc:
        _check_weight_symmetry(s_np, r_np, w_np, n)
        w_esc = w_np[esc_mask]
        escape = _build_escape_fixup(
            s_np[esc_mask], r_np[esc_mask], w_esc, n, escape_pad_multiple,
        )
        if compact_escapes:
            uniq = np.unique(r_np[esc_mask])
            es2 = np.searchsorted(uniq, s_np[esc_mask])
            er2 = np.searchsorted(uniq, r_np[esc_mask])
            order = np.lexsort((es2, er2))
            esc2_graph = Graph(
                senders=es2[order].astype(np.int32),
                receivers=er2[order].astype(np.int32),
                weights=w_esc[order].astype(np.float32),
                num_nodes=int(uniq.size),
                num_edges=int(n_esc),
                receivers_sorted=True,
            )
            esc2_src = uniq.astype(np.int32)
            esc2_back = np.zeros(escape.nbr.shape[0], np.int32)
            esc2_back[: uniq.size] = np.arange(uniq.size, dtype=np.int32)
        keep = ~esc_mask
        s_np, r_np, w_np = s_np[keep], r_np[keep], w_np[keep]

    nbr_rel, nbr_w, _, _, _ = ell_tables(
        s_np, r_np, w_np,
        num_dst=n_pad,  # pad dst to the superblock multiple
        num_src=src_alloc,
        block_size=block,
        window_size=W,
        forced_window_start=ws,
    )
    s_mat = _build_s_ring(nbr_rel, nbr_w, W, dtype, device_build)

    xbase = np.clip(
        np.arange(num_super, dtype=np.int64) * t_sb * block - best_c,
        0,
        max(src_alloc - buf, 0),
    )
    offsets = ws - np.repeat(xbase, t_sb)
    if offsets.size and (offsets.min() < 0 or offsets.max() > buf - W):
        raise AssertionError("diag-window offsets escaped the superblock")

    return DiagWindowGraph(
        s_mat=s_mat,
        offsets=offsets.astype(np.int32),
        xbase=xbase.astype(np.int32),
        num_nodes=n,
        num_edges=e,
        block_size=block,
        window_size=int(W),
        superblock=t_sb,
        num_src_rows=src_alloc,
        escape=escape,
        esc2_graph=esc2_graph,
        esc2_src=esc2_src,
        esc2_back=esc2_back,
    )


def _sliding_monotonic(
    nbr: np.ndarray,
    nbr_w: np.ndarray,
    win_start: np.ndarray,
    block_size: int,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Phase 1 of the sliding-ring transform: monotonically nondecreasing
    window starts (running max) + absolute source indices.

    Returns ``(ws_mono, abs_idx, required_window)`` where ``required_window``
    is the smallest window covering every edge relative to ``ws_mono``.
    Shared across :func:`to_sliding_dense` and the partitioned builder
    (``gwen.parallel.partition``), which must agree on a window across
    partitions before phase 2.
    """
    ws = win_start.astype(np.int64)
    ws_mono = np.maximum.accumulate(ws)
    abs_idx = nbr.astype(np.int64) + ws.repeat(block_size)[:, None]
    rel_mono = abs_idx - ws_mono.repeat(block_size)[:, None]
    rel_mono = np.where(nbr_w != 0, rel_mono, 0)
    if rel_mono.size and rel_mono.min() < 0:
        raise AssertionError("monotonic window start broke coverage (below)")
    max_rel = int(rel_mono.max()) if rel_mono.size else 0
    return ws_mono, abs_idx, max_rel + 1


def _sliding_tables(
    ws_mono: np.ndarray,
    abs_idx: np.ndarray,
    nbr_w: np.ndarray,
    window: int,
    block_size: int,
    src_pad: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Phase 2: clamp window starts so every DMA stays inside the padded
    source axis, derive per-block delta chunk counts and ring-layout columns.

    Clamping ``ws = min(ws_mono, src_pad - window)`` is exact: it only moves
    starts *down*, so relative indices stay ≥ 0, and any edge still fits
    because its absolute index is < src_pad ≤ ws + window. (Without the
    clamp, a window grown past the ELL builder's per-block clamp would DMA
    rows beyond the padded source array.) Returns
    ``(ws_clamped, delta_blocks, abs_clamped, max_delta)``; ring columns are
    ``abs_clamped % ring_rows`` once the (possibly partition-shared)
    ``ring_rows ≥ window + max_delta*block`` is fixed by the caller.
    """
    ws = np.minimum(ws_mono, max(src_pad - window, 0))
    ws = np.maximum(ws, 0)
    rel = abs_idx - ws.repeat(block_size)[:, None]
    rel = np.where(nbr_w != 0, rel, 0)
    if rel.size and (rel.min() < 0 or rel.max() >= window):
        raise AssertionError("sliding window clamp broke coverage")
    deltas = np.diff(ws, prepend=ws[0])
    assert (deltas % block_size == 0).all()
    delta_blocks = (deltas // block_size).astype(np.int32)
    delta_blocks[0] = window // block_size  # step 0 fetches the full window
    num_blocks = len(ws)
    max_delta = int(delta_blocks[1:].max()) if num_blocks > 1 else 0
    abs_clamped = ws.repeat(block_size)[:, None] + rel
    return ws, delta_blocks, abs_clamped, max_delta


def _build_s_ring(cols, nbr_w, ring_rows, dtype, device_build):
    """Materialize the ring-layout scatter matrix (host numpy or on device
    from the compact O(edges) tables — see :func:`_expand_s_device`)."""
    n_pad = cols.shape[0]
    if device_build:
        return _expand_s_device(
            jnp.asarray(cols.astype(np.int32)), jnp.asarray(nbr_w),
            ring_rows, np.dtype(dtype),
        )
    s_mat = np.zeros((n_pad, ring_rows), dtype)
    rows = np.repeat(np.arange(n_pad), cols.shape[1])
    np.add.at(s_mat, (rows, cols.ravel()), nbr_w.ravel().astype(dtype))
    return s_mat


def _densest_window_starts(
    s: np.ndarray, r: np.ndarray, num_blocks: int, window: int, block: int
) -> np.ndarray:
    """Per destination block: the block-aligned window start covering the
    most edges, made monotonically nondecreasing (running max — measured to
    cost zero extra escapes on KD+RCM-ordered meshes, since densest windows
    track the matrix diagonal)."""
    blk = r // block
    order = np.lexsort((s, blk))
    s_o, blk_o = s[order], blk[order]
    counts = np.bincount(blk_o, minlength=num_blocks)
    bounds = np.zeros(num_blocks + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    ws = np.zeros(num_blocks, np.int64)
    for b in range(num_blocks):
        lo, hi = bounds[b], bounds[b + 1]
        if hi == lo:
            continue
        src = s_o[lo:hi]  # sorted within the block
        cand = np.unique(src // block) * block
        cov = np.searchsorted(src, cand + window, side="left") - np.searchsorted(
            src, cand, side="left"
        )
        ws[b] = cand[int(np.argmax(cov))]
    return np.maximum.accumulate(ws)


def _symmetric_escape_mask(
    s: np.ndarray, r: np.ndarray, esc: np.ndarray, num_nodes: int
) -> np.ndarray:
    """OR the escape flag across each undirected edge pair, so the in-window
    remainder stays symmetric (S = Sᵀ ⇒ the sliding kernels' custom VJP —
    backward = forward — remains exact)."""
    key = np.minimum(s, r).astype(np.int64) * np.int64(num_nodes) + np.maximum(s, r)
    uniq, inv = np.unique(key, return_inverse=True)
    esc_any = np.zeros(uniq.size, bool)
    np.logical_or.at(esc_any, inv, esc)
    return esc_any[inv]


def _check_weight_symmetry(
    s: np.ndarray, r: np.ndarray, w: np.ndarray, num_nodes: int
) -> None:
    """Verify ``w[a→b] == w[b→a]`` for every off-diagonal edge (and that the
    reverse edge exists) — the correctness precondition of the sliding/diag
    kernels' backward-reuses-forward custom VJP and the escape fixup's
    ``Eᵀ = E`` shortcut. Holds for GCN ``D^-1/2 A D^-1/2`` weights; fails
    loudly for e.g. row-normalized ``D^-1 A``. O(E log E) host-side."""
    off = s != r
    ss, rr, ww = s[off].astype(np.int64), r[off].astype(np.int64), w[off]
    key = np.minimum(ss, rr) * np.int64(num_nodes) + np.maximum(ss, rr)
    order = np.lexsort((ss, key))
    key_o, w_o = key[order], ww[order]
    if key_o.size % 2 or not np.array_equal(key_o[0::2], key_o[1::2]):
        raise ValueError(
            "graph structure is not symmetric: some edge lacks its reverse; "
            "the sliding/diag-window kernels' VJP (backward = forward) "
            "requires a symmetric adjacency"
        )
    a, b = w_o[0::2], w_o[1::2]
    scale = np.maximum(np.abs(a), np.abs(b))
    if not np.all(np.abs(a - b) <= 1e-5 * np.maximum(scale, 1e-30)):
        bad = int(np.argmax(np.abs(a - b) - 1e-5 * np.maximum(scale, 1e-30)))
        raise ValueError(
            "edge weights are not symmetric (w[a->b] != w[b->a], e.g. "
            f"pair {bad}: {a[bad]!r} vs {b[bad]!r}); the sliding/diag-window "
            "kernels' VJP and the escape fixup assume w[a->b] == w[b->a] "
            "(GCN sym-normalization). Use the segment/ELL backends for "
            "asymmetric weights."
        )


def _build_escape_fixup(
    es: np.ndarray,
    er: np.ndarray,
    ew: np.ndarray,
    num_nodes: int,
    pad_multiple: int,
    extra_rows: int = 0,
) -> EscapeFixup:
    """Host-side tables for the gather-only escape fixup (see
    :class:`EscapeFixup`). ``extra_rows`` pads additional all-zero ELL rows
    so in-kernel placement DMAs of a static ``cnt_pad`` slice stay in
    bounds."""
    n_esc = es.shape[0]
    eorder = np.argsort(er, kind="stable")
    es, er, ew = es[eorder], er[eorder], ew[eorder]
    # COO (receiver-sorted) for reference/tests.
    pad = _round_up(n_esc, pad_multiple)
    coo_s = np.zeros(pad, np.int32)
    coo_r = np.zeros(pad, np.int32)
    coo_w = np.zeros(pad, np.float32)
    coo_s[:n_esc], coo_r[:n_esc], coo_w[:n_esc] = es, er, ew
    # ELL over unique receivers + inverse map (trailing all-zero row).
    # deg is the exact max receiver count (escape degrees are tiny — p99≈4)
    # and padding slots re-point at the row's own first sender: the gather
    # is the fixup's real cost (~12 ns per 512 B random row read, measured),
    # so wasted slots are wasted milliseconds and a repeated row at least
    # rereads hot data.
    uniq, inv = np.unique(er, return_inverse=True)
    counts = np.bincount(inv)
    deg = max(int(counts.max()), 1)
    u_pad = _round_up(uniq.size + 1 + extra_rows, 8)  # ≥1 trailing zero row
    nbr = np.zeros((u_pad, deg), np.int32)
    w_ell = np.zeros((u_pad, deg), np.float32)
    starts = np.zeros(uniq.size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(n_esc) - starts[inv]
    nbr[inv, slot] = es
    w_ell[inv, slot] = ew
    pad_slot = (
        np.arange(deg)[None, :] >= counts[:, None]
    )  # (uniq, deg) padding mask
    nbr[: uniq.size][pad_slot] = np.broadcast_to(
        nbr[: uniq.size, :1], (uniq.size, deg)
    )[pad_slot]
    # Strictly increasing with unique in-bounds entries: padding entries are
    # out of bounds (>= num_nodes) and dropped by the scatter (mode="drop"),
    # so indices_are_sorted/unique_indices stay honest.
    rows = (
        np.arange(u_pad, dtype=np.int64) - uniq.size + num_nodes
    ).astype(np.int32)
    rows[: uniq.size] = uniq
    return EscapeFixup(
        senders=coo_s,
        receivers=coo_r,
        weights=coo_w,
        nbr=nbr,
        w=w_ell,
        num_edges=int(n_esc),
        num_nodes=num_nodes,
        rows=rows,
    )


def to_sliding_dense(
    graph: Graph,
    *,
    block_size: int = 128,
    dtype=np.float32,
    device_build: bool = False,
    window_size: Optional[int] = None,
    escape_pad_multiple: int = 1024,
) -> SlidingDenseGraph:
    """Build the sliding-ring streamed-S layout.

    ``device_build=True`` expands the big S array on device from compact
    O(edges) tables (see :func:`to_windowed_dense`); required in practice at
    L8+ scale where S is GBs and host→device placement would dominate.

    ``window_size`` (optional) narrows the streamed window below the graph's
    full band: per destination block the densest block-aligned window is
    chosen, and edges that do not fit (symmetrized — see
    :func:`_symmetric_escape_mask`) go to ``.escape``, an :class:`EscapeFixup`
    the aggregation adds back scatter-free (unique-receiver ELL gather +
    inverse-permutation placement). With a locality ordering such as
    :func:`gwen.graph.reorder.kd_patch_order`, a ~4-8x narrower window
    covers ~98 % of edges — S bytes and matmul flops (both ∝ window) shrink
    by the same factor, which is the L8+ unlock where the dense-S matmul is
    the wall (flops ∝ N·window).

    The sliding kernels' custom VJP reuses the forward on the cotangent,
    which requires the *weights* (not just the structure) to be symmetric:
    ``w[a→b] == w[b→a]`` (true for GCN ``D^-1/2 A D^-1/2`` normalization,
    NOT for row-normalized ``D^-1 A``). When escapes are split off this is
    verified at build time (cheap host-side check); asymmetric weights raise.
    """
    e = graph.num_edges
    n = graph.num_nodes
    s_np = np.asarray(graph.senders)[:e]
    r_np = np.asarray(graph.receivers)[:e]
    w_np = np.asarray(graph.weights)[:e]
    escape: Optional[Graph] = None
    forced_ws = None
    if window_size is not None:
        window_size = _round_up(int(window_size), block_size)
        n_pad = _round_up(max(n, 1), block_size)
        src_pad = n_pad
        num_blocks = n_pad // block_size
        ws = _densest_window_starts(s_np, r_np, num_blocks, window_size, block_size)
        # Pre-clamp into the padded source axis so the escape mask is
        # computed against the starts the kernel will actually use.
        ws = np.clip(ws, 0, max(src_pad - window_size, 0))
        blk = r_np // block_size
        out_of_win = (s_np < ws[blk]) | (s_np >= ws[blk] + window_size)
        esc_mask = _symmetric_escape_mask(s_np, r_np, out_of_win, n)
        n_esc = int(esc_mask.sum())
        if n_esc:
            _check_weight_symmetry(s_np, r_np, w_np, n)
            escape = _build_escape_fixup(
                s_np[esc_mask], r_np[esc_mask], w_np[esc_mask], n,
                escape_pad_multiple,
            )
            keep = ~esc_mask
            s_np, r_np, w_np = s_np[keep], r_np[keep], w_np[keep]
        forced_ws = ws
    nbr, nbr_w, win_start, window, src_pad = ell_tables(
        s_np,
        r_np,
        w_np,
        num_dst=n,
        num_src=n,
        block_size=block_size,
        window_size=window_size,
        forced_window_start=forced_ws,
    )
    ws_mono, abs_idx, required = _sliding_monotonic(
        nbr, nbr_w, win_start, block_size
    )
    window = max(window, _round_up(required, block_size))
    window = min(window, src_pad)
    if required > window:
        raise ValueError("window cannot cover spans after monotonic adjustment")
    ws, delta_blocks, abs_clamped, max_delta = _sliding_tables(
        ws_mono, abs_idx, nbr_w, window, block_size, src_pad
    )
    ring_rows = window + max(max_delta, 1) * block_size
    cols = abs_clamped % ring_rows
    s_mat = _build_s_ring(cols, nbr_w, ring_rows, dtype, device_build)

    return SlidingDenseGraph(
        s_mat=s_mat,
        window_start=ws.astype(np.int32),
        delta_blocks=delta_blocks,
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        window_size=int(window),
        max_delta_blocks=max(max_delta, 1),
        num_src_rows=src_pad,
        escape=escape,
    )


@struct.dataclass
class SlidingRank1Graph:
    """int8 rank-1-factored sliding-ring layout.

    GCN symmetric normalization is *exactly* rank-1: every edge weight is
    ``w_e = a[r] · a[s]`` with ``a = 1/sqrt(d̂)`` (self-loop weight
    ``a[i]²`` — how the builder recovers ``a`` from a normalized graph).
    So ``S = diag(a) · S01 · diag(a)`` with S01 the *binary* adjacency in
    ring layout: stream S01 as int8 (half the HBM bytes of bf16, quarter of
    f32) and apply the two scale vectors elementwise outside the kernel.
    ``core`` is a :class:`SlidingDenseGraph` whose ``s_mat`` holds int8 0/1.
    """

    core: SlidingDenseGraph
    row_scale: Array  # (N_pad,) float32 — a[r] for destination rows
    col_scale: Array  # (src_rows_padded,) float32 — a[s] for source rows

    @property
    def num_nodes(self) -> int:
        return self.core.num_nodes

    @property
    def num_edges(self) -> int:
        return self.core.num_edges

    @property
    def num_padded_nodes(self) -> int:
        return self.core.num_padded_nodes

    @property
    def num_src_rows(self) -> int:
        return self.core.num_src_rows


def rank1_scales(graph: Graph, atol: float = 1e-5) -> np.ndarray:
    """Recover the rank-1 factor ``a`` (``w_e = a[r]·a[s]``) from a
    GCN-normalized graph and VERIFY exactness on every edge.

    Uses the self-loop weights: gcn_normalize gives loop ``(i, i)`` weight
    ``a[i]²`` (graph.py:gcn_normalize). Raises ``ValueError`` if the graph
    has no self loops or its weights are not rank-1 to ``atol`` — callers
    fall back to the weighted sliding layout.
    """
    e = graph.num_edges
    s = np.asarray(graph.senders)[:e].astype(np.int64)
    r = np.asarray(graph.receivers)[:e].astype(np.int64)
    w = np.asarray(graph.weights)[:e].astype(np.float64)
    n = graph.num_nodes
    loops = s == r
    a2 = np.zeros(n, np.float64)
    a2[r[loops]] = w[loops]
    if not loops.any() or (a2 <= 0).any():
        raise ValueError(
            "rank-1 factorization needs self loops on every node "
            "(build the graph with self_loops=True / GCN normalization)"
        )
    a = np.sqrt(a2)
    if not np.allclose(w, a[r] * a[s], rtol=0, atol=atol):
        raise ValueError("edge weights are not rank-1 (w_e != a_r * a_s)")
    return a.astype(np.float32)


def to_sliding_rank1(
    graph: Graph,
    *,
    block_size: int = 128,
    device_build: bool = False,
) -> SlidingRank1Graph:
    """Build the int8 rank-1-factored sliding-ring layout.

    Exact for GCN-normalized graphs (validated edge-by-edge by
    :func:`rank1_scales`); S01 HBM footprint is half of the bf16 weighted
    ``to_sliding_dense`` S at identical kernel structure.
    """
    a = rank1_scales(graph)
    e = graph.num_edges
    n = graph.num_nodes
    nbr, nbr_w, win_start, window, src_pad = ell_tables(
        np.asarray(graph.senders)[:e],
        np.asarray(graph.receivers)[:e],
        np.asarray(graph.weights)[:e],
        num_dst=n,
        num_src=n,
        block_size=block_size,
    )
    ws_mono, abs_idx, required = _sliding_monotonic(
        nbr, nbr_w, win_start, block_size
    )
    window = max(window, _round_up(required, block_size))
    window = min(window, src_pad)
    if required > window:
        raise ValueError("window cannot cover spans after monotonic adjustment")
    ws, delta_blocks, abs_clamped, max_delta = _sliding_tables(
        ws_mono, abs_idx, nbr_w, window, block_size, src_pad
    )
    ring_rows = window + max(max_delta, 1) * block_size
    cols = abs_clamped % ring_rows
    ones = (nbr_w != 0).astype(np.float32)  # binary slots; 0 on padding
    s01 = _build_s_ring(cols, ones, ring_rows, np.int8, device_build)

    n_pad = nbr.shape[0]
    row_scale = np.zeros(n_pad, np.float32)
    row_scale[:n] = a
    col_scale = np.zeros(src_pad, np.float32)
    col_scale[:n] = a
    core = SlidingDenseGraph(
        s_mat=s01,
        window_start=ws.astype(np.int32),
        delta_blocks=delta_blocks,
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        window_size=int(window),
        max_delta_blocks=max(max_delta, 1),
        num_src_rows=src_pad,
    )
    return SlidingRank1Graph(core=core, row_scale=row_scale, col_scale=col_scale)


@struct.dataclass
class SlidingPackedGraph:
    """Bit-packed rank-1 sliding-ring layout.

    Like :class:`SlidingRank1Graph` but S01 is packed 8 destination rows per
    byte along the row axis: ``packed[g, c]`` bit ``b`` = S01[8g+b, c] —
    1/16 of the bf16 weighted S in memory. Exact GCN scales apply outside
    (``out = a ⊙ K01(a ⊙ x)``), so this layout requires rank-1 weights.
    """

    packed: Array  # (N_pad // 8, ring_rows) uint8 — row-packed binary S
    window_start: Array  # (num_blocks,) int32, block-aligned, nondecreasing
    delta_blocks: Array  # (num_blocks,) int32
    row_scale: Array  # (N_pad,) float32
    col_scale: Array  # (src_rows_padded,) float32
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    window_size: int = struct.field(pytree_node=False)
    max_delta_blocks: int = struct.field(pytree_node=False)
    num_src_rows: int = struct.field(pytree_node=False)

    @property
    def num_padded_nodes(self) -> int:
        return int(self.packed.shape[0]) * 8

    @property
    def ring_rows(self) -> int:
        return int(self.packed.shape[1])

    @property
    def num_blocks(self) -> int:
        return int(self.window_start.shape[0])


def _packed_row_bit(n_pad: int, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Tile-order packing map: global row ``i`` lives in packed row
    ``blk*gpb + (l % gpb)`` at bit ``l // gpb`` (``l = i % block``,
    ``gpb = block // 8``) — whole-array tiling of the packed tile, undone
    with a single per-row bit mask."""
    gpb = block_size // 8
    i = np.arange(n_pad)
    blk, l = i // block_size, i % block_size
    return blk * gpb + (l % gpb), (l // gpb).astype(np.uint8)


@functools.partial(jax.jit, static_argnums=(2,))
def _pack_s_device(cols: Array, nonzero: Array, ring: int) -> Array:
    """Build the row-packed binary scatter matrix on device from compact
    per-row slot tables PRE-GATHERED into tile order: ``cols``/``nonzero``
    are (groups, 8, degree) where axis 1 is the bit index. Device analog of
    the np.bitwise_or.at host build; same rationale as
    :func:`_expand_s_device` — only O(edges) bytes cross the host→device
    link, the packed array never does."""
    g, _, deg = cols.shape
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (g, ring), 1)
    p = jnp.zeros((g, ring), jnp.uint8)
    for b in range(8):
        for d in range(deg):
            hit = (col_iota == cols[:, b, d][:, None]) & nonzero[:, b, d][:, None]
            p = p | jnp.where(hit, jnp.uint8(1 << b), jnp.uint8(0))
    return p


def to_sliding_packed(
    graph: Graph,
    *,
    block_size: int = 256,
    device_build: bool = False,
) -> SlidingPackedGraph:
    """Build the bit-packed rank-1 sliding layout.

    ``block_size`` must be a multiple of 8 (row packing); 256 by default.
    """
    if block_size % 8:
        raise ValueError("block_size must be a multiple of 8 for row packing")
    a = rank1_scales(graph)
    e = graph.num_edges
    n = graph.num_nodes
    nbr, nbr_w, win_start, window, src_pad = ell_tables(
        np.asarray(graph.senders)[:e],
        np.asarray(graph.receivers)[:e],
        np.asarray(graph.weights)[:e],
        num_dst=n,
        num_src=n,
        block_size=block_size,
    )
    ws_mono, abs_idx, required = _sliding_monotonic(
        nbr, nbr_w, win_start, block_size
    )
    window = max(window, _round_up(required, block_size))
    window = min(window, src_pad)
    if required > window:
        raise ValueError("window cannot cover spans after monotonic adjustment")
    ws, delta_blocks, abs_clamped, max_delta = _sliding_tables(
        ws_mono, abs_idx, nbr_w, window, block_size, src_pad
    )
    ring_rows = window + max(max_delta, 1) * block_size
    cols = (abs_clamped % ring_rows).astype(np.int32)
    n_pad = nbr.shape[0]
    deg = nbr.shape[1]

    prow, pbit = _packed_row_bit(n_pad, block_size)
    if device_build:
        # Pre-gather the compact tables into tile order (g, 8, deg): the
        # global row for (group g, bit b) inverts _packed_row_bit.
        gpb = block_size // 8
        gidx = np.arange(n_pad // 8)
        rows = ((gidx // gpb)[:, None] * block_size
                + np.arange(8)[None, :] * gpb + (gidx % gpb)[:, None])
        packed = _pack_s_device(
            jnp.asarray(cols[rows]), jnp.asarray(nbr_w[rows] != 0), ring_rows
        )
    else:
        packed = np.zeros((n_pad // 8, ring_rows), np.uint8)
        np.bitwise_or.at(
            packed,
            (np.repeat(prow, deg), cols.ravel()),
            (((nbr_w != 0).astype(np.uint8) << pbit[:, None])).ravel(),
        )

    row_scale = np.zeros(n_pad, np.float32)
    row_scale[:n] = a
    col_scale = np.zeros(src_pad, np.float32)
    col_scale[:n] = a
    return SlidingPackedGraph(
        packed=packed,
        window_start=ws.astype(np.int32),
        delta_blocks=delta_blocks,
        row_scale=row_scale,
        col_scale=col_scale,
        num_nodes=n,
        num_edges=e,
        block_size=block_size,
        window_size=int(window),
        max_delta_blocks=max(max_delta, 1),
        num_src_rows=src_pad,
    )


@struct.dataclass
class MultiLevelGraph:
    """Union-of-levels mesh graph (GraphCast-style multimesh).

    Aggregation = sum over per-level subgraph aggregations. Fine levels are
    banded after RCM (window layouts apply); coarse levels are tiny and run
    on the segment path — each level picks its best backend through the
    normal ``aggregate`` dispatch. Normalization is computed once over the
    *union* so the semantics match a single GCN layer on the union graph.
    """

    subgraphs: tuple  # tuple of graph containers (any aggregate-able type)
    num_nodes: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)


def build_multilevel_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_level: np.ndarray,
    num_nodes: int,
    *,
    self_loops: bool = True,
    fine_layout: str = "coo",  # "coo" | "ell" | "windowed" | "sliding"
    block_size: int = 128,
) -> MultiLevelGraph:
    """Normalize over the edge union, split by level, pick layouts.

    The finest level holds ~3/4 of the edges and is banded (assuming RCM
    node order); coarser levels have long-range edges that would blow up the
    bandwidth bound, so they stay on the COO/segment path.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    edge_level = np.asarray(edge_level)
    s_all, r_all, w_all = gcn_normalize(senders, receivers, num_nodes, self_loops)
    # gcn_normalize appends self loops at the end; give them the finest level.
    max_lv = int(edge_level.max()) if edge_level.size else 0
    lv_all = np.concatenate(
        [edge_level, np.full(len(s_all) - len(edge_level), max_lv)]
    )
    subgraphs = []
    for lv in sorted(set(lv_all.tolist())):
        m = lv_all == lv
        g = build_graph(
            s_all[m], r_all[m], num_nodes, normalize=False, weights=w_all[m]
        )
        if lv == max_lv and fine_layout != "coo":
            if fine_layout == "ell":
                g = to_block_ell(g, block_size=block_size)
            elif fine_layout == "windowed":
                g = to_windowed_dense(g, block_size=block_size)
            elif fine_layout == "sliding":
                g = to_sliding_dense(g, block_size=block_size)
        subgraphs.append(g)
    return MultiLevelGraph(
        subgraphs=tuple(subgraphs),
        num_nodes=num_nodes,
        num_edges=int(len(s_all)),
    )
