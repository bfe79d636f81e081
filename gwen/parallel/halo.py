"""Halo-exchange aggregation over a partitioned mesh graph.

This is the framework's scaling axis for large weather meshes (SURVEY §2.3:
the reference has no analog — it folds the spatial field into node features
and coarsens when it doesn't fit). Nodes are RCM-ordered and split into
contiguous, equal-size partitions over the mesh ``graph`` axis. Because RCM
bounds the graph bandwidth, every cross-partition edge reaches at most
``halo`` rows into the two neighboring partitions, so one bidirectional
``ppermute`` ring exchange per aggregation delivers all remote source rows.

:class:`HaloGraph` is the *local* view used inside ``shard_map``: per-device
ELL tables whose source indices are relative to the halo-extended local array
``[left-halo | local | right-halo]``. ``aggregate_halo`` does the exchange +
local aggregation (the diagonal-window kernel for the diag layout, jnp
aggregations for the older layouts), and ``gwen.ops.aggregate``
dispatches to it, so models are parallelism-agnostic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gwen import struct
from gwen.graph.graph import BlockEllGraph

Array = jnp.ndarray


@struct.dataclass
class HaloGraph:
    """Per-device partition of a mesh graph (constructed inside shard_map by
    slicing the stacked tables from ``gwen.parallel.partition``)."""

    nbr: Array  # (n_local_pad, D) int32, window-relative into ext space
    nbr_weight: Array  # (n_local_pad, D) float32
    window_start: Array  # (n_local_pad // block, ) int32 into ext space
    axis_name: str = struct.field(pytree_node=False)
    halo: int = struct.field(pytree_node=False)
    n_local: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    window_size: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    # Optional dense scatter matrix; None -> blocked-ELL aggregation. With
    # ``delta_blocks`` set it is the *ring-layout* matrix (n_local,
    # ring_rows) of the sliding layout and ``window_start`` holds the
    # monotonic clamped starts; otherwise the windowed matrix (n_local,
    # window).
    s_mat: "Array | None" = None
    delta_blocks: "Array | None" = None  # (n_local // block,) int32
    ring_rows: int = struct.field(pytree_node=False, default=0)
    max_delta: int = struct.field(pytree_node=False, default=0)

    @property
    def num_nodes(self) -> int:  # model-facing row count per device
        return self.n_local

    @property
    def ext_rows(self) -> int:
        return self.n_local + 2 * self.halo

    def local_block_ell(self) -> BlockEllGraph:
        return BlockEllGraph(
            nbr=self.nbr,
            nbr_weight=self.nbr_weight,
            window_start=self.window_start,
            num_nodes=self.n_local,
            num_edges=self.num_edges,
            block_size=self.block_size,
            window_size=self.window_size,
            num_src_rows=self.ext_rows,
        )


@struct.dataclass
class HaloDiagGraph:
    """Per-device partition of the GLOBAL diagonal-window layout.

    Local aggregation = halo exchange (halo = window, O(1) in mesh size —
    vs the O(√N) bandwidth halos of the RCM layouts) + the diagonal-window
    aggregation over the halo-extended rows (the same core as the global
    layout). Escape edges (~2% under the KD-patch ordering) ride the compact
    escape graph *globally*: each device extracts its slice of the U
    boundary-skeleton rows, one ``all_gather`` over the graph axis rebuilds
    the compacted x, the compact sorted ``segment_sum`` runs replicated (it
    is tiny), and each device gathers its fix rows and adds them with one
    sorted scatter-add.
    """

    offsets: Array  # (n_local // block,) int32 — ws − xbase, ext-relative
    xbase: Array  # (blocks // superblock,) int32 — superblock start
    s_mat: Array  # (n_local, W)
    axis_name: str = struct.field(pytree_node=False)
    halo: int = struct.field(pytree_node=False)
    n_local: int = struct.field(pytree_node=False)
    block_size: int = struct.field(pytree_node=False)
    window_size: int = struct.field(pytree_node=False)
    superblock: int = struct.field(pytree_node=False)
    num_edges: int = struct.field(pytree_node=False)
    # Escape machinery (None when the window covers every edge):
    loc_idx: "Array | None" = None  # (U_pp,) int32 — local x rows to extract
    fix_rows: "Array | None" = None  # (U_pp,) int32 — local dst row per fix
    #   row; strictly increasing, padding out of bounds (dropped)
    back_loc: "Array | None" = None  # (U_pp,) int32 — c2 row per fix row
    idx2: "Array | None" = None  # (U,) int32 — gathered-layout row per c2 row
    esc2: "object | None" = None  # replicated compact escape Graph (COO)

    @property
    def num_nodes(self) -> int:  # model-facing row count per device
        return self.n_local

    @property
    def ext_rows(self) -> int:
        return self.n_local + 2 * self.halo


def halo_exchange(x: Array, halo: int, axis_name: str) -> Array:
    """Bidirectional ring exchange of boundary rows; returns the extended
    array ``[left-halo | x | right-halo]`` along the node axis (-2)."""
    num = jax.lax.axis_size(axis_name)
    if halo == 0 or num == 1:
        left = jnp.zeros_like(x[..., :halo, :])
        right = jnp.zeros_like(x[..., :halo, :])
        return jnp.concatenate([left, x, right], axis=-2)
    fwd = [(i, (i + 1) % num) for i in range(num)]
    bwd = [(i, (i - 1) % num) for i in range(num)]
    # Receive the left neighbor's last rows and the right neighbor's first rows.
    from_left = jax.lax.ppermute(x[..., -halo:, :], axis_name, perm=fwd)
    from_right = jax.lax.ppermute(x[..., :halo, :], axis_name, perm=bwd)
    return jnp.concatenate([from_left, x, from_right], axis=-2)


def aggregate_halo(graph: HaloGraph, x: Array, backend: str = "auto") -> Array:
    """Exchange halos, aggregate locally, return local rows.

    The ring wraps, so the first/last partitions receive wrapped rows — but no
    edge references them (indices were built from the acyclic node ordering),
    so they are inert.

    Differentiation: the composite (exchange → local aggregate → crop) is,
    globally, multiplication by the padded normalized adjacency — symmetric
    for the undirected GCN-normalized graphs this framework builds — so the
    VJP w.r.t. ``x`` is the SAME halo aggregation applied to the cotangent.
    The custom VJP lives HERE, at the composite level, because the local
    scatter matrix is (n_local × ext) non-square: the global kernel's own
    backward-reuses-forward VJP is only valid for square symmetric S and
    must not be relied on inside the halo path.
    """
    if x.shape[-2] != graph.n_local:
        raise ValueError(f"x has {x.shape[-2]} rows, partition has {graph.n_local}")
    return _aggregate_halo_sym(graph, x, backend)


def _zero_cotangent(leaf):
    # Integer/bool primals take float0 cotangents; float table cotangents are
    # symbolic zeros that XLA DCEs (the graph tables are never differentiated).
    if jnp.issubdtype(leaf.dtype, jnp.integer) or leaf.dtype == jnp.bool_:
        return np.zeros(leaf.shape, jax.dtypes.float0)
    return jnp.zeros_like(leaf)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _aggregate_halo_sym(graph: HaloGraph, x: Array, backend: str) -> Array:
    return _aggregate_halo_impl(graph, x, backend)


def _aggregate_halo_fwd(graph, x, backend):
    return _aggregate_halo_impl(graph, x, backend), graph


def _aggregate_halo_bwd(backend, graph, g):
    gx = _aggregate_halo_impl(graph, g, backend)
    return (jax.tree_util.tree_map(_zero_cotangent, graph), gx)


_aggregate_halo_sym.defvjp(_aggregate_halo_fwd, _aggregate_halo_bwd)


def _diag_halo_fix(graph: "HaloDiagGraph", x: Array) -> "Array | None":
    """Escape fix rows for this device's receivers (placement order):
    extract local boundary-skeleton rows → ``all_gather`` over the graph
    axis → compact sorted ``segment_sum`` (replicated, tiny) → gather back
    this device's slice."""
    if graph.loc_idx is None:
        return None
    from gwen.ops.aggregate import aggregate_segment

    node_ax = x.ndim - 2
    xc_loc = jnp.take(x, graph.loc_idx, axis=node_ax)
    xc_all = jax.lax.all_gather(
        xc_loc, graph.axis_name, axis=node_ax, tiled=True
    )
    xc2 = jnp.take(xc_all, graph.idx2, axis=node_ax)
    fixc2 = aggregate_segment(graph.esc2, xc2)
    return jnp.take(fixc2, graph.back_loc, axis=node_ax).astype(x.dtype)


def _diag_halo_local(graph: "HaloDiagGraph", x_ext: Array,
                     backend: str) -> Array:
    """In-window aggregation over the halo-extended rows: the Triton kernel
    or its plain-XLA form, whichever the platform dispatch picks."""
    from gwen.ops.platform import diag_impl

    if diag_impl(backend) == "pallas":
        from gwen.ops.spmm_pallas import diag_window_core

        return diag_window_core(graph.xbase, graph.offsets, graph.s_mat,
                                x_ext, superblock=graph.superblock,
                                src_rows=graph.ext_rows)
    from gwen.ops.aggregate import diag_window_core_einsum

    return diag_window_core_einsum(graph, x_ext, graph.ext_rows)


def _aggregate_halo_impl(graph, x: Array, backend: str) -> Array:
    x_ext = halo_exchange(x, graph.halo, graph.axis_name)
    if isinstance(graph, HaloDiagGraph):
        from gwen.ops.aggregate import _escape_place

        out = _diag_halo_local(graph, x_ext, backend)[..., : graph.n_local, :]
        fix = _diag_halo_fix(graph, x)
        if fix is not None:
            out = _escape_place(graph.fix_rows, fix, out)
        return out
    if graph.delta_blocks is not None:
        from gwen.graph.graph import SlidingDenseGraph
        from gwen.ops.aggregate import aggregate_sliding_dense_reference

        sd = SlidingDenseGraph(
            s_mat=graph.s_mat,
            window_start=graph.window_start,
            delta_blocks=graph.delta_blocks,
            num_nodes=graph.n_local,
            num_edges=graph.num_edges,
            block_size=graph.block_size,
            window_size=graph.window_size,
            max_delta_blocks=graph.max_delta,
            num_src_rows=graph.ext_rows,
        )
        out = aggregate_sliding_dense_reference(sd, x_ext)
    elif graph.s_mat is not None:
        from gwen.graph.graph import WindowedDenseGraph
        from gwen.ops.aggregate import aggregate_windowed_dense_reference

        wd = WindowedDenseGraph(
            s_mat=graph.s_mat,
            window_start=graph.window_start,
            num_nodes=graph.n_local,
            num_edges=graph.num_edges,
            block_size=graph.block_size,
            num_src_rows=graph.ext_rows,
        )
        out = aggregate_windowed_dense_reference(wd, x_ext)
    else:
        from gwen.ops.aggregate import aggregate_block_ell_reference

        out = aggregate_block_ell_reference(graph.local_block_ell(), x_ext)
    return out[..., : graph.n_local, :]


# ---------------------------------------------- partitioned attention


def attend_halo(graph: HaloDiagGraph, q: Array, k: Array, v: Array, *,
                scale: "float | None" = None) -> Array:
    """Windowed attention over a partitioned diag layout.

    Each destination's in-window neighbourhood is fully contained in the
    halo-extended local array (halo = window), so partitioned attention is
    two halo ring exchanges (K, V) + the same vectorised attention as the
    global layout — and, unlike the GCN path, there is no escape term at
    all (windowed attention excludes out-of-window edges by definition,
    identically on the global layout). Autodiff of the ``ppermute``-based
    exchange routes halo cotangents back to their owners.
    """
    from gwen.ops.attention import window_attention_core
    from gwen.ops.platform import attention_impl

    if q.shape[-2] != graph.n_local:
        raise ValueError(
            f"q has {q.shape[-2]} rows, partition has {graph.n_local}")
    f = q.shape[-1]
    if scale is None:
        scale = 1.0 / (f ** 0.5)
    k_ext = halo_exchange(k, graph.halo, graph.axis_name)
    v_ext = halo_exchange(v, graph.halo, graph.axis_name)
    return window_attention_core(
        graph.xbase, graph.offsets, graph.s_mat, q, k_ext, v_ext,
        superblock=graph.superblock, src_rows=graph.ext_rows,
        scale=float(scale), impl=attention_impl(q.dtype))
