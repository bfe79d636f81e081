"""shard_map wiring: run a GNN model over a partitioned mesh graph.

``make_partitioned_apply`` wraps ``model.apply`` in ``jax.shard_map`` over the
(data, graph) mesh: node features are sharded over the ``graph`` axis (each
device holds its contiguous partition), batch over ``data``, params
replicated. Inside the mapped function each device reconstructs its local
:class:`~gwen.parallel.halo.HaloGraph` from the stacked partition tables
and runs the unchanged model — halo ppermutes happen inside
``gwen.ops.aggregate`` dispatch, overlapped/scheduled by XLA.

This replaces the reference's DDP+NCCL single-axis data parallelism
(models_cnn.py:510) and adds the graph axis it never had (SURVEY §2.3).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gwen.parallel.halo import HaloGraph
from gwen.parallel.partition import PartitionedGraph


def make_partitioned_apply(
    model,
    pg: PartitionedGraph,
    mesh: Mesh,
    data_axis: str = "data",
    graph_axis: str = "graph",
) -> Callable:
    """Returns ``apply(params, x)`` for global ``x (..., P*n_local, F)``.

    The result is jit-compatible; batch (leading) axis is sharded over
    ``data_axis`` when present, node axis over ``graph_axis``.
    """
    max_edges = int(pg.edges_per_part.max()) if pg.num_parts else 0
    sliding = pg.layout == "sliding" and pg.s_sliding is not None
    diag = pg.layout == "diag" and pg.s_diag is not None

    table_specs: "tuple | None" = None
    if diag:
        from gwen.parallel.halo import HaloDiagGraph

        has_esc = pg.diag_loc_idx is not None
        sharded = (
            jnp.asarray(pg.diag_offsets),
            jnp.asarray(pg.diag_xbase),
            jnp.asarray(pg.s_diag),
        ) + ((
            jnp.asarray(pg.diag_loc_idx),
            jnp.asarray(pg.diag_fix_rows),
            jnp.asarray(pg.diag_back_loc),
        ) if has_esc else ())
        # Replicated: the compact escape graph + the gathered-layout index
        # (identical on every device).
        repl = ((jnp.asarray(pg.diag_idx2), pg.esc2_graph)
                if has_esc else ())
        tables = sharded + repl
        table_specs = tuple(P(graph_axis) for _ in sharded) + tuple(
            P() for _ in repl
        )

        def local_apply(*args):
            off_p, xb_p, s_p, *rest = args
            if has_esc:
                li_p, fr_p, bk_p, idx2, esc2, params, x = rest
            else:
                params, x = rest
                li_p = fr_p = bk_p = idx2 = esc2 = None

            def first(a):  # strip the sliced leading partition axis
                return None if a is None else a[0]

            hg = HaloDiagGraph(
                offsets=off_p[0],
                xbase=xb_p[0],
                s_mat=s_p[0],
                axis_name=graph_axis,
                halo=pg.halo,
                n_local=pg.n_local,
                block_size=pg.block_size,
                window_size=pg.diag_window,
                superblock=pg.diag_superblock,
                num_edges=max_edges,
                loc_idx=first(li_p),
                fix_rows=first(fr_p),
                back_loc=first(bk_p),
                idx2=idx2,
                esc2=esc2,
            )
            return model.apply(params, hg, x)
    elif sliding:
        # Sliding layout: ring-S + monotonic starts + per-block deltas.
        tables = (
            jnp.asarray(pg.sliding_window_start),
            jnp.asarray(pg.sliding_delta),
            jnp.asarray(pg.s_sliding),
        )

        def local_apply(ws_p, delta_p, s_p, params, x):
            hg = HaloGraph(
                nbr=jnp.zeros((pg.n_local, 1), jnp.int32),  # unused
                nbr_weight=jnp.zeros((pg.n_local, 1), s_p.dtype),
                window_start=ws_p[0],
                axis_name=graph_axis,
                halo=pg.halo,
                n_local=pg.n_local,
                block_size=pg.block_size,
                window_size=pg.sliding_window,
                num_edges=max_edges,
                s_mat=s_p[0],
                delta_blocks=delta_p[0],
                ring_rows=pg.sliding_ring,
                max_delta=pg.sliding_max_delta,
            )
            return model.apply(params, hg, x)
    else:
        has_dense_s = pg.s_dense is not None
        tables = (
            jnp.asarray(pg.nbr),
            jnp.asarray(pg.nbr_weight),
            jnp.asarray(pg.window_start),
        ) + ((jnp.asarray(pg.s_dense),) if has_dense_s else ())

        def local_apply(nbr_p, nbr_w_p, wstart_p, *rest):
            *s_p, params, x = rest
            hg = HaloGraph(
                nbr=nbr_p[0],
                nbr_weight=nbr_w_p[0],
                window_start=wstart_p[0],
                axis_name=graph_axis,
                halo=pg.halo,
                n_local=pg.n_local,
                block_size=pg.block_size,
                window_size=pg.window_size,
                num_edges=max_edges,
                s_mat=s_p[0][0] if s_p else None,
            )
            return model.apply(params, hg, x)

    def x_spec(ndim: int) -> P:
        spec = [None] * ndim
        spec[-2] = graph_axis
        if ndim >= 3:
            spec[0] = data_axis
        return P(*spec)

    if table_specs is None:
        table_specs = tuple(P(graph_axis) for _ in tables)
    # Place each table where shard_map reads it: every device holds its own
    # partition's slice (and the replicated tables), nothing sits on the
    # first device alone.
    tables = tuple(
        jax.device_put(t, NamedSharding(mesh, spec))
        for t, spec in zip(tables, table_specs)
    )

    def apply(params, x, tables_arg=None):
        """``tables_arg`` lets callers thread the partition tables through a
        jit boundary as arguments (mesh-scale-safe; defaults to the captured
        tables, fine for small graphs)."""
        t = tables if tables_arg is None else tables_arg
        mapped = jax.shard_map(
            local_apply,
            mesh=mesh,
            in_specs=table_specs + (P(), x_spec(x.ndim)),
            out_specs=x_spec(x.ndim),
            check_vma=False,
        )
        return mapped(*t, params, x)

    apply.tables = tables
    apply.table_specs = table_specs
    return apply
