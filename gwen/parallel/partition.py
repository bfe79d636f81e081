"""Host-side contiguous-chunk graph partitioning for halo-exchange parallelism.

After RCM reordering (``gwen.graph.reorder``), a weather mesh's adjacency
is banded: edges reach at most ``bandwidth`` positions away. Splitting the
node axis into equal contiguous chunks then guarantees every cross-partition
edge lands within ``halo = bandwidth`` rows of a chunk boundary — the ring
halo exchange in ``gwen.parallel.halo`` is exact, with no general
all-to-all needed. (Contiguous-chunks-after-RCM plays the role METIS plays in
other graph frameworks, with the advantage that halos are *contiguous row
ranges*: static shapes, one ppermute, no gather.)

All per-partition tables share identical static shapes (max degree, window,
rows), stacked along a leading partition axis so ``shard_map`` can slice them
over the mesh ``graph`` axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gwen.graph.graph import (
    _build_s_ring,
    _sliding_monotonic,
    _sliding_tables,
    ell_tables,
    gcn_normalize,
)
from gwen.graph.reorder import apply_order, bandwidth, rcm_order


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class PartitionedGraph:
    """Stacked per-partition blocked-ELL tables + the node permutation."""

    nbr: np.ndarray  # (P, n_local, D) int32, ext-space window-relative
    nbr_weight: np.ndarray  # (P, n_local, D) float32
    window_start: np.ndarray  # (P, n_local // block) int32 into ext space
    s_dense: "np.ndarray | None"  # (P, n_local, window) dense scatter matrices
    perm: np.ndarray  # new i = old perm[i]
    inv_perm: np.ndarray
    num_parts: int
    n_local: int
    halo: int
    block_size: int
    window_size: int
    num_nodes: int  # global, before padding
    num_edges: int
    edges_per_part: np.ndarray  # (P,) actual edge counts (incl. self loops)
    # Sliding-ring layout — shared static shapes across partitions; None
    # unless built with layout="sliding".
    s_sliding: "np.ndarray | None" = None  # (P, n_local, ring_rows)
    sliding_window_start: "np.ndarray | None" = None  # (P, n_local // block)
    sliding_delta: "np.ndarray | None" = None  # (P, n_local // block) int32
    sliding_window: int = 0
    sliding_ring: int = 0
    sliding_max_delta: int = 0
    layout: str = "ell"
    # Diagonal-window layout (layout="diag"): the GLOBAL diag
    # layout sliced per partition (contiguous chunks ⇒ S rows reshape; the
    # implicit-diagonal window starts re-expressed halo-ext-relative). The
    # decisive scaling property vs RCM layouts: halo = window (O(1), ~384
    # rows) instead of the full graph bandwidth (O(√N)). Escapes ride the
    # compact escape graph with one all_gather of the U boundary-skeleton
    # rows (see gwen.parallel.halo.HaloDiagGraph).
    s_diag: "np.ndarray | None" = None  # (P, n_local, W)
    diag_offsets: "np.ndarray | None" = None  # (P, n_local // block) int32
    diag_xbase: "np.ndarray | None" = None  # (P, blocks // superblock) int32
    diag_window: int = 0
    diag_superblock: int = 0
    diag_u_pp: int = 0  # padded per-partition boundary-row count
    diag_loc_idx: "np.ndarray | None" = None  # (P, U_pp) int32 local x rows
    diag_fix_rows: "np.ndarray | None" = None  # (P, U_pp) int32 dst rows
    diag_back_loc: "np.ndarray | None" = None  # (P, U_pp) int32 c2 rows
    diag_idx2: "np.ndarray | None" = None  # (U,) int32 into gathered layout
    esc2_graph: "object | None" = None  # replicated compact escape Graph

    @property
    def padded_nodes(self) -> int:
        return self.num_parts * self.n_local

    # ------------------------------------------------------------ features
    def pad_nodes(self, x: np.ndarray, node_axis: int = -2) -> np.ndarray:
        """Reorder node data by ``perm`` and zero-pad to ``padded_nodes``."""
        x = np.asarray(x)
        x = np.take(x, self.perm, axis=node_axis)
        pad = self.padded_nodes - x.shape[node_axis]
        if pad:
            widths = [(0, 0)] * x.ndim
            widths[node_axis % x.ndim] = (0, pad)
            x = np.pad(x, widths)
        return x

    def unpad_nodes(self, x: np.ndarray, node_axis: int = -2) -> np.ndarray:
        """Crop padding and restore the original node order."""
        x = np.take(x, np.arange(self.num_nodes), axis=node_axis)
        return np.take(x, self.inv_perm, axis=node_axis)


def partition_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_parts: int,
    *,
    block_size: int = 128,
    self_loops: bool = True,
    reorder: bool = True,
    halo: int | None = None,
    dense_s: bool = False,
    layout: str = "ell",
    s_dtype=np.float32,
    device_build: bool = False,
    diag_window: int = 384,
    diag_superblock: int = 8,
) -> PartitionedGraph:
    """Partition a (symmetric) graph into ``num_parts`` contiguous chunks.

    ``layout`` picks the local-aggregation tables every partition carries
    (all layouts share identical static shapes so ``shard_map`` can slice
    the stacked arrays over the mesh ``graph`` axis):

    * ``"ell"`` — blocked-ELL only (compact).
    * ``"dense"`` — + per-partition windowed-dense scatter matrices
      (equivalent to the legacy ``dense_s=True``).
    * ``"sliding"`` — + per-partition sliding-ring tables. The window /
      ring size / max-delta are shared (maxed) across partitions.
    * ``"diag"`` — the global diagonal-window layout sliced per partition
      (halo = window); the layout the kernel runs on. Callers should
      ``kd_patch_order`` the edge list first and pass ``reorder=False``.

    ``device_build=True`` expands the stacked S on device from the
    O(edges) tables (keeps hundreds of MB off the host→device link).
    """
    if dense_s:
        layout = "dense"
    if layout not in ("ell", "dense", "sliding", "diag"):
        raise ValueError(f"unknown partition layout {layout!r}")
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if reorder:
        # NOTE: RCM is the right default for the band-based layouts below.
        # layout="diag" callers should kd_patch_order the edge list first
        # and pass reorder=False (the diag windows want patch locality).
        perm = rcm_order(senders, receivers, num_nodes)
        senders, receivers, _ = apply_order(perm, senders, receivers)
    else:
        perm = np.arange(num_nodes, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_nodes)

    s, r, w = gcn_normalize(senders, receivers, num_nodes, self_loops=self_loops)

    if layout == "diag":
        return _partition_diag(
            s, r, w, num_nodes, num_parts, perm, inv,
            block_size=block_size, window_size=diag_window,
            superblock=diag_superblock, s_dtype=s_dtype,
            device_build=device_build,
        )

    n_local = _round_up(-(-num_nodes // num_parts), block_size)
    bw = bandwidth(s, r)
    halo_eff = halo if halo is not None else _round_up(max(bw, 1), block_size)
    if halo_eff < bw:
        raise ValueError(f"halo {halo_eff} < graph bandwidth {bw}")
    if halo_eff > n_local:
        raise ValueError(
            f"halo {halo_eff} exceeds partition size {n_local}: too many "
            f"partitions for this graph's bandwidth — reduce num_parts"
        )
    n_ext = n_local + 2 * halo_eff

    part = r // n_local
    per_part = []
    max_deg = 0
    for p in range(num_parts):
        m = part == p
        sp, rp, wp = s[m], r[m], w[m]
        r_rel = rp - p * n_local
        s_rel = sp - (p * n_local - halo_eff)
        if s_rel.size and (s_rel.min() < 0 or s_rel.max() >= n_ext):
            raise AssertionError("edge escapes halo window (bandwidth bound broken)")
        per_part.append((s_rel, r_rel, wp))
        if rp.size:
            max_deg = max(max_deg, int(np.bincount(r_rel, minlength=n_local).max()))
    max_deg = max(_round_up(max_deg, 8), 8)

    # Shared window across partitions: max span per 128-row destination
    # block, computed directly from the edge lists (no table materialization).
    window = block_size
    for s_rel, r_rel, _ in per_part:
        if not len(r_rel):
            continue
        nblk = n_local // block_size
        lo = np.full(nblk, n_ext, np.int64)
        hi = np.zeros(nblk, np.int64)
        blk = r_rel // block_size
        np.minimum.at(lo, blk, s_rel)
        np.maximum.at(hi, blk, s_rel + 1)
        lo = np.where(lo > hi, 0, (lo // block_size) * block_size)
        span = int((hi - lo).max())
        window = max(window, _round_up(span, block_size))
    window = min(window, _round_up(n_ext, block_size))
    nbrs, nws, wss, counts = [], [], [], []
    for s_rel, r_rel, wp in per_part:
        nbr, nw, ws, _, _ = ell_tables(
            s_rel, r_rel, wp, num_dst=n_local, num_src=n_ext,
            block_size=block_size, window_size=window, max_degree=max_deg,
        )
        nbrs.append(nbr)
        nws.append(nw)
        wss.append(ws)
        counts.append(len(wp))

    s_dense = None
    if layout == "dense":
        # Per-partition dense scatter matrices (windowed-dense layout).
        s_dense = np.zeros((num_parts, n_local, window), np.float32)
        rows = np.repeat(np.arange(n_local), max_deg)
        for p in range(num_parts):
            np.add.at(
                s_dense[p], (rows, nbrs[p].ravel()), nws[p].ravel()
            )

    s_sliding = sl_ws = sl_delta = None
    sl_window = sl_ring = sl_max_delta = 0
    if layout == "sliding":
        # Two-phase build so the window / ring / max-delta statics are
        # SHARED across partitions (shard_map slices a stacked array).
        src_pad_ext = _round_up(n_ext, block_size)
        monos = [
            _sliding_monotonic(nbrs[p], nws[p], wss[p], block_size)
            for p in range(num_parts)
        ]
        sl_window = max(
            window,
            max(_round_up(req, block_size) for _, _, req in monos),
        )
        sl_window = min(sl_window, src_pad_ext)
        tabs = [
            _sliding_tables(ws_mono, abs_idx, nws[p], sl_window,
                            block_size, src_pad_ext)
            for p, (ws_mono, abs_idx, _) in enumerate(monos)
        ]
        sl_max_delta = max(md for _, _, _, md in tabs)
        sl_ring = sl_window + max(sl_max_delta, 1) * block_size
        s_parts, ws_parts, delta_parts = [], [], []
        for p, (ws_p, delta_p, abs_p, _) in enumerate(tabs):
            cols = abs_p % sl_ring
            s_parts.append(
                _build_s_ring(cols, nws[p], sl_ring, s_dtype, device_build)
            )
            ws_parts.append(ws_p.astype(np.int32))
            delta_parts.append(delta_p)
        if device_build:
            import jax.numpy as jnp

            s_sliding = jnp.stack(s_parts)
        else:
            s_sliding = np.stack(s_parts)
        sl_ws = np.stack(ws_parts)
        sl_delta = np.stack(delta_parts)

    return PartitionedGraph(
        nbr=np.stack(nbrs),
        nbr_weight=np.stack(nws),
        window_start=np.stack(wss),
        s_dense=s_dense,
        perm=perm,
        inv_perm=inv,
        num_parts=num_parts,
        n_local=n_local,
        halo=halo_eff,
        block_size=block_size,
        window_size=window,
        num_nodes=num_nodes,
        num_edges=len(s),
        edges_per_part=np.asarray(counts),
        s_sliding=s_sliding,
        sliding_window_start=sl_ws,
        sliding_delta=sl_delta,
        sliding_window=sl_window,
        sliding_ring=sl_ring,
        sliding_max_delta=max(sl_max_delta, 1) if layout == "sliding" else 0,
        layout=layout,
    )


def _partition_diag(
    s: np.ndarray,
    r: np.ndarray,
    w: np.ndarray,
    num_nodes: int,
    num_parts: int,
    perm: np.ndarray,
    inv: np.ndarray,
    *,
    block_size: int,
    window_size: int,
    superblock: int,
    s_dtype,
    device_build: bool,
) -> PartitionedGraph:
    """Partition via the GLOBAL diagonal-window layout.

    Contiguous chunks make the slicing trivial: S rows reshape to
    ``(P, n_local, W)`` and the implicit-diagonal window starts re-express
    halo-ext-relative with ``halo = round_up(W, block)`` — O(1) in mesh
    size, vs the O(√N) bandwidth halos of the RCM layouts. Escape edges
    (~2% under a KD-patch ordering) ride the compact escape graph: each
    device extracts its slice of the U boundary-skeleton rows, one
    ``all_gather`` rebuilds the compacted x, the compact ``segment_sum``
    runs replicated, and each device adds its fix rows with one sorted
    scatter-add.
    """
    from gwen.graph.graph import Graph, to_diag_window

    block = block_size
    t_sb = max(int(superblock), 1)
    n_local = _round_up(-(-num_nodes // num_parts), block * t_sb)
    n_pad = num_parts * n_local
    g_norm = Graph(
        senders=s.astype(np.int32), receivers=r.astype(np.int32),
        weights=w.astype(np.float32), num_nodes=num_nodes, num_edges=len(s),
    )
    dwg = to_diag_window(
        g_norm, window_size=window_size, block_size=block, superblock=t_sb,
        dtype=s_dtype, device_build=device_build, compact_escapes=True,
        n_pad=n_pad,
    )
    if dwg.superblock != t_sb:
        raise ValueError(
            f"graph too small for partitioned diag layout at superblock="
            f"{t_sb} (shrunk to {dwg.superblock}); reduce superblock or "
            f"num_parts"
        )
    W = dwg.window_size
    buf = W + (t_sb - 1) * block
    halo_eff = _round_up(W, block)
    if halo_eff > n_local:
        raise ValueError(
            f"diag halo {halo_eff} (= window) exceeds partition size "
            f"{n_local}: too many partitions for this window — reduce "
            f"num_parts or diag_window"
        )
    n_ext = n_local + 2 * halo_eff
    if buf > n_ext:
        raise ValueError(
            f"diag superblock buffer {buf} exceeds halo-extended partition "
            f"{n_ext}; reduce superblock or increase partition size"
        )
    nb_loc = n_local // block
    ns_loc = nb_loc // t_sb

    # Global window starts, re-expressed relative to each partition's
    # halo-extended local array [left-halo | local | right-halo].
    ws_glob = np.repeat(np.asarray(dwg.xbase, np.int64), t_sb) + np.asarray(
        dwg.offsets, np.int64
    )
    ws_l = ws_glob.reshape(num_parts, nb_loc) - (
        np.arange(num_parts, dtype=np.int64)[:, None] * n_local - halo_eff
    )
    if ws_l.min() < 0 or ws_l.max() > n_ext - W:
        raise AssertionError("diag window escapes the halo-extended array")
    # ws is monotone within each partition, so the superblock's first block
    # holds the minimum; clamp so the buffer stays in bounds.
    xb_l = np.clip(
        ws_l.reshape(num_parts, ns_loc, t_sb)[:, :, 0], 0, n_ext - buf
    )
    off_l = ws_l - np.repeat(xb_l, t_sb, axis=1)
    if off_l.min() < 0 or off_l.max() > buf - W:
        raise AssertionError("diag offsets escape the superblock buffer")

    s_mat = dwg.s_mat
    if device_build:
        s_diag = s_mat.reshape(num_parts, n_local, W)
    else:
        s_diag = np.asarray(s_mat).reshape(num_parts, n_local, W)

    # ---- escape (boundary-skeleton) tables, partitioned ------------------
    u_pp = 0
    loc_idx = fix_rows = back_loc = idx2 = None
    esc2_graph = None
    if dwg.escape is not None:
        esc2_graph = dwg.esc2_graph
        uniq = np.asarray(dwg.esc2_src, np.int64)  # sorted node rows
        U = uniq.size
        inv2 = np.asarray(dwg.esc2_back, np.int64)[:U]
        bounds = np.arange(num_parts + 1, dtype=np.int64) * n_local
        ulo = np.searchsorted(uniq, bounds[:-1])
        uhi = np.searchsorted(uniq, bounds[1:])
        u_part = uhi - ulo
        u_pp = _round_up(int(u_part.max()) + 1, 8)
        loc_idx = np.zeros((num_parts, u_pp), np.int32)
        back_loc = np.zeros((num_parts, u_pp), np.int32)
        # placement rows: the local receivers (sorted, unique), padding
        # strictly increasing past n_local so the scatter drops it
        fix_rows = np.tile(np.arange(u_pp, dtype=np.int32) + n_local,
                           (num_parts, 1))
        for p in range(num_parts):
            k = int(u_part[p])
            loc_idx[p, :k] = uniq[ulo[p]:uhi[p]] - p * n_local
            fix_rows[p, :k] = loc_idx[p, :k]
            back_loc[p, :k] = inv2[ulo[p]:uhi[p]]
        # c2 row k reads gathered-layout row owner*u_pp + (k - ulo[owner])
        owner = uniq // n_local
        idx2 = (owner * u_pp + (np.arange(U) - ulo[owner])).astype(np.int32)

    counts = np.bincount(
        np.minimum(r // n_local, num_parts - 1), minlength=num_parts
    )
    return PartitionedGraph(
        nbr=np.zeros((num_parts, 1, 1), np.int32),
        nbr_weight=np.zeros((num_parts, 1, 1), np.float32),
        window_start=np.zeros((num_parts, 1), np.int32),
        s_dense=None,
        perm=perm,
        inv_perm=inv,
        num_parts=num_parts,
        n_local=n_local,
        halo=halo_eff,
        block_size=block,
        window_size=W,
        num_nodes=num_nodes,
        num_edges=len(s),
        edges_per_part=np.asarray(counts),
        layout="diag",
        s_diag=s_diag,
        diag_offsets=off_l.astype(np.int32),
        diag_xbase=xb_l.astype(np.int32),
        diag_window=W,
        diag_superblock=t_sb,
        diag_u_pp=u_pp,
        diag_loc_idx=loc_idx,
        diag_fix_rows=fix_rows,
        diag_back_loc=back_loc,
        diag_idx2=idx2,
        esc2_graph=esc2_graph,
    )
