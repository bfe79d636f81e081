"""Host-side graph constructors.

Reference parity: the member graph is ``erdos_renyi_graph(nodes, edge_prob=1)``
— a fully-connected digraph over ensemble members (utils.py:176). Beyond that,
this module provides the weather-mesh graphs the framework scales to
(BASELINE.json configs): refined icosahedral meshes (ICON-style) and 2-D
structured grids, all as plain numpy edge lists fed to
``gwen.graph.graph.build_graph``.
"""

from __future__ import annotations

import numpy as np


def complete_edges(num_nodes: int, self_loops: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """All ordered pairs (i, j); the reference's member graph with p=1."""
    idx = np.arange(num_nodes)
    s = np.repeat(idx, num_nodes)
    r = np.tile(idx, num_nodes)
    if not self_loops:
        keep = s != r
        s, r = s[keep], r[keep]
    return s, r


def erdos_renyi_edges(
    num_nodes: int, edge_prob: float, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Directed G(n, p) without self loops (torch_geometric.utils.erdos_renyi_graph
    analog, utils.py:176)."""
    if edge_prob >= 1.0:
        return complete_edges(num_nodes)
    rng = np.random.default_rng(seed)
    mask = rng.random((num_nodes, num_nodes)) < edge_prob
    np.fill_diagonal(mask, False)
    s, r = np.nonzero(mask)
    return s.astype(np.int64), r.astype(np.int64)


def grid2d_edges(height: int, width: int, periodic: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """4-neighborhood lattice graph over an H×W grid (regional model domains)."""
    idx = np.arange(height * width).reshape(height, width)
    senders, receivers = [], []
    for shift, axis in ((1, 0), (1, 1)):
        rolled = np.roll(idx, -shift, axis=axis)
        a, b = idx, rolled
        if not periodic:
            if axis == 0:
                a, b = idx[:-1, :], idx[1:, :]
            else:
                a, b = idx[:, :-1], idx[:, 1:]
        senders += [a.ravel(), b.ravel()]
        receivers += [b.ravel(), a.ravel()]
    return np.concatenate(senders), np.concatenate(receivers)


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron: (12, 3) vertices and (20, 3) faces."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def refine_triangulation(
    verts: np.ndarray, faces: np.ndarray, levels: int
) -> tuple[np.ndarray, np.ndarray]:
    """Loop-subdivide a spherical triangulation ``levels`` times (ICON-style
    icosahedral refinement: each triangle splits into 4, midpoints projected
    to the sphere). Nodes at level L: 10·4^L + 2. Fully vectorized (numpy) —
    multi-million-node meshes build in seconds."""
    for _ in range(levels):
        nf = len(faces)
        # All face edges, deduplicated: midpoint ids are shared per edge.
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mids = verts[uniq[:, 0]] + verts[uniq[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        mid_ids = len(verts) + np.arange(len(uniq), dtype=np.int64)
        ab = mid_ids[inv[:nf]]
        bc = mid_ids[inv[nf : 2 * nf]]
        ca = mid_ids[inv[2 * nf :]]
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        faces = np.concatenate(
            [
                np.stack([a, ab, ca], axis=1),
                np.stack([b, bc, ab], axis=1),
                np.stack([c, ca, bc], axis=1),
                np.stack([ab, bc, ca], axis=1),
            ]
        )
        verts = np.concatenate([verts, mids], axis=0)
    return verts, faces


def faces_to_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique undirected triangle edges → symmetric directed edge list."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    s = np.concatenate([e[:, 0], e[:, 1]])
    r = np.concatenate([e[:, 1], e[:, 0]])
    return s, r


def icosphere_edges(levels: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Refined icosahedral mesh: returns (vertices, senders, receivers)."""
    verts, faces = icosahedron()
    verts, faces = refine_triangulation(verts, faces, levels)
    s, r = faces_to_edges(faces)
    return verts, s, r


def icosphere_multilevel_edges(
    levels: int, min_level: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """GraphCast-style multimesh: the finest icosphere's vertices with the
    *union* of edges from every refinement level ``min_level..levels``.

    Subdivision preserves vertex ids (coarse vertices are a prefix of fine
    ones), so coarse-level edges are valid long-range edges on the fine mesh —
    message passing mixes information across scales in one step.

    Returns ``(verts, senders, receivers, edge_level)``.
    """
    verts, faces = icosahedron()
    all_s, all_r, all_lv = [], [], []
    for lv in range(levels + 1):
        if lv >= min_level:
            s, r = faces_to_edges(faces)
            all_s.append(s)
            all_r.append(r)
            all_lv.append(np.full(len(s), lv, np.int64))
        if lv < levels:
            verts, faces = refine_triangulation(verts, faces, 1)
    s = np.concatenate(all_s)
    r = np.concatenate(all_r)
    lv = np.concatenate(all_lv)
    # Dedup identical (s, r) pairs across levels, keeping the finest level.
    key = s * len(verts) + r
    order = np.lexsort((-lv, key))
    key_sorted = key[order]
    keep = np.ones(len(key), bool)
    keep[1:] = key_sorted[1:] != key_sorted[:-1]
    sel = order[keep]
    return verts, s[sel], r[sel], lv[sel]
