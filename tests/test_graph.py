"""Graph container and builder tests."""

import numpy as np
import pytest

from gwen.graph import (
    apply_order,
    bandwidth,
    build_graph,
    complete_edges,
    erdos_renyi_edges,
    gcn_normalize,
    grid2d_edges,
    icosphere_edges,
    rcm_order,
    to_block_ell,
    to_dense,
)


def test_complete_edges():
    s, r = complete_edges(5)
    assert len(s) == 5 * 4
    assert not np.any(s == r)


def test_erdos_renyi_p1_matches_complete():
    s1, r1 = complete_edges(7)
    s2, r2 = erdos_renyi_edges(7, 1.0)
    assert set(zip(s1, r1)) == set(zip(s2, r2))


def test_gcn_normalize_row_sums():
    # For a complete graph + self loops, normalized adjacency rows sum to 1.
    s, r = complete_edges(6)
    s2, r2, w = gcn_normalize(s, r, 6, self_loops=True)
    rowsum = np.zeros(6)
    np.add.at(rowsum, r2, w)
    np.testing.assert_allclose(rowsum, 1.0, rtol=1e-6)


def test_build_graph_padding():
    s, r = complete_edges(4)
    g = build_graph(s, r, 4, edge_pad_multiple=64)
    assert g.num_padded_edges == 64
    assert g.num_edges == 16  # 12 edges + 4 self loops
    w = np.asarray(g.weights)
    assert np.all(w[g.num_edges :] == 0)


def test_to_dense_matches_coo():
    s, r = grid2d_edges(3, 4)
    g = build_graph(s, r, 12)
    d = to_dense(g)
    # Compare dense aggregation to direct scatter.
    x = np.random.default_rng(0).normal(size=(12, 5)).astype(np.float32)
    out = np.zeros_like(x)
    sl, rl, wl = (np.asarray(g.senders), np.asarray(g.receivers), np.asarray(g.weights))
    for e in range(g.num_edges):
        out[rl[e]] += wl[e] * x[sl[e]]
    np.testing.assert_allclose(np.asarray(d.adj) @ x, out, rtol=1e-5, atol=1e-5)


def test_icosphere_counts():
    verts, s, r = icosphere_edges(2)
    assert verts.shape[0] == 10 * 4**2 + 2  # 162
    assert len(s) == 2 * 30 * 4**2  # directed edges
    # degree 5 at the 12 original vertices, 6 elsewhere
    deg = np.bincount(r)
    assert sorted(np.unique(deg)) == [5, 6]
    assert np.sum(deg == 5) == 12


def test_rcm_reduces_bandwidth():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s2, r2, inv = apply_order(perm, s, r)
    assert bandwidth(s2, r2) < bandwidth(s, r)
    assert bandwidth(s2, r2) < 4 * int(np.sqrt(n)) * 4  # loose sanity bound


def test_block_ell_roundtrip():
    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)
    be = to_block_ell(g, block_size=32)
    assert be.num_edges == g.num_edges
    assert be.num_padded_nodes % 32 == 0
    # weights preserved in total
    np.testing.assert_allclose(
        np.asarray(be.nbr_weight).sum(), np.asarray(g.weights).sum(), rtol=1e-5
    )


def test_block_ell_bandwidth_guard():
    # A graph with an edge spanning the whole index range must fail for a
    # small window.
    s = np.array([0, 999])
    r = np.array([999, 0])
    g = build_graph(s, r, 1000)
    with pytest.raises(ValueError):
        to_block_ell(g, block_size=128, window_size=128)


def test_multilevel_edges_union():
    from gwen.graph import icosphere_multilevel_edges

    verts, s, r, lv = icosphere_multilevel_edges(2, min_level=0)
    assert verts.shape[0] == 162
    # Union is strictly larger than the fine level alone, smaller than sum
    # of levels (dedup), and symmetric.
    _, sf, rf = icosphere_edges(2)
    assert len(s) > len(sf)
    assert set(zip(s, r)) == set(zip(r, s))
    # Coarse long-range edges exist (span > fine-mesh neighborhood).
    assert lv.min() == 0 and lv.max() == 2


def test_multilevel_graph_matches_union_segment():
    import jax.numpy as jnp

    from gwen.graph import (
        build_multilevel_graph,
        icosphere_multilevel_edges,
    )
    from gwen.ops import aggregate, aggregate_segment

    verts, s, r, lv = icosphere_multilevel_edges(2)
    n = verts.shape[0]
    union = build_graph(s, r, n)  # normalized over the union
    ml = build_multilevel_graph(s, r, lv, n)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32))
    want = np.asarray(aggregate_segment(union, x))
    got = np.asarray(aggregate(ml, x, backend="segment"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_multilevel_with_fine_ell_layout():
    import jax.numpy as jnp

    from gwen.graph import (
        build_multilevel_graph,
        icosphere_multilevel_edges,
    )
    from gwen.ops import aggregate, aggregate_segment

    verts, s, r, lv = icosphere_multilevel_edges(3)
    n = verts.shape[0]
    # RCM on the FINE edges; relabel the whole union with the same perm.
    fine = lv == lv.max()
    perm = rcm_order(s[fine], r[fine], n)
    s2, r2, _ = apply_order(perm, s, r)
    union = build_graph(s2, r2, n)
    ml = build_multilevel_graph(s2, r2, lv, n, fine_layout="ell", block_size=32)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(n, 16)).astype(np.float32))
    want = np.asarray(aggregate_segment(union, x))
    got = np.asarray(aggregate(ml, x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
