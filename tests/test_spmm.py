"""Aggregation equivalence tests on the CPU.

The diagonal-window Triton kernel runs here in Pallas interpret mode (the
test passes ``interpret=True`` itself); its plain-XLA form, the older window
layouts' jnp aggregations, the escape composite and the platform dispatch
are checked against ``segment_sum``. The compiled kernel is checked on the
GPU by the ``gpu``-marked test at the end and by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gwen.graph import (
    apply_order,
    build_graph,
    icosphere_edges,
    kd_patch_order,
    rcm_order,
    to_diag_window,
)
from gwen.ops import aggregate, aggregate_segment
from gwen.ops.aggregate import aggregate_diag_window_reference

TOL = dict(rtol=1e-4, atol=1e-4)


def _mesh_graph(levels=2):
    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    return build_graph(s, r, n), n


def _kd_graph(levels=3, leaf_size=128):
    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=leaf_size)
    s, r, _ = apply_order(perm, s, r)
    return build_graph(s, r, n), n


def _kd_diag_graph(levels=3, window_size=256, block=32, superblock=4, **kw):
    g, n = _kd_graph(levels)
    dw = to_diag_window(g, window_size=window_size, block_size=block,
                        superblock=superblock, **kw)
    return g, dw, n


def _x(shape, seed):
    return jnp.asarray(np.random.default_rng(seed).normal(size=shape)
                       .astype(np.float32))


def _grad_pair(agg, g, x, fn=jnp.sin):
    f = lambda xx: jnp.sum(fn(agg(xx)))  # noqa: E731
    fr = lambda xx: jnp.sum(fn(aggregate_segment(g, xx)))  # noqa: E731
    return jax.grad(f)(x), jax.grad(fr)(x)


# ------------------------------------- older window layouts (jnp aggregation)


def _layout(name, g):
    from gwen import graph as gr

    return {
        "block_ell": lambda: gr.to_block_ell(g, block_size=32),
        "block_tiles": lambda: gr.to_block_tiles(g, block_size=32),
        "windowed_dense": lambda: gr.to_windowed_dense(g, block_size=32),
        "sliding_dense": lambda: gr.to_sliding_dense(g, block_size=32),
        "sliding_rank1": lambda: gr.to_sliding_rank1(g, block_size=32),
        "sliding_packed": lambda: gr.to_sliding_packed(g, block_size=32),
    }[name]()


LAYOUTS = ["block_ell", "block_tiles", "windowed_dense", "sliding_dense",
           "sliding_rank1", "sliding_packed"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_matches_segment(name):
    g, n = _mesh_graph(levels=3)
    lay = _layout(name, g)
    x = _x((n, 24), 1)
    np.testing.assert_allclose(np.asarray(aggregate(lay, x)),
                               np.asarray(aggregate_segment(g, x)), **TOL)


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_batched_and_grad(name):
    g, n = _mesh_graph()
    lay = _layout(name, g)
    xb = _x((2, n, 8), 2)
    want = jax.vmap(lambda x: aggregate_segment(g, x))(xb)
    np.testing.assert_allclose(np.asarray(aggregate(lay, xb)),
                               np.asarray(want), **TOL)
    ga, gr = _grad_pair(lambda xx: aggregate(lay, xx), g, xb[0])
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gr), **TOL)


def test_rank1_scales_recovered_and_verified():
    from gwen.graph import rank1_scales

    g, n = _mesh_graph()
    a = rank1_scales(g)
    assert a.shape == (n,)
    # icosphere: 12 pentagon nodes (deg 5 → d̂=6), rest hexagons (d̂=7).
    assert np.allclose(np.sort(np.unique(np.round(a, 6))),
                       np.sort(np.unique(np.round(
                           [1 / np.sqrt(6), 1 / np.sqrt(7)], 6))))
    bad = build_graph(np.array([0, 1, 0, 1]), np.array([1, 0, 0, 1]), 2,
                      normalize=False, weights=np.array([1.0, 2.0, 1.0, 1.0]))
    with pytest.raises(ValueError):
        rank1_scales(bad)


def test_sliding_packed_device_build_matches_host():
    from gwen.graph import to_sliding_packed

    g, _ = _mesh_graph()
    host = to_sliding_packed(g, block_size=32)
    dev = to_sliding_packed(g, block_size=32, device_build=True)
    np.testing.assert_array_equal(np.asarray(dev.packed), host.packed)


def test_build_graph_sorts_receivers():
    g, n = _mesh_graph()
    r = np.asarray(g.receivers)
    assert g.receivers_sorted and np.all(np.diff(r) >= 0)
    # padding edges are inert (zero weight) and keep the order
    assert np.all(np.asarray(g.weights)[g.num_edges:] == 0)


# ------------------------------------------------ escape-window layouts


def test_kd_patch_order_is_permutation():
    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=64)
    assert perm.shape == (n,)
    assert np.array_equal(np.sort(perm), np.arange(n))


def test_escape_window_sliding_layout():
    from gwen.graph import to_sliding_dense
    from gwen.ops.aggregate import aggregate_sliding_dense_reference

    g, n = _kd_graph()
    sd = to_sliding_dense(g, block_size=32, window_size=256)
    assert sd.escape is not None and sd.escape.num_edges > 0
    # In-window + escape edges account for every edge exactly once.
    assert (np.asarray(sd.s_mat) != 0).sum() + sd.escape.num_edges \
        == g.num_edges
    xb = _x((2, n, 8), 3)
    want = jax.vmap(lambda x: aggregate_segment(g, x))(xb)
    got = aggregate_sliding_dense_reference(sd, xb)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    ga, gr = _grad_pair(lambda xx: aggregate_sliding_dense_reference(sd, xx),
                        g, xb[0])
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gr), **TOL)


def test_escape_set_is_symmetric():
    _, dw, _ = _kd_diag_graph()
    esc = dw.escape
    e = esc.num_edges
    s, r = np.asarray(esc.senders[:e]), np.asarray(esc.receivers[:e])
    fwd = set(zip(s.tolist(), r.tolist()))
    assert all((b, a) in fwd for a, b in fwd), "escape set must be symmetric"


def test_forced_window_start_rejects_escaping_edges():
    from gwen.graph.graph import ell_tables

    s = np.array([0, 90], np.int64)
    r = np.array([0, 1], np.int64)
    w = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="escape the forced windows"):
        ell_tables(s, r, w, num_dst=2, num_src=128, block_size=32,
                   window_size=64, forced_window_start=np.zeros(1, np.int64))


def test_escape_build_rejects_asymmetric_weights():
    from gwen.graph import to_sliding_dense
    from gwen.graph.graph import Graph

    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=128)
    s, r, _ = apply_order(perm, s, r)
    # Row-normalized D^-1 A weights: symmetric structure, asymmetric weights.
    deg = np.bincount(r, minlength=n).astype(np.float32)
    w = (1.0 / deg[r]).astype(np.float32)
    g = Graph(senders=s.astype(np.int32), receivers=r.astype(np.int32),
              weights=w, num_nodes=n, num_edges=s.shape[0])
    with pytest.raises(ValueError, match="not symmetric"):
        to_sliding_dense(g, block_size=32, window_size=256)
    with pytest.raises(ValueError, match="not symmetric"):
        to_diag_window(g, window_size=256, block_size=32)


def test_diag_window_covers_every_edge_once():
    g, dw, n = _kd_diag_graph()
    assert dw.escape is not None and dw.escape.num_edges > 0
    assert (np.asarray(dw.s_mat) != 0).sum() + dw.escape.num_edges \
        == g.num_edges
    starts = np.repeat(np.asarray(dw.xbase), dw.superblock) + dw.offsets
    assert np.all(np.diff(starts) >= 0)
    assert starts.max() + dw.window_size <= dw.num_src_rows


def test_compact_escape_graph_matches_escape_edges():
    from gwen.ops.aggregate import escape_add

    g, dw, n = _kd_diag_graph(compact_escapes=True)
    c2 = dw.esc2_graph
    assert c2.num_edges == dw.escape.num_edges and c2.receivers_sorted
    x = _x((n, 6), 4)
    # the compact contraction, scattered back, equals the escape composite
    xc = jnp.take(x, jnp.asarray(dw.esc2_src), axis=0)
    fixc = aggregate_segment(c2, xc)
    want = escape_add(dw, x, jnp.zeros_like(x))
    got = jnp.zeros_like(x).at[jnp.asarray(dw.esc2_src)].add(fixc)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ------------------------------- diagonal-window Triton kernel (interpret)


def _kernel(**kw):
    from gwen.ops.spmm_pallas import spmm_diag_window

    return functools.partial(spmm_diag_window, interpret=True, **kw)


KERNEL_CASES = {
    # name: (feature width, batch shape, launch chunk)
    "unbatched": (24, (), 128),
    "batched": (8, (2,), 128),
    "batched_2d": (8, (2, 2), 128),
    "f_not_chunk_multiple": (40, (), 32),
    "f_wider_than_chunk": (200, (), 64),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_diag_kernel_matches_segment(case):
    f, lead, chunk = KERNEL_CASES[case]
    g, dw, n = _kd_diag_graph()
    x = _x(lead + (n, f), 5)
    got = _kernel(launch=(chunk, 4, 2))(dw, x)
    want = aggregate_segment(g, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_diag_kernel_gradient():
    g, dw, n = _kd_diag_graph()
    x = _x((2, n, 8), 6)
    ga, gr = _grad_pair(functools.partial(_kernel(), dw), g, x)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gr), **TOL)


@pytest.mark.parametrize("rows", ["padded", "src"])
def test_diag_kernel_prepadded_rows(rows):
    """x kept at num_padded_nodes (or num_src_rows) rows comes back with
    its row count; the real rows match segment_sum and the gradient of the
    padded chain matches too."""
    g, dw, n = _kd_diag_graph()
    r = dw.num_padded_nodes if rows == "padded" else dw.num_src_rows
    x = jnp.zeros((r, 16)).at[:n].set(_x((n, 16), 7))
    got = _kernel()(dw, x)
    assert got.shape == (r, 16)
    np.testing.assert_allclose(np.asarray(got[:n]),
                               np.asarray(aggregate_segment(g, x[:n])), **TOL)
    ga = jax.grad(lambda xx: jnp.sum(jnp.sin(_kernel()(dw, xx)[:n])))(x)
    gr = jax.grad(lambda xx: jnp.sum(jnp.sin(aggregate_segment(g, xx))))(
        x[:n])
    np.testing.assert_allclose(np.asarray(ga[:n]), np.asarray(gr), **TOL)


def test_diag_kernel_under_jit_bf16():
    g, dw32, n = _kd_diag_graph()
    dw = to_diag_window(g, window_size=256, block_size=32, superblock=4,
                        dtype=jnp.bfloat16)
    x = _x((n, 32), 8)
    got = jax.jit(_kernel())(dw, x.astype(jnp.bfloat16))
    want = aggregate_segment(g, x)
    assert got.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want),
                               rtol=2e-2, atol=2e-2 * float(
                                   jnp.max(jnp.abs(want))))


def test_diag_kernel_tiny_graph_shrinks_superblock():
    verts, s, r = icosphere_edges(1)
    n = verts.shape[0]  # 42 nodes — the superblock cannot reach 8 blocks
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)
    dw = to_diag_window(g, window_size=128, block_size=32, superblock=8)
    assert dw.superblock < 8
    x = _x((n, 8), 9)
    np.testing.assert_allclose(np.asarray(_kernel()(dw, x)),
                               np.asarray(aggregate_segment(g, x)), **TOL)


def test_diag_kernel_wrong_rows_raises():
    _, dw, n = _kd_diag_graph()
    with pytest.raises(ValueError):
        _kernel()(dw, jnp.zeros((n + 1, 8)))


def test_diag_kernel_halo_extended_rows():
    """The kernel core on halo-extended partition rows equals the
    plain-XLA core on the same tables."""
    from gwen.ops.aggregate import diag_window_core_einsum
    from gwen.ops.spmm_pallas import diag_window_core
    from gwen.parallel import partition_graph
    from gwen.parallel.halo import HaloDiagGraph

    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=128)
    s, r, _ = apply_order(perm, s, r)
    pg = partition_graph(s, r, n, num_parts=2, block_size=32, reorder=False,
                         layout="diag", diag_window=128, diag_superblock=4)
    p = 1
    hg = HaloDiagGraph(
        offsets=pg.diag_offsets[p], xbase=pg.diag_xbase[p],
        s_mat=pg.s_diag[p], axis_name="graph", halo=pg.halo,
        n_local=pg.n_local, block_size=pg.block_size,
        window_size=pg.diag_window, superblock=pg.diag_superblock,
        num_edges=0)
    x_ext = _x((2, hg.ext_rows, 12), 10)
    got = diag_window_core(hg.xbase, hg.offsets, hg.s_mat, x_ext,
                           superblock=hg.superblock, src_rows=hg.ext_rows,
                           interpret=True)
    want = diag_window_core_einsum(hg, x_ext, hg.ext_rows)
    assert got.shape == (2, pg.n_local, 12)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ------------------------------------------- plain-XLA diag form + dispatch


def test_diag_einsum_matches_segment_batched_and_grad():
    g, dw, n = _kd_diag_graph()
    xb = _x((2, n, 8), 11)
    want = jax.vmap(lambda x: aggregate_segment(g, x))(xb)
    np.testing.assert_allclose(
        np.asarray(aggregate_diag_window_reference(dw, xb)),
        np.asarray(want), **TOL)
    ga, gr = _grad_pair(lambda xx: aggregate_diag_window_reference(dw, xx),
                        g, xb, fn=jnp.tanh)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gr), **TOL)


def test_cpu_dispatch_never_interprets(monkeypatch):
    """On the CPU, ``aggregate`` takes the plain-XLA form (the kernel entry
    point is never reached); forcing the kernel without interpret mode
    fails instead of silently interpreting."""
    from gwen.ops import spmm_pallas

    g, dw, n = _kd_diag_graph()
    x = _x((n, 8), 12)

    def boom(*a, **k):
        raise AssertionError("kernel reached on the CPU")

    with monkeypatch.context() as m:
        m.setattr(spmm_pallas, "spmm_diag_window", boom)
        got = aggregate(dw, x)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(aggregate_segment(g, x)), **TOL)
    with pytest.raises(Exception):
        jax.block_until_ready(aggregate(dw, x, backend="pallas"))


@pytest.mark.parametrize("plat,backend,want", [
    ("cpu", "auto", "einsum"),
    ("gpu", "auto", "GPU"),
    ("cpu", "pallas", "pallas"),
    ("gpu", "segment", "einsum"),
])
def test_platform_dispatch(monkeypatch, plat, backend, want):
    from gwen.ops import platform

    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    want = platform.GPU_DIAG_IMPL if want == "GPU" else want
    assert platform.diag_impl(backend) == want


def test_unknown_platform_raises(monkeypatch):
    from gwen.ops import platform

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported platform"):
        platform.diag_impl()
    with pytest.raises(RuntimeError, match="unsupported platform"):
        platform.attention_impl(jnp.bfloat16)


@pytest.mark.gpu
def test_compiled_kernel_matches_segment_on_gpu(gpu):
    from gwen.ops.spmm_pallas import spmm_diag_window

    g, dw, n = _kd_diag_graph()
    x = _x((2, n, 64), 13)
    with jax.default_matmul_precision("highest"):
        want = aggregate_segment(g, x)
    got = jax.jit(spmm_diag_window)(dw, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
