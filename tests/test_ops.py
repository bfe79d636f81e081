"""Aggregation backend equivalence tests (golden path = segment_sum)."""

import jax.numpy as jnp
import numpy as np

from gwen.graph import (
    apply_order,
    build_graph,
    complete_edges,
    grid2d_edges,
    icosphere_edges,
    rcm_order,
    to_block_ell,
    to_dense,
)
from gwen.ops import (
    aggregate_block_ell_reference,
    aggregate_dense,
    aggregate_segment,
)


def _random_x(n, f, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    )


def test_dense_matches_segment_complete():
    n = 17
    s, r = complete_edges(n)
    g = build_graph(s, r, n)
    x = _random_x(n, 9)
    a = aggregate_segment(g, x)
    b = aggregate_dense(to_dense(g), x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_dense_matches_segment_grid():
    s, r = grid2d_edges(5, 7)
    g = build_graph(s, r, 35)
    x = _random_x(35, 13)
    a = aggregate_segment(g, x)
    b = aggregate_dense(to_dense(g), x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_block_ell_reference_matches_segment():
    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)
    be = to_block_ell(g, block_size=32)
    x = _random_x(n, 24)
    a = aggregate_segment(g, x)
    b = aggregate_block_ell_reference(be, x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_aggregate_dispatch_sliding_and_windowed_backends():
    """Regression: the windowed-dense and sliding containers dispatch
    through aggregate() to their jnp aggregations on every backend."""
    from gwen.graph import (
        apply_order,
        icosphere_edges,
        rcm_order,
        to_sliding_dense,
        to_windowed_dense,
    )
    from gwen.ops import aggregate

    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)
    x = _random_x(n, 12)
    want = np.asarray(aggregate_segment(g, x))

    wd = to_windowed_dense(g, block_size=32)
    sd = to_sliding_dense(g, block_size=32)
    for graph in (wd, sd):
        got_k = np.asarray(aggregate(graph, x))
        got_r = np.asarray(aggregate(graph, x, backend="segment"))
        np.testing.assert_allclose(got_k, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got_r, want, rtol=1e-4, atol=1e-4)


def test_device_build_s_matches_host_build():
    """device_build=True expands the same S as the host np.add.at path —
    the L8-scale route where S must never cross the host->device link."""
    from gwen.graph import to_sliding_dense, to_windowed_dense

    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)

    wd_host = to_windowed_dense(g, block_size=32)
    wd_dev = to_windowed_dense(g, block_size=32, device_build=True)
    np.testing.assert_allclose(
        np.asarray(wd_dev.s_mat), wd_host.s_mat, rtol=1e-6, atol=1e-6
    )
    assert np.array_equal(np.asarray(wd_dev.window_start), wd_host.window_start)

    sd_host = to_sliding_dense(g, block_size=32)
    sd_dev = to_sliding_dense(g, block_size=32, device_build=True)
    np.testing.assert_allclose(
        np.asarray(sd_dev.s_mat), sd_host.s_mat, rtol=1e-6, atol=1e-6
    )
    assert sd_dev.ring_rows == sd_host.ring_rows
    assert np.array_equal(np.asarray(sd_dev.delta_blocks), sd_host.delta_blocks)


def _float64_residual_ln(p, m, h, eps=1e-6):
    m = np.asarray(m, np.float64)
    mu = m.mean(-1, keepdims=True)
    var = m.var(-1, keepdims=True)
    return (np.asarray(h, np.float64) + (m - mu) / np.sqrt(var + eps)
            * np.asarray(p["scale"], np.float64)
            + np.asarray(p["bias"], np.float64))


def test_residual_layernorm_matches_float64_and_grads():
    """The process-step tail h + layer_norm(m) (plain jnp, float32
    statistics) against a float64 host computation, incl. batched leading
    dims, with gradients against finite differences of the float64 form."""
    import jax
    import jax.numpy as jnp

    from gwen.nn import EncodeProcessDecode, core

    model = EncodeProcessDecode(channels_in=2, channels_out=2, latent_size=8)
    rng = np.random.default_rng(0)
    for shape in [(700, 128), (3, 130, 256), (64, 96)]:
        m = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        h = jnp.asarray(rng.normal(size=shape).astype(np.float32))
        p = core.layer_norm_init(shape[-1])
        p = {"scale": p["scale"] * 1.3 + 0.1, "bias": p["bias"] + 0.2}
        got = jax.jit(model._norm_residual)(p, m, h)
        np.testing.assert_allclose(np.asarray(got),
                                   _float64_residual_ln(p, m, h),
                                   rtol=1e-5, atol=1e-5)
        # d/dh of the residual path is the identity; d/dbias sums rows.
        gh, gb = jax.grad(lambda h_, b_: jnp.sum(model._norm_residual(
            {"scale": p["scale"], "bias": b_}, m, h_)), argnums=(0, 1))(
                h, p["bias"])
        np.testing.assert_allclose(np.asarray(gh), 1.0)
        np.testing.assert_allclose(np.asarray(gb),
                                   np.prod(shape[:-1]), rtol=1e-6)


def test_residual_layernorm_bf16_and_remat():
    """bf16 inputs (statistics in float32) + composition with
    jax.checkpoint (save_agg-style)."""
    import jax
    import jax.numpy as jnp

    from gwen.nn import EncodeProcessDecode, core

    model = EncodeProcessDecode(channels_in=2, channels_out=2, latent_size=8)
    rng = np.random.default_rng(1)
    m = jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32),
                    jnp.bfloat16)
    h = jnp.asarray(rng.normal(size=(256, 128)).astype(np.float32),
                    jnp.bfloat16)
    p = core.layer_norm_init(128)

    def loss(p_, m_, h_):
        step = jax.checkpoint(lambda mm: model._norm_residual(p_, mm, h_))
        return jnp.sum(step(m_).astype(jnp.float32))

    got = float(loss(p, m, h))
    want = float(np.sum(_float64_residual_ln(p, m, h)))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2.0)
    g = jax.grad(loss, argnums=1)(p, m, h)
    assert g.dtype == jnp.bfloat16 and np.isfinite(
        np.asarray(g, np.float32)
    ).all()
