"""Partitioned-graph parallelism tests on the 8-device virtual CPU mesh.

Validates the halo-exchange design end-to-end: partitioned aggregation and a
full model under shard_map must match the single-device global computation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gwen.graph import apply_order, build_graph, icosphere_edges, rcm_order
from gwen.nn import EncodeProcessDecode
from gwen.ops import aggregate_segment
from gwen.parallel import make_partitioned_apply, partition_graph
from gwen.train import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs multi-device CPU mesh"
)


def _global_reference_graph(s, r, n):
    """Graph in the same RCM order the partitioner uses."""
    perm = rcm_order(s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    return build_graph(s2, r2, n), perm


def test_partition_tables_consistent():
    verts, s, r = icosphere_edges(3)  # 642 nodes
    n = verts.shape[0]
    pg = partition_graph(s, r, n, num_parts=4, block_size=32)
    assert pg.nbr.shape[0] == 4
    assert pg.n_local * 4 >= n
    assert pg.edges_per_part.sum() == pg.num_edges
    assert pg.halo <= pg.n_local


def test_partitioned_aggregation_matches_global():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    num_parts = 4
    pg = partition_graph(s, r, n, num_parts=num_parts, block_size=32)
    g_ref, perm = _global_reference_graph(s, r, n)

    x = np.random.default_rng(0).normal(size=(n, 16)).astype(np.float32)
    want = np.asarray(aggregate_segment(g_ref, jnp.asarray(np.take(x, perm, axis=0))))

    mesh = make_mesh(data=len(jax.devices()) // num_parts, graph=num_parts)

    from gwen.parallel import HaloGraph
    from gwen.ops import aggregate
    from jax.sharding import PartitionSpec as P

    nbr = jnp.asarray(pg.nbr)
    nbr_w = jnp.asarray(pg.nbr_weight)
    ws = jnp.asarray(pg.window_start)
    xp = jnp.asarray(pg.pad_nodes(x, node_axis=0))

    def local(nbr_p, w_p, ws_p, x_p):
        hg = HaloGraph(
            nbr=nbr_p[0], nbr_weight=w_p[0], window_start=ws_p[0],
            axis_name="graph", halo=pg.halo, n_local=pg.n_local,
            block_size=pg.block_size, window_size=pg.window_size,
            num_edges=int(pg.edges_per_part.max()),
        )
        return aggregate(hg, x_p)

    out = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("graph"), P("graph"), P("graph"), P("graph", None)),
            out_specs=P("graph", None),
            check_vma=False,
        )
    )(nbr, nbr_w, ws, xp)
    got = np.asarray(out)[:n]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_partitioned_model_matches_global():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    num_parts = 2
    pg = partition_graph(s, r, n, num_parts=num_parts, block_size=32)
    g_ref, perm = _global_reference_graph(s, r, n)

    model = EncodeProcessDecode(
        channels_in=8, channels_out=8, latent_size=16, process_steps=2,
        backend="segment",
    )
    params = model.init(jax.random.key(0))

    dp = len(jax.devices()) // num_parts
    x = np.random.default_rng(1).normal(size=(dp, n, 8)).astype(np.float32)
    want = np.asarray(model.apply(params, g_ref, jnp.asarray(np.take(x, perm, axis=1))))

    mesh = make_mesh(data=len(jax.devices()) // num_parts, graph=num_parts)
    apply = make_partitioned_apply(model, pg, mesh)
    xp = jnp.asarray(pg.pad_nodes(x))
    got = np.asarray(jax.jit(apply)(params, xp))[:, :n, :]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_partitioned_gradients():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    pg = partition_graph(s, r, n, num_parts=2, block_size=32)
    g_ref, perm = _global_reference_graph(s, r, n)
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    mesh = make_mesh(data=len(jax.devices()) // 2, graph=2)
    apply = make_partitioned_apply(model, pg, mesh)

    dp = len(jax.devices()) // 2
    x = np.random.default_rng(2).normal(size=(dp, n, 4)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    xg = jnp.asarray(np.take(x, perm, axis=1))

    def loss_part(p):
        return jnp.sum(jnp.sin(apply(p, xp)[:, :n, :]))

    def loss_global(p):
        return jnp.sum(jnp.sin(model.apply(p, g_ref, xg)))

    gp = jax.jit(jax.grad(loss_part))(params)
    gg = jax.jit(jax.grad(loss_global))(params)
    for a, b in zip(jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_partitioned_dense_s_matches_global():
    """Streamed-S local aggregation inside shard_map == global model."""
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    num_parts = 2
    pg = partition_graph(s, r, n, num_parts=num_parts, block_size=32, dense_s=True)
    assert pg.s_dense is not None
    g_ref, perm = _global_reference_graph(s, r, n)

    model = EncodeProcessDecode(
        channels_in=8, channels_out=8, latent_size=16, process_steps=2,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    dp = len(jax.devices()) // num_parts
    x = np.random.default_rng(4).normal(size=(dp, n, 8)).astype(np.float32)
    want = np.asarray(model.apply(params, g_ref, jnp.asarray(np.take(x, perm, axis=1))))

    mesh = make_mesh(data=dp, graph=num_parts)
    apply = make_partitioned_apply(model, pg, mesh)
    assert len(apply.tables) == 4
    xp = jnp.asarray(pg.pad_nodes(x))
    got = np.asarray(jax.jit(apply)(params, xp))[:, :n, :]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_partitioned_sliding_matches_global():
    """Sliding-ring local aggregation inside shard_map == global model —
    the flagship kernel on the partitioned path (round-1 verdict #1)."""
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    num_parts = 4
    pg = partition_graph(s, r, n, num_parts=num_parts, block_size=32,
                         layout="sliding")
    assert pg.s_sliding is not None
    assert pg.s_sliding.shape[0] == num_parts
    assert pg.sliding_ring >= pg.sliding_window
    g_ref, perm = _global_reference_graph(s, r, n)

    model = EncodeProcessDecode(
        channels_in=8, channels_out=8, latent_size=16, process_steps=2,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    dp = len(jax.devices()) // num_parts
    x = np.random.default_rng(5).normal(size=(dp, n, 8)).astype(np.float32)
    want = np.asarray(model.apply(params, g_ref, jnp.asarray(np.take(x, perm, axis=1))))

    mesh = make_mesh(data=dp, graph=num_parts)
    apply = make_partitioned_apply(model, pg, mesh)
    assert len(apply.tables) == 3  # (window_start, delta_blocks, s_ring)
    xp = jnp.asarray(pg.pad_nodes(x))
    got = np.asarray(jax.jit(apply)(params, xp))[:, :n, :]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_partitioned_sliding_gradients():
    """Gradients through the sliding partitioned path == global gradients."""
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    pg = partition_graph(s, r, n, num_parts=2, block_size=32, layout="sliding")
    g_ref, perm = _global_reference_graph(s, r, n)
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    dp = len(jax.devices()) // 2
    mesh = make_mesh(data=dp, graph=2)
    apply = make_partitioned_apply(model, pg, mesh)

    x = np.random.default_rng(6).normal(size=(dp, n, 4)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    xg = jnp.asarray(np.take(x, perm, axis=1))

    gp = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(apply(p, xp)[:, :n, :]))))(params)
    gg = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(model.apply(p, g_ref, xg)))))(params)
    for a, b in zip(jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_partitioned_rollout_loss_matches_global_preds():
    """partitioned_rollout_loss_fn's trajectory == global model rollout."""
    from gwen.train.tasks import partitioned_rollout_loss_fn

    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    pg = partition_graph(s, r, n, num_parts=2, block_size=32)
    g_ref, perm = _global_reference_graph(s, r, n)
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    dp = len(jax.devices()) // 2
    mesh = make_mesh(data=dp, graph=2)
    apply = make_partitioned_apply(model, pg, mesh)

    horizon = 2
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=(dp, n, 4)).astype(np.float32)
    traj = rng.normal(size=(dp, horizon, n, 4)).astype(np.float32)
    x0p = jnp.asarray(pg.pad_nodes(x0))
    trajp = jnp.asarray(pg.pad_nodes(traj))

    loss_fn = partitioned_rollout_loss_fn(apply, horizon)
    value, preds = jax.jit(loss_fn)(params, (x0p, trajp), apply.tables)
    assert np.isfinite(float(value))

    # Global rollout on the RCM-ordered graph.
    xg = jnp.asarray(np.take(x0, perm, axis=1))
    want = []
    cur = xg
    for _ in range(horizon):
        cur = model.apply(params, g_ref, cur)
        want.append(np.asarray(cur))
    want = np.stack(want, axis=1)  # (dp, H, n, 4)
    np.testing.assert_allclose(
        np.asarray(preds)[:, :, :n, :], want, rtol=2e-4, atol=2e-4
    )

    grads = jax.jit(
        jax.grad(lambda p: loss_fn(p, (x0p, trajp), apply.tables)[0])
    )(params)
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_partitioned_ensemble_crps_loss_runs():
    """CRPS-ensemble training through the partitioned apply: finite loss and
    gradients; ensemble-mean preds shaped like the target."""
    from gwen.train.tasks import partitioned_ensemble_crps_loss_fn

    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    pg = partition_graph(s, r, n, num_parts=2, block_size=32)
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    dp = len(jax.devices()) // 2
    mesh = make_mesh(data=dp, graph=2)
    apply = make_partitioned_apply(model, pg, mesh)

    # Noise graph over the padded node space, in the partitioner's order.
    perm = pg.perm
    s2, r2 = perm.argsort()[s], perm.argsort()[r]
    from gwen.graph import build_graph as _bg
    noise_graph = _bg(s2, r2, pg.padded_nodes)

    rng = np.random.default_rng(9)
    # B*K must divide the data axis: B=dp, K=2 with dp in {2, 4}.
    x = rng.normal(size=(dp, n, 4)).astype(np.float32)
    y = rng.normal(size=(dp, n, 4)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    yp = jnp.asarray(pg.pad_nodes(y))

    loss_fn = partitioned_ensemble_crps_loss_fn(apply, num_members=2, sigma=0.05)
    # Noise graph travels with the tables as jit arguments (Trainer context
    # pattern) — closed-over numpy tables would inline as constants.
    context = (apply.tables, noise_graph)
    value, preds = jax.jit(loss_fn)(
        params, (xp, yp, jax.random.key(3)), context
    )
    assert np.isfinite(float(value))
    assert preds.shape == yp.shape
    grads = jax.jit(
        jax.grad(lambda p: loss_fn(p, (xp, yp, jax.random.key(3)),
                                   context)[0])
    )(params)
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.all(np.isfinite(np.asarray(leaf)))


# ---------------------------------------------- diagonal-window partitions


def _kd_graph(levels=3, leaf_size=128):
    from gwen.graph import kd_patch_order

    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=leaf_size)
    s2, r2, _ = apply_order(perm, s, r)
    return s2, r2, n


class _AggModel:
    """Minimal model shim: apply = aggregate, for kernel-only tests."""

    @staticmethod
    def apply(params, graph, x):
        from gwen.ops import aggregate

        return aggregate(graph, x)


def test_partitioned_diag_matches_global():
    """Diag-window local kernel + boundary-skeleton escape allgather inside
    shard_map == global segment aggregation (same KD order)."""
    s2, r2, n = _kd_graph()
    num_parts = 2
    pg = partition_graph(
        s2, r2, n, num_parts=num_parts, block_size=32, reorder=False,
        layout="diag", diag_window=128, diag_superblock=4,
    )
    assert pg.layout == "diag" and pg.s_diag is not None
    assert pg.diag_loc_idx is not None, "window must force escapes"
    assert pg.halo == pg.diag_window  # O(window) halos, not O(bandwidth)
    g_ref = build_graph(s2, r2, n)

    x = np.random.default_rng(3).normal(size=(n, 16)).astype(np.float32)
    want = np.asarray(aggregate_segment(g_ref, jnp.asarray(x)))

    mesh = make_mesh(data=len(jax.devices()) // num_parts, graph=num_parts)
    apply = make_partitioned_apply(_AggModel(), pg, mesh)
    xp = jnp.asarray(pg.pad_nodes(x, node_axis=0))
    got = np.asarray(jax.jit(apply)(None, xp))[:n]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_partitioned_diag_model_and_gradients():
    s2, r2, n = _kd_graph()
    num_parts = 2
    pg = partition_graph(
        s2, r2, n, num_parts=num_parts, block_size=32, reorder=False,
        layout="diag", diag_window=128, diag_superblock=4,
    )
    g_ref = build_graph(s2, r2, n)
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=2,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    mesh = make_mesh(data=len(jax.devices()) // num_parts, graph=num_parts)
    apply = make_partitioned_apply(model, pg, mesh)

    dp = len(jax.devices()) // num_parts
    x = np.random.default_rng(4).normal(size=(dp, n, 4)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    want = np.asarray(model.apply(params, g_ref, jnp.asarray(x)))
    got = np.asarray(jax.jit(apply)(params, xp))[:, :n, :]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def loss_part(p):
        return jnp.sum(jnp.sin(apply(p, xp)[:, :n, :]))

    def loss_global(p):
        return jnp.sum(jnp.sin(model.apply(p, g_ref, jnp.asarray(x))))

    gp = jax.jit(jax.grad(loss_part))(params)
    gg = jax.jit(jax.grad(loss_global))(params)
    for a, b in zip(jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_partitioned_attention_matches_global():
    """Partitioned windowed attention (halo K/V exchange + the same local
    attention) == global windowed attention, incl. gradients. The global
    layout is rebuilt at the partition's n_pad so the window masks are
    identical."""
    from gwen.graph import to_diag_window

    s2, r2, n = _kd_graph()
    num_parts = 2
    pg = partition_graph(
        s2, r2, n, num_parts=num_parts, block_size=32, reorder=False,
        layout="diag", diag_window=128, diag_superblock=4,
    )
    g_ref = build_graph(s2, r2, n)
    dw = to_diag_window(
        g_ref, window_size=128, block_size=32, superblock=4,
        n_pad=num_parts * pg.n_local,
    )
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=2,
        processor="attention", attn_heads=2,
    )
    params = model.init(jax.random.key(1))
    mesh = make_mesh(data=len(jax.devices()) // num_parts, graph=num_parts)
    apply = make_partitioned_apply(model, pg, mesh)

    dp = len(jax.devices()) // num_parts
    x = np.random.default_rng(5).normal(size=(dp, n, 4)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    want = np.asarray(model.apply(params, dw, jnp.asarray(x)))
    got = np.asarray(jax.jit(apply)(params, xp))[:, :n, :]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def loss_part(p):
        return jnp.sum(jnp.sin(apply(p, xp)[:, :n, :]))

    def loss_global(p):
        return jnp.sum(jnp.sin(model.apply(p, dw, jnp.asarray(x))))

    gp = jax.jit(jax.grad(loss_part))(params)
    gg = jax.jit(jax.grad(loss_global))(params)
    for a, b in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(gg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)


def test_partitioned_diag_per_device_batch():
    """Per-device leading batch >1 rides one batched halo aggregation per
    call and must match the global batched computation."""
    s2, r2, n = _kd_graph()
    num_parts = 2
    pg = partition_graph(
        s2, r2, n, num_parts=num_parts, block_size=32, reorder=False,
        layout="diag", diag_window=128, diag_superblock=4,
    )
    g_ref = build_graph(s2, r2, n)
    dp = len(jax.devices()) // num_parts
    mesh = make_mesh(data=dp, graph=num_parts)
    apply = make_partitioned_apply(_AggModel(), pg, mesh)

    bpd = 3  # batch entries PER DEVICE on the data axis
    x = np.random.default_rng(7).normal(
        size=(dp * bpd, n, 16)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    want = np.asarray(aggregate_segment(g_ref, jnp.asarray(x)))
    got = np.asarray(jax.jit(apply)(None, xp))[:, :n]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_partitioned_attention_per_device_batch():
    """Batched partitioned attention: per-device batch 2 x 2 heads ride the
    leading axes of one attention call; K/V halo exchanges happen once per
    tensor, not once per head."""
    from gwen.graph import to_diag_window

    s2, r2, n = _kd_graph()
    num_parts = 2
    pg = partition_graph(
        s2, r2, n, num_parts=num_parts, block_size=32, reorder=False,
        layout="diag", diag_window=128, diag_superblock=4,
    )
    g_ref = build_graph(s2, r2, n)
    dw = to_diag_window(
        g_ref, window_size=128, block_size=32, superblock=4,
        n_pad=num_parts * pg.n_local,
    )
    model = EncodeProcessDecode(
        channels_in=4, channels_out=4, latent_size=8, process_steps=2,
        processor="attention", attn_heads=2,
    )
    params = model.init(jax.random.key(2))
    dp = len(jax.devices()) // num_parts
    mesh = make_mesh(data=dp, graph=num_parts)
    apply = make_partitioned_apply(model, pg, mesh)

    bpd = 2
    x = np.random.default_rng(8).normal(
        size=(dp * bpd, n, 4)).astype(np.float32)
    xp = jnp.asarray(pg.pad_nodes(x))
    want = np.asarray(model.apply(params, dw, jnp.asarray(x)))
    got = np.asarray(jax.jit(apply)(params, xp))[:, :n, :]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def loss_part(p):
        return jnp.sum(jnp.sin(apply(p, xp)[:, :n, :]))

    def loss_global(p):
        return jnp.sum(jnp.sin(model.apply(p, dw, jnp.asarray(x))))

    gp = jax.jit(jax.grad(loss_part))(params)
    gg = jax.jit(jax.grad(loss_global))(params)
    for a, b in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(gg)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)
