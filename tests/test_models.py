"""Model tests: shapes, width schedule parity, golden-math checks, grads."""

import jax
import jax.numpy as jnp
import numpy as np

from gwen.graph import build_graph, complete_edges, to_dense
from gwen.nn import EncodeProcessDecode, GCNStack, gcn_apply, gcn_init
from gwen.nn.core import count_params


def _member_graph(n=8):
    s, r = complete_edges(n)
    return build_graph(s, r, n)


def test_width_schedule_matches_reference():
    # Reference: ch_in -> h -> h/2 -> h/4 -> h/2 -> h -> ch_out
    # (models_gnn.py:106-206, active layers only).
    m = GCNStack(channels_in=64, channels_out=5, hidden_feats=32)
    assert m.widths == [64, 32, 16, 8, 16, 32, 5]


def test_gcn_stack_forward_shape():
    g = _member_graph(8)
    m = GCNStack(channels_in=12, channels_out=12, hidden_feats=16)
    params = m.init(jax.random.key(0))
    x = jnp.ones((8, 12))
    out = m.apply(params, g, x)
    assert out.shape == (8, 12)
    assert np.isfinite(np.asarray(out)).all()


def test_gcn_layer_golden_math():
    """GCNConv == D^{-1/2} Â D^{-1/2} X W + b, checked against explicit numpy."""
    n, d_in, d_out = 6, 4, 3
    s, r = complete_edges(n)
    g = build_graph(s, r, n)
    params = gcn_init(jax.random.key(1), d_in, d_out)
    x = np.random.default_rng(2).normal(size=(n, d_in)).astype(np.float32)

    out = gcn_apply(params, g, jnp.asarray(x))

    # numpy golden: normalized adjacency with self loops
    adj = np.ones((n, n), np.float32)  # complete + self loops, deg_hat = n
    adj /= n
    expected = adj @ x @ np.asarray(params["w"]) + np.asarray(params["b"])
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-4, atol=1e-4)


def test_gcn_golden_fixture_all_backends():
    """Checked-in golden fixture vs every aggregation backend (round-1
    verdict #7): tests/data/gcn_golden.npz holds a pure-numpy derivation of
    the reference GCNConv math (models_gnn.py:118-184) on a hand-checkable
    5-node path graph — generated by tests/data/make_gcn_golden.py WITHOUT
    importing gwen. Fails if GCN normalization or layer semantics ever
    drift from the reference's."""
    from pathlib import Path

    from gwen.graph import (
        to_block_ell,
        to_block_tiles,
        to_sliding_dense,
        to_sliding_rank1,
        to_windowed_dense,
    )
    from gwen.ops import aggregate

    fx = np.load(Path(__file__).parent / "data" / "gcn_golden.npz")
    n = int(fx["num_nodes"])
    g = build_graph(fx["senders"], fx["receivers"], n)
    x = jnp.asarray(fx["x"].astype(np.float32))
    containers = {
        "segment": g,
        "dense": to_dense(g),
        "ell": to_block_ell(g),
        "tiles": to_block_tiles(g),
        "windowed": to_windowed_dense(g),
        "sliding": to_sliding_dense(g),
        "rank1": to_sliding_rank1(g),
    }
    with jax.default_matmul_precision("highest"):
        # Normalized adjacency itself must match the hand derivation.
        np.testing.assert_allclose(
            np.asarray(containers["dense"].adj), fx["norm_adj"],
            rtol=1e-6, atol=1e-6,
        )
        for name, container in containers.items():
            got = np.asarray(aggregate(container, x))[:n]
            np.testing.assert_allclose(
                got, fx["expected_agg"], rtol=1e-5, atol=1e-5,
                err_msg=f"aggregation backend {name!r} drifted from golden",
            )
        # Full layer: Â X W + b.
        params = {"w": jnp.asarray(fx["w"].astype(np.float32)),
                  "b": jnp.asarray(fx["b"].astype(np.float32))}
        for name, container in containers.items():
            got = np.asarray(gcn_apply(params, container, x))[:n]
            np.testing.assert_allclose(
                got, fx["expected_layer"], rtol=1e-5, atol=1e-5,
                err_msg=f"gcn layer on backend {name!r} drifted from golden",
            )


def test_gcn_transform_order_equivalence():
    """Aggregate-then-transform == transform-then-aggregate (linearity)."""
    n = 10
    g = _member_graph(n)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32))
    p_wide = gcn_init(jax.random.key(0), 8, 16)  # d_out > d_in branch
    p_narrow = gcn_init(jax.random.key(0), 8, 4)  # d_out < d_in branch
    from gwen.ops import aggregate_segment

    for p in (p_wide, p_narrow):
        got = gcn_apply(p, g, x)
        want = aggregate_segment(g, x) @ p["w"] + p["b"]
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_encode_process_decode():
    g = _member_graph(8)
    m = EncodeProcessDecode(channels_in=10, channels_out=10, latent_size=16, process_steps=2)
    params = m.init(jax.random.key(0))
    x = jnp.ones((8, 10))
    out = m.apply(params, g, x)
    assert out.shape == (8, 10)
    assert count_params(params) > 0


def test_gradients_flow():
    g = _member_graph(6)
    m = GCNStack(channels_in=5, channels_out=5, hidden_feats=8)
    params = m.init(jax.random.key(0))
    x = jnp.ones((6, 5))
    target_mask = jnp.array([False] * 4 + [True] * 2)

    def loss_fn(p):
        from gwen.losses import masked_node_l1

        out = m.apply(p, g, x)
        return masked_node_l1(out, x * 0.5, target_mask)

    grads = jax.grad(loss_fn)(params)
    norms = [float(jnp.linalg.norm(g_)) for g_ in jax.tree_util.tree_leaves(grads)]
    assert all(np.isfinite(norms))
    assert any(v > 0 for v in norms)


def test_dense_graph_model_equivalence():
    """Model on DenseGraph == model on COO Graph (same params)."""
    n = 9
    g = _member_graph(n)
    dg = to_dense(g)
    m = GCNStack(channels_in=7, channels_out=7, hidden_feats=8)
    params = m.init(jax.random.key(3))
    x = jnp.asarray(np.random.default_rng(1).normal(size=(n, 7)).astype(np.float32))
    a = m.apply(params, g, x)
    b = m.apply(params, dg, x)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_interaction_processor():
    """MeshGraphNets-style edge-MLP processor trains and differs from GCN."""
    import optax

    from gwen.graph import build_graph, icosphere_edges
    from gwen.nn.interaction import interaction_apply, interaction_init

    verts, s, r = icosphere_edges(1)
    n = verts.shape[0]
    g = build_graph(s, r, n)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32))

    p = interaction_init(jax.random.key(0), 8)
    out = interaction_apply(p, g, x)
    assert out.shape == x.shape
    # batched
    xb = jnp.stack([x, x * 2])
    outb = interaction_apply(p, g, xb)
    assert outb.shape == xb.shape
    np.testing.assert_allclose(np.asarray(outb[0]), np.asarray(out), rtol=1e-5)

    model = EncodeProcessDecode(
        channels_in=8, channels_out=8, latent_size=8, process_steps=2,
        processor="interaction",
    )
    params = model.init(jax.random.key(1))
    y = model.apply(params, g, x)
    assert y.shape == x.shape

    # end-to-end gradient step works
    opt = optax.adam(1e-3)
    st = opt.init(params)

    def loss(pp):
        return jnp.mean((model.apply(pp, g, x) - x * 0.5) ** 2)

    l0 = float(loss(params))
    grads = jax.grad(loss)(params)
    updates, st = opt.update(grads, st, params)
    params2 = optax.apply_updates(params, updates)
    assert float(loss(params2)) < l0 + 1e-6


def test_epd_remat_modes_match():
    """remat=True (full recompute) and remat="save_agg" (checkpoint the
    aggregation outputs, recompute only cheap ops) must produce identical
    outputs and gradients to the un-rematerialized model."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gwen.graph import apply_order, build_graph, icosphere_edges, rcm_order
    from gwen.nn import EncodeProcessDecode

    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    g = build_graph(s2, r2, n)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(n, 3)),
                    jnp.float32)

    models = {
        mode: EncodeProcessDecode(channels_in=3, channels_out=3,
                                  latent_size=16, process_steps=2,
                                  backend="segment", remat=mode)
        for mode in (False, True, "save_agg")
    }
    params = models[False].init(jax.random.key(0))

    outs, grads = {}, {}
    for mode, m in models.items():
        outs[mode] = np.asarray(m.apply(params, g, x))
        grads[mode] = jax.grad(
            lambda p, m=m: jnp.sum(jnp.sin(m.apply(p, g, x))))(params)
    for mode in (True, "save_agg"):
        np.testing.assert_allclose(outs[mode], outs[False], rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(grads[mode]),
                        jax.tree_util.tree_leaves(grads[False])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)


def test_epd_remat_save_agg_attention():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gwen.graph import (
        apply_order, build_graph, icosphere_edges, kd_patch_order,
        to_diag_window,
    )
    from gwen.nn import EncodeProcessDecode

    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=64)
    s2, r2, _ = apply_order(perm, s, r)
    dw = to_diag_window(build_graph(s2, r2, n), window_size=128,
                        block_size=32, superblock=4)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(n, 3)),
                    jnp.float32)
    params = None
    outs, grads = {}, {}
    for mode in (False, "save_agg"):
        m = EncodeProcessDecode(channels_in=3, channels_out=3,
                                latent_size=16, process_steps=2,
                                processor="attention", attn_heads=2,
                                remat=mode)
        if params is None:
            params = m.init(jax.random.key(1))
        outs[mode] = np.asarray(m.apply(params, dw, x))
        grads[mode] = jax.grad(
            lambda p, m=m: jnp.sum(jnp.sin(m.apply(p, dw, x))))(params)
    np.testing.assert_allclose(outs["save_agg"], outs[False], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(grads["save_agg"]),
                    jax.tree_util.tree_leaves(grads[False])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
