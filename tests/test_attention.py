"""Windowed-attention tests on the CPU: the vectorised XLA form against a
dense masked softmax built independently from the diag-window layout, the
edge-list reference, the multi-head layer and the attention processor.
cuDNN's fused attention (the GPU choice for 16-bit inputs) is checked by the
``gpu``-marked test and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gwen.graph import (
    apply_order,
    build_graph,
    icosphere_edges,
    kd_patch_order,
    to_diag_window,
)
from gwen.ops.attention import (
    edge_attention_reference,
    window_edges,
    windowed_attention,
)

TOL = dict(rtol=2e-5, atol=2e-5)


def _diag_graph(levels=3, window=128, block=32, superblock=4):
    verts, s, r = icosphere_edges(levels)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=64)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)
    dw = to_diag_window(g, window_size=window, block_size=block,
                        superblock=superblock)
    return g, dw, n


def _dense_mask(dw, n):
    """Neighbour mask expanded block by block on the host (float64)."""
    s = np.asarray(dw.s_mat)
    bs, w = dw.block_size, dw.window_size
    dense = np.zeros((dw.num_padded_nodes, dw.num_src_rows), bool)
    starts = np.repeat(np.asarray(dw.xbase), dw.superblock) + dw.offsets
    for blk, start in enumerate(starts):
        dense[blk * bs:(blk + 1) * bs, start:start + w] = \
            s[blk * bs:(blk + 1) * bs] != 0
    return dense[:n, :n]


def _dense_attention(mask, q, k, v, scale):
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    logits = np.einsum("...id,...jd->...ij", q, k) * scale
    logits = np.where(mask, logits, -np.inf)
    logits -= logits.max(-1, keepdims=True)
    p = np.exp(logits) * mask
    p /= p.sum(-1, keepdims=True)
    return np.einsum("...ij,...jd->...id", p, v)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=shape).astype(np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)],
                         ids=["single", "heads", "heads_batch"])
def test_windowed_attention_matches_dense_softmax(lead):
    _, dw, n = _diag_graph()
    f = 16
    q, k, v = _qkv(lead + (n, f), 1)
    got = windowed_attention(dw, q, k, v)
    want = _dense_attention(_dense_mask(dw, n), q, k, v, 1 / np.sqrt(f))
    assert got.shape == q.shape
    np.testing.assert_allclose(np.asarray(got), want, **TOL)


def test_windowed_attention_gradients_match_dense():
    _, dw, n = _diag_graph()
    f = 8
    q, k, v = _qkv((2, n, f), 2)
    mask = jnp.asarray(_dense_mask(dw, n))

    def dense(q, k, v):
        logits = jnp.einsum("...id,...jd->...ij", q, k) / np.sqrt(f)
        p = jax.nn.softmax(jnp.where(mask, logits, -1e30), axis=-1)
        return jnp.einsum("...ij,...jd->...id", p, v)

    def loss(fn):
        return lambda q, k, v: jnp.sum(jnp.cos(fn(q, k, v)))

    gw = jax.grad(loss(lambda *a: windowed_attention(dw, *a)),
                  argnums=(0, 1, 2))(q, k, v)
    gd = jax.grad(loss(dense), argnums=(0, 1, 2))(q, k, v)
    for a, b, name in zip(gw, gd, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_windowed_attention_padded_rows_and_scale():
    """q/k/v at the padded row count: real rows match; an explicit scale
    is honoured."""
    _, dw, n = _diag_graph()
    f = 8
    q, k, v = _qkv((dw.num_padded_nodes, f), 3)
    got = windowed_attention(dw, q, k, v, scale=0.5)
    assert got.shape == q.shape
    want = _dense_attention(_dense_mask(dw, n), q[:n], k[:n], v[:n], 0.5)
    np.testing.assert_allclose(np.asarray(got[:n]), want, **TOL)


def _padded_grads(dw, q, k, v, ct, fn):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * ct)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def test_windowed_attention_gradients_padded_rows():
    """Gradients at the padded row count match the edge-list reference over
    the same rows, and are zero on the rows past the last node."""
    _, dw, n = _diag_graph()
    rows = dw.num_padded_nodes
    assert rows > n
    q, k, v = _qkv((2, rows, 8), 7)
    ct = _qkv((2, rows, 8), 8)[0]
    es, er = window_edges(dw)
    got = _padded_grads(dw, q, k, v, ct,
                        lambda *a: windowed_attention(dw, *a))
    want = _padded_grads(dw, q, k, v, ct,
                         lambda q, k, v: edge_attention_reference(
                             es, er, q, k, v, rows))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL,
                                   err_msg=name)
        assert not np.any(np.asarray(a)[:, n:]), name


def test_edge_reference_agrees():
    """The edge-list reference (the golden at mesh scale) agrees with the
    independent host computation."""
    _, dw, n = _diag_graph()
    f = 8
    q, k, v = _qkv((2, n, f), 4)
    want = _dense_attention(_dense_mask(dw, n), q, k, v, 1 / np.sqrt(f))
    es, er = window_edges(dw)
    assert np.all(np.diff(er) >= 0)
    np.testing.assert_allclose(
        np.asarray(edge_attention_reference(es, er, q, k, v, n)), want, **TOL)


def test_attention_bf16_within_golden_tolerance():
    _, dw, n = _diag_graph()
    f = 32
    q, k, v = _qkv((2, n, f), 5)
    got = windowed_attention(dw, *(a.astype(jnp.bfloat16) for a in (q, k, v)))
    es, er = window_edges(dw)
    want = edge_attention_reference(es, er, q, k, v, n)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want))
                / jnp.max(jnp.abs(want)))
    assert got.dtype == jnp.bfloat16 and err <= 2e-2


def test_attention_rejects_other_graphs():
    from gwen.nn.attention import graph_attention_apply, graph_attention_init

    g, _, n = _diag_graph(levels=2)
    params = graph_attention_init(jax.random.key(0), 8, heads=2)
    with pytest.raises(TypeError, match="DiagWindowGraph"):
        graph_attention_apply(params, g, jnp.zeros((n, 8)))


@pytest.mark.parametrize("heads", [2, 4])
def test_graph_attention_heads_match_per_head_reference(heads):
    """Multi-head layer = per-head dense attention of the projected
    slices, concatenated and mixed by the output projection."""
    from gwen.nn.attention import graph_attention_apply, graph_attention_init

    _, dw, n = _diag_graph(levels=2, window=128, block=32, superblock=2)
    latent = 32
    params = graph_attention_init(jax.random.key(2), latent, heads=heads)
    x = jnp.asarray(np.random.default_rng(9).normal(size=(2, n, latent)),
                    jnp.float32)
    got = graph_attention_apply(params, dw, x, heads=heads)

    dh = latent // heads
    mask = _dense_mask(dw, n)

    def proj(p):
        return np.asarray(x) @ np.asarray(p["w"]) + np.asarray(p["b"])

    q, k, v = (proj(params[w]) for w in ("wq", "wk", "wv"))
    outs = [_dense_attention(mask, q[..., h * dh:(h + 1) * dh],
                             k[..., h * dh:(h + 1) * dh],
                             v[..., h * dh:(h + 1) * dh], 1 / np.sqrt(dh))
            for h in range(heads)]
    want = (np.concatenate(outs, -1) @ np.asarray(params["wo"]["w"])
            + np.asarray(params["wo"]["b"]))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_epd_attention_processor_trains():
    import optax

    from gwen.nn import EncodeProcessDecode

    _, dw, n = _diag_graph(levels=2, window=128, block=32, superblock=2)
    model = EncodeProcessDecode(channels_in=6, channels_out=6, latent_size=32,
                                process_steps=2, processor="attention",
                                attn_heads=2)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(n, 6)).astype(np.float32))
    y = x * 0.7

    out = model.apply(params, dw, x)
    assert out.shape == (n, 6)
    assert np.isfinite(np.asarray(out)).all()

    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss(p):
            return jnp.mean((model.apply(p, dw, x) - y) ** 2)
        lval, grads = jax.value_and_grad(loss)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, lval

    losses = []
    for _ in range(5):
        params, opt_state, lval = step(params, opt_state)
        losses.append(float(lval))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.gpu
def test_cudnn_attention_matches_xla_on_gpu(gpu):
    _, dw, n = _diag_graph()
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv((2, n, 64), 6))
    xla = windowed_attention(dw, q, k, v, impl="xla")
    cudnn = windowed_attention(dw, q, k, v, impl="cudnn")
    np.testing.assert_allclose(np.asarray(cudnn, np.float32),
                               np.asarray(xla, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_cudnn_attention_gradients_match_xla_on_gpu(gpu):
    """cuDNN's backward, padded rows included: the rows past the last node
    are fully masked, and their gradients must be zero, not NaN."""
    _, dw, n = _diag_graph()
    rows = dw.num_padded_nodes
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv((2, rows, 64), 9))
    ct = _qkv((2, rows, 64), 10)[0]
    xla, cudnn = (
        _padded_grads(dw, q, k, v, ct,
                      lambda *a, impl=impl: windowed_attention(dw, *a,
                                                               impl=impl))
        for impl in ("xla", "cudnn"))
    for a, b, name in zip(cudnn, xla, "qkv"):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.isfinite(a).all() and not np.any(a[:, n:]), name
        np.testing.assert_allclose(a, b, rtol=2e-2,
                                   atol=2e-2 * np.abs(b).max(), err_msg=name)
