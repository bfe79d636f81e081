"""Serving artifact tests: pytree codec round-trip, export→load→step parity,
CLI export/predict end-to-end (CPU; the exported computation is the
segment/XLA path on the CPU)."""

import json

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
from gwen.nn import EncodeProcessDecode
from gwen.serve import ServingModel, export_model, pack_tree, unpack_tree


def test_pack_tree_roundtrip_graph_containers():
    verts, s, r = icosphere_edges(3)
    n = verts.shape[0]
    perm = kd_patch_order(verts, s, r, n, leaf_size=64)
    s, r, _ = apply_order(perm, s, r)
    dw = to_diag_window(build_graph(s, r, n), window_size=128, block_size=32,
                        superblock=4, compact_escapes=True)
    leaves: list = []
    spec = pack_tree({"graph": dw, "extra": (1, None, "x", [2.5, True])},
                     leaves)
    spec = json.loads(json.dumps(spec))  # must survive JSON
    back = unpack_tree(spec, leaves)
    dw2 = back["graph"]
    assert back["extra"] == (1, None, "x", [2.5, True])
    assert type(dw2) is type(dw)
    assert dw2.superblock == dw.superblock
    assert dw2.window_size == dw.window_size
    assert dw2.esc2_graph.receivers_sorted
    flat1 = jax.tree_util.tree_leaves(dw)
    flat2 = jax.tree_util.tree_leaves(dw2)
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _tiny_model_and_graph():
    verts, s, r = icosphere_edges(2)
    n = verts.shape[0]
    perm = rcm_order(s, r, n)
    s, r, _ = apply_order(perm, s, r)
    g = build_graph(s, r, n)
    model = EncodeProcessDecode(channels_in=3, channels_out=3,
                                latent_size=16, process_steps=2,
                                backend="segment")
    params = model.init(jax.random.key(0))
    return model, params, g, n


def test_export_load_step_parity(tmp_path):
    model, params, g, n = _tiny_model_and_graph()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3)).astype(np.float32)

    path = export_model(model, params, g, x, tmp_path / "artifact",
                        metadata={"purpose": "test"})
    sm = ServingModel.load(path)
    assert sm.meta["metadata"]["purpose"] == "test"
    assert sm.input_shape == (n, 3)

    got = np.asarray(sm.step(jnp.asarray(x)))
    want = np.asarray(model.apply(params, g, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    traj = np.asarray(sm.rollout(jnp.asarray(x), 3))
    assert traj.shape == (3, n, 3)
    assert np.isfinite(traj).all()


def test_export_scan_rollout(tmp_path):
    # The scan-based rollout artifact (R steps per dispatch) must produce
    # the same trajectory as step-by-step feeding, including when the
    # requested horizon is not a multiple of R.
    model, params, g, n = _tiny_model_and_graph()
    x = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)

    path = export_model(model, params, g, x, tmp_path / "art_roll",
                        rollout_steps=2)
    assert (tmp_path / "art_roll" / "rollout.stablehlo").exists()
    sm = ServingModel.load(path)
    assert sm.rollout_steps == 2

    got = np.asarray(sm.rollout(jnp.asarray(x), 5))
    assert got.shape == (5, n, 3)
    want, xi = [], jnp.asarray(x)
    for _ in range(5):
        xi = sm.step(xi)
        want.append(np.asarray(xi))
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-5, atol=1e-5)


def test_export_needs_no_flatbuffers(tmp_path, monkeypatch):
    """The artifact is written and read without JAX's flatbuffers-based
    serializer (the package may be missing where the model is served)."""
    import sys

    monkeypatch.setitem(sys.modules, "flatbuffers", None)
    model, params, g, n = _tiny_model_and_graph()
    x = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    path = export_model(model, params, g, x, tmp_path / "art",
                        rollout_steps=2)
    sm = ServingModel.load(path)
    np.testing.assert_allclose(
        np.asarray(sm.rollout(jnp.asarray(x), 2))[-1],
        np.asarray(model.apply(params, g, model.apply(params, g, x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("field,value,match", [
    ("format", None, "format"),
    ("jax_version", "0.0.1", "JAX 0.0.1"),
], ids=["serialize_format", "other_jax"])
def test_load_refuses_foreign_artifact(tmp_path, field, value, match):
    """An artifact from an earlier format or another JAX version fails to
    load with the reason, not deep inside jax.export."""
    model, params, g, n = _tiny_model_and_graph()
    x = np.zeros((n, 3), np.float32)
    path = export_model(model, params, g, x, tmp_path / "art")
    meta = json.loads((path / "meta.json").read_text())
    meta[field] = value
    (path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=match):
        ServingModel.load(path)


def test_export_load_step_bf16(tmp_path):
    # np.savez degrades ml_dtypes bfloat16 to raw void '|V2' on reload; the
    # npz codec's dtype record must view it back (every bf16 model export
    # has bf16 leaves).
    model, params, g, n = _tiny_model_and_graph()
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        params)
    x = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)

    path = export_model(model, params, g, x, tmp_path / "art_bf16")
    sm = ServingModel.load(path)
    leaf_dtypes = {np.asarray(leaf).dtype.name
                   for leaf in jax.tree_util.tree_leaves(sm.params)}
    assert "bfloat16" in leaf_dtypes
    assert not any(d.startswith("void") for d in leaf_dtypes)

    got = np.asarray(sm.step(jnp.asarray(x)), np.float32)
    want = np.asarray(model.apply(params, g, jnp.asarray(x)), np.float32)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_cli_export_predict(tmp_path, capsys):
    from gwen.cli.main import main as cli

    # Seed the registry with a trained tiny mesh run, then export + predict.
    assert cli(["train-mesh", "--members", "2", "--steps", "4",
                "graph.refine=2", "model.latent_size=8",
                "model.process_steps=1", "train.epochs=1",
                "train.batch_size=2", "run.experiment=SRV",
                f"run.registry_root={tmp_path / 'runs'}"]) == 0
    capsys.readouterr()

    assert cli(["export", "--out", str(tmp_path / "art"),
                "model.latent_size=8", "model.process_steps=1",
                "run.experiment=SRV",
                f"run.registry_root={tmp_path / 'runs'}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nodes"] == 162

    x0 = np.zeros((162, out["channels"]), np.float32)
    np.save(tmp_path / "x0.npy", x0)
    assert cli(["predict", "--artifact", str(tmp_path / "art"),
                "--input", str(tmp_path / "x0.npy"), "--steps", "2",
                "--out", str(tmp_path / "pred.npy")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pred = np.load(tmp_path / "pred.npy")
    assert pred.shape == (2, 162, x0.shape[1])
    assert np.isfinite(pred).all()

    # A CLI override conflicting with the run's stored hyperparameters must
    # be rejected (same param shapes → would serve silently wrong preds).
    with pytest.raises(ValueError, match="attn_heads"):
        cli(["export", "--out", str(tmp_path / "art2"),
             "model.attn_heads=4", "run.experiment=SRV",
             f"run.registry_root={tmp_path / 'runs'}"])
