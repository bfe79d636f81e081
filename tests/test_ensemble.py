"""Ensemble perturbation sampling, rollout, and skill verification tests."""

import jax
import jax.numpy as jnp
import numpy as np

from gwen import ensemble
from gwen.data.synthetic import mesh_ensemble_dataset
from gwen.graph import build_graph
from gwen.nn import EncodeProcessDecode


def _setup(levels=2, members=3, steps=6):
    fields, verts, s, r = mesh_ensemble_dataset(levels=levels, members=members, steps=steps)
    g = build_graph(s, r, verts.shape[0])
    return fields, g


def test_synthetic_dataset_shapes():
    fields, g = _setup()
    assert fields.shape[:2] == (6, 3)
    assert np.isfinite(fields).all()
    # Dynamics actually move: consecutive steps differ.
    assert np.abs(fields[1] - fields[0]).max() > 1e-4


def test_correlated_noise_is_smooth():
    fields, g = _setup()
    n = g.num_nodes
    key = jax.random.key(0)
    white = ensemble.correlated_noise(key, g, (n, 1), smoothing_steps=0)
    smooth = ensemble.correlated_noise(key, g, (n, 1), smoothing_steps=3)
    # Smoothed noise has higher neighbor correlation: measure via aggregation.
    from gwen.ops import aggregate_segment

    def neighbor_corr(x):
        ax = aggregate_segment(g, x)
        return float(jnp.corrcoef(x[:, 0], ax[:, 0])[0, 1])

    assert neighbor_corr(smooth) > neighbor_corr(white)
    # Unit-ish variance preserved.
    assert 0.5 < float(jnp.std(smooth)) < 2.0


def test_sample_perturbed_members():
    fields, g = _setup()
    base = jnp.asarray(fields[0, 0])
    out = ensemble.sample_perturbed_members(
        jax.random.key(1), base, num_members=5, sigma=0.2, graph=g
    )
    assert out.shape == (5,) + base.shape
    # Members differ from each other and straddle the base.
    assert float(jnp.abs(out[0] - out[1]).max()) > 1e-3
    assert float(jnp.abs(jnp.mean(out, axis=0) - base).mean()) < 0.2


def test_rollout_and_generate():
    fields, g = _setup()
    ch = fields.shape[-1]
    model = EncodeProcessDecode(
        channels_in=ch, channels_out=ch, latent_size=8, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    traj = ensemble.generate_ensemble(
        model, params, g, jnp.asarray(fields[0, 0]), jax.random.key(2),
        num_members=3, num_steps=4, sigma=0.1,
    )
    assert traj.shape == (3, 4) + fields.shape[2:]
    assert np.isfinite(np.asarray(traj)).all()


def test_ensemble_skill_calibration_signal():
    rng = np.random.default_rng(0)
    # Reliable ensemble: truth is exchangeable with the members — all drawn
    # around a common (unknown) center with unit noise.
    center = rng.normal(size=(50,)) * 2.0
    truth = center + rng.normal(size=(50,))
    good = center[None] + rng.normal(size=(20, 50))
    # Overconfident ensemble: tiny spread, biased.
    bad = center[None] + rng.normal(size=(20, 50)) * 0.05 + 1.0
    s_good = ensemble.ensemble_skill(jnp.asarray(good), jnp.asarray(truth))
    s_bad = ensemble.ensemble_skill(jnp.asarray(bad), jnp.asarray(truth))
    assert s_good["crps"] < s_bad["crps"]
    assert 0.7 < s_good["spread_error_ratio"] < 1.4
    assert s_bad["spread_error_ratio"] < 0.2


def test_mesh_training_improves_skill():
    """End-to-end north-star slice: train next-step EPD on synthetic mesh
    dynamics, verify loss decreases and generated-ensemble CRPS beats a
    persistence ensemble."""
    import optax

    from gwen.data.dataset import MeshEnsembleDataset
    from gwen.train import Trainer, TrainState, mesh_loss_fn

    fields, g = _setup(levels=2, members=3, steps=10)
    ch = fields.shape[-1]
    ds = MeshEnsembleDataset(fields=fields[:, :2])  # train on 2 members
    model = EncodeProcessDecode(
        channels_in=ch, channels_out=ch, latent_size=16, process_steps=2,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    opt = optax.adam(3e-3)
    trainer = Trainer(
        loss_fn=mesh_loss_fn(lambda p, x: model.apply(p, g, x)), optimizer=opt
    )
    state = TrainState.create(params, opt)
    batches = lambda ep: ds.batches(4, shuffle=True, seed=ep)  # noqa: E731
    state, l0 = trainer.fit(state, batches, epochs=1)
    state, l1 = trainer.fit(state, batches, epochs=15)
    assert l1 < l0

    # Skill: generated ensemble vs held-out member-2 trajectory, trained
    # model must beat the untrained model (learning signal), ensemble-CRPS
    # fairly scored.
    horizon = 4
    truth = jnp.asarray(fields[1 : 1 + horizon, 2])

    def gen_skill(p):
        gen = ensemble.generate_ensemble(
            model, p, g, jnp.asarray(fields[0, 2]), jax.random.key(3),
            num_members=4, num_steps=horizon, sigma=0.05,
        )
        return ensemble.ensemble_skill(gen, truth, ensemble_axis=0)

    skill_trained = gen_skill(state.params)
    skill_untrained = gen_skill(model.init(jax.random.key(9)))
    assert np.isfinite(skill_trained["crps"])
    assert skill_trained["crps"] < skill_untrained["crps"]
    assert skill_trained["rmse_ensemble_mean"] < skill_untrained["rmse_ensemble_mean"]


def test_ensemble_crps_training_beats_init():
    """CRPS-trained model improves fair-CRPS skill over its init."""
    import optax

    from gwen.data.dataset import MeshEnsembleDataset
    from gwen.train import Trainer, TrainState
    from gwen.train.tasks import ensemble_crps_loss_fn

    fields, g = _setup(levels=2, members=3, steps=10)
    ch = fields.shape[-1]
    ds = MeshEnsembleDataset(fields=fields[:, :2])
    model = EncodeProcessDecode(
        channels_in=ch, channels_out=ch, latent_size=16, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    opt = optax.adam(3e-3)
    trainer = Trainer(
        loss_fn=ensemble_crps_loss_fn(model, num_members=3, sigma=0.05),
        optimizer=opt, context=g,
    )
    state = TrainState.create(params, opt)

    def batches(ep):
        for i, (x, y) in enumerate(ds.batches(4, shuffle=True, seed=ep)):
            yield (x, y, jax.random.key(ep * 1000 + i))

    state, l0 = trainer.fit(state, batches, epochs=1)
    state, l1 = trainer.fit(state, batches, epochs=10)
    assert l1 < l0  # CRPS decreased


def test_rollout_training_and_sigma_calibration():
    import optax

    from gwen.data.dataset import MeshEnsembleDataset
    from gwen.train import Trainer, TrainState
    from gwen.train.tasks import rollout_loss_fn

    fields, g = _setup(levels=2, members=3, steps=10)
    ch = fields.shape[-1]
    ds = MeshEnsembleDataset(fields=fields[:, :2])
    model = EncodeProcessDecode(
        channels_in=ch, channels_out=ch, latent_size=16, process_steps=1,
        backend="segment",
    )
    params = model.init(jax.random.key(0))
    opt = optax.adam(3e-3)
    horizon = 3
    trainer = Trainer(
        loss_fn=rollout_loss_fn(model, horizon), optimizer=opt, context=g
    )
    state = TrainState.create(params, opt)
    batches = lambda ep: ds.trajectory_batches(4, horizon, shuffle=True, seed=ep)  # noqa: E731
    state, l0 = trainer.fit(state, batches, epochs=1)
    state, l1 = trainer.fit(state, batches, epochs=8)
    assert l1 < l0

    cal = ensemble.calibrate_sigma(
        model, state.params, g, fields[:, 2:], jax.random.key(5),
        sigmas=(0.01, 0.1), num_members=3, horizon=3,
    )
    assert cal["best_sigma"] in (0.01, 0.1)
    assert len(cal["table"]) == 2
    assert all(np.isfinite(row["crps"]) for row in cal["table"])


def test_inflation_calibration_restores_spread():
    """inflate_ensemble scales spread linearly without moving the mean, and
    calibrate_inflation's closed-form factor lands the spread/error ratio on
    target."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gwen import ensemble

    rng = np.random.default_rng(0)
    truth = rng.normal(size=(6, 50, 3)).astype(np.float32)
    # Under-dispersive ensemble: tiny perturbations around a biased mean.
    gen = truth[None] + 0.5 + 0.05 * rng.normal(size=(8, 6, 50, 3)).astype(np.float32)
    gen = jnp.asarray(gen)
    truth = jnp.asarray(truth)

    before = ensemble.ensemble_skill(gen, truth, ensemble_axis=0)
    assert before["spread_error_ratio"] < 0.5

    factor = ensemble.calibrate_inflation(gen, truth, ensemble_axis=0)
    assert factor > 1.0
    inflated = ensemble.inflate_ensemble(gen, factor, ensemble_axis=0)

    # Mean (and hence its RMSE) unchanged.
    np.testing.assert_allclose(
        np.asarray(jnp.mean(inflated, axis=0)),
        np.asarray(jnp.mean(gen, axis=0)), rtol=1e-5, atol=1e-5,
    )
    after = ensemble.ensemble_skill(inflated, truth, ensemble_axis=0)
    assert abs(after["spread_error_ratio"] - 1.0) < 0.05
    np.testing.assert_allclose(
        after["rmse_ensemble_mean"], before["rmse_ensemble_mean"], rtol=1e-5
    )
