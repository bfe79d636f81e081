"""UNet CNN training orchestrator (reference train_cnn.py:31-197, as a function).

Differences from the GNN flow (train_cnn.py vs train_gnn.py): ConvDataset
member-channel batches, UNet model with channels from ``simplify``/member
split (train_cnn.py:69-80), Adam lr*100 (train_cnn.py:82), spatial variance
mask applied via MaskedLoss (train_cnn.py:51-60).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gwen.config import GwenConfig
from gwen.logging_utils import get_logger, setup_logger
from gwen.registry import Registry, default_experiment

log = get_logger()


def main(config: GwenConfig, animate: bool = True, out_dir: str = "output") -> dict:
    import jax
    import jax.numpy as jnp

    from gwen.data.dataset import ConvEnsembleDataset, load_data
    from gwen.nn.unet import UNet
    from gwen.train import Trainer, TrainState, cnn_loss_fn, make_mesh
    from gwen.train.checkpoint import Checkpointer

    setup_logger()
    train_np, test_np, meta = load_data(config.data)
    tcfg = config.train

    ds = ConvEnsembleDataset(
        data=train_np, member_split=tcfg.member_split,
        seed=tcfg.seed, simplify=tcfg.simplify,
    )
    ds_test = ConvEnsembleDataset(
        data=test_np, member_split=tcfg.member_split,
        seed=tcfg.seed, simplify=tcfg.simplify,
    )
    ch_in = len(ds.input_indices)
    ch_out = len(ds.target_indices)

    spatial_mask = None
    if tcfg.mask_threshold > 0:
        var = train_np.var(axis=0).mean(axis=0)  # (height, ncells)
        spatial_mask = jnp.asarray((var > tcfg.mask_threshold).astype(np.float32))

    model = UNet(channels_in=ch_in, channels_out=ch_out,
                 hidden=config.unet.hidden, depth=config.unet.depth)
    registry = Registry(config.run.registry_root)
    experiment = (config.run.experiment or default_experiment()) + "_CNN"

    params = model.init(jax.random.key(tcfg.seed))
    if not tcfg.retrain:
        params, _ = registry.load_best_model(experiment, params_template=params)

    from gwen.train.optim import make_optimizer

    opt = make_optimizer(
        tcfg.lr * 100.0,
        weight_decay=tcfg.weight_decay,
        scheduler=tcfg.scheduler,
        warmup_steps=tcfg.warmup_steps,
        cycle_steps=tcfg.cycle_steps,
        grad_clip=tcfg.grad_clip,
    )
    state = TrainState.create(params, opt)

    n_dev = len(jax.devices())
    mesh = make_mesh(data=n_dev, graph=1) if n_dev > 1 else None
    run = registry.create_run(experiment, config.to_dict(), config.run.run_name)
    ckpt = Checkpointer(Path(config.run.registry_root) / "checkpoints" / run.run_id,
                        max_to_keep=tcfg.max_checkpoints)
    from jax.sharding import PartitionSpec as P

    trainer = Trainer(
        loss_fn=cnn_loss_fn(model, spatial_mask=spatial_mask),
        optimizer=opt, mesh=mesh, run=run, checkpointer=ckpt,
        log_every=tcfg.log_every,
        batch_spec=(P("data"), P("data")),  # (x, y) batch-leading pairs
    )

    best = float("inf")
    if tcfg.retrain:
        batches = lambda ep: ds.batches(  # noqa: E731
            tcfg.batch_size, shuffle=True, seed=ep
        )
        state, best = trainer.fit(
            state, batches, tcfg.epochs, checkpoint_every=tcfg.checkpoint_every
        )
        run.save_model(state.params,
                       {"hidden": config.unet.hidden, "depth": config.unet.depth,
                        "channels_in": ch_in, "channels_out": ch_out},
                       best_metric=best)

    test_loss, preds = trainer.evaluate(state.params, ds_test.batches(1))
    log.info("test loss: %.6f", test_loss)
    run.log_metric("test_loss", test_loss)
    run.finish()

    result = {"test_loss": test_loss, "best_train_loss": best, "run_id": run.run_id}
    if animate and preds is not None:
        from gwen import viz

        members = meta.get("members") or [str(i) for i in range(train_np.shape[1])]
        targets = [members[i] for i in ds_test.target_indices]
        paths = viz.animate_predictions(preds, targets, out_dir, label="CNN")
        result["animations"] = [str(p) for p in paths]
    return result
