"""GNN training orchestrator (reference train_gnn.py:73-228, as a function).

Flow parity: load config+data → member GraphDataset → variance mask → model
(fresh or best-from-registry depending on ``retrain``) → train (multi-device
via the mesh data axis — replaces mp.spawn/NCCL) → eval on the test split →
per-target-member GIF animations.
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

    from gwen.data.dataset import MemberGraphDataset, load_data
    from gwen.graph import build_graph, erdos_renyi_edges, to_dense
    from gwen.nn import GCNStack
    from gwen.train import Trainer, TrainState, gnn_loss_fn, make_mesh
    from gwen.train.checkpoint import Checkpointer

    setup_logger()
    train_np, test_np, meta = load_data(config.data)
    tcfg = config.train

    ds = MemberGraphDataset(
        data=train_np, member_split=tcfg.member_split,
        seed=tcfg.seed, simplify=tcfg.simplify,
    )
    ds_test = MemberGraphDataset(
        data=test_np, member_split=tcfg.member_split,
        seed=tcfg.seed, simplify=tcfg.simplify,
    )

    # Member graph: fully connected (utils.py:176), densified (adj @ x).
    s, r = erdos_renyi_edges(ds.num_nodes, config.graph.edge_prob, seed=tcfg.seed)
    graph = to_dense(build_graph(s, r, ds.num_nodes, self_loops=config.graph.self_loops))

    # Spatial variance mask (train_gnn.py:88-96), computed as a streaming
    # per-cell time variance so it works for lazy (chunked) fields too.
    feat_mask = None
    if tcfg.mask_threshold > 0:
        t_len = train_np.shape[0]
        s1 = np.zeros(train_np.shape[1:], np.float64)
        s2 = np.zeros_like(s1)
        for t in range(t_len):
            step = np.asarray(train_np[t], np.float64)  # (member, h, c)
            s1 += step
            s2 += step * step
        var = s2 / t_len - (s1 / t_len) ** 2
        fm = (var > tcfg.mask_threshold).reshape(ds.num_nodes, -1)
        feat_mask = fm.max(axis=0).astype(np.float32)  # over members → per-feature

    model = GCNStack(
        channels_in=ds.num_features, channels_out=ds.num_features,
        hidden_feats=config.model.hidden_feats,
    )
    registry = Registry(config.run.registry_root)
    experiment = config.run.experiment or default_experiment()

    params = model.init(jax.random.key(tcfg.seed))
    if not tcfg.retrain:
        params, _ = registry.load_best_model(experiment, params_template=params)
        log.info("loaded best model from registry (retrain=false)")

    from gwen.train.optim import make_optimizer

    opt = make_optimizer(
        tcfg.lr * tcfg.lr_multiplier,
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

    # Explicit per-leaf sharding: x/target batch over the data axis; the
    # member mask is replicated (its length is the member count, which may
    # happen to divide the device count — never shard it).
    def batch_spec(batch):
        return {k: (P() if k == "mask" else P("data")) for k in batch}

    trainer = Trainer(
        loss_fn=gnn_loss_fn(model, graph, loss=tcfg.loss,
                            mask_threshold_mask=feat_mask,
                            var_reg_alpha=tcfg.var_reg_alpha),
        optimizer=opt, mesh=mesh, run=run, checkpointer=ckpt,
        log_every=tcfg.log_every, batch_spec=batch_spec,
    )

    best = float("inf")
    if tcfg.retrain:
        batches = lambda ep: (  # noqa: E731
            {"x": x, "mask": m}
            for x, m in ds.batches(
                tcfg.batch_size, shuffle=True, seed=ep,
                node_batch_size=tcfg.node_batch_size,
            )
        )
        state, best = trainer.fit(
            state, batches, tcfg.epochs, checkpoint_every=tcfg.checkpoint_every
        )
        run.save_model(state.params, {"hidden_feats": config.model.hidden_feats,
                                      "channels": ds.num_features},
                       best_metric=best)

    test_loss, preds = trainer.evaluate(
        state.params,
        ({"x": x, "mask": m} for x, m in ds_test.batches(1)),
    )
    log.info("test loss: %.6f", test_loss)
    run.log_metric("test_loss", test_loss)
    run.finish()

    result = {"test_loss": test_loss, "best_train_loss": best, "run_id": run.run_id}
    if animate and preds is not None:
        from gwen import viz

        t, m_, h, c = test_np.shape
        preds4 = preds.reshape(preds.shape[0], m_, h, c)
        members = meta.get("members") or [str(i) for i in range(m_)]
        targets = [members[i] for i in ds_test.target_indices]
        paths = viz.animate_predictions(
            preds4[:, ds_test.target_indices], targets, out_dir, label="GNN"
        )
        paths += viz.animate_predictions(
            test_np[:, ds_test.target_indices], targets, out_dir, label="ICON"
        )
        result["animations"] = [str(p) for p in paths]
    return result
