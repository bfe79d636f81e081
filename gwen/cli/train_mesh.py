"""Mesh-scale ensemble training orchestrator (the north-star workflow).

No reference analog — this is the scaling extension BASELINE.json demands:
encode-process-decode over a weather mesh graph (diagonal-window
aggregation), next-step training over ensemble members, multi-device via the
(data, graph) mesh with halo-partitioned graph parallelism, and skill
verification of generated ensembles (fair CRPS / RMSE / spread) against a
held-out member.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gwen.config import GwenConfig
from gwen.logging_utils import get_logger, setup_logger
from gwen.registry import Registry, default_experiment

log = get_logger()


def main(config: GwenConfig, members: int = 4, steps: int = 16, data: str = '') -> dict:
    import jax
    import jax.numpy as jnp

    from gwen import ensemble
    from gwen.data.dataset import MeshEnsembleDataset
    from gwen.data.synthetic import mesh_ensemble_dataset
    from gwen.graph import (
        apply_order,
        build_graph,
        rcm_order,
    )
    from gwen.nn import EncodeProcessDecode
    from gwen.parallel import make_partitioned_apply, partition_graph
    from gwen.train import Trainer, TrainState, make_mesh
    from gwen.train.checkpoint import Checkpointer

    setup_logger()
    tcfg = config.train
    levels = config.graph.refine

    lazy = bool(data) and config.data.lazy
    if data:
        from gwen.data.meshstore import load_mesh_dataset

        fields, s, r, verts, _meta = load_mesh_dataset(data, lazy=lazy)
        members = fields.shape[1]
    else:
        fields, verts, s, r = mesh_ensemble_dataset(
            levels=levels, members=members, steps=steps, seed=tcfg.seed
        )
    n = fields.shape[2]
    n_dev = len(jax.devices())
    graph_parts = min(config.mesh.graph_axis, n_dev)
    use_partition = (
        graph_parts > 1 or config.mesh.force_partition
    ) and n_dev % graph_parts == 0
    # Layout/ordering choice. With vertex positions, the diag-window layout
    # over the KD-patch ordering (narrow windows, ~2% escapes) on every
    # platform; the implementation underneath is the platform's choice
    # (gwen.ops.platform). mesh.kernel="segment" keeps the ordering but
    # aggregates the COO graph with segment_sum; the interaction net's edge
    # MLP always rides the COO path (a windowed layout cannot express
    # per-edge features). Without positions: RCM + COO.
    kernel = config.mesh.kernel
    if kernel not in ("auto", "diag", "segment"):
        raise ValueError(
            f"mesh.kernel must be auto, diag or segment; got {kernel!r}")
    processor = config.model.processor
    if kernel == "diag" and verts is None:
        raise ValueError(
            "mesh.kernel='diag' needs vertex positions for the KD-patch "
            "diag-window layout")
    if processor == "attention":
        # Windowed attention rides the diag-window layout; the partitioned
        # variant needs the diag partition layout (halo = window).
        if use_partition and config.mesh.partition_layout != "diag":
            raise ValueError(
                "model.processor='attention' on the partitioned path "
                "requires mesh.partition_layout='diag'; got "
                f"{config.mesh.partition_layout!r}"
            )
        if verts is None:
            raise ValueError(
                "model.processor='attention' needs vertex positions for the "
                "KD-patch diag-window layout"
            )
        if kernel == "segment":
            raise ValueError(
                "model.processor='attention' needs the diag-window layout; "
                "mesh.kernel='segment' cannot express it")
    use_diag = (
        not use_partition
        and verts is not None
        and kernel != "segment"
        and processor != "interaction"
    )
    part_diag = (
        use_partition
        and config.mesh.partition_layout == "diag"
        and verts is not None
    )
    if verts is not None and (not use_partition or part_diag):
        from gwen.graph import kd_patch_order

        perm = kd_patch_order(np.asarray(verts), s, r, n)
    else:
        perm = rcm_order(s, r, n)
    s2, r2, _ = apply_order(perm, s, r)
    if lazy:
        # Streaming path (data.lazy=true): node reorder composes onto each
        # step read; the archive never materializes in host RAM.
        fields = fields.map(lambda step: np.take(step, perm, axis=1))
    else:
        fields = np.take(fields, perm, axis=2)
    ch = fields.shape[-1]

    compute_dtype = (
        jnp.bfloat16 if config.model.compute_dtype == "bfloat16" else jnp.float32
    )
    model = EncodeProcessDecode(
        channels_in=ch,
        channels_out=ch,
        latent_size=config.model.latent_size,
        process_steps=config.model.process_steps,
        mlp_layers=config.model.mlp_layers,
        residual=config.model.residual,
        remat=tcfg.remat,
        compute_dtype=compute_dtype,
        processor=processor,
        attn_heads=config.model.attn_heads,
    )

    # Graph tables travel through the jitted steps as the Trainer *context*
    # (arguments, not closed-over constants — mandatory at mesh scale).
    from gwen.train.tasks import mesh_graph_loss_fn

    if use_partition:
        mesh = make_mesh(data=n_dev // graph_parts, graph=graph_parts)
        pg = partition_graph(
            s2, r2, n, num_parts=graph_parts, reorder=False,
            layout=config.mesh.partition_layout,
            s_dtype=compute_dtype,
            diag_window=config.mesh.diag_window,
            device_build=(
                config.mesh.device_build
                and config.mesh.partition_layout in ("sliding", "diag")
            ),
        )
        apply_fn = make_partitioned_apply(model, pg, mesh)
        if lazy:
            fields = fields.map(lambda s: pg.pad_nodes(s, node_axis=-2))
        else:
            fields = pg.pad_nodes(fields)
        global_graph = build_graph(s2, r2, n)  # for skill eval / calibration
        context = apply_fn.tables

        if tcfg.rollout_horizon > 1:
            from gwen.train.tasks import partitioned_rollout_loss_fn

            loss_fn = partitioned_rollout_loss_fn(
                apply_fn, tcfg.rollout_horizon,
                loss=tcfg.loss if tcfg.loss in ("mse", "l1") else "mse",
            )
        elif tcfg.loss == "crps-ensemble":
            from gwen.train.tasks import partitioned_ensemble_crps_loss_fn

            # shard_map constraint: the K-member fan-out batch must divide
            # the data mesh axis. Fail here with the constraint spelled out
            # instead of an opaque sharding error deep inside jit.
            n_data = n_dev // graph_parts
            if (tcfg.batch_size * tcfg.crps_members) % n_data:
                raise ValueError(
                    f"batch_size * crps_members = {tcfg.batch_size} * "
                    f"{tcfg.crps_members} must divide the data mesh axis "
                    f"({n_data}) for partitioned CRPS-ensemble training"
                )
            # Noise correlation over the padded node space (isolated pad
            # rows get white self-loop noise — harmless). Threads through
            # the Trainer context with the tables (jit arguments, never
            # closed-over constants — mesh-scale rule).
            noise_graph = build_graph(s2, r2, fields.shape[2])
            context = (apply_fn.tables, noise_graph)
            loss_fn = partitioned_ensemble_crps_loss_fn(
                apply_fn,
                num_members=tcfg.crps_members, sigma=tcfg.sigma,
            )
        else:
            def loss_fn(params, batch, tables):
                x, y = batch
                preds = apply_fn(params, x, tables)
                if tcfg.loss == "l1":
                    return jnp.mean(jnp.abs(preds - y)), preds
                return jnp.mean((preds - y) ** 2), preds
    else:
        mesh = None
        g = build_graph(s2, r2, n)
        if use_diag:
            # Diagonal-window layout over the KD-patch ordering; S is
            # expanded on device from the O(edges) tables.
            from gwen.graph import to_diag_window

            graph = to_diag_window(
                g, window_size=config.mesh.diag_window,
                dtype=compute_dtype, device_build=True,
            )
        else:
            graph = g
        context = graph
        if tcfg.rollout_horizon > 1:
            from gwen.train.tasks import rollout_loss_fn

            loss_fn = rollout_loss_fn(model, tcfg.rollout_horizon)
        elif tcfg.loss == "crps-ensemble":
            from gwen.train.tasks import ensemble_crps_loss_fn

            loss_fn = ensemble_crps_loss_fn(
                model, num_members=tcfg.crps_members, sigma=tcfg.sigma
            )
        else:
            loss_fn = mesh_graph_loss_fn(
                model, loss=tcfg.loss if tcfg.loss in ("mse", "l1") else "mse"
            )
        global_graph = g

    # Train on all members except the last (held out for skill verification).
    train_fields = fields.map(lambda s: s[:-1]) if lazy else fields[:, :-1]
    ds = MeshEnsembleDataset(fields=train_fields)
    params = model.init(jax.random.key(tcfg.seed))
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

    registry = Registry(config.run.registry_root)
    experiment = (config.run.experiment or default_experiment()) + "_MESH"
    run = registry.create_run(experiment, config.to_dict(), config.run.run_name)
    ckpt = Checkpointer(
        Path(config.run.registry_root) / "checkpoints" / run.run_id,
        max_to_keep=tcfg.max_checkpoints,
    )
    batch_spec = None
    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        def batch_spec(batch):
            # Node fields: batch over "data", node axis (-2) over "graph".
            # Scalars / PRNG keys replicate.
            def sp(leaf):
                nd = getattr(leaf, "ndim", 0)
                if nd == 0:
                    return P()
                spec = [None] * nd
                spec[0] = "data"
                if nd >= 3:
                    spec[-2] = "graph"
                return P(*spec)

            return jax.tree_util.tree_map(sp, batch)

    trainer = Trainer(
        loss_fn=loss_fn, optimizer=opt, mesh=mesh, context=context,
        run=run, checkpointer=ckpt, log_every=tcfg.log_every,
        batch_spec=batch_spec,
    )

    if tcfg.rollout_horizon > 1:
        batches = lambda ep: ds.trajectory_batches(  # noqa: E731
            tcfg.batch_size, tcfg.rollout_horizon, shuffle=True, seed=ep
        )
    elif tcfg.loss == "crps-ensemble":
        def batches(ep):
            for i, (x, y) in enumerate(ds.batches(tcfg.batch_size, shuffle=True, seed=ep)):
                yield (x, y, jax.random.key(ep * 100003 + i))
    else:
        batches = lambda ep: ds.batches(tcfg.batch_size, shuffle=True, seed=ep)  # noqa: E731
    state, best = trainer.fit(
        state, batches, tcfg.epochs, checkpoint_every=tcfg.checkpoint_every
    )
    # Persist EVERY hyperparameter the export CLI needs to rebuild the
    # model: a mismatched processor/attn_heads/residual/mlp_layers produces
    # identical param shapes, so export would otherwise succeed and serve
    # silently wrong predictions. nodes/data pin the mesh identity.
    run.save_model(
        state.params,
        {"latent_size": config.model.latent_size,
         "process_steps": config.model.process_steps,
         "channels": ch, "levels": levels,
         "processor": processor,
         "attn_heads": config.model.attn_heads,
         "residual": config.model.residual,
         "mlp_layers": config.model.mlp_layers,
         "diag_window": config.mesh.diag_window,
         "compute_dtype": config.model.compute_dtype,
         "nodes": n, "data": data or ""},
        best_metric=best,
    )

    # Skill verification against the held-out member.
    horizon = min(4, fields.shape[0] - 1)
    base = jnp.asarray(fields[0, -1, :n] if use_partition else fields[0, -1])
    truth = jnp.asarray(fields[1 : 1 + horizon, -1, :n] if use_partition
                        else fields[1 : 1 + horizon, -1])

    skill_model = (
        EncodeProcessDecode(
            channels_in=ch, channels_out=ch,
            latent_size=config.model.latent_size,
            process_steps=config.model.process_steps,
            mlp_layers=config.model.mlp_layers,
            residual=config.model.residual,
            backend="segment" if processor != "attention" else "auto",
            processor=processor,
            attn_heads=config.model.attn_heads,
        )
    )
    if processor == "attention":
        # Attention needs the diag layout; aggregate() dispatch makes the
        # same container serve the perturbation smoothing. On the
        # partitioned path, rebuild the equivalent GLOBAL layout for skill
        # eval (same n_pad so the window mask matches the trained model).
        if use_partition:
            from gwen.graph import to_diag_window as _tdw

            global_graph = _tdw(
                global_graph, window_size=config.mesh.diag_window,
                dtype=compute_dtype, device_build=True,
                n_pad=pg.num_parts * pg.n_local,
            )
        else:
            global_graph = graph
    sigma = tcfg.sigma
    if tcfg.calibrate_sigma and fields.shape[1] > 1:
        cal = ensemble.calibrate_sigma(
            skill_model, state.params, global_graph,
            fields[:, :-1, :n] if use_partition else fields[:, :-1],
            jax.random.key(11), num_members=members, horizon=horizon,
        )
        sigma = cal["best_sigma"]
        run.log_metric("calibrated_sigma", sigma)
    gen = ensemble.generate_ensemble(
        skill_model, state.params, global_graph, base, jax.random.key(7),
        num_members=members, num_steps=horizon, sigma=sigma,
    )
    inflation = tcfg.inflation
    if tcfg.calibrate_inflation and fields.shape[1] > 1:
        # Closed-form: calibrate on a *validation* member (not the held-out
        # one), then apply to the held-out generation.
        vbase = jnp.asarray(fields[0, 0, :n] if use_partition else fields[0, 0])
        vtruth = jnp.asarray(fields[1 : 1 + horizon, 0, :n] if use_partition
                             else fields[1 : 1 + horizon, 0])
        vgen = ensemble.generate_ensemble(
            skill_model, state.params, global_graph, vbase, jax.random.key(13),
            num_members=members, num_steps=horizon, sigma=sigma,
        )
        inflation = ensemble.calibrate_inflation(vgen, vtruth, ensemble_axis=0)
        run.log_metric("calibrated_inflation", inflation)
    if inflation != 1.0:
        gen = ensemble.inflate_ensemble(gen, inflation, ensemble_axis=0)
    skill = ensemble.ensemble_skill(gen, truth, ensemble_axis=0)
    for k, v in skill.items():
        run.log_metric(f"skill_{k}", v)
    run.finish()
    log.info("mesh training done: best=%.5f skill=%s", best, skill)
    return {"best_train_loss": best, "run_id": run.run_id, "nodes": n,
            "edges": len(s), "layout": "diag" if (use_diag or part_diag)
            else "coo", "train_steps": len(trainer.losses),
            "train_loss_last": trainer.losses[-1] if trainer.losses else None,
            "train_losses_finite": bool(np.all(np.isfinite(trainer.losses))),
            "train_step_memory": trainer.step_memory,
            **{f"skill_{k}": v for k, v in skill.items()}}
