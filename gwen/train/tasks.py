"""Task definitions: bind model + graph + loss into trainer-ready loss_fns.

Mirrors the reference's two training entry points (train_gnn.py / train_cnn.py)
as pure functions instead of model-methods-with-side-effects.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from gwen import losses


def gnn_loss_fn(
    model,
    graph,
    loss: str = "l1-masked",
    mask_threshold_mask=None,
    var_reg_alpha: float = 0.1,
) -> Callable:
    """Member-graph GNN task.

    Batch: ``{"x": (B, members, features), "mask": (members,)}``. The model is
    vmapped over the batch (time) axis. Loss = L1 over target-masked member
    nodes (models_gnn.py:261-265,370), optionally composed with a spatial
    variance mask (train_gnn.py:88-96) or the ensemble-variance regularizer.
    """

    def loss_fn(params, batch):
        x, target_mask = batch["x"], batch["mask"]
        # With mask_inputs datasets the input has target rows zeroed; the
        # loss must compare against the unmasked ground truth.
        target = batch.get("target", x)
        # Aggregation backends are batch-native (leading dims fold into the
        # feature axis), so the model applies to (B, N, F) directly — no vmap,
        # which keeps Pallas kernels out of batching rules.
        preds = model.apply(params, graph, x)
        if mask_threshold_mask is not None:
            # Spatial variance mask over features (train_gnn.py:88-96 +
            # MaskedLoss, loss_functions.py:126-180) combined with the
            # target-node mask: count only active cells of target members.
            fmask = jnp.reshape(mask_threshold_mask, (1, 1, -1))
            nmask = jnp.reshape(target_mask, (1, -1, 1))
            value = losses.masked_loss(preds, target, fmask * nmask)
        elif loss == "l1-masked":
            value = losses.masked_node_l1(preds, target, target_mask)
        elif loss == "ensemble-var-reg":
            value = losses.ensemble_variance_regularized_l1(
                preds, target, alpha=var_reg_alpha, ensemble_axis=1
            )
        elif loss == "crps":
            value = losses.crps_gaussian_surrogate(preds, target, ensemble_axis=1)
        else:
            raise ValueError(f"unknown GNN loss {loss!r}")
        return value, preds

    return loss_fn


def mesh_loss_fn(apply_fn: Callable, loss: str = "mse") -> Callable:
    """Mesh-scale next-step prediction task (BASELINE north star).

    ``apply_fn(params, x) -> preds`` is either ``model.apply`` bound to a
    global graph, or the shard_map-wrapped partitioned apply from
    ``gwen.parallel.make_partitioned_apply``. Batch: ``(x, y)`` node-field
    pairs ``(B, nodes, channels)`` — consecutive time steps of members.
    """

    def loss_fn(params, batch):
        x, y = batch
        preds = apply_fn(params, x)
        if loss == "mse":
            value = jnp.mean((preds - y) ** 2)
        elif loss == "l1":
            value = jnp.mean(jnp.abs(preds - y))
        else:
            raise ValueError(f"unknown mesh loss {loss!r}")
        return value, preds

    return loss_fn


def mesh_graph_loss_fn(model, loss: str = "mse") -> Callable:
    """Context-aware mesh task: ``loss_fn(params, (x, y), graph)`` with the
    graph container supplied through the Trainer's ``context`` — the
    mesh-scale-safe pattern (graph tables are jit *arguments*, never inlined
    constants; see Trainer docstring)."""

    def loss_fn(params, batch, graph):
        x, y = batch
        preds = model.apply(params, graph, x)
        if loss == "mse":
            value = jnp.mean((preds - y) ** 2)
        elif loss == "l1":
            value = jnp.mean(jnp.abs(preds - y))
        else:
            raise ValueError(f"unknown mesh loss {loss!r}")
        return value, preds

    return loss_fn


def cnn_loss_fn(model, loss: str = "l1", spatial_mask=None) -> Callable:
    """UNet CNN task: batch = (x, y) with member channels (train_cnn.py:42-86)."""

    def loss_fn(params, batch):
        x, y = batch
        preds = model.apply(params, x)
        if spatial_mask is not None:
            value = losses.masked_loss(preds, y, spatial_mask, base=loss)
        elif loss == "l1":
            value = losses.l1_loss(preds, y)
        elif loss == "mse":
            value = jnp.mean((preds - y) ** 2)
        else:
            raise ValueError(f"unknown CNN loss {loss!r}")
        return value, preds

    return loss_fn


def ensemble_crps_loss_fn(
    model,
    num_members: int = 4,
    sigma: float = 0.05,
    smoothing_steps: int = 2,
    spread_weight: float = 0.0,
) -> Callable:
    """Probabilistic mesh training: minimize the *fair ensemble CRPS* of K
    perturbed forecasts (north-star extension; the reference's CRPSLoss is a
    Gaussian-surrogate on existing members, loss_functions.py:41-73).

    Context-aware: ``loss_fn(params, (x, y, key), graph)``. For each sample,
    K graph-correlated perturbations of the input state are forecast one step
    and scored against the target with fair CRPS — directly optimizing
    ensemble skill instead of a deterministic L2.
    """
    from gwen import ensemble, losses

    def loss_fn(params, batch, graph):
        x, y, key = batch  # x, y: (B, N, C); key: jax PRNG key array
        b = x.shape[0]
        # (B, K) perturbations in one batch-native draw (leading dims fold
        # into the batched aggregation kernels; no vmap).
        xs = ensemble.sample_perturbed_members(
            key, x, num_members, sigma, graph, smoothing_steps, batch_dims=1
        )  # (B, K, N, C)
        xs = xs.reshape((b * num_members,) + x.shape[1:])
        preds = model.apply(params, graph, xs)
        preds = preds.reshape((b, num_members) + y.shape[1:])  # (B, K, N, C)
        crps = losses.crps_ensemble(preds, y, ensemble_axis=1, fair=True)
        value = crps
        if spread_weight:
            spread = jnp.sqrt(jnp.mean(jnp.var(preds, axis=1)) + 1e-12)
            value = value - spread_weight * spread
        # Report the deterministic ensemble mean as preds.
        return value, jnp.mean(preds, axis=1)

    return loss_fn


def partitioned_rollout_loss_fn(apply_fn: Callable, horizon: int,
                                loss: str = "mse") -> Callable:
    """Rollout-horizon training through the shard_map-wrapped partitioned
    apply (``gwen.parallel.make_partitioned_apply``).

    Context-aware: ``loss_fn(params, (x0, traj), tables)`` — the partition
    tables thread through the Trainer context as jit arguments. ``x0`` and
    ``traj`` are in the *padded* global node space (``pg.pad_nodes``).
    """
    import jax

    def loss_fn(params, batch, tables):
        x0, traj = batch

        def step(carry, _):
            nxt = apply_fn(params, carry, tables)
            return nxt, nxt

        _, preds = jax.lax.scan(step, x0, None, length=horizon)
        preds = jnp.moveaxis(preds, 0, 1)  # (B, H, N, C)
        if loss == "mse":
            value = jnp.mean((preds - traj) ** 2)
        else:
            value = jnp.mean(jnp.abs(preds - traj))
        return value, preds

    return loss_fn


def partitioned_ensemble_crps_loss_fn(
    apply_fn: Callable,
    num_members: int = 4,
    sigma: float = 0.05,
    smoothing_steps: int = 2,
) -> Callable:
    """Fair-ensemble-CRPS training through the partitioned apply.

    Perturbation noise is correlated with a noise graph — a COO graph over
    the *padded* global node space, evaluated outside shard_map (replicated;
    O(edges) tables). The K-member forecast fan-out rides the partitioned
    apply, so ``batch_size * num_members`` must divide the ``data`` mesh
    axis evenly (shard_map sharding constraint).

    Context-aware: ``loss_fn(params, (x, y, key), (tables, noise_graph))`` —
    both the partition tables AND the noise graph thread through the Trainer
    context as jit *arguments* (closed-over O(edges) numpy tables would be
    inlined as compile-time constants; see Trainer docstring).
    """
    from gwen import ensemble

    def loss_fn(params, batch, context):
        tables, noise_graph = context
        x, y, key = batch  # padded global node space
        b = x.shape[0]
        # Batch-native (B, K) draw — see ensemble_crps_loss_fn.
        xs = ensemble.sample_perturbed_members(
            key, x, num_members, sigma, noise_graph, smoothing_steps,
            batch_dims=1,
        )  # (B, K, N, C)
        xs = xs.reshape((b * num_members,) + x.shape[1:])
        preds = apply_fn(params, xs, tables)
        preds = preds.reshape((b, num_members) + y.shape[1:])
        crps = losses.crps_ensemble(preds, y, ensemble_axis=1, fair=True)
        return crps, jnp.mean(preds, axis=1)

    return loss_fn


def rollout_loss_fn(model, horizon: int, loss: str = "mse") -> Callable:
    """Multi-step (rollout-horizon) training: autoregress ``horizon`` steps
    and penalize the whole trajectory — curbs the error accumulation that
    single-step training leaves unconstrained (GraphCast-style curriculum).

    Context-aware: ``loss_fn(params, (x0, traj), graph)`` with ``traj``
    shaped ``(B, horizon, N, C)``.
    """
    import jax

    def loss_fn(params, batch, graph):
        x0, traj = batch

        def step(carry, _):
            nxt = model.apply(params, graph, carry)
            return nxt, nxt

        _, preds = jax.lax.scan(step, x0, None, length=horizon)  # (H, B, N, C)
        preds = jnp.moveaxis(preds, 0, 1)
        if loss == "mse":
            value = jnp.mean((preds - traj) ** 2)
        else:
            value = jnp.mean(jnp.abs(preds - traj))
        return value, preds

    return loss_fn
